"""Component framework: the JAX-native equivalent of the reference's
nnet1-style component zoo (reference: src/aslp-nnet/nnet-component.h:45).

Design (functional, not a port of PropagateFnc/BackpropagateFnc):
  - a Component instance holds only *hyperparameters* (dims, attrs);
  - ``init_params(key)`` returns a pytree of arrays;
  - ``apply(params, x, state, ...)`` is a pure function, so the whole
    network propagates under one ``jax.jit`` and gradients come from
    ``jax.grad`` instead of hand-written backprop;
  - recurrent/stateful components thread an explicit ``state`` pytree
    (LSTM carries, BN accumulators), replacing the reference's mutable
    ``prev_nnet_state_`` buffers (nnet-lstm-projected-streams.h:296).

Data layout: sequence components take [S, T, D] (streams-major, scan over
T); frame-level components accept any [..., D].  This replaces the
reference's interleaved ``t*S + s`` row layout (SURVEY.md §3.2) which
would defeat XLA batching.

The registry maps reference proto/model tokens (``<AffineTransform>`` ...)
to classes so reference <NnetProto> files parse directly
(reference: nnet-component.h:50-103 MarkerToType, Component::Init).
"""

from __future__ import annotations

import shlex
from typing import Any, Dict, List, Optional, Tuple, Type

import jax
import jax.numpy as jnp


class Component:
    """Base component (reference: nnet-component.h:45)."""

    token: str = "<Component>"
    updatable: bool = False
    recurrent: bool = False

    def __init__(self, input_dim: int, output_dim: int, **attrs):
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.attrs = attrs

    # -- parameters ---------------------------------------------------------
    def init_params(self, key: jax.Array) -> Dict[str, jnp.ndarray]:
        return {}

    def num_params(self, params) -> int:
        return sum(int(p.size) for p in jax.tree_util.tree_leaves(params))

    # -- state (recurrent carry / accumulators) -----------------------------
    def init_state(self, num_streams: int) -> Any:
        return None

    # -- forward ------------------------------------------------------------
    def apply(
        self,
        params: Dict[str, jnp.ndarray],
        x: jnp.ndarray,
        state: Any = None,
        train: bool = False,
        rng: Optional[jax.Array] = None,
    ) -> Tuple[jnp.ndarray, Any]:
        raise NotImplementedError

    # -- config -------------------------------------------------------------
    @classmethod
    def from_config(cls, input_dim: int, output_dim: int,
                    attrs: Dict[str, Any]) -> "Component":
        return cls(input_dim, output_dim, **attrs)

    def config_attrs(self) -> Dict[str, Any]:
        """Attrs to serialize; subclasses extend."""
        return dict(self.attrs)

    def __repr__(self):
        return (f"{type(self).__name__}(in={self.input_dim}, "
                f"out={self.output_dim})")


_REGISTRY: Dict[str, Type[Component]] = {}


def register(cls: Type[Component]) -> Type[Component]:
    _REGISTRY[cls.token] = cls
    # tolerate case-insensitive lookup like the reference's MarkerToType
    _REGISTRY[cls.token.lower()] = cls
    return cls


def component_from_token(token: str) -> Type[Component]:
    try:
        return _REGISTRY[token] if token in _REGISTRY else _REGISTRY[token.lower()]
    except KeyError:
        raise ValueError(f"unknown component token {token!r}") from None


def known_tokens() -> List[str]:
    return sorted({c.token for c in _REGISTRY.values()})


# ---------------------------------------------------------------------------
# proto-line parsing (reference: Component::Init, nnet-component.cc)
# ---------------------------------------------------------------------------

def parse_proto_line(line: str) -> Tuple[Type[Component], Dict[str, Any]]:
    """Parse one ``<Token> <Key> value ...`` proto line.

    Returns (component class, attrs dict with input_dim/output_dim and
    normalized snake_case extras).  Mirrors the reference's marker
    convention: ``<InputDim> 40 <OutputDim> 512 <ParamStddev> 0.1 ...``.
    """
    toks = shlex.split(line)
    if not toks or not toks[0].startswith("<"):
        raise ValueError(f"bad proto line: {line!r}")
    cls = component_from_token(toks[0])
    attrs: Dict[str, Any] = {}
    i = 1
    while i < len(toks):
        key = toks[i]
        if not (key.startswith("<") and key.endswith(">")):
            raise ValueError(f"expected <Key> in proto line, got {key!r}")
        name = _snake(key[1:-1])
        if i + 1 < len(toks) and not toks[i + 1].startswith("<"):
            attrs[name] = _auto(toks[i + 1])
            i += 2
        else:
            attrs[name] = True
            i += 1
    return cls, attrs


def _snake(camel: str) -> str:
    out = []
    for i, c in enumerate(camel):
        if c.isupper() and i > 0 and (not camel[i - 1].isupper()):
            out.append("_")
        out.append(c.lower())
    return "".join(out)


def _camel(snake: str) -> str:
    return "".join(p.capitalize() for p in snake.split("_"))


def _auto(s: str):
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    return s


def build_component(line: str) -> Component:
    cls, attrs = parse_proto_line(line)
    input_dim = attrs.pop("input_dim")
    output_dim = attrs.pop("output_dim")
    return cls.from_config(input_dim, output_dim, attrs)
