"""Graph network container: DAG of components with multi-input/multi-output.

JAX-native equivalent of the reference's graph Nnet (reference:
src/aslp-nnet/nnet-nnet.{h,cc} — component ids, per-edge column offsets,
AssignComponentId/SortComponent topo sort at nnet-nnet.cc:886,951,
multi-io Propagate summing into per-component input buffers at :70-106).

Functional design: the container holds only topology + component
hyperparams.  ``init`` produces the param pytree; ``apply`` is a pure
function over (params, inputs, states) suitable for jit/grad/shard_map.
Edges carry a column offset into the destination's input buffer, which
expresses both add-junctions (same offset) and splice-junctions
(disjoint offsets), exactly like the reference.

Node input sources: non-negative ints are component ids; the string
"in:k" (or -1-k) is the k-th network input (the reference models these
as InputLayer pseudo-components, nnet-io.h:19)."""

from __future__ import annotations

import io
import json
import zipfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_aslp_tpu.models.component import (
    Component,
    build_component,
    component_from_token,
)

# components whose apply() accepts a mask kwarg (sequence-aware)
_MASK_AWARE = ("mask",)

Source = Union[int, str]  # component id or "in:k"


@dataclass
class Node:
    comp: Component
    inputs: List[Tuple[Source, int]]  # (source, column offset into input buf)


class Nnet:
    def __init__(self, num_inputs: int = 1,
                 output_ids: Optional[List[int]] = None):
        self.nodes: List[Node] = []
        self.num_inputs = num_inputs
        self._output_ids = output_ids

    # -- construction -------------------------------------------------------
    def add(self, comp: Component,
            inputs: Optional[List[Tuple[Source, int]]] = None) -> int:
        """Append a component; default input = previous node (chain),
        mirroring the reference's AutoComplete (nnet-nnet.cc:534)."""
        if inputs is None:
            src: Source = "in:0" if not self.nodes else len(self.nodes) - 1
            inputs = [(src, 0)]
        self.nodes.append(Node(comp, inputs))
        return len(self.nodes) - 1

    @classmethod
    def from_proto(cls, proto: str) -> "Nnet":
        """Build a chain network from <NnetProto> text
        (reference: nnet-nnet.cc:561 Init)."""
        net = cls()
        for line in proto.strip().splitlines():
            line = line.strip()
            if not line or line in ("<NnetProto>", "</NnetProto>"):
                continue
            net.add(build_component(line))
        return net

    # -- shape bookkeeping --------------------------------------------------
    @property
    def input_dim(self) -> int:
        return self.nodes[0].comp.input_dim if self.nodes else 0

    @property
    def output_dim(self) -> int:
        outs = self.output_ids()
        return sum(self.nodes[i].comp.output_dim for i in outs)

    def output_ids(self) -> List[int]:
        if self._output_ids is not None:
            return self._output_ids
        consumed = {s for n in self.nodes for (s, _) in n.inputs
                    if isinstance(s, int)}
        outs = [i for i in range(len(self.nodes)) if i not in consumed]
        return outs or [len(self.nodes) - 1]

    def num_components(self) -> int:
        return len(self.nodes)

    # -- params / state -----------------------------------------------------
    def init(self, key: jax.Array) -> Dict[str, Any]:
        keys = jax.random.split(key, max(len(self.nodes), 1))
        return {
            str(i): node.comp.init_params(keys[i])
            for i, node in enumerate(self.nodes)
        }

    def init_state(self, num_streams: int) -> Dict[str, Any]:
        out = {}
        for i, node in enumerate(self.nodes):
            s = node.comp.init_state(num_streams)
            if s is not None:
                out[str(i)] = s
        return out

    def num_params(self, params) -> int:
        return sum(int(p.size) for p in jax.tree_util.tree_leaves(params))

    def param_list(self, params) -> List[Tuple[str, jnp.ndarray]]:
        """Flat (path, array) view — the GetGpuParams ABI equivalent
        (reference: nnet-nnet.h:113) used by BMUF/optimizer code."""
        flat, _ = jax.tree_util.tree_flatten_with_path(params)
        return [(jax.tree_util.keystr(path), leaf) for path, leaf in flat]

    # -- forward ------------------------------------------------------------
    def apply(
        self,
        params: Dict[str, Any],
        inputs: Union[jnp.ndarray, Sequence[jnp.ndarray]],
        states: Optional[Dict[str, Any]] = None,
        train: bool = False,
        rng: Optional[jax.Array] = None,
        mask: Optional[jnp.ndarray] = None,
    ):
        """Run the DAG (reference: Propagate nnet-nnet.cc:70-106).

        Returns (outputs, new_states): outputs is a single array if the
        net has one output, else a list."""
        if isinstance(inputs, (list, tuple)):
            input_list = list(inputs)
        else:
            input_list = [inputs]
        if len(input_list) != self.num_inputs:
            raise ValueError(
                f"expected {self.num_inputs} inputs, got {len(input_list)}"
            )
        states = dict(states or {})
        outputs: Dict[int, jnp.ndarray] = {}
        new_states: Dict[str, Any] = {}
        rngs = (jax.random.split(rng, len(self.nodes))
                if rng is not None else [None] * len(self.nodes))
        for i, node in enumerate(self.nodes):
            x = self._gather_input(node, input_list, outputs)
            kwargs: Dict[str, Any] = {}
            if node.comp.recurrent or type(node.comp).__name__ in (
                "BatchNormalization", "CompactFsmn", "RowConvolution"
            ):
                kwargs["mask"] = mask
            y, s = node.comp.apply(
                params.get(str(i), {}), x, states.get(str(i)),
                train=train, rng=rngs[i], **kwargs
            )
            outputs[i] = y
            if s is not None:
                new_states[str(i)] = s
        outs = [outputs[i] for i in self.output_ids()]
        return (outs[0] if len(outs) == 1 else outs), new_states

    def feedforward(self, params, inputs, states=None, mask=None):
        y, _ = self.apply(params, inputs, states, train=False, mask=mask)
        return y

    def _gather_input(self, node: Node, input_list, outputs) -> jnp.ndarray:
        """Sum edge sources into the node's input buffer at column offsets
        (reference: nnet-nnet.cc:70-106)."""
        srcs = []
        for (src, off) in node.inputs:
            val = (input_list[int(str(src).split(":")[1])]
                   if isinstance(src, str) else outputs[src])
            srcs.append((val, off))
        if len(srcs) == 1 and srcs[0][1] == 0 and (
            srcs[0][0].shape[-1] == node.comp.input_dim
        ):
            return srcs[0][0]
        width = node.comp.input_dim
        base = srcs[0][0]
        buf = jnp.zeros(base.shape[:-1] + (width,), base.dtype)
        for val, off in srcs:
            buf = buf.at[..., off:off + val.shape[-1]].add(val)
        return buf

    # -- serialization (native format: zip of JSON topology + npz params) ---
    def save(self, path: str, params: Dict[str, Any],
             states: Optional[Dict[str, Any]] = None) -> None:
        topo = {
            "num_inputs": self.num_inputs,
            "output_ids": self._output_ids,
            "nodes": [
                {
                    "token": n.comp.token,
                    "input_dim": n.comp.input_dim,
                    "output_dim": n.comp.output_dim,
                    "attrs": n.comp.attrs,
                    "inputs": [[s, o] for (s, o) in n.inputs],
                }
                for n in self.nodes
            ],
        }
        flat, _ = jax.tree_util.tree_flatten_with_path(
            {"params": params, "states": states or {}}
        )
        arrays = {
            jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in flat
        }
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("topology.json", json.dumps(topo))
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            z.writestr("arrays.npz", buf.getvalue())

    @classmethod
    def load(cls, path: str):
        """Returns (nnet, params, states)."""
        with zipfile.ZipFile(path) as z:
            topo = json.loads(z.read("topology.json"))
            npz = np.load(io.BytesIO(z.read("arrays.npz")))
            arrays = {k: npz[k] for k in npz.files}
        net = cls(num_inputs=topo["num_inputs"],
                  output_ids=topo["output_ids"])
        for nd in topo["nodes"]:
            comp_cls = component_from_token(nd["token"])
            comp = comp_cls(nd["input_dim"], nd["output_dim"], **nd["attrs"])
            net.nodes.append(
                Node(comp, [tuple(e) for e in nd["inputs"]])
            )
        params: Dict[str, Any] = {str(i): {} for i in range(len(net.nodes))}
        states: Dict[str, Any] = {}
        for keystr, arr in arrays.items():
            keys = [k for k in keystr.replace("]", "").split("[") if k]
            keys = [k.strip("'\"") for k in keys]
            tgt = params if keys[0] == "params" else states
            d = tgt
            for k in keys[1:-1]:
                d = d.setdefault(k, {})
            d[keys[-1]] = jnp.asarray(arr)
        return net, params, states

    # -- diagnostics --------------------------------------------------------
    def info(self, params: Optional[Dict[str, Any]] = None) -> str:
        """Human-readable summary (reference: aslp-nnet-info)."""
        lines = [f"num-components {len(self.nodes)}",
                 f"input-dim {self.input_dim}",
                 f"output-dim {self.output_dim}"]
        total = 0
        for i, n in enumerate(self.nodes):
            extra = ""
            if params is not None and str(i) in params:
                cnt = sum(int(p.size) for p in
                          jax.tree_util.tree_leaves(params[str(i)]))
                total += cnt
                extra = f", {cnt} params"
            lines.append(
                f"component {i} : {n.comp.token} "
                f"{n.comp.input_dim}->{n.comp.output_dim}"
                f" inputs={n.inputs}{extra}"
            )
        if params is not None:
            lines.append(f"number-of-parameters {total}")
        return "\n".join(lines)

    def to_dot(self) -> str:
        """Graphviz dump (reference: WriteDotFile nnet-nnet.h:148)."""
        lines = ["digraph nnet {"]
        for k in range(self.num_inputs):
            lines.append(f'  "in:{k}" [shape=box];')
        for i, n in enumerate(self.nodes):
            label = n.comp.token.strip("<>")
            lines.append(f'  n{i} [label="{i}:{label}"];')
            for (s, off) in n.inputs:
                src = f'"{s}"' if isinstance(s, str) else f"n{s}"
                lines.append(f'  {src} -> n{i} [label="{off}"];')
        lines.append("}")
        return "\n".join(lines)
