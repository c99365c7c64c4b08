"""Config / flag system.

JAX-native replacement for Kaldi's ParseOptions (reference:
src/util/parse-options.h): options dataclasses self-register flags,
``--config=FILE`` loads ``--name=value`` lines from a file, booleans accept
true/false, and every CLI prints a usage string.  Unlike the reference
there is a single typed registry instead of raw pointers.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type, get_type_hints


class ConfigError(ValueError):
    pass


def _parse_value(raw: str, typ: type) -> Any:
    if typ is bool:
        low = raw.strip().lower()
        if low in ("true", "t", "1"):
            return True
        if low in ("false", "f", "0"):
            return False
        raise ConfigError(f"cannot parse {raw!r} as bool")
    if typ is int:
        return int(raw)
    if typ is float:
        return float(raw)
    return raw


@dataclasses.dataclass
class Config:
    """Base class for options structs.

    Subclass with dataclass fields; field names use underscores, flags use
    dashes (``batch_size`` ↔ ``--batch-size``), mirroring the reference's
    RegisterStandard naming normalization (src/util/parse-options.cc).
    """

    @classmethod
    def field_types(cls) -> Dict[str, type]:
        hints = get_type_hints(cls)
        return {f.name: hints[f.name] for f in dataclasses.fields(cls)}

    def set_flag(self, name: str, raw: str) -> None:
        key = name.replace("-", "_")
        types = self.field_types()
        if key not in types:
            raise ConfigError(f"unknown option --{name}")
        setattr(self, key, _parse_value(raw, types[key]))

    def flag_names(self) -> List[str]:
        return [f.name.replace("_", "-") for f in dataclasses.fields(self)]

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _read_config_file(path: str) -> List[str]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            out.append(line)
    return out


def parse_options(
    argv: Sequence[str],
    configs: Sequence[Config],
    usage: str = "",
    min_args: int = 0,
    max_args: Optional[int] = None,
) -> List[str]:
    """Parse ``--name=value`` flags into the given configs; return positional args.

    Mirrors ParseOptions::Read semantics (reference: src/util/parse-options.h):
    flags must precede positional args, ``--`` terminates flags, ``--config=F``
    reads more flags from F, ``--help`` prints usage.
    """
    args: List[str] = []
    i = 0
    argv = list(argv)
    while i < len(argv):
        tok = argv[i]
        i += 1
        if tok == "--":
            args.extend(argv[i:])
            break
        if tok.startswith("--"):
            body = tok[2:]
            if "=" in body:
                name, raw = body.split("=", 1)
            else:
                name, raw = body, "true"
            if name == "help":
                print(usage, file=sys.stderr)
                _print_flags(configs)
                raise SystemExit(0)
            if name == "config":
                for line in _read_config_file(raw):
                    parse_options([line], configs)
                continue
            if name == "verbose":
                from kaldi_aslp_tpu.utils.log import set_verbose_level

                set_verbose_level(int(raw))
                continue
            _set_in_any(configs, name, raw)
        else:
            args.append(tok)
            args.extend(argv[i:])
            break
    if len(args) < min_args or (max_args is not None and len(args) > max_args):
        print(usage, file=sys.stderr)
        raise ConfigError(
            f"expected between {min_args} and {max_args or 'inf'} positional "
            f"args, got {len(args)}"
        )
    return args


def _set_in_any(configs: Sequence[Config], name: str, raw: str) -> None:
    key = name.replace("-", "_")
    for cfg in configs:
        if key in cfg.field_types():
            cfg.set_flag(name, raw)
            return
    raise ConfigError(f"unknown option --{name}")


def _print_flags(configs: Sequence[Config]) -> None:
    for cfg in configs:
        for f in dataclasses.fields(cfg):
            print(
                f"  --{f.name.replace('_', '-')} : "
                f"{cfg.field_types()[f.name].__name__} "
                f"(default {getattr(cfg, f.name)!r})",
                file=sys.stderr,
            )
