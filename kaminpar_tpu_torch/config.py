"""TOML round-trip for the :class:`Context` config tree (counterpart of
``kaminpar_tpu/config.py``).

Reference: the CLI's ``--dump-config``/``-C`` TOML interface
(``kaminpar-cli/CLI11.h`` config machinery used by ``apps/KaMinPar.cc``);
the reference dumps its ~200 CLI11 options as TOML and can reload them.
Here the config surface *is* the ``Context`` dataclass tree, so dump/load
walk it generically: sections per nested dataclass, enums as their string
values, derived arrays (block-weight budgets) skipped.
"""

from __future__ import annotations

import dataclasses
import enum

import tomllib

from .context import Context, RefinementAlgorithm

# Fields computed by PartitionContext.setup() at partition time — not part
# of the durable config surface.
_DERIVED = {"max_block_weights", "min_block_weights", "total_node_weight"}


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, enum.Enum):
        return f'"{v.value}"'
    if isinstance(v, str):
        return f'"{v}"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    return repr(v)


def dump_toml(ctx: Context) -> str:
    """Serialize a Context to a TOML string (reference: ``--dump-config``)."""
    lines: list = []

    def emit(obj, prefix: str):
        scalars = []
        subsections = []
        for f in dataclasses.fields(obj):
            if f.name in _DERIVED:
                continue
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                subsections.append((f.name, v))
            elif v is None:
                continue
            else:
                scalars.append((f.name, v))
        if prefix and scalars:
            lines.append(f"[{prefix}]")
        for name, v in scalars:
            lines.append(f"{name} = {_toml_value(v)}")
        if scalars:
            lines.append("")
        for name, v in subsections:
            emit(v, f"{prefix}.{name}" if prefix else name)

    emit(ctx, "")
    return "\n".join(lines)


def _apply(obj, d: dict, path: str) -> None:
    for key, val in d.items():
        if not hasattr(obj, key):
            raise ValueError(f"unknown config key '{path}{key}'")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur):
            if not isinstance(val, dict):
                raise ValueError(f"'{path}{key}' must be a table")
            _apply(cur, val, f"{path}{key}.")
        elif isinstance(cur, enum.Enum):
            setattr(obj, key, type(cur)(val))
        elif key == "algorithms":
            setattr(obj, key, tuple(RefinementAlgorithm(v) for v in val))
        elif isinstance(cur, tuple):
            setattr(obj, key, tuple(val))
        else:
            setattr(obj, key, type(cur)(val) if cur is not None else val)


def load_toml(text: str, base: Context | None = None) -> Context:
    """Parse a TOML config over a base context (default preset if None)."""
    from .presets import create_context_by_preset_name

    d = tomllib.loads(text)
    preset = d.pop("preset_name", None)
    if base is None:
        base = create_context_by_preset_name(preset or "default")
    elif preset:
        base.preset_name = preset
    _apply(base, d, "")
    return base


def load_toml_file(path: str, base: Context | None = None) -> Context:
    with open(path, "r") as fh:
        return load_toml(fh.read(), base)
