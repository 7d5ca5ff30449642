"""Minimal Prometheus text-exposition renderer + validator.

The serve engine's :meth:`PartitionEngine.metrics_text` renders its stats
snapshot through :func:`render`; the serve CLI's optional ``--metrics-port``
endpoint serves that text at ``/metrics``.  No client library dependency —
the text exposition format (version 0.0.4) is a few lines of escaping rules,
and the container must not grow a new package for it.

A *family* is ``(name, type, help, samples)`` with ``samples`` a list of
``(labels_dict, value)``; ``None`` values are skipped (absent gauge).
:func:`validate` is the inverse used by the tier-1 smoke tests and ``tools``
checks: it parses an exposition back into ``{name: [(labels, value)]}`` and
raises on any line that is neither a valid comment nor a valid sample.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r" (?P<value>-?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|Inf|NaN)|[+-]Inf)$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _escape_label(value: str) -> str:
    return (
        str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(value) -> str:
    if isinstance(value, bool):
        return str(int(value))
    if isinstance(value, int):
        return str(value)
    value = float(value)
    # The exposition format spells non-finite values NaN/+Inf/-Inf; Python's
    # lowercase repr would fail scrapers (and this module's own validate()).
    if value != value:
        return "NaN"
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    return repr(value)


def render(families: List[Tuple[str, str, str, list]]) -> str:
    """Render ``[(name, type, help, [(labels, value), ...]), ...]`` as
    Prometheus text exposition (trailing newline included)."""
    lines: List[str] = []
    for name, kind, help_text, samples in families:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        if kind not in ("counter", "gauge", "histogram", "summary", "untyped"):
            raise ValueError(f"invalid metric type {kind!r} for {name}")
        emitted_header = False
        for labels, value in samples:
            if value is None:
                continue
            if not emitted_header:
                lines.append(f"# HELP {name} {_escape_help(help_text)}")
                lines.append(f"# TYPE {name} {kind}")
                emitted_header = True
            if labels:
                label_str = ",".join(
                    f'{k}="{_escape_label(v)}"' for k, v in labels.items()
                )
                lines.append(f"{name}{{{label_str}}} {_format_value(value)}")
            else:
                lines.append(f"{name} {_format_value(value)}")
    return "\n".join(lines) + "\n" if lines else ""


def validate(text: str) -> Dict[str, List[Tuple[dict, float]]]:
    """Parse a text exposition; raises ValueError on malformed lines.
    Returns ``{metric_name: [(labels, value), ...]}``."""
    out: Dict[str, List[Tuple[dict, float]]] = {}
    typed: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                raise ValueError(f"line {lineno}: malformed comment {line!r}")
            if parts[1] == "TYPE":
                typed[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        labels: dict = {}
        raw = m.group("labels")
        if raw:
            consumed = 0
            for lm in _LABEL_RE.finditer(raw):
                labels[lm.group(1)] = lm.group(2)
                consumed = lm.end()
            leftover = raw[consumed:].strip().strip(",")
            if leftover:
                raise ValueError(
                    f"line {lineno}: malformed labels {raw!r} ({leftover!r})"
                )
        out.setdefault(m.group("name"), []).append(
            (labels, float(m.group("value")))
        )
    for name in out:
        if name not in typed:
            raise ValueError(f"metric {name} has samples but no # TYPE line")
    return out


def get_sample(
    families: Dict[str, List[Tuple[dict, float]]],
    name: str,
    **labels,
) -> Optional[float]:
    """Convenience lookup over :func:`validate` output."""
    for sample_labels, value in families.get(name, ()):
        if all(sample_labels.get(k) == v for k, v in labels.items()):
            return value
    return None
