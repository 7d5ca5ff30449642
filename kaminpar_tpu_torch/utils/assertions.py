"""Leveled runtime assertions, the KASSERT ladder (counterpart of
``kaminpar_tpu/utils/assertions.py``).

Levels ``always < light < normal < heavy``; the active level comes from
the ``KAMINPAR_TPU_ASSERT`` environment variable or
:func:`set_assertion_level` ("none", "always", "light", "normal",
"heavy"; default "always").  A check above the active level costs one
integer compare.
"""

from __future__ import annotations

import os

ALWAYS, LIGHT, NORMAL, HEAVY = 1, 2, 3, 4
_NAMES = {"none": 0, "always": ALWAYS, "light": LIGHT, "normal": NORMAL, "heavy": HEAVY}

_level = _NAMES.get(os.environ.get("KAMINPAR_TPU_ASSERT", "always"), ALWAYS)


def set_assertion_level(name: str) -> None:
    if name not in _NAMES:
        raise ValueError(f"unknown assertion level {name!r}; one of {list(_NAMES)}")
    global _level
    _level = _NAMES[name]


def assertion_level() -> int:
    return _level


def kassert(cond, msg: str = "", level: int = ALWAYS) -> None:
    """Raise AssertionError when the check is active (``level`` at or below
    the active level) and ``cond`` is falsy; ``cond`` may be a callable,
    evaluated only when the check is active."""
    if level > _level:
        return
    if callable(cond):
        cond = cond()
    if not cond:
        raise AssertionError(msg or "KASSERT failed")


def kassert_heavy(cond, msg: str = "") -> None:
    kassert(cond, msg, HEAVY)
