"""Logger with a verbosity ladder and the parseable ``RESULT`` line.

Counterpart of ``kaminpar_tpu/utils/logger.py`` (plain-text mode only);
the ``RESULT`` line is byte-compatible with it.
"""

from __future__ import annotations

import enum
import sys


class OutputLevel(enum.IntEnum):
    QUIET = 0
    PROGRESS = 1
    APPLICATION = 2
    EXPERIMENT = 3
    DEBUG = 4


class Logger:
    level: OutputLevel = OutputLevel.APPLICATION

    @classmethod
    def log(cls, msg: str, level: OutputLevel = OutputLevel.APPLICATION) -> None:
        if cls.level >= level:
            print(msg, file=sys.stdout, flush=True)

    @classmethod
    def warning(cls, msg: str) -> None:
        if cls.level > OutputLevel.QUIET:
            print(f"[Warning] {msg}", file=sys.stderr, flush=True)


def log_result_line(cut: int, imbalance: float, feasible: bool, k: int,
                    seconds: float) -> str:
    """``RESULT cut=... imbalance=... feasible=... k=... time=...``."""
    line = (
        f"RESULT cut={int(cut)} imbalance={imbalance} feasible={int(feasible)} "
        f"k={int(k)} time={seconds}"
    )
    Logger.log(line, OutputLevel.EXPERIMENT)
    return line
