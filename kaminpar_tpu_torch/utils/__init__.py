from . import sync_stats
from .assertions import assertion_level, kassert, kassert_heavy, set_assertion_level
from .logger import Logger, OutputLevel, log_result_line
from .rng import RandomState
from .timer import Timer, scoped_timer

__all__ = [
    "Logger",
    "OutputLevel",
    "RandomState",
    "Timer",
    "assertion_level",
    "kassert",
    "kassert_heavy",
    "log_result_line",
    "scoped_timer",
    "set_assertion_level",
    "sync_stats",
]
