from .logger import Logger, OutputLevel, log_result_line
from .rng import RandomState

__all__ = ["Logger", "OutputLevel", "RandomState", "log_result_line"]
