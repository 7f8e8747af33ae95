"""Utilities: timing, profiling, debug display."""

from .display import display_array
from .profiling import annotate, trace
from .timing import Timer, execution_time

__all__ = ["Timer", "annotate", "display_array", "execution_time", "trace"]
