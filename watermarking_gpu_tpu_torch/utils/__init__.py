"""Utilities: timing."""

from .timing import Timer, execution_time

__all__ = ["Timer", "execution_time"]
