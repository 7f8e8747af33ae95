"""Frames embedded and then detected a second, a bulk cell's step
(``readers.window_rate``); read by ``step_fps.<tag>``, one metric a bulk
configuration, since each has a bound of its own."""

from wmbench.readers import window_rate as read  # noqa: F401
