"""Frames identified against the whole bank a second
(``readers.window_rate``)."""

from wmbench.readers import window_rate as read  # noqa: F401
