"""Frames read through the video pipeline a second: every frame of the
window's whole passes of ``video.detect_video`` over the window, which
ends when the last pass has collected its results
(``readers.window_rate``)."""

from wmbench.readers import window_rate as read  # noqa: F401
