"""Host ms to enqueue one bulk step (``readers.enqueue_ms``); read by
``engine.enqueue_ms.<tag>``, one metric a bulk configuration."""

from wmbench.readers import enqueue_ms as read  # noqa: F401
