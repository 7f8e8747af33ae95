"""Device kernels a bulk step (``readers.kernels_per_call``); read by
``pipeline.kernels.<tag>``, one metric a bulk configuration."""

from wmbench.readers import kernels_per_call as read  # noqa: F401
