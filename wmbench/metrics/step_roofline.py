"""A bulk step's share of its roofline, in % (``work/step.py`` over device
busy a step; ``readers.op_roofline``); read by ``step_roofline.<tag>``, one
metric a bulk configuration."""

from wmbench.readers import op_roofline as read  # noqa: F401
