"""An identification call's share of its roofline, in %
(``work/identify.py`` over device busy a call; ``readers.op_roofline``)."""

from wmbench.readers import op_roofline as read  # noqa: F401
