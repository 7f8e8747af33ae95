"""95th percentile, over the window's resolved requests, of the ms from
when ``submit`` accepted a request to when its batch's staging began: the
submission queue and the gathering of the batch (``serving.request``,
``serving.gather`` and ``serving.stage`` spans of ``serving.py``, joined
by their request and batch ids)."""

import numpy as np

from wmbench.spans import program_spans


def read(ctx):
    spans = program_spans("serving.request")
    if spans is None:
        return None
    batch_of, staged = {}, {}
    for span in spans:
        if span.name == "serving.gather":
            batch_of.update(dict.fromkeys(span.requests, span.batch))
        elif span.name == "serving.stage":
            staged[span.batch] = span.start_ns
    waits = [staged[batch_of[span.request]] - span.start_ns
             for span in spans if span.name == "serving.request"
             and batch_of.get(span.request) in staged]
    if not waits:
        return None
    return float(np.percentile(waits, 95)) / 1e6
