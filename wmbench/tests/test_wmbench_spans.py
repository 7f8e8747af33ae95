"""The span readers: each gives its value from a synthetic store of the
program's spans, and None from an empty store or a program without one."""

from types import SimpleNamespace

import numpy as np
import pytest

from watermarking_gpu_tpu_torch.utils import profiling
from wmbench import harness

BENCH = harness.BENCH_DIR
MS = 1_000_000


def span(name, start, end, id, parent=None, **ids):
    return profiling.Span(name, start * MS, end * MS, 1, id, parent, **ids)


SERVE = [
    span("serving.gather", 1, 3, 10, batch=0, requests=(0, 1)),
    span("serving.stage", 3, 7, 11, batch=0),
    span("serving.gather", 7, 8, 12, batch=1, requests=(2, 3)),
    span("serving.stage", 8, 10, 13, batch=1),
    span("serving.request", 0, 12, 1, request=0),
    span("serving.request", 2, 12, 2, request=1),
    span("serving.request", 4, 14, 3, request=2),
    span("serving.request", 7, 14, 4, request=3),
]

# two steps: a pipeline span with kernel children, another nested in its
# engine span, and a kernel span inside a kernel span (counted once)
BULK = [
    span("engine.embed", 0, 10, 1),
    span("pipeline.embed", 1, 9, 2, parent=1),
    span("kernels.me_gram_solve8", 2, 4, 3, parent=2),
    span("kernels.embed_field", 5, 8, 4, parent=2),
    span("engine.detect", 10, 20, 5),
    span("pipeline.detect", 11, 19, 6, parent=5),
    span("kernels.nvf_mask", 12, 16, 7, parent=6),
    span("kernels.nvf_mask", 13, 15, 8, parent=7),
]


def read(name, spans, monkeypatch, steps=2):
    monkeypatch.setattr(profiling, "spans",
                        lambda: profiling.Spans(spans, 0))
    ctx = SimpleNamespace(spans={"window": (1.0, steps)})
    return harness.reader(BENCH, name)(ctx)


def test_serving_readers(monkeypatch):
    waits = [3 - 0, 3 - 2, 8 - 4, 8 - 7]
    assert read("serving.wait_p95_ms", SERVE, monkeypatch) == pytest.approx(
        np.percentile(waits, 95))
    assert read("serving.stage_ms", SERVE, monkeypatch) == pytest.approx(3.0)


def test_bulk_readers(monkeypatch):
    # pipeline: (8 + 8) ms less kernels (2 + 3 + 4) over 2 steps
    assert read("pipeline.host_ms.1080p", BULK, monkeypatch) == \
        pytest.approx((16 - 9) / 2)
    assert read("kernels.host_ms.1080p", BULK, monkeypatch) == \
        pytest.approx(9 / 2)


@pytest.mark.parametrize("name", ["serving.wait_p95_ms", "serving.stage_ms",
                                  "pipeline.host_ms.1080p",
                                  "kernels.host_ms.1080p"])
def test_nothing_to_read(name, monkeypatch):
    assert read(name, [], monkeypatch) is None
    assert read(name, BULK if name.startswith("serving") else SERVE,
                monkeypatch) is None
    monkeypatch.delattr(profiling, "spans")     # a program without them
    ctx = SimpleNamespace(spans={"window": (1.0, 2)})
    assert harness.reader(BENCH, name)(ctx) is None
