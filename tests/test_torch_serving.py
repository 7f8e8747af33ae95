"""The port's serving layer on the CPU (``device="cpu"``): the single-device
cases of tests/test_serving.py — batching, partial batches, parity with
direct engine calls, backpressure, errors, stats and a wedged device."""

import os
import queue
import sys
import threading
import time

import numpy as np
import pytest
import torch

from watermarking_gpu_tpu_torch import (DetectorService, EmbedderService,
                                        IdentifierService)
from watermarking_gpu_tpu_torch.models import BatchedWatermark, MaskType

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engine():
    rng = np.random.default_rng(4864)
    wm = rng.normal(size=(48, 64)).astype(np.float32)
    return BatchedWatermark(48, 64, wm, p=3, psnr=35.0, device="cpu")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(114864)
    return np.clip(rng.normal(128, 40, (11, 48, 64)), 0,
                   255).astype(np.float32)


class StalledEngine:
    """An engine whose detect waits for ``release`` (a device that stalls,
    or never answers)."""

    def __init__(self, engine, release):
        self.rows, self.cols = engine.rows, engine.cols
        self.device = engine.device
        self.release = release

    def detect(self, stack, mask_type):
        self.release.wait(timeout=60)
        return torch.zeros(stack.shape[0])


def test_detector_service_matches_direct(engine, frames):
    direct = engine.detect(frames[:8], MaskType.ME).numpy()
    service = DetectorService(engine, batch_size=4)
    try:
        futures = [service.submit(f) for f in frames]
        got = [f.result(timeout=60) for f in futures]
    finally:
        service.close()
    np.testing.assert_allclose(got[:8], direct, atol=1e-5)
    assert len(got) == 11  # partial final batch resolved too
    assert all(isinstance(c, float) for c in got)


def test_embedder_service_roundtrip(engine, frames):
    embedder = EmbedderService(engine, batch_size=4)
    detector = DetectorService(engine, batch_size=4)
    try:
        marked = [f.result(timeout=60)[0]
                  for f in [embedder.submit(x) for x in frames[:5]]]
        strengths = [embedder.submit(x).result(timeout=60)[1]
                     for x in frames[:2]]
        corrs = [detector.submit(m).result(timeout=60) for m in marked]
    finally:
        embedder.close()
        detector.close()
    direct, _ = engine.embed(frames[:4])
    np.testing.assert_allclose(np.stack(marked[:4]), direct.numpy(),
                               atol=1e-5)
    assert isinstance(marked[0], np.ndarray)
    assert all(s > 0 for s in strengths)
    # small noisy frames at PSNR 35 correlate ~0.2 marked vs ~0.0 clean
    clean = float(engine.detect(frames[:1], MaskType.ME)[0])
    assert clean < 0.1
    assert all(c > 0.12 for c in corrs)


def test_service_close_rejects(engine, frames):
    service = DetectorService(engine, batch_size=2)
    service.submit(frames[0]).result(timeout=60)
    service.close()
    with pytest.raises(RuntimeError):
        service.submit(frames[0])


def test_concurrent_submitters(engine, frames):
    """submit() is safe from multiple threads."""
    service = DetectorService(engine, batch_size=4)
    results = {}

    def worker(tid):
        futs = [(i, service.submit(frames[i % len(frames)]))
                for i in range(tid, 20, 4)]
        for i, f in futs:
            results[(tid, i)] = f.result(timeout=60)

    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        service.close()
    assert len(results) == 20
    assert all(np.isfinite(v) for v in results.values())


def test_many_submitters_keep_the_ledger(engine, frames):
    """Twice as many submitting threads as cores, the interpreter switching
    threads every microsecond: every future resolves to its own frame's
    correlation and the counters balance, which a lost update under the
    service's locks would break."""
    direct = engine.detect(frames, MaskType.ME).numpy()
    n_threads, per_thread = 2 * (os.cpu_count() or 4), 3
    service = DetectorService(engine, batch_size=4, flush_timeout=0.001)
    results = {}

    def worker(tid):
        futures = [(i, service.submit(frames[i]))
                   for i in ((tid + j) % len(frames)
                             for j in range(per_thread))]
        results[tid] = [(i, f.result(timeout=120)) for i, f in futures]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        stats = service.stats()
    finally:
        sys.setswitchinterval(interval)
        service.close()
    assert len(results) == n_threads
    for pairs in results.values():
        for i, corr in pairs:
            assert corr == pytest.approx(float(direct[i]), abs=1e-5)
    assert stats["submitted"] == stats["completed"] == n_threads * per_thread
    assert stats["failed"] == 0 and stats["queued"] == 0


def test_serving_u8_ingest_and_warmup(engine, frames):
    """uint8 submissions (video lumas) ride the narrow transfer path and
    match f32 results; warmup() runs both ingest dtypes; close() is
    idempotent and a repeated close blocks until the workers are gone."""
    u8 = frames.astype(np.uint8)
    direct = engine.detect(u8[:4].astype(np.float32), MaskType.ME).numpy()
    service = DetectorService(engine, batch_size=4)
    try:
        service.warmup()
        futures = [service.submit(f) for f in u8[:4]]
        got = [f.result(timeout=60) for f in futures]
        assert np.isfinite(service.submit(frames[0]).result(timeout=60))
        assert service.stats()["submitted"] == 5   # warmup is not traffic
    finally:
        service.close()
        service.close()   # second close: blocks until joined, no error
    assert not service._dispatcher.is_alive()
    np.testing.assert_allclose(got, direct, atol=1e-5)


def test_dispatch_error_propagates(engine):
    """A bad submission (wrong shape) must fail its future, not hang it."""
    service = DetectorService(engine, batch_size=2, flush_timeout=0.01)
    try:
        bad = service.submit(np.zeros((7, 9), dtype=np.float32))
        with pytest.raises(ValueError):
            bad.result(timeout=60)
    finally:
        service.close()


def test_submission_backpressure(engine):
    """A producer faster than the device blocks on the bounded queue
    instead of buffering frames without limit; with a timeout, submit
    fails fast with queue.Full."""
    release = threading.Event()
    frame = np.zeros((engine.rows, engine.cols), np.float32)
    service = DetectorService(StalledEngine(engine, release), batch_size=1,
                              max_inflight=1, flush_timeout=0.001,
                              max_queued=2)
    try:
        futures = [service.submit(frame)]      # dispatched, engine stalls
        time.sleep(0.05)                       # let the dispatcher pick it
        futures += [service.submit(frame) for _ in range(2)]  # fills queue
        assert service.stats()["queued"] == 2
        with pytest.raises(queue.Full):
            service.submit(frame, timeout=0.05)
        # a blocking submit parks until the device frees a slot
        unblocked = []
        thread = threading.Thread(
            target=lambda: unblocked.append(service.submit(frame)))
        thread.start()
        time.sleep(0.05)
        assert thread.is_alive()               # blocked: queue still full
        release.set()                          # device drains
        thread.join(timeout=30)
        assert not thread.is_alive()
        futures += unblocked
        assert all(np.isfinite(f.result(timeout=30)) for f in futures)
    finally:
        release.set()
        service.close()


def test_identifier_service_matches_direct(engine, frames):
    """submit(frame) -> (N,) correlations against a fixed candidate bank,
    matching engine.detect_many; the embedded candidate wins argmax."""
    rng = np.random.default_rng(77)
    bank = np.stack(
        [engine.random_matrix.numpy()]
        + [rng.normal(size=(engine.rows, engine.cols)).astype(np.float32)
           for _ in range(5)])
    marked, _ = engine.embed(frames[:3], mask_type=MaskType.ME)
    marked = marked.numpy()
    direct = engine.detect_many(marked, bank, MaskType.ME).numpy()
    service = IdentifierService(engine, bank, batch_size=2,
                                flush_timeout=0.01)
    try:
        futures = [service.submit(f) for f in marked]
        got = np.stack([f.result(timeout=60) for f in futures])
    finally:
        service.close()
    assert got.shape == (3, 6)
    np.testing.assert_allclose(got, direct, atol=1e-5)
    assert (np.argmax(got, axis=1) == 0).all()   # the embedded candidate

    with pytest.raises(ValueError, match="Candidate bank"):
        IdentifierService(engine, bank[:, :-1])


def test_identifier_bank_lives_on_the_engine_device(engine):
    """The bank is uploaded once, at construction, to the engine's device;
    a bank that is already an f32 tensor there is kept without a copy, and
    every dispatch passes that same tensor to detect_many."""
    rng = np.random.default_rng(78)
    bank = rng.normal(size=(3, engine.rows, engine.cols)).astype(np.float32)
    service = IdentifierService(engine, bank, batch_size=2)
    resident = torch.from_numpy(bank)
    kept = IdentifierService(engine, resident, batch_size=2)
    try:
        assert isinstance(service._bank, torch.Tensor)
        assert service._bank.device == engine.device
        assert service._bank.dtype == torch.float32
        np.testing.assert_array_equal(service._bank.numpy(), bank)
        assert kept._bank.data_ptr() == resident.data_ptr()
        seen = []
        original = engine.detect_many
        engine.detect_many = lambda stack, candidates, mask: (
            seen.append(candidates) or original(stack, candidates, mask))
        try:
            kept.submit(np.zeros((engine.rows, engine.cols),
                                 np.float32)).result(timeout=60)
        finally:
            del engine.detect_many
        assert seen and seen[0] is kept._bank
    finally:
        service.close()
        kept.close()


def test_close_completes_with_wedged_device(engine):
    """A device that never answers must not turn close() into a deadlock:
    with the submission queue FULL behind a stuck batch, a timed close()
    returns, every outstanding future resolves (exceptionally), and late
    producers get the closed error — no caller hangs forever."""
    release = threading.Event()
    frame = np.zeros((engine.rows, engine.cols), np.float32)
    service = DetectorService(StalledEngine(engine, release), batch_size=1,
                              max_inflight=1, flush_timeout=0.001,
                              max_queued=2)
    try:
        futures = [service.submit(frame)]      # dispatched, engine wedges
        time.sleep(0.05)
        futures += [service.submit(frame) for _ in range(2)]  # queue full
        # a producer parked at the full queue must unblock on close()
        blocked_err = []

        def producer():
            try:
                service.submit(frame)
            except Exception as exc:
                blocked_err.append(exc)

        thread = threading.Thread(target=producer)
        thread.start()
        time.sleep(0.05)
        assert thread.is_alive()               # parked: queue still full

        closed = []
        closer = threading.Thread(
            target=lambda: closed.append(service.close(timeout=1.0)))
        closer.start()
        closer.join(timeout=30)
        assert not closer.is_alive()           # close() returned
        assert closed == [False]               # ... reporting a dirty stop
        thread.join(timeout=30)
        assert not thread.is_alive()
        assert len(blocked_err) == 1 and isinstance(blocked_err[0],
                                                    RuntimeError)
        for f in futures:                      # all resolve, exceptionally
            with pytest.raises(RuntimeError, match="unresponsive"):
                f.result(timeout=30)
        assert service.stats()["failed"] >= 3
        with pytest.raises(RuntimeError):      # closed to new traffic
            service.submit(frame)
    finally:
        release.set()                          # let the worker threads exit
        service._dispatcher.join(timeout=90)
        service._collector.join(timeout=90)
        assert not service._dispatcher.is_alive()
        assert not service._collector.is_alive()
    # late answers to force-failed futures are dropped and not counted:
    # after a dirty close the ledger still balances
    s = service.stats()
    assert s["completed"] == 0
    assert s["completed"] + s["failed"] == s["submitted"] == 3


def test_service_stats(engine, frames):
    """Lifetime counters and queue depths: 11 frames through batch_size=4
    -> >= 3 dispatches, all completed, none failed, fill <= 1."""
    service = DetectorService(engine, batch_size=4)
    try:
        assert service.stats()["submitted"] == 0
        futures = [service.submit(f) for f in frames]
        [f.result(timeout=60) for f in futures]
        stats = service.stats()
    finally:
        service.close()
    assert stats["submitted"] == 11
    assert stats["completed"] == 11
    assert stats["failed"] == 0
    assert stats["batches"] >= 3
    assert 0 < stats["mean_batch_fill"] <= 1.0
    assert stats["queued"] == 0
    assert 0 < stats["mean_batch_latency_s"] <= stats["max_batch_latency_s"]


def test_service_stats_counts_failures(engine):
    """A shape error fails the whole batch and shows up in the counters."""
    service = DetectorService(engine, batch_size=2, flush_timeout=0.05)
    try:
        bad = [service.submit(np.zeros((7, 9), np.float32))
               for _ in range(2)]
        for f in bad:
            with pytest.raises(ValueError):
                f.result(timeout=60)
        stats = service.stats()
    finally:
        service.close()
    assert stats["failed"] == 2
    assert stats["completed"] == 0
