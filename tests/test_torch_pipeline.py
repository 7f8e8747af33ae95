"""The slice as a whole: the port's pipelines and engines against the JAX
package's, with the same numpy frames and watermark fed to both.

``impl="torch"`` is held to the JAX ``impl="xla"`` oracle and ``impl="cuda"``
(on the CPU: the kernels' plain versions in the fused algebra) to the JAX
``impl="pallas"`` kernels in interpret mode. Tolerances are the JAX suite's
(tests/test_pallas.py): correlations abs 2e-4 (3e-4 at the raw-mode
geometry), strengths rel 2e-4, pixels atol 0.1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from watermarking_gpu_tpu.models import BatchedWatermark as JaxBatched
from watermarking_gpu_tpu.models import Watermark as JaxWatermark
from watermarking_gpu_tpu.ops import pipelines as jp
from watermarking_gpu_tpu_torch.models import (BatchedWatermark, Watermark,
                                               pad_to_batch)
from watermarking_gpu_tpu_torch.ops import pipelines as tp
from watermarking_gpu_tpu_torch.utils import Timer, execution_time

torch.set_num_threads(1)

SF = 2.55  # strength_factor(40)
JAX_IMPL = {"torch": "xla", "cuda": "pallas"}


def make_case(shape, seed=40961):
    rng = np.random.default_rng(seed)
    frames = np.clip(rng.normal(128, 40, shape), 0, 255).astype(np.float32)
    return frames, rng.normal(size=shape[-2:]).astype(np.float32)


def round_trip_torch(frames, wm, mask_type, impl, output=None):
    f, w = torch.from_numpy(frames), torch.from_numpy(wm)
    out = f if output is None else torch.from_numpy(output)
    marked, strength = tp.embed_pipeline(f, out, w, SF, mask_type, impl=impl)
    gray = marked if output is None else f
    corr = tp.detect_pipeline(gray, w, mask_type, impl=impl)
    return marked.numpy(), strength.numpy(), corr.numpy()


def round_trip_jax(frames, wm, mask_type, impl, output=None):
    f, w = jnp.asarray(frames), jnp.asarray(wm)
    out = f if output is None else jnp.asarray(output)
    marked, strength = jp.embed_pipeline(f, out, w, SF, mask_type, impl=impl)
    gray = marked if output is None else f
    corr = jp.detect_pipeline(gray, w, mask_type, impl=impl)
    return tuple(np.asarray(a) for a in (marked, strength, corr))


def assert_round_trips_match(got, want, corr_atol=2e-4):
    np.testing.assert_allclose(got[0], want[0], atol=0.1)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-4)
    np.testing.assert_allclose(got[2], want[2], atol=corr_atol)


# (40, 96) reaches the JAX Pallas kernels in tests/test_torch_kernels.py
# already; interpret-mode compiles are the suite's cost here
@pytest.mark.parametrize("mask_type", ["me", "nvf"])
@pytest.mark.parametrize("shape,impl", [
    ((40, 96), "torch"), ((37, 83), "torch"), ((3, 40, 96), "torch"),
    ((37, 83), "cuda"), ((3, 40, 96), "cuda")])
def test_pipelines_match_jax(shape, impl, mask_type):
    frames, wm = make_case(shape)
    got = round_trip_torch(frames, wm, mask_type, impl)
    want = round_trip_jax(frames, wm, mask_type, JAX_IMPL[impl])
    assert got[0].shape == shape and got[2].shape == shape[:-2]
    assert_round_trips_match(got, want)
    assert (got[2] > 0.02).all()   # marked frames correlate (clean: ~0)


@pytest.mark.parametrize("mask_type", ["me", "nvf"])
def test_raw_mode_geometry_matches_pallas(mask_type):
    """(1048, 512) is a geometry the JAX kernels run in raw mode with a
    masked bottom strip; the port has no such modes and must agree."""
    frames, wm = make_case((1048, 512), seed=3)
    got = round_trip_torch(frames, wm, mask_type, "cuda")
    want = round_trip_jax(frames, wm, mask_type, "pallas")
    assert_round_trips_match(got, want, corr_atol=3e-4)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_rgb_output_matches_jax(impl):
    frames, wm = make_case((37, 83))
    rgb = np.stack([frames, frames * 0.5, 255 - frames], axis=-1)
    got = round_trip_torch(frames, wm, "me", impl, output=rgb)
    want = round_trip_jax(frames, wm, "me", JAX_IMPL[impl], output=rgb)
    assert got[0].shape == (37, 83, 3)
    assert_round_trips_match(got, want)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_singular_frame_soft_fails(impl):
    """A constant frame in a batch: only that frame soft-fails (embed
    passthrough, strength 0, correlation 0), as in the JAX package."""
    good, wm = make_case((40, 96))
    flat = np.full((40, 96), 77.0, dtype=np.float32)
    frames = np.stack([good, flat, np.clip(good + 1.0, 0, 255)])
    marked, strength, _ = round_trip_torch(frames, wm, "me", impl)
    corr = tp.detect_pipeline(torch.from_numpy(frames), torch.from_numpy(wm),
                              "me", impl=impl).numpy()
    want_corr = np.asarray(jp.detect_pipeline(
        jnp.asarray(frames), jnp.asarray(wm), "me", impl="xla"))
    assert strength[1] == 0.0 and (strength[[0, 2]] > 0).all()
    np.testing.assert_array_equal(marked[1], flat)
    assert corr[1] == 0.0 == want_corr[1]
    np.testing.assert_allclose(corr, want_corr, atol=2e-4)


def jax_engine_state(engine):
    return {"rows": engine.rows, "cols": engine.cols, "p": engine.p,
            "psnr": engine.psnr,
            "random_matrix": np.asarray(engine.random_matrix)}


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_watermark_from_state_matches_jax(impl):
    frame, _ = make_case((40, 96), seed=5)
    ref = JaxWatermark(40, 96, 7, p=3, psnr=40.0, impl=JAX_IMPL[impl])
    port = Watermark.from_state(jax_engine_state(ref), device="cpu",
                                impl=impl)
    np.testing.assert_array_equal(port.random_matrix.numpy(),
                                  np.asarray(ref.random_matrix))
    for mask_type in ("me", "nvf"):
        marked, strength = port.embed(frame, mask_type=mask_type)
        corr = port.detect(marked, mask_type)
        marked_j, strength_j = ref.embed(frame, mask_type=mask_type)
        corr_j = ref.detect(marked_j, mask_type)
        assert marked.device.type == "cpu" and marked.shape == (40, 96)
        assert_round_trips_match(
            (marked.numpy(), strength.numpy(), corr.numpy()),
            tuple(np.asarray(a) for a in (marked_j, strength_j, corr_j)))


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_batched_watermark_from_state_matches_jax(impl):
    frames, _ = make_case((3, 40, 96), seed=9)
    ref = JaxBatched(40, 96, 11, p=3, psnr=40.0, impl=JAX_IMPL[impl])
    port = BatchedWatermark.from_state(jax_engine_state(ref), device="cpu",
                                       impl=impl)
    for mask_type in ("me", "nvf"):
        marked, strength = port.embed(frames, mask_type=mask_type)
        corr = port.detect(marked, mask_type)
        marked_j, strength_j = ref.embed(frames, mask_type=mask_type)
        corr_j = ref.detect(marked_j, mask_type)
        assert_round_trips_match(
            (marked.numpy(), strength.numpy(), corr.numpy()),
            tuple(np.asarray(a) for a in (marked_j, strength_j, corr_j)))
    lumas = frames.astype(np.uint8)
    out, strength = port.embed_luma_u8(lumas)
    out_j, strength_j = ref.embed_luma_u8(lumas)
    assert out.dtype == torch.uint8 and out.shape == lumas.shape
    # the cast truncates: pixels that land within f32 noise of an integer
    # may truncate to neighbours in the two packages
    delta = np.abs(out.numpy().astype(int) - np.asarray(out_j).astype(int))
    assert delta.max() <= 1 and (delta == 0).mean() > 0.999
    np.testing.assert_allclose(strength.numpy(), np.asarray(strength_j),
                               rtol=2e-4)


def test_engine_guards_and_reinitialize():
    engine = Watermark(16, 24, 3, device="cpu")
    with pytest.raises(ValueError):
        engine.embed(np.zeros((15, 24), np.float32))
    with pytest.raises(ValueError):   # RGB is not a grayscale analysis input
        engine.detect(np.zeros((16, 24, 3), np.float32))
    with pytest.raises(ValueError):
        Watermark(16, 24, 3, p=4, device="cpu")
    with pytest.raises(ValueError):
        Watermark(16, 24, 3, psnr=0.0, device="cpu")
    with pytest.raises(ValueError):
        Watermark(16, 24, np.zeros((4, 4), np.float32), device="cpu")
    with pytest.raises(ValueError):
        Watermark(16, 24, 3, impl="pallas", device="cpu")
    engine.reinitialize(5, 8, 10)
    assert tuple(engine.random_matrix.shape) == (8, 10)
    engine.warmup(channels=3)
    marked, strength = engine.embed(np.full((8, 10), 9.0, np.float32))
    assert marked.shape == (8, 10) and float(strength) == 0.0


def test_pad_to_batch():
    stack = np.arange(6, dtype=np.float32).reshape(2, 3)
    padded = pad_to_batch(stack, 4)
    assert padded.shape == (4, 3)
    np.testing.assert_array_equal(padded[2:], stack[[1, 1]])
    assert pad_to_batch(stack, 2) is stack


def test_timer_and_format():
    timer = Timer()
    timer.start()
    value = torch.ones(3) * 2
    timer.end(value)
    assert timer.elapsed_seconds >= 0.0
    assert execution_time(True, 0.5) == "FPS: 2.00 FPS"
    assert execution_time(False, 0.5) == "0.500000 seconds"
