"""The embed finish (``ops/cuda/finish.py``): the strength and the
clamp(output + u_raw * scale) of every fused embed, against the eager tail
that ``ops/pipelines.py::_embed_fused`` ran before the kernel took it over,
and the pipeline through it against the JAX package's.

The plain version is that eager tail moved op for op, so it is held to it
bit for bit (NaN-aware: an NVF constant frame gives NaN pixels in both, and
in the JAX package's XLA route). The card's kernel is held to the plain version in
``tests/test_torch_cuda.py``. Through the pipeline, ``impl="cuda"`` on the
CPU is held to the JAX package's ``impl="pallas"`` in interpret mode with
the JAX suite's tolerances (ROADMAP.md §3): pixels atol 0.1, strengths
rtol 2e-4; uint8 frames within 1 of each other (the cast truncates, and a
pixel within f32 noise of an integer may land on either side).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from watermarking_gpu_tpu.models import batched as jbatched
from watermarking_gpu_tpu.ops import pipelines as jp
from watermarking_gpu_tpu_torch.models import batch_embed_luma_u8
from watermarking_gpu_tpu_torch.ops import cuda as kernels
from watermarking_gpu_tpu_torch.ops import pipelines as tp
from watermarking_gpu_tpu_torch.ops.me import solve_coefficients

torch.set_num_threads(1)

SF = 2.55  # strength_factor(40)


def eager_tail(u_raw, output, sum_u2, max_e, valid, strength_factor_value,
               n, mask_type):
    """The tail of ``_embed_fused`` before the kernel, as it was."""
    scale = strength_factor_value * math.sqrt(n) / torch.sqrt(sum_u2)
    strength = scale * max_e if mask_type == "me" else scale
    addend = u_raw * scale[..., None, None]
    if output.ndim == u_raw.ndim + 1:
        addend = addend[..., None]
    watermarked = torch.clamp(output + addend, 0.0, 255.0)
    return (tp._gate(watermarked, valid, output),
            torch.where(valid, strength, 0.0))


def make_frames(shape, seed=40961):
    rng = np.random.default_rng(seed)
    frames = np.clip(rng.normal(128, 40, shape), 0, 255).astype(np.float32)
    return frames, rng.normal(size=shape[-2:]).astype(np.float32)


def field(frames: np.ndarray, wm: np.ndarray, mask_type: str):
    """(frames, u_raw, sum_u2, max_e, valid) of the embed field's plain
    version on the frames at p=3, as ``_embed_fused`` gets them."""
    f = torch.from_numpy(frames)
    gram = kernels.me_gram_plain(f)
    coefficients, valid = solve_coefficients(gram[:, :8, :8], gram[:, :8, 8])
    u_raw, sum_u2, max_e = kernels.embed_field(
        f, torch.from_numpy(wm),
        coefficients if mask_type == "me" else None, mask_type, 3)
    if mask_type == "nvf":
        valid = torch.ones_like(valid)
    return f, u_raw, sum_u2, max_e, valid


def assert_same(got, want):
    """Equal bits and dtypes, NaN equal to NaN."""
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("mask_type", ["me", "nvf"])
@pytest.mark.parametrize("case", ["batch", "invalid", "frame", "rgb"])
def test_plain_matches_the_eager_tail(mask_type, case):
    """A batch, one frame's solve failed, a 2-D frame, and an RGB output
    at a width that is not a multiple of 4."""
    frames, wm = make_frames((3, 24, 37))
    f, u_raw, sum_u2, max_e, valid = field(frames, wm, mask_type)
    output = f
    if case == "invalid":
        valid = torch.tensor([True, False, True])
    elif case == "frame":
        f, u_raw, sum_u2, max_e, valid = f[1], u_raw[1], sum_u2[1], \
            max_e[1], valid[1]
        output = f
    elif case == "rgb":
        output = torch.stack([f, f * 0.5, 255 - f], dim=-1)
    numerator = SF * math.sqrt(24 * 37)
    got = kernels.embed_finish_plain(u_raw, output, sum_u2, max_e, valid,
                                     numerator, mask_type)
    want = eager_tail(u_raw, output, sum_u2, max_e, valid, SF, 24 * 37,
                      mask_type)
    assert_same(got, want)
    assert got[0].shape == output.shape and got[1].shape == valid.shape
    if case == "invalid":
        assert got[1][1] == 0.0 and torch.equal(got[0][1], output[1])


@pytest.mark.parametrize("mask_type", ["me", "nvf"])
@pytest.mark.parametrize("channels", [None, 3])
def test_plain_u8_form_is_the_f32_form_cast(mask_type, channels):
    frames, wm = make_frames((3, 24, 37), seed=7)
    lumas = frames.astype(np.uint8)
    f, u_raw, sum_u2, max_e, valid = field(lumas.astype(np.float32), wm,
                                           mask_type)
    valid = torch.tensor([True, False, True])
    output = torch.from_numpy(lumas)
    if channels:
        output = torch.stack([output, 255 - output, output // 2], dim=-1)
    numerator = SF * math.sqrt(24 * 37)
    got = kernels.embed_finish_plain(u_raw, output, sum_u2, max_e, valid,
                                     numerator, mask_type)
    want = kernels.embed_finish_plain(u_raw, output.to(torch.float32),
                                      sum_u2, max_e, valid, numerator,
                                      mask_type)
    assert got[0].dtype == torch.uint8
    assert_same(got, (want[0].to(torch.uint8), want[1]))
    assert torch.equal(got[0][1], output[1])


def test_plain_passes_nvf_constant_frame_nan_through():
    """Under NVF a constant frame has mask 0, so u_raw and sum u_raw^2 are
    0, the scale inf and its pixels NaN (valid holds for NVF), in the
    eager tail and in the JAX package alike; the clamp must not turn them
    into 0 or 255."""
    frames, wm = make_frames((2, 24, 37))
    frames = np.floor(frames)     # whole values, as the u8 form reads them
    frames[1] = 77.0
    f, u_raw, sum_u2, max_e, valid = field(frames, wm, "nvf")
    assert sum_u2[1] == 0.0 and bool(valid.all())
    numerator = SF * math.sqrt(24 * 37)
    got = kernels.embed_finish_plain(u_raw, f, sum_u2, max_e, valid,
                                     numerator, "nvf")
    assert_same(got, eager_tail(u_raw, f, sum_u2, max_e, valid, SF,
                                24 * 37, "nvf"))
    assert bool(got[0][1].isnan().all()) and bool(got[0][0].isfinite().all())
    assert math.isinf(float(got[1][1]))
    u8, _ = kernels.embed_finish_plain(u_raw, f.to(torch.uint8), sum_u2,
                                       max_e, valid, numerator, "nvf")
    assert torch.equal(u8, got[0].to(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_wrapper_takes_the_plain_version_on_cpu(dtype):
    frames, wm = make_frames((2, 16, 24), seed=3)
    f, u_raw, sum_u2, max_e, valid = field(frames, wm, "me")
    kernels.reset_launch_counts()
    args = (u_raw, f.to(dtype), sum_u2, max_e, valid, SF * math.sqrt(384),
            "me")
    assert_same(kernels.embed_finish(*args), kernels.embed_finish_plain(*args))
    assert kernels.embed_finish.launches == 0


def test_wrapper_raises_off_cpu_and_cuda():
    meta = torch.empty((2, 16, 24), device="meta")
    vec = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.embed_finish(meta, meta, vec, vec, vec.bool(), 1.0, "me")
    frames, wm = make_frames((2, 16, 24), seed=3)
    f, u_raw, sum_u2, max_e, valid = field(frames, wm, "me")
    with pytest.raises(ValueError, match="mask_type"):
        kernels.embed_finish(u_raw, f, sum_u2, max_e, valid, 1.0, "xla")
    assert kernels.embed_finish.launches == 0


def with_singular_frame(shape, seed):
    frames, wm = make_frames(shape, seed=seed)
    frames[1] = 77.0
    return frames, wm


def jax_embed(frames, wm, mask_type, impl):
    marked, strength = jp.embed_pipeline(
        jnp.asarray(frames), jnp.asarray(frames), jnp.asarray(wm), SF,
        mask_type, impl=impl)
    return np.asarray(marked), np.asarray(strength)


@pytest.mark.parametrize("mask_type", ["me", "nvf"])
def test_pipeline_through_the_finish_matches_pallas(mask_type):
    """``embed_pipeline(impl="cuda")`` against the JAX package's Pallas
    route; for ME on a batch with a constant frame, whose solve fails: the
    frame passes through with strength 0."""
    if mask_type == "me":
        frames, wm = with_singular_frame((3, 40, 96), seed=11)
    else:
        frames, wm = make_frames((3, 40, 96), seed=11)
    marked, strength = tp.embed_pipeline(torch.from_numpy(frames),
                                         torch.from_numpy(frames),
                                         torch.from_numpy(wm), SF, mask_type,
                                         impl="cuda")
    marked_j, strength_j = jax_embed(frames, wm, mask_type, "pallas")
    np.testing.assert_allclose(marked.numpy(), marked_j, atol=0.1)
    np.testing.assert_allclose(strength.numpy(), strength_j, rtol=2e-4)
    if mask_type == "me":
        assert strength[1] == 0.0
        np.testing.assert_array_equal(marked[1].numpy(), frames[1])


def test_nvf_constant_frame_matches_the_jax_oracle():
    """An NVF constant frame through ``impl="cuda"``: NaN pixels and an
    infinite strength, as the JAX package's ``impl="xla"`` oracle gives (its
    Pallas NVF mask, in interpret mode, is not exactly 0 on such a frame,
    and gives finite pixels there); the other frames as before."""
    frames, wm = with_singular_frame((3, 40, 96), seed=11)
    marked, strength = tp.embed_pipeline(torch.from_numpy(frames),
                                         torch.from_numpy(frames),
                                         torch.from_numpy(wm), SF, "nvf",
                                         impl="cuda")
    marked_j, strength_j = jax_embed(frames, wm, "nvf", "xla")
    assert bool(marked[1].isnan().all()) and np.isnan(marked_j[1]).all()
    assert math.isinf(float(strength[1])) and np.isinf(strength_j[1])
    np.testing.assert_allclose(marked.numpy(), marked_j, atol=0.1)
    np.testing.assert_allclose(strength.numpy()[[0, 2]], strength_j[[0, 2]],
                               rtol=2e-4)


@pytest.mark.parametrize("mask_type", ["me", "nvf"])
def test_luma_u8_through_the_finish_matches_pallas(mask_type):
    """``batch_embed_luma_u8(impl="cuda")``: the u8 form writes the frames,
    the same bytes as the f32 pipeline cast to uint8, and within 1 of the
    JAX package's Pallas route (ME with a constant frame, passed through
    untouched)."""
    if mask_type == "me":
        frames, wm = with_singular_frame((3, 40, 96), seed=12)
    else:
        frames, wm = make_frames((3, 40, 96), seed=12)
    lumas = frames.astype(np.uint8)
    out, strength = batch_embed_luma_u8(torch.from_numpy(lumas),
                                        torch.from_numpy(wm), SF, mask_type,
                                        impl="cuda")
    f32, f32_strength = tp.embed_pipeline(torch.from_numpy(lumas),
                                          torch.from_numpy(lumas),
                                          torch.from_numpy(wm), SF,
                                          mask_type, impl="cuda")
    assert out.dtype == torch.uint8 and out.shape == lumas.shape
    assert torch.equal(out, f32.to(torch.uint8))
    assert torch.equal(strength, f32_strength)
    out_j, strength_j = jbatched.batch_embed_luma_u8(
        jnp.asarray(lumas), jnp.asarray(wm), SF, mask_type, impl="pallas")
    delta = np.abs(out.numpy().astype(int) - np.asarray(out_j).astype(int))
    assert delta.max() <= 1 and (delta == 0).mean() > 0.999
    np.testing.assert_allclose(strength.numpy(), np.asarray(strength_j),
                               rtol=2e-4)
    if mask_type == "me":
        np.testing.assert_array_equal(out[1].numpy(), lumas[1])
