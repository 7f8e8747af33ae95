"""Each kernel module of the port: the plain PyTorch version against the JAX
package's Pallas kernel (interpret mode on the CPU, as tests/test_pallas.py
runs it), with the same inputs and coefficients fed to both. The CUDA
kernels themselves are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: Gram rtol 1e-4; u_raw rtol 1e-5 + atol 1e-3 (the per-pixel
terms round alike, only the image-wide max and sum are reductions);
reductions rtol 1e-4; correlations abs 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from watermarking_gpu_tpu.ops.pallas.fused import (fused_detect_tail,
                                                   fused_embed_field)
from watermarking_gpu_tpu.ops.pallas.me_kernel import \
    me_normal_equations_pallas
from watermarking_gpu_tpu_torch.ops import cuda as kernels
from watermarking_gpu_tpu_torch.ops.me import solve_coefficients

torch.set_num_threads(1)

SHAPES = [(40, 96), (37, 83), (3, 40, 96)]


def make_inputs(shape, seed=40961):
    """Frames, watermark and per-frame coefficients as numpy f32; the
    coefficients are the frames' own least-squares predictors, so the
    fields are realistic (zero for a frame too small to solve)."""
    rng = np.random.default_rng(seed)
    frames = np.clip(rng.normal(128, 40, shape), 0, 255).astype(np.float32)
    wm = rng.normal(size=shape[-2:]).astype(np.float32)
    gram = kernels.me_gram_plain(torch.from_numpy(frames.reshape(
        (-1,) + shape[-2:])))
    coeffs, _ = solve_coefficients(gram[:, :8, :8], gram[:, :8, 8])
    return frames, wm, coeffs.numpy().reshape(shape[:-2] + (8,))


def as_batch(array, shape):
    """Torch view of a numpy array with the batch axis that frames of
    ``shape`` (2-D or batched 3-D) may lack."""
    tensor = torch.from_numpy(array)
    return tensor if len(shape) == 3 else tensor[None]


@pytest.mark.parametrize("shape", SHAPES)
def test_me_gram_plain_matches_pallas(shape):
    frames, _, _ = make_inputs(shape)
    gram = kernels.me_gram_plain(as_batch(frames, shape))
    rm, rv = me_normal_equations_pallas(jnp.asarray(frames))
    rm, rv = np.asarray(rm).reshape(-1, 8, 8), np.asarray(rv).reshape(-1, 8)
    np.testing.assert_allclose(gram[:, :8, :8].numpy(), rm, rtol=1e-4)
    np.testing.assert_allclose(gram[:, :8, 8].numpy(), rv, rtol=1e-4)
    np.testing.assert_array_equal(gram.numpy(), gram.transpose(1, 2).numpy())


@pytest.mark.parametrize("mask_type", ["me", "nvf"])
@pytest.mark.parametrize("shape", SHAPES)
def test_embed_field_plain_matches_pallas(shape, mask_type):
    frames, wm, coeffs = make_inputs(shape)
    u_t, s_t, m_t = kernels.embed_field_plain(
        as_batch(frames, shape), torch.from_numpy(wm),
        as_batch(coeffs, shape), mask_type)
    u_j, s_j, m_j = fused_embed_field(jnp.asarray(frames), jnp.asarray(wm),
                                      jnp.asarray(coeffs), mask_type)
    np.testing.assert_allclose(u_t.numpy().reshape(shape), np.asarray(u_j),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(s_t.numpy().ravel(), np.asarray(s_j).ravel(),
                               rtol=1e-4)
    np.testing.assert_allclose(m_t.numpy().ravel(), np.asarray(m_j).ravel(),
                               rtol=1e-4)


@pytest.mark.parametrize("mask_type", ["me", "nvf"])
@pytest.mark.parametrize("shape", SHAPES)
def test_detect_partials_plain_matches_pallas(shape, mask_type):
    frames, wm, coeffs = make_inputs(shape)
    # detect frames that carry the watermark, so the correlation means
    # something (a u ring built from edge-replicated image rows instead of
    # u's own edge would show here)
    marked = np.clip(frames + 3.0 * wm, 0, 255).astype(np.float32)
    dot, norm_u, norm_z = kernels.detect_partials_plain(
        as_batch(marked, shape), torch.from_numpy(wm),
        as_batch(coeffs, shape), mask_type)
    corr = (dot / torch.sqrt(norm_u * norm_z)).numpy()
    want = np.asarray(fused_detect_tail(jnp.asarray(marked), jnp.asarray(wm),
                                        jnp.asarray(coeffs), mask_type))
    np.testing.assert_allclose(corr, want.ravel(), atol=2e-4)
    assert (corr > 0.05).all()
