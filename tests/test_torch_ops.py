"""The PyTorch port's plain ops against the JAX package's ``impl="xla"`` ops.

The same numpy inputs, made from a seed, go through both packages.
Tolerances are the JAX suite's own: Gram rtol 1e-4, NVF mask atol 5e-3,
pixels atol 0.1, strengths rel 2e-4, correlations abs 2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from watermarking_gpu_tpu.ops import color as jcolor
from watermarking_gpu_tpu.ops.correlation import correlation as jcorrelation
from watermarking_gpu_tpu.ops import embed as jembed
from watermarking_gpu_tpu.ops import me as jme
from watermarking_gpu_tpu.ops import neighbors as jnb
from watermarking_gpu_tpu.ops import nvf as jnvf
from watermarking_gpu_tpu_torch.ops import color as tcolor
from watermarking_gpu_tpu_torch.ops.correlation import \
    correlation as tcorrelation
from watermarking_gpu_tpu_torch.ops import embed as tembed
from watermarking_gpu_tpu_torch.ops import me as tme
from watermarking_gpu_tpu_torch.ops import neighbors as tnb
from watermarking_gpu_tpu_torch.ops import nvf as tnvf

torch.set_num_threads(1)

# (40, 96); a width not divisible by 8; a batch of 3
SHAPES = [(40, 96), (37, 83), (3, 40, 96)]


def make_image(shape, seed=40961):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(128, 40, shape), 0, 255).astype(np.float32)


def both(array):
    """The same numpy array as a JAX array and a torch tensor."""
    return jnp.asarray(array), torch.from_numpy(np.array(array))


@pytest.mark.parametrize("p", [3, 5])
def test_neighbor_offsets_match(p):
    assert tnb.neighbor_offsets(p) == jnb.neighbor_offsets(p)
    assert tnb.NEIGHBOR_OFFSETS == jnb.NEIGHBOR_OFFSETS


@pytest.mark.parametrize("shape", SHAPES + [(5, 7)])
def test_pad_edge_matches(shape):
    j, t = both(make_image(shape))
    np.testing.assert_array_equal(tnb.pad_edge(t, 2).numpy(),
                                  np.asarray(jnb.pad_edge(j, 2)))
    views = tnb.shifted_views(tnb.pad_edge(t, 1), *shape[-2:])
    np.testing.assert_array_equal(torch.stack(views, dim=-3).numpy(),
                                  np.asarray(jnb.neighbor_stack(j)))


@pytest.mark.parametrize("shape", SHAPES)
def test_nvf_mask_matches(shape):
    j, t = both(make_image(shape))
    np.testing.assert_allclose(tnvf.nvf_mask(t).numpy(),
                               np.asarray(jnvf.nvf_mask(j)), atol=5e-3)


@pytest.mark.parametrize("shape", SHAPES)
def test_me_normal_equations_match(shape):
    j, t = both(make_image(shape))
    rm_t, rv_t = tme.me_normal_equations(t)
    rm_j, rv_j = jme.me_normal_equations(j)
    np.testing.assert_allclose(rm_t.numpy(), np.asarray(rm_j), rtol=1e-4)
    np.testing.assert_allclose(rv_t.numpy(), np.asarray(rv_j), rtol=1e-4)


@pytest.mark.parametrize("solver", ["lu", "spd"])
@pytest.mark.parametrize("shape", [(40, 96), (3, 40, 96)])
def test_solves_match_on_real_gram(shape, solver):
    """Both solvers fed the JAX Gram give the JAX coefficients. The Gram of
    a frame has cond ~1e4, so f32 solves in another order differ by a few
    1e-5 absolute."""
    rm, rv = jme.me_normal_equations(jnp.asarray(make_image(shape)))
    port = {"lu": tme.solve_coefficients,
            "spd": tme.solve_coefficients_spd}[solver]
    ref = {"lu": jme.solve_coefficients,
           "spd": jme.solve_coefficients_spd}[solver]
    c_t, v_t = port(torch.from_numpy(np.array(rm)),
                    torch.from_numpy(np.array(rv)))
    c_j, v_j = ref(rm, rv)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert v_t.all()
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-4)


@pytest.mark.parametrize("solver", [tme.solve_coefficients,
                                    tme.solve_coefficients_spd])
def test_singular_systems_flag_invalid(solver):
    """A zero system, and a constant frame's rank-1 Gram in a batch with a
    good frame: only the singular ones come back invalid, with zero
    coefficients (the JAX solvers flag the same frames)."""
    coeffs, valid = solver(torch.zeros(8, 8), torch.ones(8))
    assert not bool(valid) and not coeffs.any()
    frames = np.stack([make_image((40, 96)),
                       np.full((40, 96), 77.0, np.float32)])
    rm, rv = tme.me_normal_equations(torch.from_numpy(frames))
    coeffs, valid = solver(rm, rv)
    rm_j, rv_j = jme.me_normal_equations(jnp.asarray(frames))
    _, valid_j = jme.solve_coefficients(rm_j, rv_j)
    assert valid.tolist() == [True, False] == np.asarray(valid_j).tolist()
    assert not coeffs[1].any() and coeffs[0].abs().sum() > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_prediction_error_and_mask_match(shape):
    rng = np.random.default_rng(7)
    coeffs = rng.normal(0, 0.2, shape[:-2] + (8,)).astype(np.float32)
    (j, t), (cj, ct) = both(make_image(shape)), both(coeffs)
    e_t = tme.prediction_error(t, ct)
    e_j = jme.prediction_error(j, cj)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), atol=1e-3)
    np.testing.assert_allclose(tme.predict(t, ct).numpy(),
                               np.asarray(jme.predict(j, cj)), atol=1e-3)
    np.testing.assert_allclose(tme.me_mask_from_error(e_t).numpy(),
                               np.asarray(jme.me_mask_from_error(e_j)),
                               atol=1e-5)


def test_wide_windows_raise():
    """Only window sizes outside {3, 5, 7, 9} raise (the wide ones are held
    to the JAX package in tests/test_torch_wide.py)."""
    image = torch.zeros(16, 16)
    for p in (1, 4, 11):
        with pytest.raises(ValueError, match="p must be one of"):
            tme.me_normal_equations(image, p=p)
        with pytest.raises(ValueError, match="p must be one of"):
            tme.prediction_error(image, torch.zeros(p * p - 1), p=p)
    rm, rv = tme.me_normal_equations(image, p=5)
    assert rm.shape == (24, 24) and rv.shape == (24,)
    assert tme.prediction_error(image, torch.zeros(24), p=5).shape == (16, 16)


@pytest.mark.parametrize("channels", [0, 3])
@pytest.mark.parametrize("shape", [(40, 96), (3, 37, 83)])
def test_embed_watermark_matches(shape, channels):
    rng = np.random.default_rng(11)
    image = make_image(shape)
    mask = rng.uniform(0, 1, shape).astype(np.float32)
    wm = rng.normal(size=shape[-2:]).astype(np.float32)
    out = image if channels == 0 else np.repeat(image[..., None], 3, -1)
    (oj, ot), (mj, mt), (wj, wt) = both(out), both(mask), both(wm)
    got, s_t = tembed.embed_watermark(ot, mt, wt, tembed.strength_factor(40))
    want, s_j = jembed.embed_watermark(oj, mj, wj, jembed.strength_factor(40))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=0.1)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=2e-4)


def test_strength_factor_matches():
    for psnr in (20.0, 40.0, 55.5):
        assert tembed.strength_factor(psnr) == jembed.strength_factor(psnr)


@pytest.mark.parametrize("shape", SHAPES)
def test_correlation_matches(shape):
    rng = np.random.default_rng(13)
    a = rng.normal(size=shape).astype(np.float32)
    b = (a + rng.normal(size=shape)).astype(np.float32)
    (aj, at), (bj, bt) = both(a), both(b)
    np.testing.assert_allclose(tcorrelation(at, bt).numpy(),
                               np.asarray(jcorrelation(aj, bj)),
                               atol=2e-4)


def test_rgb_to_gray_matches():
    rgb = make_image((12, 10, 3))
    j, t = both(rgb)
    np.testing.assert_allclose(tcolor.rgb_to_gray(t).numpy(),
                               np.asarray(jcolor.rgb_to_gray(j)), atol=1e-3)
    gray = torch.from_numpy(make_image((12, 10)))
    assert tcolor.rgb_to_gray(gray) is gray
