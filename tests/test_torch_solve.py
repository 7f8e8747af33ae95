"""The 3x3 predictor's solve (``ops/cuda/solve.py::spd_solve8``) against the
JAX package's ``ops/me.py::solve_coefficients_spd``, and the kernel routes
that run it: alone on the spatial routes' folded Gram, inside the Gram's
assembly (``me_gram_solve8``) on a single device.

The same numpy frames, made from a seed, give the Grams. On CPU tensors the
wrapper runs its plain version, the unrolled (B,)-vector Cholesky
``ops/me.py::solve_coefficients_spd``, which the kernel matches on the card
(``tests/test_torch_cuda.py``). Tolerance: coefficients atol 1e-4, the JAX
suite's bound for solves of a frame's Gram (cond ~1e4, so f32 solves in
another order differ by a few 1e-5), and ``valid`` equal. Correlations
through the routes: abs 2e-4, the JAX suite's bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import watermarking_gpu_tpu_torch.parallel as tp
from watermarking_gpu_tpu.ops import me as jme
from watermarking_gpu_tpu.ops.pipelines import detect_pipeline as jdetect
from watermarking_gpu_tpu_torch.ops import cuda as kernels
from watermarking_gpu_tpu_torch.ops import me as tme
from watermarking_gpu_tpu_torch.ops import pipelines
from watermarking_gpu_tpu_torch.parallel import spatial

torch.set_num_threads(1)


def make_frames(shape, seed=40961):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(128, 40, shape), 0, 255).astype(np.float32)


def jax_gram(frames: np.ndarray) -> np.ndarray:
    """The (B, 9, 9) Gram of the JAX package's normal equations: Rx in
    [:8, :8], rx in [:8, 8] and [8, :8], the centre's sum of squares in
    [8, 8] (the solve does not read row 8)."""
    rx_matrix, rx_vector = (np.asarray(a) for a in
                            jme.me_normal_equations(jnp.asarray(frames)))
    gram = np.zeros(frames.shape[:1] + (9, 9), np.float32)
    gram[:, :8, :8] = rx_matrix
    gram[:, :8, 8] = gram[:, 8, :8] = rx_vector
    gram[:, 8, 8] = (frames.astype(np.float64) ** 2).sum(axis=(1, 2))
    return gram


def jax_solve(gram: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    coefficients, valid = jme.solve_coefficients_spd(
        jnp.asarray(gram[:, :8, :8]), jnp.asarray(gram[:, :8, 8]))
    return np.asarray(coefficients), np.asarray(valid)


@pytest.mark.parametrize("shape", [(1, 40, 96), (5, 37, 83), (1, 120, 200),
                                   (5, 64, 64), (5, 9, 300)])
def test_spd_solve8_matches_jax_on_the_same_gram(shape):
    """The JAX Gram of the same frames through both solvers."""
    gram = jax_gram(make_frames(shape))
    coefficients, valid = kernels.spd_solve8(torch.from_numpy(gram))
    want, want_valid = jax_solve(gram)
    assert coefficients.shape == (shape[0], 8) and valid.dtype == torch.bool
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    assert valid.all()
    np.testing.assert_allclose(coefficients.numpy(), want, atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("shape", [(1, 40, 96), (5, 37, 83), (5, 120, 200)])
def test_spd_solve8_of_port_gram_matches_jax(shape):
    """The port's 3x3 Gram (``me_gram`` on CPU tensors: the direct
    per-pair sums) through ``spd_solve8`` against the JAX package's Gram
    and solve of the same frames: the kernel route's analysis as a whole."""
    frames = make_frames(shape)
    coefficients, valid = kernels.spd_solve8(
        kernels.me_gram(torch.from_numpy(frames)))
    want, want_valid = jax_solve(jax_gram(frames))
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_allclose(coefficients.numpy(), want, atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("batch", [1, 5])
def test_spd_solve8_on_cpu_is_the_plain_solve(batch):
    """On a CPU tensor the wrapper is ``solve_coefficients_spd`` of the
    Gram's blocks, bit for bit, and launches nothing."""
    gram = kernels.me_gram(torch.from_numpy(make_frames((batch, 40, 96))))
    before = kernels.spd_solve8.launches
    got = kernels.spd_solve8(gram)
    want = tme.solve_coefficients_spd(gram[:, :8, :8], gram[:, :8, 8])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w)
               for g, w in zip(got, kernels.spd_solve8_plain(gram)))
    assert kernels.spd_solve8.launches == before


def singular_grams() -> dict[str, np.ndarray]:
    """Each a (2, 9, 9) batch: a good frame's Gram first, then a singular
    system."""
    good = jax_gram(make_frames((1, 40, 96)))[0]
    flat = jax_gram(np.full((1, 40, 96), 77.0, np.float32))[0]
    nan = good.copy()
    nan[3, 2] = np.nan
    return {"constant frame": np.stack([good, flat]),
            "all zero": np.stack([good, np.zeros((9, 9), np.float32)]),
            "nan entry": np.stack([good, nan])}


@pytest.mark.parametrize("case", ["constant frame", "all zero", "nan entry"])
def test_singular_systems_come_back_invalid(case):
    """A constant frame's rank-1 Gram, an all-zero system and a Gram with a
    NaN entry: invalid with zero coefficients, as the JAX solver flags
    them, beside a good frame that solves."""
    gram = singular_grams()[case]
    coefficients, valid = kernels.spd_solve8(torch.from_numpy(gram))
    want, want_valid = jax_solve(gram)
    assert valid.tolist() == [True, False] == want_valid.tolist()
    assert not coefficients[1].any() and not want[1].any()
    np.testing.assert_allclose(coefficients[0].numpy(), want[0], atol=1e-4,
                               rtol=0)


class CountingSolve:
    """Stands in for ``spd_solve8`` in a module and counts its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, gram):
        self.calls += 1
        assert gram.ndim == 3 and gram.shape[1:] == (9, 9)
        return kernels.spd_solve8(gram)


class CountingGramSolve:
    """Stands in for ``me_gram_solve8`` in a module and counts its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, image):
        self.calls += 1
        gram, coefficients, valid = kernels.me_gram_solve8(image)
        assert gram.shape[1:] == (9, 9) and coefficients.shape[1:] == (8,)
        return gram, coefficients, valid


@pytest.fixture
def counting(monkeypatch):
    solve = CountingSolve()
    monkeypatch.setattr(spatial, "spd_solve8", solve)
    return solve


@pytest.fixture
def counting_fused(monkeypatch):
    solve = CountingGramSolve()
    monkeypatch.setattr(pipelines, "me_gram_solve8", solve)
    return solve


@pytest.mark.parametrize("mask_type,p", [("me", 3), ("nvf", 3), ("nvf", 5)])
def test_fused_analysis_solves_through_spd_solve8(counting_fused, counting,
                                                  mask_type, p):
    """The kernel route's detect, embed and identification at a 3x3
    predictor (ME p=3; NVF detection at every p) each solve once through
    ``spd_solve8``'s device function inside the Gram's assembly
    (``me_gram_solve8``), and never through the ``spd_solve8`` kernel
    alone; the plain route never does either. Correlations within 2e-4 of
    the JAX package's detect on the same frames."""
    frames = make_frames((2, 40, 96))
    wm = np.random.default_rng(5).normal(size=(40, 96)).astype(np.float32)
    t_frames, t_wm = torch.from_numpy(frames), torch.from_numpy(wm)
    corr = pipelines.detect_pipeline(t_frames, t_wm, mask_type, p=p,
                                     impl="cuda")
    assert counting_fused.calls == 1
    pipelines.embed_pipeline(t_frames, t_frames, t_wm, 2.55, mask_type, p=p,
                             impl="cuda")
    assert counting_fused.calls == (2 if mask_type == "me" else 1)
    calls = counting_fused.calls
    pipelines.detect_many_pipeline(t_frames, torch.stack([t_wm, -t_wm]),
                                   mask_type, p=p, impl="cuda")
    assert counting_fused.calls == calls + 1
    pipelines.detect_pipeline(t_frames, t_wm, mask_type, p=p, impl="torch")
    assert counting_fused.calls == calls + 1
    assert counting.calls == 0
    want = np.asarray(jdetect(jnp.asarray(frames), jnp.asarray(wm),
                              mask_type, p=p, impl="xla"))
    np.testing.assert_allclose(corr.numpy(), want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("mask_type,p", [("me", 3), ("nvf", 5)])
def test_spatial_kernel_route_solves_once_a_space_row(counting, mask_type,
                                                      p):
    """``spatial._solve_cuda`` at a 3x3 predictor solves the folded Gram
    once a space row through ``spd_solve8``: a spatial detect on 1 x 4
    shards once, a hybrid embed then detect on 2 x 2 twice each (ME) or
    the detect alone (NVF); the single-device detect beside it solves in
    its Gram's assembly instead, and the plain route never does."""
    frames = make_frames((4, 32, 96))
    wm = np.random.default_rng(6).normal(size=(32, 96)).astype(np.float32)
    t_frames, t_wm = torch.from_numpy(frames), torch.from_numpy(wm)
    single = pipelines.detect_pipeline(t_frames[0], t_wm, mask_type, p=p)
    assert counting.calls == 0
    mesh = tp.make_mesh(1, 4, devices=["cpu"] * 4)
    corr = tp.make_spatial_detect(mesh, mask_type, p=p)(t_frames[0], t_wm)
    assert counting.calls == 1
    assert abs(float(corr) - float(single)) <= 1e-4
    hybrid = tp.make_mesh(2, 2, devices=["cpu"] * 4)
    marked, _ = tp.make_hybrid_embed(hybrid, mask_type, 2.55, p=p)(
        t_frames, t_frames, t_wm)
    tp.make_hybrid_detect(hybrid, mask_type, p=p)(marked.gather(), t_wm)
    assert counting.calls == 1 + (4 if mask_type == "me" else 2)
    calls = counting.calls
    tp.make_spatial_detect(mesh, mask_type, p=p, impl="torch")(t_frames[0],
                                                               t_wm)
    assert counting.calls == calls


def test_spd_solve8_raises_on_other_devices():
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.spd_solve8(torch.zeros(1, 9, 9, device="meta"))
