"""The wide predictor's solve (``ops/cuda/solve.py::spd_solve_wide``, whose
plain version is ``ops/me.py::solve_coefficients_spd_blocked``) against the
JAX package's ``ops/me.py::solve_coefficients_spd_blocked``, and the kernel
routes that run it at ME p = 5, 7, 9.

The same numpy frames and random systems, made from a seed, go to both
packages. On CPU tensors the wrapper runs its plain version, which the
kernel matches on the card (``tests/test_torch_cuda.py``). Tolerance:
coefficients atol 1e-4, the wide solves' bound (f32 solves of a frame's
Gram in another order differ by a few 1e-6 here; cond(Rx) ~3e2-1e3 at p =
5-9), and ``valid`` equal. Correlations through the routes: abs 2e-4, the
JAX suite's bound.
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

WIDE_P = (5, 7, 9)
ATOL = 1e-4


def make_frames(shape, seed=40961, std=40):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(128, std, shape), 0, 255).astype(np.float32)


def jax_gram(frames: np.ndarray, p: int) -> np.ndarray:
    """The (B, k+1, k+1) Gram of the JAX package's normal equations: Rx in
    [:k, :k], rx in [:k, k] and [k, :k], the centre's sum of squares in
    [k, k] (the solve does not read row k)."""
    k = p * p - 1
    rx_matrix, rx_vector = (np.asarray(a) for a in
                            jme.me_normal_equations(jnp.asarray(frames), p))
    gram = np.zeros(frames.shape[:1] + (k + 1, k + 1), np.float32)
    gram[:, :k, :k] = rx_matrix
    gram[:, :k, k] = gram[:, k, :k] = rx_vector
    gram[:, k, k] = (frames.astype(np.float64) ** 2).sum(axis=(1, 2))
    return gram


def random_spd_grams(batch: int, k: int, seed: int) -> np.ndarray:
    """(batch, k+1, k+1) Grams 3e5 A A^T + 1e5 I of N(0, 1) A (k+1 square):
    a frame Gram's scale (~1e7 on the diagonal) and conditioning (cond(Rx)
    ~2e2 at k = 24 to ~1e3 at k = 80, as a frame's at p = 5-9); without the
    ridge, cond reaches ~7e3 at k = 80, where f32 solves in any order,
    the library's too, differ by ~1e-4."""
    a = np.random.default_rng(seed).normal(size=(batch, k + 1, k + 1))
    return (3e5 * (a @ a.transpose(0, 2, 1))
            + 1e5 * np.eye(k + 1)).astype(np.float32)


def jax_solve(gram: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    k = gram.shape[-1] - 1
    coefficients, valid = jme.solve_coefficients_spd_blocked(
        jnp.asarray(gram[:, :k, :k]), jnp.asarray(gram[:, :k, k]))
    return np.asarray(coefficients), np.asarray(valid)


def grams(case: str, p: int) -> np.ndarray:
    """A batch of (k+1, k+1) Grams: the JAX Grams of seeded frames of
    40 x 96 or of the lag form's least geometry (6h x 6h), seeded random
    SPD systems (B = 1, 8), or a good frame, a constant frame and another
    frame."""
    h, k = p // 2, p * p - 1
    if case == "40x96":
        return jax_gram(make_frames((2, 40, 96), seed=p), p)
    if case == "6h":
        return jax_gram(make_frames((2, 6 * h, 6 * h), seed=p + 10), p)
    if case.startswith("random"):
        batch = int(case.split("=")[1])
        return random_spd_grams(batch, k, seed=batch + p)
    stack = np.stack([make_frames((40, 96), seed=p),
                      np.full((40, 96), 77.0, np.float32),
                      make_frames((40, 96), seed=p + 1, std=20)])
    return jax_gram(stack, p)


CASES = ("40x96", "6h", "random B=1", "random B=8", "constant frame")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("p", WIDE_P)
def test_blocked_solve_matches_jax(p, case):
    """The plain blocked solve against the JAX package's on the same Grams:
    valid lists equal, coefficients within 1e-4; a constant frame's rank-1
    Gram comes back invalid with zero coefficients beside good frames."""
    gram = grams(case, p)
    coefficients, valid = kernels.spd_solve_wide(torch.from_numpy(gram))
    want, want_valid = jax_solve(gram)
    assert coefficients.shape == (gram.shape[0], p * p - 1)
    assert valid.dtype == torch.bool
    assert valid.tolist() == want_valid.tolist()
    if case == "constant frame":
        assert valid.tolist() == [True, False, True]
        assert not coefficients[1].any() and not want[1].any()
    else:
        assert valid.all()
    err = float(np.abs(coefficients.numpy() - want).max())
    print(f"p={p} {case}: max abs diff from JAX {err:.2e}")
    assert err <= ATOL, err


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("p", WIDE_P)
def test_blocked_solve_matches_the_library_pair(p, case):
    """The plain blocked solve against the plain route's library solve
    (``cholesky_ex`` + ``cholesky_solve``) on the same Grams, at the same
    bound."""
    k = p * p - 1
    gram = torch.from_numpy(grams(case, p))
    coefficients, valid = tme.solve_coefficients_spd_blocked(
        gram[:, :k, :k], gram[:, :k, k])
    want, want_valid = tme.solve_coefficients_spd_wide(gram[:, :k, :k],
                                                       gram[:, :k, k])
    assert torch.equal(valid, want_valid)
    err = float((coefficients - want).abs().max())
    print(f"p={p} {case}: max abs diff from the library pair {err:.2e}")
    assert err <= ATOL, err


@pytest.mark.parametrize("p", WIDE_P)
def test_port_gram_of_a_constant_frame_is_invalid(p):
    """The port's own wide Gram (``me_gram_wide`` on CPU tensors: the plain
    lag form) of a constant frame, between two frames, through
    ``spd_solve_wide``: [True, False, True], within 1e-4 of the JAX Gram
    and solve of the same frames."""
    stack = np.stack([make_frames((40, 96), seed=p),
                      np.full((40, 96), 77.0, np.float32),
                      make_frames((40, 96), seed=p + 1, std=20)])
    coefficients, valid = kernels.spd_solve_wide(
        kernels.me_gram_wide(torch.from_numpy(stack), p))
    want, want_valid = jax_solve(jax_gram(stack, p))
    assert valid.tolist() == [True, False, True] == want_valid.tolist()
    assert not coefficients[1].any()
    np.testing.assert_allclose(coefficients.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("p", WIDE_P)
def test_spd_solve_wide_on_cpu_is_the_plain_solve(p):
    """On a CPU tensor the wrapper is ``solve_coefficients_spd_blocked`` of
    the Gram's blocks, bit for bit, and launches nothing."""
    k = p * p - 1
    gram = kernels.me_gram_wide(torch.from_numpy(make_frames((3, 40, 96))),
                                p)
    before = kernels.launch_counts()
    got = kernels.spd_solve_wide(gram)
    want = tme.solve_coefficients_spd_blocked(gram[:, :k, :k],
                                              gram[:, :k, k])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w)
               for g, w in zip(got, kernels.spd_solve_wide_plain(gram)))
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("gram", [
    torch.zeros(2, 9, 9), torch.zeros(2, 16, 16), torch.zeros(2, 25, 24),
    torch.zeros(25, 25), torch.zeros(2, 25, 25, dtype=torch.float64),
    torch.zeros(1, 49, 49, device="meta")],
    ids=["k=8", "k=15", "not square", "unbatched", "float64", "meta"])
def test_spd_solve_wide_raises_on_what_it_does_not_take(gram):
    """Another k than 24, 48, 80, another shape, dtype or device."""
    with pytest.raises(ValueError, match="spd_solve_wide takes"):
        kernels.spd_solve_wide(gram)


def test_blocked_solve_raises_on_a_ragged_block():
    with pytest.raises(ValueError, match="multiple of 8"):
        tme.solve_coefficients_spd_blocked(torch.eye(12)[None],
                                           torch.ones(1, 12))


class CountingSolve:
    """Stands in for ``spd_solve_wide`` in a module and counts its calls."""

    def __init__(self):
        self.calls = 0

    def __call__(self, gram):
        self.calls += 1
        assert gram.ndim == 3 and gram.shape[1] - 1 in (24, 48, 80)
        return kernels.spd_solve_wide(gram)


@pytest.fixture
def counting(monkeypatch):
    solve = CountingSolve()
    monkeypatch.setattr(pipelines, "spd_solve_wide", solve)
    monkeypatch.setattr(spatial, "spd_solve_wide", solve)
    return solve


@pytest.mark.parametrize("p", WIDE_P)
def test_fused_analysis_solves_through_spd_solve_wide(counting, p):
    """The kernel route's ME detect, embed and identification at p = 5, 7, 9
    each solve once through ``spd_solve_wide``; NVF detection (its 3x3
    predictor) and the plain route never do. Correlations within 2e-4 of
    the JAX package's detect on the same frames."""
    frames = make_frames((2, 40, 96))
    wm = np.random.default_rng(5).normal(size=(40, 96)).astype(np.float32)
    t_frames, t_wm = torch.from_numpy(frames), torch.from_numpy(wm)
    corr = pipelines.detect_pipeline(t_frames, t_wm, "me", p=p, impl="cuda")
    assert counting.calls == 1
    pipelines.embed_pipeline(t_frames, t_frames, t_wm, 2.55, "me", p=p,
                             impl="cuda")
    assert counting.calls == 2
    pipelines.detect_many_pipeline(t_frames, torch.stack([t_wm, -t_wm]),
                                   "me", p=p, impl="cuda")
    assert counting.calls == 3
    pipelines.detect_pipeline(t_frames, t_wm, "nvf", p=p, impl="cuda")
    pipelines.detect_pipeline(t_frames, t_wm, "me", p=p, impl="torch")
    assert counting.calls == 3
    want = np.asarray(jdetect(jnp.asarray(frames), jnp.asarray(wm), "me",
                              p=p, impl="xla"))
    np.testing.assert_allclose(corr.numpy(), want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("p", [5, 9])
def test_spatial_kernel_route_solves_once_a_space_row(counting, p):
    """``spatial._solve_cuda`` at ME p > 3 solves the folded Gram once a
    space row through ``spd_solve_wide``: a spatial detect on 1 x 4 shards
    once, a hybrid embed then detect on 2 x 2 twice each; the plain route
    never does."""
    frames = make_frames((4, 32, 96))
    wm = np.random.default_rng(6).normal(size=(32, 96)).astype(np.float32)
    t_frames, t_wm = torch.from_numpy(frames), torch.from_numpy(wm)
    single = pipelines.detect_pipeline(t_frames[0], t_wm, "me", p=p)
    mesh = tp.make_mesh(1, 4, devices=["cpu"] * 4)
    corr = tp.make_spatial_detect(mesh, "me", p=p)(t_frames[0], t_wm)
    assert counting.calls == 2     # the single-device detect, then one
    assert abs(float(corr) - float(single)) <= 1e-4
    hybrid = tp.make_mesh(2, 2, devices=["cpu"] * 4)
    marked, _ = tp.make_hybrid_embed(hybrid, "me", 2.55, p=p)(
        t_frames, t_frames, t_wm)
    tp.make_hybrid_detect(hybrid, "me", p=p)(marked.gather(), t_wm)
    assert counting.calls == 2 + 4
    tp.make_spatial_detect(mesh, "me", p=p, impl="torch")(t_frames[0], t_wm)
    assert counting.calls == 6
