"""The 3x3 Gram with the 8x8 solve folded into its assembly
(``ops/cuda/me_kernel.py::me_gram_solve8``) against its two-call form and
the JAX package's normal equations and solver.

On CPU tensors the wrapper is ``me_gram_plain`` then ``spd_solve8_plain``,
bit for bit; on the card the assembly kernel's last block of each frame
solves with ``spd_solve8``'s own device function (``tests/test_torch_cuda.py``
holds the two forms' bits together there). The same numpy frames, made
from a seed, go through the JAX package's ``me_normal_equations`` and
``solve_coefficients_spd``. Tolerances: ``tests/test_torch_solve.py``'s,
coefficients atol 1e-4 and ``valid`` equal; the Gram's Rx and rx rtol
1e-4, the JAX suite's Gram bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from watermarking_gpu_tpu.ops import me as jme
from watermarking_gpu_tpu_torch.ops import cuda as kernels

torch.set_num_threads(1)

SHAPES = [(1, 40, 96), (3, 37, 53), (2, 24, 64)]


def make_frames(shape, seed=40961):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(128, 40, shape), 0, 255).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_me_gram_solve8_is_the_two_call_form_on_cpu(shape):
    """On a CPU tensor: the Gram of ``me_gram_plain`` and the solve of
    ``spd_solve8_plain``, bit for bit, as ``spd_solve8(me_gram(x))`` gives
    them; no kernel counts a launch."""
    frames = torch.from_numpy(make_frames(shape))
    before = kernels.launch_counts()
    gram, coefficients, valid = kernels.me_gram_solve8(frames)
    want_gram = kernels.me_gram_plain(frames)
    want = kernels.spd_solve8_plain(want_gram)
    assert torch.equal(gram, want_gram)
    assert torch.equal(coefficients, want[0]) and torch.equal(valid, want[1])
    two_calls = kernels.spd_solve8(kernels.me_gram(frames))
    assert all(torch.equal(g, w) for g, w in zip((coefficients, valid),
                                                 two_calls))
    assert gram.shape == (shape[0], 9, 9) and coefficients.shape == (
        shape[0], 8) and valid.dtype == torch.bool
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("shape", SHAPES)
def test_me_gram_solve8_matches_jax(shape):
    """The same frames through the JAX package's normal equations and
    ``solve_coefficients_spd``: Rx and rx within rtol 1e-4, coefficients
    within atol 1e-4, every frame valid."""
    frames = make_frames(shape)
    gram, coefficients, valid = kernels.me_gram_solve8(
        torch.from_numpy(frames))
    rx_matrix, rx_vector = jme.me_normal_equations(jnp.asarray(frames))
    np.testing.assert_allclose(gram[:, :8, :8].numpy(),
                               np.asarray(rx_matrix), rtol=1e-4)
    np.testing.assert_allclose(gram[:, :8, 8].numpy(),
                               np.asarray(rx_vector), rtol=1e-4)
    want, want_valid = jme.solve_coefficients_spd(rx_matrix, rx_vector)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    assert valid.all()
    np.testing.assert_allclose(coefficients.numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_me_gram_solve8_flags_a_constant_frame(shape):
    """A constant frame among real ones: its Gram is exactly singular (81
    entries of the same bits), so it comes back invalid with zero
    coefficients, as the JAX solver flags it, and the others solve."""
    frames = make_frames(shape)
    frames[-1] = 77.0
    _, coefficients, valid = kernels.me_gram_solve8(torch.from_numpy(frames))
    want, want_valid = jme.solve_coefficients_spd(
        *jme.me_normal_equations(jnp.asarray(frames)))
    assert valid.tolist() == [True] * (shape[0] - 1) + [False]
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    assert not coefficients[-1].any() and not np.asarray(want)[-1].any()
    np.testing.assert_allclose(coefficients[:-1].numpy(),
                               np.asarray(want)[:-1], atol=1e-4, rtol=0)


def test_me_gram_solve8_takes_whole_frames_only():
    """No halo form: the shards' Grams are folded before their solve
    (``parallel/spatial.py``), so a halo argument is refused."""
    frames = torch.from_numpy(make_frames((1, 24, 64)))
    with pytest.raises(TypeError):
        kernels.me_gram_solve8(frames, 1)
    with pytest.raises(TypeError):
        kernels.me_gram_solve8(frames, top=1, bottom=1)


@pytest.mark.parametrize("device", ["meta", "cpu-2d"])
def test_me_gram_solve8_raises_on_what_it_does_not_take(device):
    """Another device than CUDA or the CPU, and a frame without its batch
    axis, raise ``ValueError``."""
    image = (torch.zeros(1, 24, 64, device="meta") if device == "meta"
             else torch.zeros(24, 64))
    with pytest.raises(ValueError):
        kernels.me_gram_solve8(image)
