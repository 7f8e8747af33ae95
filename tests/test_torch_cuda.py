"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and nvcc, carries the ``cuda`` marker and
skips elsewhere. The module imports neither JAX nor the JAX package, so it
runs on a machine without them; there, skip the JAX-based conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: Gram, lag partials and reductions rtol 1e-4 (summation order
only); u_raw rtol 1e-5 + atol 1e-3 (its terms round identically); between
the two routes, correlations abs 2e-4 (3e-4 for NVF, as the JAX suite holds
its fused NVF kernels) and strengths rel 2e-4.
"""

import numpy as np
import pytest
import torch

from watermarking_gpu_tpu_torch.models import BatchedWatermark
from watermarking_gpu_tpu_torch.ops import cuda as kernels
from watermarking_gpu_tpu_torch.ops import pipelines
from watermarking_gpu_tpu_torch.ops.me import solve_coefficients
from watermarking_gpu_tpu_torch.ops.pipelines import _analysis

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py")
    return torch.device("cuda")


def make_inputs(shape, device, seed=40961):
    """Frames, watermark and the frames' own predictor coefficients (zero
    for a frame too small to solve), on ``device``."""
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(np.clip(rng.normal(128, 40, shape), 0,
                                      255).astype(np.float32))
    wm = torch.from_numpy(rng.normal(size=shape[-2:]).astype(np.float32))
    gram = kernels.me_gram_plain(frames)
    coeffs, _ = solve_coefficients(gram[:, :8, :8], gram[:, :8, 8])
    return frames.to(device), wm.to(device), coeffs.to(device)


@pytest.mark.parametrize("shape", [(3, 40, 96), (2, 37, 83), (2, 1, 5),
                                   (2, 1080, 1920)])
def test_kernels_match_plain_on_card(device, shape):
    frames, wm, coeffs = make_inputs(shape, device)
    before = kernels.launch_counts()
    torch.testing.assert_close(kernels.me_gram(frames),
                               kernels.me_gram_plain(frames),
                               rtol=1e-4, atol=0)
    for mask_type in ("me", "nvf"):
        got = kernels.embed_field(frames, wm, coeffs, mask_type)
        want = kernels.embed_field_plain(frames, wm, coeffs, mask_type)
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)
        got = got[1:] + kernels.detect_partials(frames, wm, coeffs,
                                                mask_type)
        want = want[1:] + kernels.detect_partials_plain(frames, wm, coeffs,
                                                        mask_type)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after == {"me_gram": before["me_gram"] + 1,
                     "me_gram_wide": before["me_gram_wide"],
                     "embed_field": before["embed_field"] + 2,
                     "detect_partials": before["detect_partials"] + 2}


@pytest.mark.parametrize("shape", [(2, 64, 96), (2, 37, 83), (2, 20, 30),
                                   (1, 1080, 1920)])
@pytest.mark.parametrize("p", [5, 7, 9])
def test_wide_kernels_match_plain_on_card(device, p, shape):
    """The wide Gram's lane partials and Gram, and the embed field and
    detect tail at ME and NVF p, against their plain versions. (2, 20, 30)
    is below the lag geometry at p = 7 and 9, where the Gram takes the
    direct sums and launches nothing."""
    frames, wm, _ = make_inputs(shape, device)
    k = p * p - 1
    torch.testing.assert_close(kernels.wide_gram_partials(frames, p),
                               kernels.lag_partials_plain(frames, p),
                               rtol=1e-4, atol=1e-2)
    before = kernels.launch_counts()
    gram = kernels.me_gram_wide(frames, p)
    plain = kernels.me_gram_wide(frames.cpu(), p).to(device)
    torch.testing.assert_close(gram, plain, rtol=1e-4, atol=0)
    launched = kernels.launch_counts()["me_gram_wide"] - before["me_gram_wide"]
    assert launched == (1 if min(shape[1:]) >= 6 * (p // 2) else 0)
    coeffs = {"me": _analysis(frames.cpu(), p)[0].to(device),
              "nvf": _analysis(frames.cpu(), 3)[0].to(device)}
    for mask_type in ("me", "nvf"):
        c = coeffs[mask_type]
        got = kernels.embed_field(frames, wm, c if mask_type == "me" else None,
                                  mask_type, p)
        want = kernels.embed_field_plain(frames, wm, c, mask_type, p)
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)
        got = got[1:] + kernels.detect_partials(frames, wm, c, mask_type, p)
        want = want[1:] + kernels.detect_partials_plain(frames, wm, c,
                                                        mask_type, p)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
    torch.cuda.synchronize()


def test_wrappers_reject_bad_inputs_on_card(device):
    frames = torch.zeros(2, 16, 16, device=device)
    wm = torch.zeros(16, 16, device=device)
    with pytest.raises(ValueError, match="float32"):
        kernels.me_gram(frames.double())
    with pytest.raises(ValueError, match="shape"):
        kernels.embed_field(frames, wm[:8], None, "nvf")
    with pytest.raises(ValueError, match="coefficients"):
        kernels.detect_partials(frames, wm, torch.zeros(2, 8), "me")
    with pytest.raises(ValueError, match="coefficients"):
        kernels.detect_partials(frames, wm, torch.zeros(2, 8, device=device),
                                "me", 5)
    with pytest.raises(ValueError, match="coefficients"):
        kernels.embed_field(frames, wm, torch.zeros(2, 8, device=device),
                            "me", 7)


@pytest.mark.parametrize("p", [3, 5, 7, 9])
@pytest.mark.parametrize("mask_type", ["me", "nvf"])
def test_kernel_route_matches_plain_route_on_card(device, mask_type, p):
    frames, wm, _ = make_inputs((3, 64, 96), device)
    results = {}
    for impl in ("cuda", "torch"):
        marked, strength = pipelines.embed_pipeline(frames, frames, wm, 2.55,
                                                    mask_type, p=p, impl=impl)
        corr = pipelines.detect_pipeline(marked, wm, mask_type, p=p,
                                         impl=impl)
        results[impl] = (marked, strength, corr)
    (m_k, s_k, c_k), (m_p, s_p, c_p) = results["cuda"], results["torch"]
    torch.testing.assert_close(m_k, m_p, atol=0.1, rtol=0)
    torch.testing.assert_close(s_k, s_p, rtol=2e-4, atol=0)
    torch.testing.assert_close(c_k, c_p, atol=2e-4 if mask_type == "me"
                               else 3e-4, rtol=0)


@pytest.mark.parametrize("p", [3, 5])
def test_engine_runs_on_card(device, p):
    engine = BatchedWatermark(64, 96, 7, p=p)
    frames, _, _ = make_inputs((2, 64, 96), device)
    kernels.reset_launch_counts()
    marked, strength = engine.embed(frames)
    corr = engine.detect(marked)
    lumas, _ = engine.embed_luma_u8(frames.to(torch.uint8), "nvf")
    assert engine.detect(lumas, "nvf").is_cuda   # the 3x3 Gram at every p
    assert marked.is_cuda and strength.is_cuda and corr.is_cuda
    assert lumas.dtype == torch.uint8 and lumas.is_cuda
    assert (corr > 0.02).all()
    counts = kernels.launch_counts()
    assert counts.pop("me_gram_wide") == (2 if p > 3 else 0)
    assert all(n > 0 for n in counts.values())
