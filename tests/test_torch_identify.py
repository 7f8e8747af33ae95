"""Watermark identification in the port (``detect_many_pipeline``,
``Watermark.detect_many``, the multi-candidate kernel's plain version and
the standalone prediction-error and NVF ops) against the JAX package, with
the same numpy frames and banks fed to both.

Tolerances: correlations atol 3e-4, the JAX suite's bound for detect_many
(tests/test_engine.py::test_detect_many_matches_looped_detect); the
multi-candidate partials rtol 1e-4 (summation order only); the standalone
ops as tests/test_pallas.py holds their Pallas kernels to the oracle
(atol 1e-3 for the prediction error, 5e-3 for the NVF mask); chunked
against unchunked 1e-6 (the same sums, cut differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from watermarking_gpu_tpu.ops import pipelines as jp
from watermarking_gpu_tpu.ops.pallas.fused import fused_detect_many_partials
from watermarking_gpu_tpu.ops.pallas.nvf_kernel import nvf_mask_pallas
from watermarking_gpu_tpu.ops.pallas.predict_kernel import \
    prediction_error_pallas
from watermarking_gpu_tpu_torch.models import BatchedWatermark, Watermark
from watermarking_gpu_tpu_torch.ops import cuda as kernels
from watermarking_gpu_tpu_torch.ops import pipelines as tp

torch.set_num_threads(1)

CORR_ATOL = 3e-4


def frames(shape, seed=40961):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(128, 40, shape), 0, 255).astype(np.float32)


def bank(n, rows, cols, seed=7):
    return np.random.default_rng(seed).normal(size=(n, rows, cols)).astype(
        np.float32)


def marked_stack(rows, cols, wm, seed=40961):
    """Two frames carrying ``wm`` at amplitude 3, and one clean."""
    clean = frames((3, rows, cols), seed)
    clean[:2] = np.clip(clean[:2] + 3.0 * wm, 0, 255)
    return clean


@pytest.mark.parametrize("mask_type,p", [("me", 3), ("me", 5), ("nvf", 3)])
def test_cuda_route_matches_pallas(mask_type, p):
    """impl="cuda" (the kernel's plain version on the CPU) against the JAX
    fused multi-candidate kernel in interpret mode, (B, N) and (N,)."""
    rows, cols, n = 72, 96, 5
    assert jp.fused_detect_many_applies(n, rows, cols, mask_type, p,
                                        "pallas")
    wms = bank(n, rows, cols)
    imgs = marked_stack(rows, cols, wms[2])[:2]
    got = tp.detect_many_pipeline(torch.from_numpy(imgs),
                                  torch.from_numpy(wms), mask_type, p, "cuda")
    want = jp.detect_many_pipeline(jnp.asarray(imgs), jnp.asarray(wms),
                                   mask_type, p, "pallas")
    assert got.shape == (2, n)
    np.testing.assert_allclose(got.numpy(), want, atol=CORR_ATOL)
    single = tp.detect_many_pipeline(torch.from_numpy(imgs[0]),
                                     torch.from_numpy(wms), mask_type, p,
                                     "cuda")
    assert single.shape == (n,)
    np.testing.assert_allclose(single.numpy(), got[0].numpy(), atol=1e-6)
    assert int(got[0].argmax()) == 2


@pytest.mark.parametrize("p", [3, 5, 7, 9])
@pytest.mark.parametrize("mask_type", ["me", "nvf"])
def test_torch_route_matches_xla(mask_type, p):
    rows, cols, n = 37, 83, 10
    wms = bank(n, rows, cols, seed=100 + p)
    imgs = marked_stack(rows, cols, wms[4], seed=p)[1:]
    got = tp.detect_many_pipeline(torch.from_numpy(imgs),
                                  torch.from_numpy(wms), mask_type, p,
                                  "torch")
    want = jp.detect_many_pipeline(jnp.asarray(imgs), jnp.asarray(wms),
                                   mask_type, p, "xla")
    np.testing.assert_allclose(got.numpy(), want, atol=CORR_ATOL)
    assert int(got[0].argmax()) == 4


@pytest.mark.parametrize("impl", ["cuda", "torch"])
@pytest.mark.parametrize("mask_type,p", [("me", 3), ("me", 7), ("nvf", 5)])
def test_detect_many_matches_looped_detect(mask_type, p, impl):
    rows, cols, n = 37, 83, 5
    wms = bank(n, rows, cols, seed=11)
    imgs = torch.from_numpy(marked_stack(rows, cols, wms[1])[:2])
    got = tp.detect_many_pipeline(imgs, torch.from_numpy(wms), mask_type, p,
                                  impl)
    looped = torch.stack([tp.detect_pipeline(imgs, torch.from_numpy(wm),
                                             mask_type, p, impl)
                          for wm in wms], dim=-1)
    assert got.shape == looped.shape == (2, n)
    np.testing.assert_allclose(got.numpy(), looped.numpy(), atol=CORR_ATOL)


def test_embedded_candidate_wins_argmax():
    """An engine's embed, then detect_many against a bank holding its
    watermark among decoys, embedded at PSNR 30: the embedded candidate wins
    every marked frame, at least twice the best decoy (at 96 x 128 a
    correlation with an absent watermark has a spread of about
    1/sqrt(12288) = 0.009); the clean frame correlates with none."""
    rows, cols = 96, 128
    engine = BatchedWatermark(rows, cols, 3, p=5, psnr=30.0, device="cpu")
    decoys = bank(9, rows, cols, seed=5)
    candidates = np.concatenate([decoys[:6],
                                 engine.random_matrix.numpy()[None],
                                 decoys[6:]])
    clean = torch.from_numpy(frames((3, rows, cols), seed=9))
    for mask_type in ("me", "nvf"):
        marked, _ = engine.embed(clean, mask_type=mask_type)
        scores = engine.detect_many(torch.cat([marked, clean[:1]]),
                                    candidates, mask_type)
        assert scores.shape == (4, 10)
        assert (scores[:3].argmax(dim=1) == 6).all()
        assert scores[:3, 6].min() > 2 * scores[:3].abs().sort(
            dim=1).values[:, -2].max()
        assert scores[3].abs().max() < 0.5 * scores[:3, 6].min()


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_chunked_detect_many_equals_unchunked(monkeypatch, impl):
    """A budget of 3 candidates a dispatch cuts 10 into 3 + 3 + 3 + 1 (the
    last padded to 3 and sliced back)."""
    rows, cols, n = 37, 83, 10
    engine = BatchedWatermark(rows, cols, 5, p=3, impl=impl, device="cpu")
    imgs = frames((2, rows, cols), seed=3)
    wms = bank(n, rows, cols, seed=103)
    whole = engine.detect_many(imgs, wms)
    calls = []
    original = tp.detect_many_pipeline

    def counted(image, watermarks, *args, **kwargs):
        calls.append(watermarks.shape[0])
        return original(image, watermarks, *args, **kwargs)

    monkeypatch.setattr("watermarking_gpu_tpu_torch.models.watermark."
                        "detect_many_pipeline", counted)
    monkeypatch.setattr(Watermark, "_DETECT_MANY_BUDGET_BYTES",
                        3 * Watermark._PLAIN_PLANES * 2 * 4 * rows * cols)
    chunked = engine.detect_many(imgs, wms)
    assert calls == [3, 3, 3, 3]
    assert chunked.shape == whole.shape == (2, n)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-6)


def test_bank_on_the_device_is_used_in_place(monkeypatch):
    engine = Watermark(37, 83, 5, p=3, device="cpu")
    wms = torch.from_numpy(bank(4, 37, 83))
    seen = []
    original = tp.detect_many_pipeline

    def spy(image, watermarks, *args, **kwargs):
        seen.append(watermarks)
        return original(image, watermarks, *args, **kwargs)

    monkeypatch.setattr("watermarking_gpu_tpu_torch.models.watermark."
                        "detect_many_pipeline", spy)
    scores = engine.detect_many(frames((37, 83)), wms)
    assert scores.shape == (4,)
    assert seen[0].data_ptr() == wms.data_ptr()


def test_cpu_tensors_count_no_launch_and_no_cluster():
    """CPU tensors take the plain version: neither ``launches`` nor
    ``clustered`` counts; ``launch_counts`` leaves ``clustered`` out and
    ``reset_launch_counts`` zeroes it."""
    kernels.detect_many_partials.clustered = 3
    before = kernels.launch_counts()
    imgs = torch.from_numpy(frames((8, 37, 83)))
    coeffs = torch.full((8, 8), 0.125)
    kernels.detect_many_partials(imgs, torch.from_numpy(bank(3, 37, 83)),
                                 coeffs, "me", 3)
    assert kernels.launch_counts() == before
    assert kernels.detect_many_partials.clustered == 3
    assert "clustered" not in kernels.launch_counts()
    kernels.reset_launch_counts()
    assert kernels.detect_many_partials.clustered == 0
    assert not any(kernels.launch_counts().values())


def test_detect_many_shape_checks():
    engine = Watermark(37, 83, 5, p=3, device="cpu")
    wms = bank(2, 37, 83)
    with pytest.raises(ValueError, match="Images must be"):
        engine.detect_many(frames((37, 84)), wms)
    with pytest.raises(ValueError, match="Images must be"):
        engine.detect_many(frames((1, 2, 37, 83)), wms)
    with pytest.raises(ValueError, match="Candidate watermarks"):
        engine.detect_many(frames((37, 83)), wms[0])
    with pytest.raises(ValueError, match="Candidate watermarks"):
        engine.detect_many(frames((37, 83)), wms[:, :, :80])


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_constant_frame_gives_zeros(impl):
    """An unsolvable (constant) frame scores 0 against every candidate,
    beside a frame that solves."""
    imgs = np.stack([np.full((37, 83), 77.0, np.float32),
                     frames((37, 83), seed=2)])
    wms = torch.from_numpy(bank(5, 37, 83))
    for mask_type, p in (("me", 3), ("me", 5), ("nvf", 3)):
        got = tp.detect_many_pipeline(torch.from_numpy(imgs), wms, mask_type,
                                      p, impl)
        assert not got[0].any()
        assert got[1].abs().min() > 0


@pytest.mark.parametrize("mask_type,p", [("me", 3), ("me", 5), ("nvf", 5)])
def test_partials_plain_match_pallas(mask_type, p):
    """The kernel's plain version against the JAX fused_detect_many_partials
    (interpret mode) on the same frames, bank and coefficients; 9
    candidates leave the TPU kernel a padded last chunk."""
    rows, cols, n = 72, 96, 9
    imgs = frames((2, rows, cols), seed=p)
    wms = bank(n, rows, cols, seed=100 + p)
    coeffs, _ = tp._analysis(torch.from_numpy(imgs),
                             p if mask_type == "me" else 3)
    got = kernels.detect_many_partials_plain(
        torch.from_numpy(imgs), torch.from_numpy(wms), coeffs, mask_type, p)
    want = fused_detect_many_partials(jnp.asarray(imgs), jnp.asarray(wms),
                                      jnp.asarray(coeffs.numpy()), mask_type,
                                      p)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4)


@pytest.mark.parametrize("p", [3, 5, 7, 9])
def test_standalone_plain_ops_match_pallas(p):
    """The standalone ops' plain versions (what the wrappers run on CPU
    tensors) against prediction_error_pallas and nvf_mask_pallas, strip=16
    as tests/test_pallas.py runs them."""
    imgs = frames((2, 40, 96), seed=p)
    coeffs = np.random.default_rng(p).normal(0, 0.1, (2, p * p - 1)).astype(
        np.float32)
    got = kernels.prediction_error(torch.from_numpy(imgs),
                                   torch.from_numpy(coeffs), p)
    want = prediction_error_pallas(jnp.asarray(imgs), jnp.asarray(coeffs),
                                   strip=16, p=p)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    got = kernels.nvf_mask(torch.from_numpy(imgs), p)
    want = nvf_mask_pallas(jnp.asarray(imgs), p=p, strip=16)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3)


@pytest.mark.parametrize("p", [3, 5, 7, 9])
def test_standalone_ops_take_one_frame_as_pallas_does(p):
    """The (H, W) form with (p*p-1,) coefficients, as prediction_error_pallas
    and nvf_mask_pallas take one frame: an (H, W) result, against theirs."""
    img = frames((40, 96), seed=10 + p)
    coeffs = np.random.default_rng(p).normal(0, 0.1, p * p - 1).astype(
        np.float32)
    got = kernels.prediction_error(torch.from_numpy(img),
                                   torch.from_numpy(coeffs), p)
    want = prediction_error_pallas(jnp.asarray(img), jnp.asarray(coeffs),
                                   strip=16, p=p)
    assert got.shape == want.shape == img.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    got = kernels.nvf_mask(torch.from_numpy(img), p)
    want = nvf_mask_pallas(jnp.asarray(img), p=p, strip=16)
    assert got.shape == want.shape == img.shape
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3)
