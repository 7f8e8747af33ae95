"""The fused embed and detect as one call into the kernel library
(``ops/cuda/chain.py``), on the card, against the per-wrapper route (the
same kernels called one by one, the frames' sums and the correlation's
division in torch) and the plain route (``impl="torch"``).

Every test here needs an NVIDIA GPU and nvcc, carries the ``cuda`` marker
and skips elsewhere; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_chain.py

Tolerances are those of ``tests/test_torch_cuda.py``: against either route
pixels abs 0.1, strengths rel 2e-4, correlations abs 2e-4 (3e-4 for NVF);
uint8 pixels within one step of the truncating cast, the others equal; a
frame whose solve fails keeps its pixels bit for bit, with a strength and
a correlation of 0. The chain against itself (two calls, two streams at
once, a 2-D frame against a batch of one): bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from watermarking_gpu_tpu_torch.models import (batch_detect, batch_embed,
                                               batch_embed_luma_u8)
from watermarking_gpu_tpu_torch.ops import cuda as kernels
from watermarking_gpu_tpu_torch.ops import pipelines
from watermarking_gpu_tpu_torch.ops.cuda import chain
from watermarking_gpu_tpu_torch.ops.cuda.fused import predictor_p

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

SF = 2.55   # strength factor of PSNR 40, as the route tests take it


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; on the card run "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_chain.py")
    return torch.device("cuda")


def make_inputs(shape, device, seed=40961):
    rng = np.random.default_rng(seed)
    frames = np.clip(rng.normal(128, 40, shape), 0, 255).astype(np.float32)
    wm = rng.normal(size=shape[-2:]).astype(np.float32)
    return torch.from_numpy(frames).to(device), torch.from_numpy(wm).to(device)


def per_wrapper_embed(frames, output, wm, mask_type, p):
    """The parent's formulation of the fused embed: the wrappers one by
    one, the frames' sums by torch."""
    if mask_type == "me":
        coefficients, valid = pipelines._fused_analysis(frames, p)
    else:
        coefficients = None
        valid = torch.ones(frames.shape[0], dtype=torch.bool,
                           device=frames.device)
    u_raw, sum_u2, max_e = kernels.embed_field(frames, wm, coefficients,
                                               mask_type, p)
    n = frames.shape[-2] * frames.shape[-1]
    return kernels.embed_finish(u_raw, output, sum_u2, max_e, valid,
                                SF * math.sqrt(n), mask_type)


def per_wrapper_detect(frames, wm, mask_type, p):
    coefficients, valid = pipelines._fused_analysis(
        frames, predictor_p(mask_type, p))
    dot, norm_u, norm_z = kernels.detect_partials(frames, wm, coefficients,
                                                  mask_type, p)
    return torch.where(valid, dot / torch.sqrt(norm_u * norm_z), 0.0)


def close(got, want, mask_type):
    """The route tolerances: (marked, strength, corr)."""
    torch.testing.assert_close(got[0], want[0], atol=0.1, rtol=0)
    torch.testing.assert_close(got[1], want[1], rtol=2e-4, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=0,
                               atol=2e-4 if mask_type == "me" else 3e-4)


def chain_step(frames, wm, mask_type, p):
    """One embed then one detect of the marked frames, on the chain; checks
    that both took it, each kernel's count +1 and the chain's +1."""
    before = kernels.launch_counts()
    marked, strength = pipelines.embed_pipeline(frames, frames, wm, SF,
                                                mask_type, p=p, impl="cuda")
    middle = kernels.launch_counts()
    corr = pipelines.detect_pipeline(marked, wm, mask_type, p=p,
                                     impl="cuda")
    after = kernels.launch_counts()
    me, wide = mask_type == "me", predictor_p(mask_type, p) > 3
    analysis = ({"wide_lag_strips": 1, "wide_assemble": 1,
                 "spd_solve_wide": 1} if wide else
                {"me_gram_lags": 1, "me_gram_assemble": 1,
                 "me_gram_solve8": 1})
    embed = {**(analysis if me else {}), "embed_field": 1,
             "embed_finish": 1, "embed_chain": 1}
    detect = {**analysis, "detect_partials": 1, "detect_chain": 1}
    for start, end, want in ((before, middle, embed),
                             (middle, after, detect)):
        assert {name: end[name] - start[name] for name in end} == {
            name: want.get(name, 0) for name in end}
    return marked, strength, corr


# ME at p = 3 on the flagship batch, the wide predictors, and NVF (whose
# detect takes the 3x3 predictor at every p)
CASES = [("me", 3, (8, 1080, 1920)), ("me", 5, (2, 1080, 1920)),
         ("me", 9, (2, 1080, 1920)), ("nvf", 3, (8, 1080, 1920)),
         ("nvf", 7, (2, 1080, 1920)), ("me", 3, (3, 37, 83)),
         ("me", 5, (2, 64, 96)), ("nvf", 5, (2, 150, 90))]


@pytest.mark.parametrize("mask_type, p, shape", CASES)
def test_chain_matches_both_routes_on_card(device, mask_type, p, shape):
    frames, wm = make_inputs(shape, device)
    got = chain_step(frames, wm, mask_type, p)
    marked, strength = per_wrapper_embed(frames, frames, wm, mask_type, p)
    wrappers = (marked, strength, per_wrapper_detect(marked, wm, mask_type,
                                                     p))
    close(got, wrappers, mask_type)
    marked, strength = pipelines.embed_pipeline(frames, frames, wm, SF,
                                                mask_type, p=p, impl="torch")
    plain = (marked, strength, pipelines.detect_pipeline(
        marked, wm, mask_type, p=p, impl="torch"))
    close(got, plain, mask_type)
    if shape[1] == 1080:
        assert (got[2] > 0.02).all()
    again = chain_step(frames, wm, mask_type, p)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("shape", [(8, 2160, 3840), (9, 150, 90),
                                   (1, 70, 130)])
@pytest.mark.parametrize("mask_type", ["me", "nvf"])
def test_chain_detect_pipelined_on_card(device, mask_type, shape):
    """At ME p = 3 the chain's detect tail takes the pipelined schedule,
    each frame finished by its last block over the grid's blocks (NVF p = 3
    keeps a block a tile): on the 4K cell's batch, nine frames (two chunks)
    and one small frame, its correlations equal the per-wrapper route's up
    to the order of the blocks' sums (abs 1e-6), two calls give the same
    bits, and at ME ``detect_partials.pipelined`` counts every launch
    (``detect_partials.launches``), at NVF none."""
    frames, wm = make_inputs(shape, device)
    marked, _ = pipelines.embed_pipeline(frames, frames, wm, SF, mask_type,
                                         p=3, impl="cuda")
    launches = kernels.detect_partials.launches
    pipelined = kernels.detect_partials.pipelined
    chains = kernels.detect_chain.launches
    got = pipelines.detect_pipeline(marked, wm, mask_type, p=3, impl="cuda")
    again = pipelines.detect_pipeline(marked, wm, mask_type, p=3,
                                      impl="cuda")
    assert kernels.detect_chain.launches - chains == 2
    assert kernels.detect_partials.launches - launches == 2
    assert kernels.detect_partials.pipelined - pipelined == (
        2 if mask_type == "me" else 0)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, per_wrapper_detect(marked, wm, mask_type,
                                                       3), rtol=0, atol=1e-6)
    if shape[1] >= 1080:
        assert (got > 0.02).all()


@pytest.mark.parametrize("mask_type, p", [("me", 3), ("nvf", 3), ("me", 5)])
def test_chain_u8_lumas_on_card(device, mask_type, p):
    """uint8 lumas through ``batch_embed_luma_u8`` (the video's embed):
    the chain's bytes against the per-wrapper route's, and its strengths."""
    frames, wm = make_inputs((4, 1080, 1920), device)
    lumas = frames.to(torch.uint8)
    before = kernels.launch_counts()["embed_chain"]
    marked, strength = batch_embed_luma_u8(lumas, wm, SF, mask_type, p=p)
    assert kernels.launch_counts()["embed_chain"] == before + 1
    want, want_strength = per_wrapper_embed(lumas.float(), lumas, wm,
                                            mask_type, p)
    assert marked.dtype == torch.uint8
    step = (marked.int() - want.int()).abs()
    assert int(step.max()) <= 1
    assert float((step > 0).float().mean()) < 1e-4
    torch.testing.assert_close(strength, want_strength, rtol=2e-4, atol=0)
    again, _ = batch_embed_luma_u8(lumas, wm, SF, mask_type, p=p)
    assert torch.equal(again, marked)


@pytest.mark.parametrize("mask_type, p", [("me", 3), ("nvf", 3), ("me", 7)])
def test_chain_one_frame_and_2d_on_card(device, mask_type, p):
    """A batch of one and the same frame as an (H, W) tensor (the single
    engine's input): the same bits, () strength and correlation."""
    frames, wm = make_inputs((1, 1080, 1920), device)
    batch = chain_step(frames, wm, mask_type, p)
    single = chain_step(frames[0], wm, mask_type, p)
    assert single[0].shape == (1080, 1920)
    assert single[1].shape == () and single[2].shape == ()
    assert torch.equal(single[0], batch[0][0])
    assert torch.equal(single[1], batch[1][0])
    assert torch.equal(single[2], batch[2][0])
    marked, strength = per_wrapper_embed(frames, frames, wm, mask_type, p)
    close(batch, (marked, strength,
                  per_wrapper_detect(marked, wm, mask_type, p)), mask_type)


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("shape", [(3, 1080, 1920), (3, 40, 96)])
def test_chain_constant_frame_on_card(device, p, shape):
    """A constant frame between real ones: its solve fails, so it keeps
    its pixels bit for bit, with a strength and a correlation of 0; the
    others are marked and detected."""
    frames, wm = make_inputs(shape, device)
    frames[1] = 77.0
    marked, strength, corr = chain_step(frames, wm, "me", p)
    assert torch.equal(marked[1], frames[1])
    assert strength[1] == 0.0 and corr[1] == 0.0
    assert (strength[[0, 2]] > 0).all() and (corr[[0, 2]] > 0.02).all()
    assert pipelines.detect_pipeline(frames, wm, "me", p=p)[1] == 0.0


def test_chains_on_two_streams_at_once(device):
    """An embed and a detect on each of two streams at once, each with its
    own scratch and counters: the bits of the same calls one after the
    other, over ten rounds."""
    first, wm_first = make_inputs((8, 1080, 1920), device, seed=1)
    second, wm_second = make_inputs((5, 720, 1280), device, seed=2)
    work = ((first, wm_first), (second, wm_second))

    def step(frames, wm):
        marked, strength = pipelines.embed_pipeline(frames, frames, wm, SF,
                                                    "me", p=3)
        return marked, strength, pipelines.detect_pipeline(marked, wm, "me",
                                                           p=3)

    serial = [step(*args) for args in work]
    streams = [torch.cuda.Stream(device) for _ in range(2)]
    torch.cuda.synchronize()
    for _ in range(10):
        results = []
        for stream, args in zip(streams, work):
            with torch.cuda.stream(stream):
                results.append(step(*args))
        torch.cuda.synchronize()
        for got, want in zip(results, serial):
            assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("mask_type", ["nvf", "me"])
def test_nvf_counters_on_card(device, mask_type):
    """One bulk step (``batch_embed`` then ``batch_detect``) at NVF p = 3
    counts one launch in ``embed_field.nvf`` and one in
    ``detect_partials.nvf``, both through the chains; at ME none. The
    wrappers called one by one count NVF's launches too."""
    frames, wm = make_inputs((8, 150, 90), device)
    names = ("embed_field", "detect_partials")
    nvf = [getattr(kernels, name).nvf for name in names]
    chains = [kernels.embed_chain.launches, kernels.detect_chain.launches]
    marked, _ = batch_embed(frames, frames, wm, SF, mask_type, p=3,
                            impl="cuda")
    batch_detect(marked, wm, mask_type, p=3, impl="cuda")
    torch.cuda.synchronize()
    want = 1 if mask_type == "nvf" else 0
    assert [getattr(kernels, name).nvf - n
            for name, n in zip(names, nvf)] == [want, want]
    assert [kernels.embed_chain.launches - chains[0],
            kernels.detect_chain.launches - chains[1]] == [1, 1]
    per_wrapper_embed(frames, frames, wm, mask_type, 3)
    per_wrapper_detect(marked, wm, mask_type, 3)
    assert [getattr(kernels, name).nvf - n
            for name, n in zip(names, nvf)] == [2 * want, 2 * want]


def test_chain_rejects_bad_inputs_on_card(device):
    frames, wm = make_inputs((2, 64, 96), device)
    with pytest.raises(ValueError, match="watermark"):
        chain.detect_chain(frames, wm.t().contiguous(), "me", 3)
    with pytest.raises(ValueError, match="output"):
        chain.embed_chain(frames, frames.double(), wm, 1.0, "me", 3)
    with pytest.raises(ValueError, match="frames"):
        chain.embed_chain(frames.cpu(), frames, wm, 1.0, "me", 3)
    small, small_wm = make_inputs((2, 11, 30), device)   # rows < 6h
    assert not chain.applies(small, "me", 5, detect=True)
    with pytest.raises(ValueError, match="wide"):
        chain.detect_chain(small, small_wm, "me", 5)
    # the per-wrapper route still takes such frames
    assert pipelines.detect_pipeline(small, small_wm, "me", p=5).shape == (2,)
