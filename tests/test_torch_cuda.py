"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and nvcc, carries the ``cuda`` marker and
skips elsewhere. The module imports neither JAX nor the JAX package, so it
runs on a machine without them; there, skip the JAX-based conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: Gram, lag sums and reductions rtol 1e-4 (summation order
only; a detect kernel's dot relative to sqrt(||e_u||^2 ||e_z||^2), see
``check_detect_tail``); the embed field's u_raw and max mask bit-identical
(the same rounded operations in the same order), and so are the
prediction error and the NVF mask; between the two routes, correlations
abs 2e-4 (3e-4 for NVF, as the JAX suite holds its fused NVF kernels) and
strengths rel 2e-4. The 8x8 solve kernel's
coefficients and valid flags equal its plain version's, bit for bit (the
same rounded operations in the same order), and so do the Gram's and the
solve's of ``me_gram_solve8``, whose assembly kernel solves with the same
device function, against ``spd_solve8(me_gram(x))``; the wide solve kernel's
coefficients are within 1e-4 of its plain version's (the wide solves'
bound: its 8-term sums stand for the plain version's matmuls, another
order) and its valid flags equal, its error against a float64 solve of
the frames' systems at most twice the plain blocked solve's. The embed
finish's pixels and strengths equal its plain version's, bit for bit, NaN
equal to NaN (the same rounded operations in the same order). The video pipeline's
pinned-buffer staging: its marked lumas equal a synchronous embed of the
same frames byte for byte.
"""

import io
import math

import numpy as np
import pytest
import torch

from watermarking_gpu_tpu_torch.io.config import Settings
from watermarking_gpu_tpu_torch.io.matfile import save_watermark
from watermarking_gpu_tpu_torch.models import BatchedWatermark, pad_to_batch
from watermarking_gpu_tpu_torch.ops import cuda as kernels
from watermarking_gpu_tpu_torch.ops import pipelines
from watermarking_gpu_tpu_torch.ops.cuda.detect_many import cluster_size
from watermarking_gpu_tpu_torch.ops.cuda.fused import (_mask_code,
                                                      detect_blocks)
from watermarking_gpu_tpu_torch.ops.me import (GRAM_STRIP_ROWS,
                                               solve_coefficients)
from watermarking_gpu_tpu_torch.ops.pipelines import _analysis
from watermarking_gpu_tpu_torch.video import (embed_video, frame_bytes,
                                              synthesize)

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


def check_embed_field(frames, wm, coeffs, mask_type, p):
    """The embed field against its plain version: u_raw and the max mask
    bit-identical, the sum of u_raw^2 within rtol 1e-4 (another summation
    order), and two calls bit-identical."""
    got = kernels.embed_field(frames, wm,
                              coeffs if mask_type == "me" else None,
                              mask_type, p)
    want = kernels.embed_field_plain(frames, wm, coeffs, mask_type, p)
    assert torch.equal(got[0], want[0]), float((got[0] - want[0]).abs().max())
    assert torch.equal(got[2], want[2])
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-6)
    again = kernels.embed_field(frames, wm,
                                coeffs if mask_type == "me" else None,
                                mask_type, p)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def check_detect_tail(frames, wm, coeffs, mask_type, p):
    """The detect tail against its plain version, two calls bit-identical,
    and its sum e_z^2 against the multi-candidate kernel's (the same e_z
    arithmetic, summed in another order).

    A dot is held as the correlation it becomes, dot / sqrt(||e_u||^2
    ||e_z||^2): for a watermark the frame does not carry it is a sum of
    terms that cancel to near 0, where the kernel's fused multiply-adds in
    e_u and its summation order move it by more than 1e-4 of itself, a
    change the correlation does not see. The norms are held as they are."""
    got = kernels.detect_partials(frames, wm, coeffs, mask_type, p)
    want = kernels.detect_partials_plain(frames, wm, coeffs, mask_type, p)
    scale = torch.sqrt(want[1] * want[2])
    torch.testing.assert_close(got[0] / scale, want[0] / scale, rtol=1e-4,
                               atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
    again = kernels.detect_partials(frames, wm, coeffs, mask_type, p)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    many = kernels.detect_many_partials(frames, wm[None], coeffs, mask_type,
                                        p)
    torch.testing.assert_close(got[2], many[2], rtol=1e-5, atol=1e-6)


# The pipelined detect tail of ME p = 3: the flagship batch, the 4K cell's,
# a frame smaller than two tiles each way, three 1080p frames, and nine
# frames, more than one chunk of eight
PIPELINED_SHAPES = [(8, 1080, 1920), (8, 2160, 3840), (1, 70, 130),
                    (3, 1080, 1920), (9, 150, 90)]


@pytest.mark.parametrize("shape", PIPELINED_SHAPES)
@pytest.mark.parametrize("mask_type", ["me", "nvf"])
def test_pipelined_detect_tail_on_card(device, shape, mask_type):
    """At ME p = 3 the detect tail takes the pipelined schedule: its sums
    against the plain version's and two calls bit-identical
    (``check_detect_tail``), every launch counted in
    ``detect_partials.pipelined``, and its partials one a block of a grid
    no larger than the frame's tiles that spreads them evenly (fewer
    blocks than tiles at 4K). NVF p = 3 and ME p = 5 keep a block a tile,
    and ``pipelined`` does not count NVF's launches."""
    frames, wm, coeffs = make_inputs(shape, device)
    me = mask_type == "me"
    c = coeffs if me else coeffs[:, :8]
    launches = kernels.detect_partials.launches
    pipelined = kernels.detect_partials.pipelined
    check_detect_tail(frames, wm, c, mask_type, 3)
    assert kernels.detect_partials.launches - launches == 2
    assert kernels.detect_partials.pipelined - pipelined == (2 if me else 0)
    rows, cols = shape[1:]
    tiles = -(-rows // 64) * -(-cols // 64)
    blocks = detect_blocks(device, rows, cols, _mask_code(mask_type, 3), 3)
    if me:
        rounds = -(-tiles // blocks)
        assert blocks <= tiles and blocks * (rounds - 1) < tiles
        if rows == 2160:
            assert blocks < tiles
    else:
        assert blocks == tiles
    assert detect_blocks(device, rows, cols, _mask_code("me", 5), 5) == tiles


def check_solve(gram):
    """The 8x8 solve kernel on a (B, 9, 9) Gram against its plain version:
    coefficients and valid bit-identical, one launch, two calls
    bit-identical. Returns the coefficients."""
    before = kernels.spd_solve8.launches
    got = kernels.spd_solve8(gram)
    assert kernels.spd_solve8.launches == before + 1
    want = kernels.spd_solve8_plain(gram)
    assert got[1].dtype == torch.bool and got[1].shape == want[1].shape
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0]), float((got[0] - want[0]).abs().max())
    again = kernels.spd_solve8(gram)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    return got[0]


def check_solve_wide(gram):
    """The wide solve kernel on a (B, k+1, k+1) Gram against its plain
    version: valid equal, coefficients within 1e-4, one launch, two calls
    bit-identical. Returns (coefficients, valid)."""
    before = kernels.spd_solve_wide.launches
    got = kernels.spd_solve_wide(gram)
    assert kernels.spd_solve_wide.launches == before + 1
    want = kernels.spd_solve_wide_plain(gram)
    assert got[1].dtype == torch.bool and got[1].shape == want[1].shape
    assert torch.equal(got[1], want[1]), (got[1], want[1])
    torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
    again = kernels.spd_solve_wide(gram)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    return got


def check_gram(frames):
    """The 3x3 Gram against the direct per-pair sums (rtol 1e-4), one launch
    of each of its two kernels a Gram, two calls bit-identical, and each
    kernel against its plain version on the same inputs: the lag kernel's
    strip sums, and the assembly kernel's Gram from the plain sums."""
    before = kernels.launch_counts()
    gram = kernels.me_gram(frames)
    torch.testing.assert_close(gram, kernels.me_gram_plain(frames),
                               rtol=1e-4, atol=0)
    after = kernels.launch_counts()
    assert after == {**before,
                     "me_gram_lags": before["me_gram_lags"] + 1,
                     "me_gram_assemble": before["me_gram_assemble"] + 1}
    assert torch.equal(kernels.me_gram(frames), gram)
    sums_plain = kernels.gram_lags_plain(frames)
    torch.testing.assert_close(kernels.me_gram_lags(frames), sums_plain,
                               rtol=1e-4, atol=1e-2)
    torch.testing.assert_close(
        kernels.me_gram_assemble(sums_plain, frames),
        kernels.assemble_lags_plain(sums_plain, frames), rtol=1e-4, atol=0)


# (1, 64, 64) is one tile of the embed field and the detect tail; (1, 65,
# 129) cuts a row and a column past it; (1, 150, 90) is taller than two
# tiles with rows no multiple of 4 floats, so its loads and stores of W and
# u_raw take the scalar path, as at (2, 37, 83) and (1, 45, 4). The 3x3
# Gram's lag kernel takes strips of GRAM_STRIP_ROWS rows and blocks of 512
# columns: "strip" is one strip, "strip-1" and "strip+1" a row less or a
# second strip of one row, each at 520 columns (a second column block of 8
# columns); (1, 5, 5) and (1, 6, 6) are smaller than the wide Gram's least
# lag-form frame.
@pytest.mark.parametrize("shape", [(3, 40, 96), (2, 37, 83), (2, 1, 5),
                                   (1, 45, 4), (1, 200, 300),
                                   (2, 1080, 1920), (1, 64, 64),
                                   (1, 65, 129), (1, 150, 90), "strip",
                                   "strip-1", "strip+1", (1, 5, 5),
                                   (1, 6, 6)])
def test_kernels_match_plain_on_card(device, shape):
    if isinstance(shape, str):
        shape = (2, GRAM_STRIP_ROWS + {"strip": 0, "strip-1": -1,
                                       "strip+1": 1}[shape], 520)
    frames, wm, coeffs = make_inputs(shape, device)
    before = kernels.launch_counts()
    check_gram(frames)
    check_solve(kernels.me_gram(frames))
    for mask_type in ("me", "nvf"):
        check_embed_field(frames, wm, coeffs, mask_type, 3)
        check_detect_tail(frames, wm, coeffs, mask_type, 3)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after == {**before,
                     "me_gram_lags": before["me_gram_lags"] + 4,
                     "me_gram_assemble": before["me_gram_assemble"] + 4,
                     "embed_field": before["embed_field"] + 4,
                     "detect_partials": before["detect_partials"] + 4,
                     "detect_many": before["detect_many"] + 2,
                     "spd_solve8": before["spd_solve8"] + 2}


def random_spd_grams(batch: int, seed: int, k: int = 8,
                     ridge: float = 1e4) -> torch.Tensor:
    """(batch, k+1, k+1) Grams A A^T of N(0, 1) A, scaled to a frame Gram's
    size (~1e7 on the diagonal) plus a ridge, all positive definite. The
    wide solves take ridge 1e5, a frame Gram's conditioning at p = 5-9
    (cond(Rx) ~2e2-1e3; see tests/test_torch_solve_wide.py)."""
    a = np.random.default_rng(seed).normal(size=(batch, k + 1, k + 1))
    gram = 3e5 * (a @ a.transpose(0, 2, 1)) + ridge * np.eye(k + 1)
    return torch.from_numpy(gram.astype(np.float32))


@pytest.mark.parametrize("case", ["8x1080x1920", 1, 8, 300])
def test_spd_solve8_matches_plain_on_card(device, case):
    """The 8x8 solve kernel against its plain version, bit for bit: on the
    Grams of 8 frames of 1080 x 1920, and on random SPD batches of 1, 8
    and 300 (three blocks of 128 systems); a constant frame's Gram and a
    zero system in a batch come back invalid with zero coefficients, as
    the plain version gives them."""
    if case == "8x1080x1920":
        frames, _, _ = make_inputs((8, 1080, 1920), device)
        gram = kernels.me_gram(frames)
    else:
        gram = random_spd_grams(case, case).to(device)
    coefficients = check_solve(gram)
    assert kernels.spd_solve8(gram)[1].all() and coefficients.abs().sum() > 0
    flat = kernels.me_gram(torch.full((1, 40, 96), 77.0, device=device))
    mixed = torch.cat([gram[:1], flat, torch.zeros_like(gram[:1])])
    got = check_solve(mixed.contiguous())
    assert kernels.spd_solve8(mixed)[1].tolist() == [True, False, False]
    assert not got[1:].any()


@pytest.mark.parametrize("case", ["8x1080x1920", 1, 8, 300])
@pytest.mark.parametrize("p", [5, 7, 9])
def test_spd_solve_wide_matches_plain_on_card(device, p, case):
    """The wide solve kernel against its plain version (the blocked
    Cholesky of ``solve_coefficients_spd_blocked``), TF32 off for the plain
    version's matmuls: on the wide Grams of 8 frames of 1080 x 1920, and on
    random SPD batches of 1, 8 and 300 (one block a system); a constant
    frame's wide Gram and a zero system in a batch come back invalid with
    zero coefficients, as the plain version gives them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    k = p * p - 1
    if case == "8x1080x1920":
        frames, _, _ = make_inputs((8, 1080, 1920), device)
        gram = kernels.me_gram_wide(frames, p)
    else:
        gram = random_spd_grams(case, case + p, k, ridge=1e5).to(device)
    coefficients, valid = check_solve_wide(gram)
    assert valid.all() and coefficients.abs().sum() > 0
    flat = kernels.me_gram_wide(torch.full((1, 40, 96), 77.0,
                                           device=device), p)
    mixed = torch.cat([gram[:1], flat, torch.zeros_like(gram[:1])])
    coefficients, valid = check_solve_wide(mixed.contiguous())
    assert valid.tolist() == [True, False, False]
    assert not coefficients[1:].any()


@pytest.mark.parametrize("p", [5, 7, 9])
def test_spd_solve_wide_accuracy_on_card(device, p):
    """The wide solve kernel on the wide Grams of 8 frames of 1080 x 1920,
    against a float64 ``torch.linalg.solve`` of the same systems: its
    largest error at most twice the plain blocked f32 solve's (TF32 off).
    A schedule of its own may not trade accuracy for speed; this check
    does not depend on the order of the sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    k = p * p - 1
    frames, _, _ = make_inputs((8, 1080, 1920), device)
    gram = kernels.me_gram_wide(frames, p)
    exact = torch.linalg.solve(gram[:, :k, :k].double(),
                               gram[:, :k, k].double())
    got, valid = kernels.spd_solve_wide(gram)
    plain, _ = kernels.spd_solve_wide_plain(gram)
    assert valid.all()
    kernel_err = float((got.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    assert kernel_err <= 2 * plain_err, (kernel_err, plain_err)


@pytest.mark.parametrize("shape", [(8, 1080, 1920), (3, 37, 83),
                                   (2, 64, 96)])
def test_spd_solve8_keeps_its_bits_on_card(device, shape):
    """``spd_solve8`` shares ``csrc/spd_solve.cu`` with the wide solve:
    on the 3x3 Grams of seeded frames it stays bit-identical to its plain
    version, the unrolled (B,)-vector Cholesky, as do two calls."""
    frames, _, _ = make_inputs(shape, device)
    check_solve(kernels.me_gram(frames))


def check_gram_solve(frames):
    """``me_gram_solve8`` on (B, H, W) frames against its two-call form
    ``spd_solve8(me_gram(x))``, bit for bit (Gram, coefficients, valid),
    and against the plain solve of its Gram; a lag kernel, an assembly
    kernel and one count of its own a call, no ``spd_solve8`` launch; two
    calls bit-identical. Returns (coefficients, valid)."""
    before = kernels.launch_counts()
    gram, coefficients, valid = kernels.me_gram_solve8(frames)
    after = kernels.launch_counts()
    assert after == {**before,
                     "me_gram_lags": before["me_gram_lags"] + 1,
                     "me_gram_assemble": before["me_gram_assemble"] + 1,
                     "me_gram_solve8": before["me_gram_solve8"] + 1}
    assert coefficients.shape == (frames.shape[0], 8)
    assert valid.dtype == torch.bool and valid.shape == (frames.shape[0],)
    want_gram = kernels.me_gram(frames)
    assert torch.equal(gram, want_gram)
    want = kernels.spd_solve8(want_gram)
    assert torch.equal(valid, want[1])
    assert torch.equal(coefficients, want[0]), float(
        (coefficients - want[0]).abs().max())
    plain = kernels.spd_solve8_plain(gram)
    assert torch.equal(valid, plain[1]) and torch.equal(coefficients,
                                                        plain[0])
    again = kernels.me_gram_solve8(frames)
    assert all(torch.equal(g, a) for g, a in
               zip((gram, coefficients, valid), again))
    return coefficients, valid


# 8 frames of 1080p (the main path's), one frame, an odd batch and a batch
# of hundreds (a service's, the calibration tool's): grid (13, B)
@pytest.mark.parametrize("shape", [(8, 1080, 1920), (1, 1080, 1920),
                                   (7, 200, 300), (300, 40, 96)])
def test_me_gram_solve8_matches_two_calls_on_card(device, shape):
    frames, _, _ = make_inputs(shape, device)
    coefficients, valid = check_gram_solve(frames)
    assert valid.all() and coefficients.abs().sum() > 0


@pytest.mark.parametrize("shape", [(3, 1080, 1920), (5, 40, 96)])
def test_me_gram_solve8_flags_a_constant_frame_on_card(device, shape):
    """A constant frame between real ones: exactly singular, so invalid
    with zero coefficients, as the two-call form and the plain solve give
    it; the others solve."""
    frames, _, _ = make_inputs(shape, device)
    frames[1] = 77.0
    coefficients, valid = check_gram_solve(frames)
    assert valid.tolist() == [i != 1 for i in range(shape[0])]
    assert not coefficients[1].any()


def test_me_gram_solve8_on_two_streams_at_once(device):
    """Two calls on two streams at once, each on its own batch, each with
    its own counter: the bits of the same calls one after the other."""
    first, _, _ = make_inputs((8, 1080, 1920), device, seed=1)
    second, _, _ = make_inputs((5, 720, 1280), device, seed=2)
    serial = [kernels.me_gram_solve8(x) for x in (first, second)]
    streams = [torch.cuda.Stream(device) for _ in range(2)]
    torch.cuda.synchronize()
    for _ in range(10):
        results = []
        for stream, x in zip(streams, (first, second)):
            with torch.cuda.stream(stream):
                results.append(kernels.me_gram_solve8(x))
        torch.cuda.synchronize()
        for got, want in zip(results, serial):
            assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("shape", [(3, 40, 96), (3, 1080, 1920)])
@pytest.mark.parametrize("p", [3, 5, 7, 9])
def test_singular_frame_soft_fails_on_card(device, p, shape):
    """A constant frame in a batch of three on the kernel route at ME p: at
    p=3 its Gram's 81 entries are the same bits (exactly singular); at p =
    5, 7, 9 the wide Gram and the blocked solve kernel flag it through IEEE
    arithmetic alone. Only that frame soft-fails (strength 0, pixels passed
    through, correlation 0), as
    tests/test_torch_pipeline.py::test_singular_frame_soft_fails holds on
    the CPU route."""
    frames, wm, _ = make_inputs((1, *shape[1:]), device)
    good = frames[0]
    flat = torch.full_like(good, 77.0)
    frames = torch.stack([good, flat, (good + 1.0).clamp(0, 255)])
    if p == 3:
        gram = kernels.me_gram(frames)
        assert gram[1].unique().numel() == 1
        assert gram[0].unique().numel() > 1
    else:
        _, valid = kernels.spd_solve_wide(kernels.me_gram_wide(frames, p))
        assert valid.tolist() == [True, False, True]
    marked, strength = pipelines.embed_pipeline(frames, frames, wm, 2.55,
                                                "me", p=p, impl="cuda")
    corr = pipelines.detect_pipeline(frames, wm, "me", p=p, impl="cuda")
    marked_corr = pipelines.detect_pipeline(marked, wm, "me", p=p,
                                            impl="cuda")
    assert strength[1] == 0.0 and (strength[[0, 2]] > 0).all()
    assert torch.equal(marked[1], flat)
    assert corr[1] == 0.0 and marked_corr[1] == 0.0
    assert (marked_corr[[0, 2]] > 0.02).all()


@pytest.mark.parametrize("shape", [(2, 64, 96), (2, 37, 83), (2, 20, 30),
                                   (1, 45, 4), (1, 200, 300),
                                   (1, 1080, 1920), "6h", (1, 64, 64),
                                   (1, 65, 129), (1, 150, 90)])
@pytest.mark.parametrize("p", [5, 7, 9])
def test_wide_kernels_match_plain_on_card(device, p, shape):
    """The wide Gram's two kernels, each against its plain version on the
    same inputs (the lag kernel's strip sums and edge lanes; the assembly
    kernel's Gram from the plain lag output), the Gram of both against the
    independent plain form, two calls bit-identical, and the embed field and
    detect tail at ME and NVF p, against their plain versions
    (``check_detect_tail``). "6h" is (1, 6h, 6h), the least frame of the lag
    form: one strip shorter than the default. (2, 20, 30) and (1, 45, 4)
    are below the lag geometry at p = 7 and 9, where the Gram takes the
    direct sums and launches nothing; a frame too small to solve at p gets
    coefficients of its own. (1, 45, 4) is narrower than a thread's 8
    outputs, and (1, 200, 300) has rows and columns that are no multiple of
    the detect tail's tile; (1, 64, 64), (1, 65, 129) and (1, 150, 90) as
    in ``test_kernels_match_plain_on_card``."""
    if shape == "6h":
        shape = (1, 6 * (p // 2), 6 * (p // 2))
    frames, wm, _ = make_inputs(shape, device)
    k = p * p - 1
    lag_form = min(shape[1:]) >= 6 * (p // 2)
    if lag_form:
        sums, edges = kernels.wide_lag_strips(frames, p)
        sums_plain, edges_plain = kernels.lag_strips_plain(frames, p)
        torch.testing.assert_close(sums, sums_plain, rtol=1e-4, atol=1e-2)
        torch.testing.assert_close(edges, edges_plain, rtol=1e-4, atol=1e-2)
        torch.testing.assert_close(
            kernels.wide_assemble(sums_plain, edges_plain,
                                  *kernels.frame_banks(frames, p), p,
                                  shape[1]),
            kernels.assemble_strips_plain(sums_plain, edges_plain,
                                          *kernels.frame_banks(frames, p),
                                          p), rtol=1e-4, atol=0)
        again = kernels.wide_lag_strips(frames, p)
        assert torch.equal(again[0], sums) and torch.equal(again[1], edges)
        torch.testing.assert_close(kernels.me_gram_wide(frames, p),
                                   kernels.me_gram_wide_plain(frames, p),
                                   rtol=1e-4, atol=0)
    before = kernels.launch_counts()
    gram = kernels.me_gram_wide(frames, p)
    plain = kernels.me_gram_wide(frames.cpu(), p).to(device)
    torch.testing.assert_close(gram, plain, rtol=1e-4, atol=0)
    assert torch.equal(kernels.me_gram_wide(frames, p), gram)
    after = kernels.launch_counts()
    for kernel in ("wide_lag_strips", "wide_assemble"):   # each one a Gram
        assert after[kernel] - before[kernel] == (2 if lag_form else 0)
    coeffs = {"me": _analysis(frames.cpu(), p)[0].to(device),
              "nvf": _analysis(frames.cpu(), 3)[0].to(device)}
    rng = np.random.default_rng(p)
    for mask_type in ("me", "nvf"):
        c = coeffs[mask_type]
        if not c.any():   # a frame too small to solve
            c = torch.from_numpy(rng.normal(0, 0.05, tuple(c.shape)).astype(
                np.float32)).to(device)
        check_embed_field(frames, wm, c, mask_type, p)
        check_detect_tail(frames, wm, c, mask_type, p)
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape,n", [((3, 40, 96), 10), ((2, 37, 83), 5),
                                     ((2, 1, 5), 3), ((2, 1080, 1920), 9),
                                     ((1, 40, 96), 64), ((9, 37, 83), 65),
                                     ((2, 45, 4), 130), ((2, 40, 256), 5),
                                     ((8, 1080, 1920), 64),
                                     ((8, 1080, 1920), 65),
                                     ((4, 40, 256), 10), ((6, 40, 256), 10),
                                     ((5, 40, 256), 10)])
@pytest.mark.parametrize("p", [3, 5, 7, 9])
def test_detect_many_matches_plain_on_card(device, p, shape, n):
    """The multi-candidate kernel against its plain version, with banks of
    part of a chunk of 64 (10, 5, 3, 9), a full chunk (64), a partial second
    chunk (65) and a partial third (130); one frame, four, five, six, eight
    and nine; a frame 4 pixels wide. Each candidate's sums also against the
    detect tail's for that watermark alone. Tiles whose rows lie inside the
    frame copy a 16-byte aligned bank in 16-byte chunks (at 40 x 256 and
    1080 x 1920), and at a 3 x 3 predictor (ME p=3, NVF) where the batch is
    even (2, 4, 6, 8 frames; not 1, 3, 5, 9) pairs of frames run as a
    cluster in which one bulk copy a row lands in both blocks:
    ``detect_many_partials.clustered`` counts exactly those launches. The
    same bank starting 4 bytes past an alignment boundary takes each
    block's 4-byte copies and must give the same sums.

    A dot is held as the correlation it becomes, dot / sqrt(||e_u||^2
    ||e_z||^2): for a candidate the frame does not carry it is a sum of
    terms that cancel to near 0, where the kernel's other summation order
    and its fused multiply-adds in e_u move it by more than 1e-4 of itself
    (up to 6.4e-4 on these inputs), a change the correlation does not see.
    The norms, sums of squares, are held as they are."""
    frames, _, _ = make_inputs(shape, device)
    rng = np.random.default_rng(p)
    bank = torch.from_numpy(rng.normal(size=(n,) + shape[1:]).astype(
        np.float32)).to(device)
    unaligned = torch.empty(bank.numel() + 1, device=device)[1:].view(
        bank.shape)
    unaligned.copy_(bank)
    assert unaligned.data_ptr() % 16 == 4
    for mask_type in ("me", "nvf"):
        pred_p = p if mask_type == "me" else 3
        coeffs = _analysis(frames.cpu(), pred_p)[0].to(device)
        before = kernels.launch_counts()
        clustered = kernels.detect_many_partials.clustered
        got = kernels.detect_many_partials(frames, bank, coeffs, mask_type, p)
        cluster = (2 if shape[0] % 2 == 0 and (mask_type == "nvf" or p == 3)
                   else 1)
        assert kernels.detect_many_partials.clustered == clustered + (
            cluster > 1)
        assert cluster_size(device, shape[0], _mask_code(mask_type, p),
                            p) == cluster
        want = kernels.detect_many_partials_plain(frames, bank, coeffs,
                                                  mask_type, p)
        scale = torch.sqrt(want[1] * want[2][:, None])
        torch.testing.assert_close(got[0] / scale, want[0] / scale,
                                   rtol=1e-4, atol=1e-6)
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
        for c in sorted({0, n // 2, n - 1}):
            tail = kernels.detect_partials(frames, bank[c], coeffs, mask_type,
                                           p)
            scale = torch.sqrt(tail[1] * tail[2])
            torch.testing.assert_close(got[0][:, c] / scale, tail[0] / scale,
                                       rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(got[1][:, c], tail[1], rtol=1e-5,
                                       atol=1e-6)
        torch.testing.assert_close(got[2], tail[2], rtol=1e-5, atol=1e-6)
        after = kernels.launch_counts()
        assert after["detect_many"] == before["detect_many"] + 1
        for g, u in zip(got, kernels.detect_many_partials(
                frames, unaligned, coeffs, mask_type, p)):
            assert torch.equal(g, u)
    torch.cuda.synchronize()


def standalone_frames(shape, device, seed=40961):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.clip(rng.normal(128, 40, shape), 0,
                                    255).astype(np.float32)).to(device)


@pytest.mark.parametrize("shape", [(3, 40, 96), (2, 37, 83), (2, 1, 5),
                                   (2, 1080, 1920), (2, 37, 1921),
                                   (2, 200, 40), (2, 30, 200), (130, 70)])
@pytest.mark.parametrize("p", [3, 5, 7, 9])
def test_standalone_ops_match_plain_on_card(device, p, shape):
    """Bit-identical to the plain versions (the same rounded operations in
    the same order): widths that are no multiple of 4, frames narrower and
    shorter than the kernels' 64 x 64 tile, the (H, W) form."""
    frames = standalone_frames(shape, device)
    rng = np.random.default_rng(p)
    coeffs = torch.from_numpy(rng.normal(0, 0.1, (*shape[:-2], p * p - 1))
                              .astype(np.float32)).to(device)
    before = kernels.launch_counts()
    assert torch.equal(kernels.prediction_error(frames, coeffs, p),
                       kernels.prediction_error_plain(frames, coeffs, p))
    assert torch.equal(kernels.nvf_mask(frames, p),
                       kernels.nvf_mask_plain(frames, p))
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after == {**before,
                     "prediction_error": before["prediction_error"] + 1,
                     "nvf_mask": before["nvf_mask"] + 1}


@pytest.mark.parametrize("shape", [(2, 37, 83), (2, 64, 1920)])
@pytest.mark.parametrize("p", [3, 9])
def test_standalone_ops_on_unaligned_frames(device, p, shape):
    """An image whose data pointer is 4 bytes past a 16-byte boundary (a
    view at an offset of one float) takes the kernels' 4-byte copies and
    scalar stores: the plain versions' bits all the same."""
    frames = standalone_frames(shape, device)
    store = torch.empty(frames.numel() + 1, device=device)
    store[1:] = frames.flatten()
    unaligned = store[1:].view(shape)
    assert unaligned.data_ptr() % 16 == 4 and unaligned.is_contiguous()
    coeffs = torch.from_numpy(np.random.default_rng(p).normal(
        0, 0.1, (shape[0], p * p - 1)).astype(np.float32)).to(device)
    for got in (kernels.prediction_error(unaligned, coeffs, p),
                kernels.prediction_error(frames, coeffs, p)):
        assert torch.equal(got, kernels.prediction_error_plain(frames,
                                                               coeffs, p))
    for got in (kernels.nvf_mask(unaligned, p), kernels.nvf_mask(frames, p)):
        assert torch.equal(got, kernels.nvf_mask_plain(frames, p))
    torch.cuda.synchronize()


def check_embed_finish(u_raw, output, sum_u2, max_e, valid, mask_type):
    """The embed finish against its plain version on the same inputs: the
    same bits and dtypes, NaN equal to NaN; one launch counted."""
    numerator = 2.55 * math.sqrt(u_raw.shape[-2] * u_raw.shape[-1])
    before = kernels.embed_finish.launches
    got = kernels.embed_finish(u_raw, output, sum_u2, max_e, valid,
                               numerator, mask_type)
    assert kernels.embed_finish.launches == before + 1
    want = kernels.embed_finish_plain(u_raw, output, sum_u2, max_e, valid,
                                      numerator, mask_type)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    return got


def finish_inputs(frames, wm, coeffs, mask_type, dtype, channels):
    """(u_raw, output, sum_u2, max_e, valid) from the embed field of the
    frames, frame 1's solve failed where there is one, the output the
    frames (whole values for uint8) or three channels of them."""
    u_raw, sum_u2, max_e = kernels.embed_field(
        frames, wm, coeffs if mask_type == "me" else None, mask_type)
    valid = torch.ones(frames.shape[0], dtype=torch.bool,
                       device=frames.device)
    valid[1:2] = False
    output = torch.floor(frames)
    if channels:
        output = torch.stack([output, 255 - output, output // 2], dim=-1)
    return u_raw, output.to(dtype).contiguous(), sum_u2, max_e, valid


@pytest.mark.parametrize("shape", [(3, 40, 96), (2, 37, 83), (2, 1, 5),
                                   (1, 45, 4), (3, 64, 1920)])
@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("mask_type", ["me", "nvf"])
def test_embed_finish_matches_plain_on_card(device, mask_type, dtype,
                                            channels, shape):
    """At small and odd shapes (the kernel's scalar path) and at rows of
    1920 (its 16-byte path), f32 and uint8 outputs, one or three channels,
    a frame whose solve failed passed through with strength 0."""
    frames, wm, coeffs = make_inputs(shape, device)
    inputs = finish_inputs(frames, wm, coeffs, mask_type, dtype, channels)
    marked, strength = check_embed_finish(*inputs, mask_type)
    assert marked.dtype == dtype and marked.shape == inputs[1].shape
    if shape[0] > 1:
        assert strength[1] == 0.0 and torch.equal(marked[1], inputs[1][1])
    # a 2-D frame
    check_embed_finish(*(x[0] for x in inputs), mask_type)


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("shape", [(2, 37, 83), (2, 64, 1920)])
def test_embed_finish_passes_nan_through_on_card(device, shape, dtype):
    """An NVF constant frame: u_raw and sum u_raw^2 are 0, the scale inf,
    the pixels NaN (uint8: the cast of NaN), as in the plain version."""
    frames, wm, coeffs = make_inputs(shape, device)
    frames[1] = 77.0
    u_raw, output, sum_u2, max_e, valid = finish_inputs(
        frames, wm, coeffs, "nvf", dtype, None)
    valid[:] = True
    assert float(sum_u2[1]) == 0.0
    marked, strength = check_embed_finish(u_raw, output, sum_u2, max_e,
                                          valid, "nvf")
    assert math.isinf(float(strength[1]))
    if dtype == torch.float32:
        assert bool(marked[1].isnan().all())
        assert bool(marked[0].isfinite().all())


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
    with pytest.raises(ValueError, match="bank"):
        kernels.detect_many_partials(frames, wm[None, :8],
                                     torch.zeros(2, 8, device=device))
    with pytest.raises(ValueError, match="coefficients"):
        kernels.detect_many_partials(frames, wm[None],
                                     torch.zeros(2, 8, device=device),
                                     "me", 5)
    with pytest.raises(ValueError, match="coefficients"):
        kernels.prediction_error(frames, torch.zeros(2, 8, device=device), 5)
    with pytest.raises(ValueError, match="p must be one of"):
        kernels.nvf_mask(frames, 11)
    vec = torch.ones(2, device=device)
    valid = torch.ones(2, dtype=torch.bool, device=device)
    with pytest.raises(ValueError, match="output"):
        kernels.embed_finish(frames, frames.double(), vec, vec, valid, 1.0,
                             "me")
    with pytest.raises(ValueError, match="valid"):
        kernels.embed_finish(frames, frames, vec, vec, vec, 1.0, "me")


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
    bank = torch.stack([engine.random_matrix,
                        torch.flip(engine.random_matrix, (0,))])
    scores = engine.detect_many(marked, bank)
    assert scores.shape == (2, 2) and scores.is_cuda
    torch.testing.assert_close(scores[:, 0], corr, rtol=0, atol=1e-5)
    counts = kernels.launch_counts()
    assert counts.pop("wide_lag_strips") == counts.pop("wide_assemble") == (
        3 if p > 3 else 0)
    # ME embed, detect and detect_many at p=5 (the wide solve)
    assert counts.pop("spd_solve_wide") == (3 if p > 3 else 0)
    # ME embed, detect and detect_many, NVF detect at p=3; NVF detect alone
    # at p=5 (its 3x3 predictor): the Gram with the solve in its assembly,
    # never the solve kernel alone on a single device
    assert counts["me_gram_solve8"] == (4 if p == 3 else 1)
    assert counts.pop("spd_solve8") == 0
    assert counts.pop("prediction_error") == counts.pop("nvf_mask") == 0
    assert all(n > 0 for n in counts.values())


@pytest.mark.parametrize("interval", [1, 5])
def test_embed_video_on_card_matches_synchronous_embed(device, tmp_path,
                                                      interval):
    """On the card the pipeline stages lumas in pinned buffers and copies
    results back on a side stream: its marked lumas must equal one
    synchronous ``embed_luma_u8`` of the same frames, byte for byte (a
    pinned buffer reused while a copy still reads it would differ)."""
    rows, cols, count = 240, 320, 24
    clip_path = tmp_path / "clip.yuv"
    clip_path.write_bytes(synthesize(cols, rows, count, seed=4))
    wm_path = tmp_path / "w.dat"
    save_watermark(wm_path, np.random.default_rng(2).normal(
        size=(rows, cols)).astype(np.float32))
    out_path = tmp_path / "marked.yuv"
    settings = Settings(video=str(clip_path), watermark=str(wm_path), p=3,
                        psnr=40.0, watermark_interval=interval,
                        embed_batch=4, raw_video_size=f"{cols}x{rows}",
                        encode_watermark_file_path=str(out_path))
    engine = BatchedWatermark(rows, cols, str(wm_path), p=3, psnr=40.0,
                              device=device)
    assert embed_video(settings, engine=engine, out=io.StringIO()) == count
    fb = frame_bytes(cols, rows)
    original = np.frombuffer(clip_path.read_bytes(), np.uint8).reshape(-1,
                                                                      fb)
    marked = np.frombuffer(out_path.read_bytes(), np.uint8).reshape(-1, fb)
    np.testing.assert_array_equal(marked[:, rows * cols:],
                                  original[:, rows * cols:])
    sampled = original[::interval, :rows * cols].reshape(-1, rows, cols)
    for start in range(0, len(sampled), 4):
        want, _ = engine.embed_luma_u8(pad_to_batch(sampled[start:start + 4],
                                                    4))
        got = marked[::interval][start:start + 4, :rows * cols]
        np.testing.assert_array_equal(
            got.reshape(-1, rows, cols),
            want[:len(got)].cpu().numpy())
    np.testing.assert_array_equal(
        np.delete(marked, np.s_[::interval], axis=0),
        np.delete(original, np.s_[::interval], axis=0))


def extended(frames: torch.Tensor, start: int, stop: int, halo: int):
    """Rows [start - halo, stop + halo) of the edge-replicated frames: a
    shard as ``parallel.exchange_row_halo`` extends it."""
    rows = torch.nn.functional.pad(
        frames.reshape(-1, 1, *frames.shape[-2:]), (0, 0, halo, halo),
        mode="replicate").reshape(*frames.shape[:-2], -1, frames.shape[-1])
    return rows[..., start:stop + 2 * halo, :].contiguous()


# A frame cut into shards of `rows` rows: the top shard, one in the
# interior and the bottom one; (3, 40, 96) in 4 of 10 rows (a shard shorter
# than a tile and than a Gram strip), (2, 150, 90) in 2 of 75 rows (two
# tiles, rows no multiple of 4 floats), (1, 270 * 3, 520) in 3 of 270 (the
# main path's shard height, a second column block of the Gram), (8, 120,
# 256) in 3 of 40 (eight frames: the multi-candidate kernel's clusters, with
# tiles whose rows are whole chunks)
HALO_SHAPES = {(3, 40, 96): 10, (2, 150, 90): 75, (1, 810, 520): 270,
               (8, 120, 256): 40}


@pytest.mark.parametrize("shape", list(HALO_SHAPES))
@pytest.mark.parametrize("mask_type,p", [("me", 3), ("me", 5), ("me", 9),
                                         ("nvf", 3), ("nvf", 5), ("nvf", 9)])
def test_halo_kernels_match_plain_on_card(device, shape, mask_type, p):
    """The halo forms of the 3x3 Gram's two kernels, the embed field, the
    detect tail and the multi-candidate kernel (5 candidates) against their
    plain halo forms on the same extended shards, at each shard position
    (the frame's top, the interior and its bottom, with the halo each
    kernel reads; the Gram at the detect tail's halo and at the embed
    field's, as the routes give it); the shards' Grams summed against the
    frame's at each halo, and their multi-candidate sums against the
    frame's; the embed field's u_raw bit-identical. At ME p > 3 also the
    wide Gram's lag kernel at the detect tail's 2h halo against its plain
    halo form, the shards' sums folded and assembled with the frame's banks
    by the assembly kernel against its plain version and the frame's wide
    Gram. The multi-candidate launches of an even batch at a 3 x 3
    predictor run in clusters (``detect_many_partials.clustered``): at 8
    frames of 256 columns the interior tiles share each candidate's copy,
    clamped rows and seams included. At ME p = 3 the detect tail's halo
    form takes the pipelined schedule (``detect_partials.pipelined``); two
    of its calls give the same bits."""
    frames, wm, coeffs = make_inputs(shape, device)
    if mask_type == "me" and p != 3:
        coeffs = torch.zeros(shape[0], p * p - 1, device=device)
        coeffs[:, (p * p - 1) // 2] = 0.5
    c = coeffs if mask_type == "me" else coeffs[:, :8]
    rows = HALO_SHAPES[shape]
    total = shape[1]
    reach = kernels.stencil_reach(mask_type, p)
    half = max(1, p // 2)
    wide = mask_type == "me" and p != 3
    bank = torch.from_numpy(np.random.default_rng(p).normal(
        size=(5,) + shape[1:]).astype(np.float32)).to(device)
    grams = {halo: [] for halo in {half, reach}}
    many, strips = [], []
    clustered = kernels.detect_many_partials.clustered
    for start in range(0, total, rows):
        stop = start + rows
        ext = extended(frames, start, stop, reach)
        w_ext = extended(wm, start, stop, reach)
        where = (mask_type, p, reach, reach, start, total)
        b_ext = extended(bank, start, stop, reach)
        got = kernels.detect_many_partials(ext, b_ext, c, *where)
        want = kernels.detect_many_partials_plain(ext, b_ext, c, *where)
        scale = torch.sqrt(want[1] * want[2][:, None])
        torch.testing.assert_close(got[0] / scale, want[0] / scale,
                                   rtol=1e-4, atol=1e-6)
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
        many.append(got)
        if wide:
            got = kernels.wide_lag_strips(ext, p, reach, reach, start, total)
            want = kernels.lag_strips_plain(ext, p, reach, reach)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-2)
            strips.append((got[0].sum(dim=(2, 3), keepdim=True),
                           got[1].sum(dim=2, keepdim=True)))
        for halo, parts in grams.items():
            g_ext = extended(frames, start, stop, halo)
            where = (g_ext, halo, halo, start, total)
            plain_sums = kernels.gram_lags_plain(g_ext, halo, halo)
            torch.testing.assert_close(kernels.me_gram_lags(*where),
                                       plain_sums, rtol=1e-4, atol=1e-2)
            torch.testing.assert_close(
                kernels.me_gram_assemble(plain_sums, *where),
                kernels.assemble_lags_plain(plain_sums, g_ext, halo, halo),
                rtol=1e-4, atol=0)
            gram = kernels.me_gram(*where)
            torch.testing.assert_close(
                gram, kernels.me_gram_plain(g_ext, halo, halo), rtol=1e-4,
                atol=0)
            parts.append(gram)
        e_ext = extended(frames, start, stop, half)
        got = kernels.embed_field(e_ext, wm[start:stop],
                                  coeffs if mask_type == "me" else None,
                                  mask_type, p, half, half)
        want = kernels.embed_field_plain(e_ext, wm[start:stop], coeffs,
                                         mask_type, p, half, half)
        assert torch.equal(got[0], want[0]), float(
            (got[0] - want[0]).abs().max())
        assert torch.equal(got[2], want[2])
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-6)
        pipelined = kernels.detect_partials.pipelined
        got = kernels.detect_partials(ext, w_ext, coeffs if mask_type == "me"
                                      else coeffs[:, :8], mask_type, p,
                                      reach, reach, start, total)
        assert kernels.detect_partials.pipelined - pipelined == (
            mask_type == "me" and p == 3)
        again = kernels.detect_partials(
            ext, w_ext, coeffs if mask_type == "me" else coeffs[:, :8],
            mask_type, p, reach, reach, start, total)
        assert all(torch.equal(g, a) for g, a in zip(got, again))
        want = kernels.detect_partials_plain(
            ext, w_ext, coeffs if mask_type == "me" else coeffs[:, :8],
            mask_type, p, reach, reach, start, total)
        scale = torch.sqrt(want[1] * want[2])
        torch.testing.assert_close(got[0] / scale, want[0] / scale,
                                   rtol=1e-4, atol=1e-6)
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)
    frame_gram = kernels.me_gram(frames)
    for parts in grams.values():
        torch.testing.assert_close(sum(parts), frame_gram, rtol=1e-4, atol=0)
    dot, norm_u, norm_z = (sum(parts) for parts in zip(*many))
    want = kernels.detect_many_partials(frames, bank, c, mask_type, p)
    scale = torch.sqrt(want[1] * want[2][:, None])
    torch.testing.assert_close(dot / scale, want[0] / scale, rtol=1e-4,
                               atol=1e-6)
    torch.testing.assert_close(norm_u, want[1], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(norm_z, want[2], rtol=1e-4, atol=1e-6)
    # every multi-candidate launch of an even batch at a 3 x 3 predictor
    # runs in clusters
    assert kernels.detect_many_partials.clustered - clustered == (
        len(many) + 1 if shape[0] % 2 == 0 and (mask_type == "nvf" or p == 3)
        else 0)
    if wide:
        folded = [sum(parts) for parts in zip(*strips)]
        banks = kernels.frame_banks(frames, p)
        gram = kernels.wide_assemble(*folded, *banks, p, total)
        torch.testing.assert_close(
            gram, kernels.assemble_strips_plain(*folded, *banks, p),
            rtol=1e-4, atol=0)
        torch.testing.assert_close(gram, kernels.me_gram_wide(frames, p),
                                   rtol=1e-4, atol=0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("mask_type,p", [("me", 3), ("nvf", 3), ("nvf", 5)])
def test_hybrid_matches_single_device_on_card(device, mask_type, p):
    """Hybrid embed then detect on a data=2 x space=2 mesh of one card,
    through the halo-form kernels, against the single-device kernel route:
    correlations within 1e-4, strengths 1e-4 relative, pixels 1e-2."""
    from watermarking_gpu_tpu_torch.parallel import (make_hybrid_detect,
                                                     make_hybrid_embed,
                                                     make_mesh)
    frames, wm, _ = make_inputs((4, 120, 200), device)
    mesh = make_mesh(2, 2, devices=[device] * 4)
    before = kernels.launch_counts()
    marked, strength = make_hybrid_embed(mesh, mask_type, 2.55, p=p)(
        frames, frames, wm)
    corr = make_hybrid_detect(mesh, mask_type, p=p)(marked.gather(), wm)
    after = kernels.launch_counts()
    want_marked, want_s = pipelines.embed_pipeline(frames, frames, wm, 2.55,
                                                   mask_type, p=p)
    want_corr = pipelines.detect_pipeline(want_marked, wm, mask_type, p=p)
    torch.testing.assert_close(marked.gather(), want_marked, atol=1e-2,
                               rtol=0)
    torch.testing.assert_close(strength.gather(), want_s, rtol=1e-4, atol=0)
    torch.testing.assert_close(corr.gather(), want_corr, atol=1e-4, rtol=0)
    # per data row, one launch a space shard: the embed field and the
    # detect tail, and the 3x3 Gram's two kernels (twice for ME)
    assert after["embed_field"] - before["embed_field"] == 4
    assert after["detect_partials"] - before["detect_partials"] == 4
    grams = 8 if mask_type == "me" else 4
    assert after["me_gram_lags"] - before["me_gram_lags"] == grams
    assert after["me_gram_assemble"] - before["me_gram_assemble"] == grams
    # one solve a space row, of the embed (ME) and of the detect
    assert after["spd_solve8"] - before["spd_solve8"] == grams // 2
    # the embed finish once a shard
    assert after["embed_finish"] - before["embed_finish"] == 4


@pytest.mark.parametrize("p", [5, 9])
def test_wide_and_identify_routes_match_single_device_on_card(device, p):
    """On one card: hybrid embed then detect at ME p on a data=2 x space=2
    mesh and spatial detect over 12 shards of 10 rows (shorter than 3h at
    p=9: the banks from a 3h exchange) through the wide Gram's halo form,
    and mesh identification (data=2 x space=2) at ME p and NVF p=3,
    against the single-device kernel route (correlations 1e-4, strengths
    1e-4 relative, pixels 1e-2); each halo-form kernel launched once a
    shard, the wide Gram's assembly and the wide solve once a space
    row."""
    from watermarking_gpu_tpu_torch.parallel import (make_hybrid_detect,
                                                     make_hybrid_embed,
                                                     make_mesh,
                                                     make_mesh_detect_many,
                                                     make_spatial_detect)
    frames, wm, _ = make_inputs((4, 120, 200), device)
    mesh = make_mesh(2, 2, devices=[device] * 4)
    kernels.reset_launch_counts()
    marked, strength = make_hybrid_embed(mesh, "me", 2.55, p=p)(
        frames, frames, wm)
    corr = make_hybrid_detect(mesh, "me", p=p)(marked.gather(), wm)
    counts = {k: n for k, n in kernels.launch_counts().items() if n}
    assert counts == {"wide_lag_strips": 8, "wide_assemble": 4,
                      "spd_solve_wide": 4, "embed_field": 4,
                      "embed_finish": 4, "detect_partials": 4}
    want_marked, want_s = pipelines.embed_pipeline(frames, frames, wm, 2.55,
                                                   "me", p=p)
    want_corr = pipelines.detect_pipeline(want_marked, wm, "me", p=p)
    torch.testing.assert_close(marked.gather(), want_marked, atol=1e-2,
                               rtol=0)
    torch.testing.assert_close(strength.gather(), want_s, rtol=1e-4, atol=0)
    torch.testing.assert_close(corr.gather(), want_corr, atol=1e-4, rtol=0)

    kernels.reset_launch_counts()
    spatial = make_spatial_detect(make_mesh(1, 12, devices=[device] * 12),
                                  "me", p=p)(want_marked[0], wm)
    counts = {k: n for k, n in kernels.launch_counts().items() if n}
    assert counts == {"wide_lag_strips": 12, "wide_assemble": 1,
                      "spd_solve_wide": 1, "detect_partials": 12}
    assert abs(float(spatial) - float(want_corr[0])) <= 1e-4

    rng = np.random.default_rng(p)
    bank = torch.from_numpy(np.concatenate([
        wm.cpu().numpy()[None],
        rng.normal(size=(5, 120, 200)).astype(np.float32)])).to(device)
    for mask_type, pm in (("me", p), ("nvf", 3)):
        kernels.reset_launch_counts()
        scores = make_mesh_detect_many(mesh, mask_type, p=pm)(
            want_marked[0], bank).gather()
        counts = {k: n for k, n in kernels.launch_counts().items() if n}
        gram = ({"wide_lag_strips": 4, "wide_assemble": 2,
                 "spd_solve_wide": 2} if mask_type == "me"
                else {"me_gram_lags": 4, "me_gram_assemble": 4,
                      "spd_solve8": 2})
        assert counts == {**gram, "detect_many": 4}
        want = pipelines.detect_many_pipeline(want_marked[0], bank,
                                              mask_type, p=pm)
        torch.testing.assert_close(scores, want, atol=1e-4, rtol=0)
        assert int(scores.argmax()) == 0


def test_mesh_across_cards_matches_one_card(device):
    """Where the machine has four cards: the hybrid (2 x 2), spatial (1 x
    4) and DP (4) routes over four distinct cards, whose halo rows and
    reductions are copies between devices, give the bits of the same mesh
    on one card. Skips on fewer cards."""
    from watermarking_gpu_tpu_torch.parallel import (make_dp_detect,
                                                     make_hybrid_detect,
                                                     make_hybrid_embed,
                                                     make_mesh,
                                                     make_spatial_detect)
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    frames, wm, _ = make_inputs((4, 240, 320), device)
    cards = [torch.device("cuda", i) for i in range(4)]
    one = [device] * 4
    results = []
    for devices in (cards, one):
        hybrid = make_mesh(2, 2, devices=devices)
        marked, strength = make_hybrid_embed(hybrid, "me", 2.55)(
            frames, frames, wm)
        corr = make_hybrid_detect(hybrid, "nvf", p=5)(marked, wm)
        spatial = make_spatial_detect(make_mesh(1, 4, devices=devices),
                                      "me")(marked.gather()[0], wm)
        dp = make_dp_detect(make_mesh(4, devices=devices), "me", p=5)(
            marked.gather(), wm)
        assert {str(d) for row in hybrid.devices for d in row} == \
            {str(d) for d in devices}
        results.append([t.gather("cpu") for t in (marked, strength, corr,
                                                   spatial, dp)])
    for got, want in zip(*results):
        assert torch.equal(got, want)
