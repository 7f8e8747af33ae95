#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``watermarking_gpu_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port still starts and is right.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises, exits non-zero and
prints no result:

1. Card and build: the device, ``nvidia-smi``'s name and power limit, and
   the ``nvcc`` build of the kernels in ``watermarking_gpu_tpu_torch/csrc``
   (seconds and ptxas' register report).
2. Each kernel against its plain PyTorch version on the card, with the same
   inputs and coefficients, at 8 x 1080 x 1920 and at 3 x 37 x 83: the p=3
   kernels, then for p = 5, 7, 9 the wide Gram's lag partials (and the
   assembled Gram against the direct per-pair sums ``gram_direct(p)``) and
   the embed field and detect tail at ME and NVF p.
3. The main paths, through ``BatchedWatermark(1080, 1920, 28390211, p=P,
   psnr=40, device="cuda")``. P=3: ME and NVF embed then detect of 8
   frames, ``embed_luma_u8`` and one single-frame ``Watermark`` round trip.
   P = 5, 7, 9: ME and NVF embed then detect of 8 frames. Each is held to
   numbers the JAX package computed on the CPU from the same frames, and
   its kernels' launch counters are zeroed just before it and read just
   after.
4. Timing with CUDA events: the chained 8-frame ME embed+detect step at
   each P through the kernels and through the plain path
   (``impl="torch"``), and each kernel beside its plain version.

The line before the last is ``{"kernels": [...]}``, one row per kernel,
window and mask (the 3x3 Gram serves both masks): launches in its part of
phase 3;
``max_abs_err`` of its main output against the plain version at
8 x 1080 x 1920 (the Gram or lag partials, u_raw, or the correlation formed
from the detect sums) and ``max_rel_err`` of its reductions; ``ms`` and
``plain_ms`` per call from phase 4; ``bound_ms``, the least time an H100
could take for the same work (the larger of the bytes the function must
move over 3.35 TB/s and the flops it needs over 67 TFLOP/s f32, NVIDIA's
data-sheet peaks for the SXM part at 700 W; see ``kernel_bound``), and
``bound_by``; ``library_ms`` is null:
no single PyTorch call computes any of these functions. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from watermarking_gpu_tpu_torch.io.matfile import generate_watermark
from watermarking_gpu_tpu_torch.models import (BatchedWatermark, Watermark,
                                               batch_detect, batch_embed)
from watermarking_gpu_tpu_torch.ops import cuda as kernels
from watermarking_gpu_tpu_torch.ops import strength_factor
from watermarking_gpu_tpu_torch.ops.cuda import build
from watermarking_gpu_tpu_torch.ops.me import (gram_direct,
                                               solve_coefficients_spd,
                                               solve_coefficients_spd_wide)

ROWS, COLS, BATCH = 1080, 1920, 8
SEED = 28390211
PSNR = 40.0
WIDE_P = (5, 7, 9)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12     # f32 outside the tensor cores, same source

# Computed by the JAX package (watermarking_gpu_tpu, impl="xla") on the CPU,
# one frame at a time, from the frames and watermark that make_frames() and
# generate_watermark(1080, 1920, 28390211) give: embed_pipeline(frame,
# frame, W, strength_factor(40), mask) then detect_pipeline on the marked
# frame ("corr") and on the clean one ("clean_corr"); "mean_abs_delta" is
# mean |marked - frame|. "me_u8" embeds the frames cast to uint8 and casts
# the result back to uint8 (truncating).
JAX_REFERENCE = {
    "frames_sum": 2127014255.5961576,
    "me": {
        "strength": [10.706743240356445, 10.706520080566406,
                     10.706610679626465, 10.707474708557129,
                     10.706766128540039, 10.706572532653809,
                     10.707093238830566, 10.706589698791504],
        "corr": [0.13074883818626404, 0.13076546788215637,
                 0.13074840605258942, 0.13080045580863953,
                 0.13076841831207275, 0.1307523250579834,
                 0.13076342642307281, 0.13075754046440125],
        "mean_abs_delta": [1.6156273201944724, 1.6157802817127567,
                           1.615622029445236, 1.6160395073253209,
                           1.6158047360612475, 1.6156615490358808,
                           1.6157427543337355, 1.6157054546424696],
    },
    "nvf": {
        "strength": [2.553189992904663, 2.553189992904663,
                     2.553189992904663, 2.553190231323242,
                     2.553189992904663, 2.553189992904663,
                     2.553190231323242, 2.553189992904663],
        "corr": [0.06462904810905457, 0.0646330863237381,
                 0.06462892889976501, 0.06463669240474701,
                 0.0646338239312172, 0.064629927277565,
                 0.06463057547807693, 0.06463112682104111],
        "mean_abs_delta": [2.0325648297515926, 2.0326819066460313,
                           2.0325606220547505, 2.032841983144328,
                           2.032699196783202, 2.03259215299706,
                           2.0326479242823163, 2.0326265540114474],
    },
    "me_u8": {
        "strength": [10.698214530944824, 10.727865219116211,
                     10.698201179504395, 10.729479789733887,
                     10.720473289489746, 10.697701454162598,
                     10.698346138000488, 10.68286418914795],
        "mean_abs_delta": [1.6994970100308642, 1.6995259452160494,
                           1.6994854359567901, 1.7001277970679012,
                           1.699543788580247, 1.6995703125,
                           1.6999247685185186, 1.6995326967592592],
    },
}

# The same for P = 5, 7, 9, all 8 frames, from
#   JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py \
#       --p 5 7 9 --frames 0 1 2 3 4 5 6 7
JAX_WIDE_REFERENCE = {
    5: {
        "me": {
            "strength": [10.088834762573242, 10.089303016662598,
                         10.088798522949219, 10.007281303405762,
                         10.089421272277832, 10.088908195495605,
                         10.055027961730957, 10.0890474319458],
            "corr": [0.12827302515506744, 0.1282902956008911,
                     0.12827244400978088, 0.1283298283815384,
                     0.1282932013273239, 0.1282767951488495,
                     0.12828974425792694, 0.12828174233436584],
            "mean_abs_delta": [1.6152876519250259, 1.615447103638708,
                               1.6152825645781281, 1.615697948185459,
                               1.6154733346169097, 1.615323500880694,
                               1.615400571262654, 1.6153693855779654],
        },
        "nvf": {
            "strength": [2.552610397338867, 2.552610397338867,
                         2.552610397338867, 2.552610397338867,
                         2.552610397338867, 2.552610397338867,
                         2.552610397338867, 2.552610397338867],
            "corr": [0.06461669504642487, 0.06462077796459198,
                     0.0646166130900383, 0.0646243616938591,
                     0.06462150812149048, 0.06461761146783829,
                     0.06461821496486664, 0.06461882591247559],
            "mean_abs_delta": [2.0325663602744433, 2.0326834053138305,
                               2.0325621527784508, 2.0328432373400895,
                               2.0327006896469815, 2.0325936807500327,
                               2.032649253510137, 2.032628071746634],
        },
    },
    7: {
        "me": {
            "strength": [9.470010757446289, 9.440211296081543,
                         9.470980644226074, 9.49244499206543,
                         9.434946060180664, 9.463724136352539,
                         9.491991996765137, 9.45527458190918],
            "corr": [0.12710100412368774, 0.12711866199970245,
                     0.12710042297840118, 0.12715749442577362,
                     0.1271214634180069, 0.12710483372211456,
                     0.12711752951145172, 0.12710988521575928],
            "mean_abs_delta": [1.615406949580266, 1.6155679808788714,
                               1.615401570267902, 1.6158163605163263,
                               1.6155942020545293, 1.6154431767315809,
                               1.6155189048585048, 1.6154893037404745],
        },
        "nvf": {
            "strength": [2.552497148513794, 2.552497148513794,
                         2.552497148513794, 2.552497148513794,
                         2.552497148513794, 2.552497148513794,
                         2.552497148513794, 2.552497148513794],
            "corr": [0.06461482495069504, 0.06461887806653976,
                     0.06461469829082489, 0.0646224319934845,
                     0.06461960822343826, 0.06461571156978607,
                     0.06461633741855621, 0.06461691111326218],
            "mean_abs_delta": [2.032566341327555, 2.0326833731329708,
                               2.03256213584161, 2.032843185270155,
                               2.032700653080498, 2.0325936613941313,
                               2.0326492300022796, 2.0326280453682726],
        },
    },
    9: {
        "me": {
            "strength": [9.16611385345459, 9.166438102722168,
                         9.166096687316895, 9.083864212036133,
                         9.16649341583252, 9.166177749633789,
                         9.132115364074707, 9.166282653808594],
            "corr": [0.12679250538349152, 0.126810222864151,
                     0.1267918050289154, 0.12684974074363708,
                     0.12681306898593903, 0.12679627537727356,
                     0.12680929899215698, 0.12680146098136902],
            "mean_abs_delta": [1.6154609294366997, 1.6156222270424536,
                               1.6154552915988758, 1.615872051904167,
                               1.6156482324947568, 1.6154968522238276,
                               1.6155734406892992, 1.6155435678432695],
        },
        "nvf": {
            "strength": [2.552454948425293, 2.552454948425293,
                         2.552454948425293, 2.552454948425293,
                         2.552454948425293, 2.552454948425293,
                         2.552454948425293, 2.552454948425293],
            "corr": [0.06461425125598907, 0.0646183118224144,
                     0.06461413949728012, 0.06462185084819794,
                     0.0646190494298935, 0.0646151527762413,
                     0.06461576372385025, 0.06461632251739502],
            "mean_abs_delta": [2.0325664777418004, 2.032683500275691,
                               2.032562271590829, 2.032843302154097,
                               2.0327007798182084, 2.0325937955326583,
                               2.0326493606796516, 2.032628178687099],
        },
    },
}

# Tolerances. Kernels against their plain versions: u_raw and the per-pixel
# terms round identically (see csrc/common.cuh), so only summation order
# differs; the sums get rtol 1e-4. Against the JAX CPU numbers: the
# 1080-row bounds of the JAX package's own multi-device checks
# (__graft_entry__.py:192-195) — the f32 Gram's reduction order moves the
# coefficients through cond(Rx) ~1e4.
U_RAW_RTOL, U_RAW_ATOL = 1e-5, 1e-3
SUM_RTOL = 1e-4
CORR_ATOL = 5e-4
STRENGTH_RTOL = 5e-3
PIXEL_ATOL, PIXEL_RTOL = 1e-2, 1e-2

KERNEL_SOURCES = {
    "me_gram": ("watermarking_gpu_tpu_torch/csrc/me_gram.cu",
                "watermarking_gpu_tpu/ops/pallas/me_kernel.py:101"),
    "me_gram_wide": ("watermarking_gpu_tpu_torch/csrc/me_gram_wide.cu",
                     "watermarking_gpu_tpu/ops/pallas/me_gram_wide.py:182"),
    "embed_field": ("watermarking_gpu_tpu_torch/csrc/fused.cu",
                    "watermarking_gpu_tpu/ops/pallas/fused.py:885"),
    "detect_partials": ("watermarking_gpu_tpu_torch/csrc/fused.cu",
                        "watermarking_gpu_tpu/ops/pallas/fused.py:300"),
}
P3_KERNELS = ("me_gram", "embed_field", "detect_partials")


class SmokeFailure(RuntimeError):
    pass


def check(condition, message: str) -> None:
    if not condition:
        raise SmokeFailure(message)


def make_frames() -> np.ndarray:
    """The 8 frames bench.py makes when the 1080p sample is absent."""
    rng = np.random.default_rng(0)
    base = np.clip(rng.normal(128, 40, size=(ROWS, COLS)), 0,
                   255).astype(np.float32)
    rng = np.random.default_rng(1)
    jitter = rng.normal(0, 1, size=(BATCH, 1, 1)).astype(np.float32)
    return np.clip(base[None] + jitter, 0, 255).astype(np.float32)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


def phase_card_and_build() -> str:
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is False: this smoke run needs a GPU")
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {kind} (count {torch.cuda.device_count()}); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    # the port uses no matmul or convolution, but state the f32 modes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.perf_counter()
    path, log = build.build()
    build.library()
    seconds = time.perf_counter() - start
    print(f"[1] kernels built in {seconds:.1f} s -> {path}", flush=True)
    for line in log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"[1]   ptxas: {line.strip()}", flush=True)
    return kind


def phase_kernels(frames_d: torch.Tensor, wm_d: torch.Tensor) -> dict:
    """Each kernel against its plain version; returns per-kernel errors at
    the main path's shape."""
    errors = {}
    gen = np.random.default_rng(5)
    small = torch.from_numpy(np.clip(gen.normal(128, 40, (3, 37, 83)), 0,
                                     255).astype(np.float32)).cuda()
    small_wm = torch.from_numpy(
        gen.normal(size=(37, 83)).astype(np.float32)).cuda()
    for img, wm in ((frames_d, wm_d), (small, small_wm)):
        label = "x".join(str(n) for n in img.shape)
        main_shape = img is frames_d
        before = kernels.launch_counts()
        gram = kernels.me_gram(img)
        gram_plain = kernels.me_gram_plain(img)
        check(torch.allclose(gram, gram_plain, rtol=SUM_RTOL, atol=0),
              f"me_gram {label}: rel err {rel_err(gram, gram_plain):.3e}")
        coeffs, valid = solve_coefficients_spd(gram_plain[:, :8, :8],
                                               gram_plain[:, :8, 8])
        check(bool(valid.all()), f"{label}: solve flagged a frame singular")
        if main_shape:
            errors["me_gram"] = (float((gram - gram_plain).abs().max()),
                                 rel_err(gram, gram_plain))
        worst_u = worst_sum = worst_corr = worst_detect = 0.0
        for mask in ("me", "nvf"):
            u_err = sums_err = corr_err = detect_err = 0.0
            got = kernels.embed_field(img, wm, coeffs if mask == "me"
                                      else None, mask)
            want = kernels.embed_field_plain(img, wm, coeffs, mask)
            check(torch.allclose(got[0], want[0], rtol=U_RAW_RTOL,
                                 atol=U_RAW_ATOL),
                  f"embed_field {mask} {label}: u_raw max abs err "
                  f"{float((got[0] - want[0]).abs().max()):.3e}")
            for g, w in zip(got[1:], want[1:]):
                check(torch.allclose(g, w, rtol=SUM_RTOL, atol=0),
                      f"embed_field {mask} {label}: reduction rel err "
                      f"{rel_err(g, w):.3e}")
                sums_err = max(sums_err, rel_err(g, w))
            u_err = float((got[0] - want[0]).abs().max())

            got = kernels.detect_partials(img, wm, coeffs, mask)
            want = kernels.detect_partials_plain(img, wm, coeffs, mask)
            for g, w in zip(got, want):
                check(torch.allclose(g, w, rtol=SUM_RTOL, atol=0),
                      f"detect_partials {mask} {label}: rel err "
                      f"{rel_err(g, w):.3e}")
                detect_err = max(detect_err, rel_err(g, w))
            corr = got[0] / torch.sqrt(got[1] * got[2])
            corr_plain = want[0] / torch.sqrt(want[1] * want[2])
            corr_err = float((corr - corr_plain).abs().max())
            worst_u, worst_sum = max(worst_u, u_err), max(worst_sum, sums_err)
            worst_corr = max(worst_corr, corr_err)
            worst_detect = max(worst_detect, detect_err)
            if main_shape:
                suffix = "" if mask == "me" else "_nvf_p3"
                errors["embed_field" + suffix] = (u_err, sums_err)
                errors["detect_partials" + suffix] = (corr_err, detect_err)
        after = kernels.launch_counts()
        check(all(after[k] > before[k] for k in P3_KERNELS),
              f"{label}: a launch counter did not rise: {before} -> {after}")
        torch.cuda.synchronize()
        print(f"[2] {label}: me_gram rel {rel_err(gram, gram_plain):.2e}; "
              f"embed_field u_raw abs {worst_u:.2e}, sums rel "
              f"{worst_sum:.2e}; detect_partials sums rel "
              f"{worst_detect:.2e}, corr abs {worst_corr:.2e}: ok",
              flush=True)
    return errors


def _close(got, want, atol=0.0, rtol=0.0) -> bool:
    return bool(np.all(np.abs(np.asarray(got) - np.asarray(want))
                       <= atol + rtol * np.abs(np.asarray(want))))


def phase_main_path(frames: np.ndarray) -> dict[str, dict]:
    """The p=3 main path; returns the launch counts of the whole run
    ("all") and of its NVF embed and detects ("nvf")."""
    engine = BatchedWatermark(ROWS, COLS, SEED, p=3, psnr=PSNR,
                              device="cuda")
    frames_d = torch.from_numpy(frames).cuda()
    lumas_d = torch.from_numpy(frames.astype(np.uint8)).cuda()
    single = Watermark(ROWS, COLS, SEED, p=3, psnr=PSNR, device="cuda")
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    results, part = {}, {}
    for mask in ("me", "nvf"):
        start = kernels.launch_counts()
        marked, strength = engine.embed(frames_d, mask_type=mask)
        results[mask] = (marked, strength, engine.detect(marked, mask),
                         engine.detect(frames_d, mask))
        end = kernels.launch_counts()
        part[mask] = {name: end[name] - start[name] for name in end}
    lumas_out, lumas_strength = engine.embed_luma_u8(lumas_d, "me")
    single_marked, single_strength = single.embed(frames[0])
    single_corr = single.detect(single_marked)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()

    check(all(part[mask][k] > 0 for mask in part for k in P3_KERNELS),
          f"a kernel was never launched on the main path: {part}")
    for mask, (marked, strength, corr, clean) in results.items():
        ref = JAX_REFERENCE[mask]
        check(marked.shape == frames_d.shape and marked.dtype == torch.float32
              and bool(torch.isfinite(marked).all()),
              f"{mask}: bad watermarked frames")
        strength, corr, clean = (t.cpu().numpy() for t in
                                 (strength, corr, clean))
        delta = (marked.double() - frames_d.double()).abs().mean(
            dim=(1, 2)).cpu().numpy()
        check(_close(corr, ref["corr"], atol=CORR_ATOL),
              f"{mask} corr {corr} vs JAX {ref['corr']}")
        check(_close(strength, ref["strength"], rtol=STRENGTH_RTOL),
              f"{mask} strength {strength} vs JAX {ref['strength']}")
        check(_close(delta, ref["mean_abs_delta"], atol=PIXEL_ATOL,
                     rtol=PIXEL_RTOL),
              f"{mask} mean |marked - frame| {delta} vs JAX "
              f"{ref['mean_abs_delta']}")
        check(np.abs(clean).max() < 0.2 * corr.min(),
              f"{mask}: clean frames correlate too well: {clean} vs {corr}")
        # pixels against the plain path on the same card
        plain, _ = batch_embed(frames_d, frames_d, engine.random_matrix,
                               engine.strength_factor, mask, impl="torch")
        check(torch.allclose(marked, plain, atol=PIXEL_ATOL,
                             rtol=PIXEL_RTOL),
              f"{mask}: pixels differ from the plain path by "
              f"{float((marked - plain).abs().max()):.3e}")
        print(f"[3] {mask}: corr {corr.mean():.6f} (JAX "
              f"{np.mean(ref['corr']):.6f}, clean {np.abs(clean).max():.2e})"
              f", strength {strength.mean():.5f} (JAX "
              f"{np.mean(ref['strength']):.5f}), max |pixels - plain path| "
              f"{float((marked - plain).abs().max()):.2e}: ok", flush=True)

    ref = JAX_REFERENCE["me_u8"]
    check(lumas_out.dtype == torch.uint8 and lumas_out.shape == lumas_d.shape,
          f"embed_luma_u8 returned {lumas_out.dtype} {tuple(lumas_out.shape)}")
    u8_delta = (lumas_out.double() - lumas_d.double()).abs().mean(
        dim=(1, 2)).cpu().numpy()
    check(_close(lumas_strength.cpu().numpy(), ref["strength"],
                 rtol=STRENGTH_RTOL),
          f"u8 strength {lumas_strength.cpu().numpy()} vs JAX "
          f"{ref['strength']}")
    check(_close(u8_delta, ref["mean_abs_delta"], atol=PIXEL_ATOL,
                 rtol=PIXEL_RTOL),
          f"u8 mean |marked - luma| {u8_delta} vs JAX {ref['mean_abs_delta']}")
    print(f"[3] embed_luma_u8: strength {float(lumas_strength.mean()):.5f}, "
          f"mean |delta| {u8_delta.mean():.4f}: ok", flush=True)

    check(abs(float(single_corr) - JAX_REFERENCE["me"]["corr"][0])
          <= CORR_ATOL and _close(float(single_strength),
                                  JAX_REFERENCE["me"]["strength"][0],
                                  rtol=STRENGTH_RTOL),
          f"single frame: corr {float(single_corr)}, strength "
          f"{float(single_strength)}")
    print(f"[3] Watermark single frame: corr {float(single_corr):.6f}, "
          f"strength {float(single_strength):.5f}: ok", flush=True)
    print(f"[3] launches on the main path: {counts} (NVF part "
          f"{part['nvf']})", flush=True)
    return {"all": counts, "nvf": part["nvf"]}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn``, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_timing(frames_d: torch.Tensor, wm_d: torch.Tensor) -> dict:
    sf = strength_factor(PSNR)

    def step_fps(impl: str) -> float:
        state = {"frames": frames_d}

        def step():
            marked, _ = batch_embed(state["frames"], state["frames"], wm_d,
                                    sf, "me", impl=impl)
            batch_detect(marked, wm_d, "me", impl=impl)
            state["frames"] = marked   # chained: the next step reads this
        return BATCH * 1e3 / cuda_ms(step)

    fps = {"cuda": [], "torch": []}
    for impl in ("cuda", "torch", "torch", "cuda"):
        fps[impl].append(step_fps(impl))
    print(f"[4] 8x1080p ME embed+detect step: kernels "
          f"{max(fps['cuda']):.1f} fps (runs {fps['cuda'][0]:.1f}, "
          f"{fps['cuda'][1]:.1f}), plain path {max(fps['torch']):.1f} fps "
          f"(runs {fps['torch'][0]:.1f}, {fps['torch'][1]:.1f})", flush=True)

    gram = kernels.me_gram_plain(frames_d)
    coeffs, _ = solve_coefficients_spd(gram[:, :8, :8], gram[:, :8, 8])
    pairs = {"me_gram": (lambda: kernels.me_gram(frames_d),
                         lambda: kernels.me_gram_plain(frames_d))}
    for mask, suffix in (("me", ""), ("nvf", "_nvf_p3")):
        pairs["embed_field" + suffix] = (
            lambda m=mask: kernels.embed_field(
                frames_d, wm_d, coeffs if m == "me" else None, m),
            lambda m=mask: kernels.embed_field_plain(frames_d, wm_d, coeffs,
                                                     m))
        pairs["detect_partials" + suffix] = (
            lambda m=mask: kernels.detect_partials(frames_d, wm_d, coeffs, m),
            lambda m=mask: kernels.detect_partials_plain(frames_d, wm_d,
                                                         coeffs, m))
    times = {}
    for name, (kernel_fn, plain_fn) in pairs.items():
        times[name] = (cuda_ms(kernel_fn), cuda_ms(plain_fn))
        label = name if name.endswith("_p3") else f"{name} (ME p=3)"
        print(f"[4] {label} at 8x1080x1920: kernel {times[name][0]:.4f} ms, "
              f"plain {times[name][1]:.4f} ms", flush=True)
    return times


def wide_coefficients(img: torch.Tensor, p: int) -> dict:
    """Per-mask predictor coefficients from the plain Gram and solves: the
    (p*p-1)-tap predictor for ME, the 3x3 one for NVF."""
    k = p * p - 1
    gram = kernels.me_gram_wide_plain(img, p)
    coeffs, valid = solve_coefficients_spd_wide(gram[:, :k, :k],
                                                gram[:, :k, k])
    check(bool(valid.all()), f"p={p}: the wide solve flagged a frame")
    gram3 = kernels.me_gram_plain(img)
    coeffs3, valid3 = solve_coefficients_spd(gram3[:, :8, :8], gram3[:, :8, 8])
    check(bool(valid3.all()), "the 3x3 solve flagged a frame")
    return {"me": coeffs, "nvf": coeffs3}


def phase_wide_kernels(frames_d: torch.Tensor, wm_d: torch.Tensor) -> dict:
    """The wide kernels against their plain versions at p = 5, 7, 9; returns
    per-row (max abs err, max rel err) at the main path's shape."""
    errors = {}
    gen = np.random.default_rng(6)
    small = torch.from_numpy(np.clip(gen.normal(128, 40, (3, 37, 83)), 0,
                                     255).astype(np.float32)).cuda()
    small_wm = torch.from_numpy(
        gen.normal(size=(37, 83)).astype(np.float32)).cuda()
    for p in WIDE_P:
        for img, wm in ((frames_d, wm_d), (small, small_wm)):
            label = f"p={p} " + "x".join(str(n) for n in img.shape)
            main_shape = img is frames_d
            before = kernels.launch_counts()
            lags = kernels.wide_gram_partials(img, p)
            lags_plain = kernels.lag_partials_plain(img, p)
            check(torch.allclose(lags, lags_plain, rtol=SUM_RTOL, atol=0),
                  f"me_gram_wide {label}: lag partials rel err "
                  f"{rel_err(lags, lags_plain):.3e}")
            # the assembled Gram against the direct per-pair sums, which
            # share nothing with the lag form or its assembly
            gram = kernels.me_gram_wide(img, p)
            direct = gram_direct(img, p)
            check(torch.allclose(gram, direct, rtol=SUM_RTOL, atol=0),
                  f"me_gram_wide {label}: Gram rel err against the direct "
                  f"sums {rel_err(gram, direct):.3e}")
            worst = {"gram": rel_err(gram, direct)}
            del direct
            if main_shape:
                errors[f"me_gram_wide_p{p}"] = (
                    float((lags - lags_plain).abs().max()),
                    rel_err(lags, lags_plain))
            coeffs = wide_coefficients(img, p)
            for mask in ("me", "nvf"):
                got = kernels.embed_field(
                    img, wm, coeffs[mask] if mask == "me" else None, mask, p)
                want = kernels.embed_field_plain(img, wm, coeffs[mask], mask,
                                                 p)
                u_err = float((got[0] - want[0]).abs().max())
                check(torch.allclose(got[0], want[0], rtol=U_RAW_RTOL,
                                     atol=U_RAW_ATOL),
                      f"embed_field {mask} {label}: u_raw max abs err "
                      f"{u_err:.3e}")
                sums_err = max(rel_err(g, w) for g, w in zip(got[1:],
                                                             want[1:]))
                check(sums_err <= SUM_RTOL, f"embed_field {mask} {label}: "
                      f"reduction rel err {sums_err:.3e}")
                got = kernels.detect_partials(img, wm, coeffs[mask], mask, p)
                want = kernels.detect_partials_plain(img, wm, coeffs[mask],
                                                     mask, p)
                detect_err = max(rel_err(g, w) for g, w in zip(got, want))
                check(detect_err <= SUM_RTOL, f"detect_partials {mask} "
                      f"{label}: rel err {detect_err:.3e}")
                corr_err = float(
                    (got[0] / torch.sqrt(got[1] * got[2])
                     - want[0] / torch.sqrt(want[1] * want[2])).abs().max())
                worst[mask] = (u_err, sums_err, corr_err, detect_err)
                if main_shape:
                    errors[f"embed_field_{mask}_p{p}"] = (u_err, sums_err)
                    errors[f"detect_partials_{mask}_p{p}"] = (corr_err,
                                                              detect_err)
            after = kernels.launch_counts()
            check(all(after[n] > before[n] for n in
                      ("me_gram_wide", "embed_field", "detect_partials")),
                  f"{label}: a launch counter did not rise: {before} -> "
                  f"{after}")
            torch.cuda.synchronize()
            masks = "; ".join(
                f"{m}: u_raw abs {worst[m][0]:.2e}, sums rel "
                f"{worst[m][1]:.2e}, detect sums rel {worst[m][3]:.2e}, corr "
                f"abs {worst[m][2]:.2e}" for m in ("me", "nvf"))
            print(f"[2] {label}: me_gram_wide lags rel "
                  f"{rel_err(lags, lags_plain):.2e}, Gram rel (against the "
                  f"direct sums) {worst['gram']:.2e}; {masks}: ok",
                  flush=True)
    return errors


def phase_wide_main_path(frames: np.ndarray, p: int) -> dict[str, dict]:
    """ME and NVF embed then detect of 8 frames at window p through the
    engine; returns the launch counts of each mask's part of the run."""
    engine = BatchedWatermark(ROWS, COLS, SEED, p=p, psnr=PSNR,
                              device="cuda")
    frames_d = torch.from_numpy(frames).cuda()
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    results, counts = {}, {}
    for mask in ("me", "nvf"):
        start = kernels.launch_counts()
        marked, strength = engine.embed(frames_d, mask_type=mask)
        results[mask] = (marked, strength, engine.detect(marked, mask),
                         engine.detect(frames_d, mask))
        end = kernels.launch_counts()
        counts[mask] = {name: end[name] - start[name] for name in end}
    torch.cuda.synchronize()
    total = kernels.launch_counts()

    check(counts["me"]["me_gram_wide"] > 0 and counts["nvf"]["me_gram"] > 0
          and total["embed_field"] > 0 and total["detect_partials"] > 0,
          f"p={p}: a kernel was never launched on the main path: {counts}")
    for mask, (marked, strength, corr, clean) in results.items():
        ref = JAX_WIDE_REFERENCE[p][mask]
        check(marked.shape == frames_d.shape and marked.dtype == torch.float32
              and bool(torch.isfinite(marked).all()),
              f"p={p} {mask}: bad watermarked frames")
        strength, corr, clean = (t.cpu().numpy() for t in
                                 (strength, corr, clean))
        delta = (marked.double() - frames_d.double()).abs().mean(
            dim=(1, 2)).cpu().numpy()
        corr_err = np.abs(corr - ref["corr"]).max()
        strength_err = np.abs(strength / np.asarray(ref["strength"])
                              - 1).max()
        check(_close(corr, ref["corr"], atol=CORR_ATOL),
              f"p={p} {mask} corr {corr} vs JAX {ref['corr']}")
        check(_close(strength, ref["strength"], rtol=STRENGTH_RTOL),
              f"p={p} {mask} strength {strength} vs JAX {ref['strength']}")
        check(_close(delta, ref["mean_abs_delta"], atol=PIXEL_ATOL,
                     rtol=PIXEL_RTOL),
              f"p={p} {mask} mean |marked - frame| {delta} vs JAX "
              f"{ref['mean_abs_delta']}")
        check(np.abs(clean).max() < 0.2 * corr.min(),
              f"p={p} {mask}: clean frames correlate too well: {clean} vs "
              f"{corr}")
        plain, _ = batch_embed(frames_d, frames_d, engine.random_matrix,
                               engine.strength_factor, mask, p=p,
                               impl="torch")
        pixel_err = float((marked - plain).abs().max())
        check(torch.allclose(marked, plain, atol=PIXEL_ATOL,
                             rtol=PIXEL_RTOL),
              f"p={p} {mask}: pixels differ from the plain path by "
              f"{pixel_err:.3e}")
        print(f"[3] p={p} {mask}: corr {corr.mean():.6f} (JAX "
              f"{np.mean(ref['corr']):.6f}, max abs diff {corr_err:.2e}, "
              f"clean {np.abs(clean).max():.2e}), strength "
              f"{strength.mean():.5f} (JAX {np.mean(ref['strength']):.5f}, "
              f"max rel diff {strength_err:.2e}), max |pixels - plain path| "
              f"{pixel_err:.2e}: ok", flush=True)
    print(f"[3] p={p} launches on the main path: {total} (ME {counts['me']},"
          f" NVF {counts['nvf']})", flush=True)
    return counts


def phase_wide_timing(frames_d: torch.Tensor, wm_d: torch.Tensor,
                      p: int) -> dict:
    sf = strength_factor(PSNR)

    def step_fps(impl: str) -> float:
        state = {"frames": frames_d}

        def step():
            marked, _ = batch_embed(state["frames"], state["frames"], wm_d,
                                    sf, "me", p=p, impl=impl)
            batch_detect(marked, wm_d, "me", p=p, impl=impl)
            state["frames"] = marked
        return BATCH * 1e3 / cuda_ms(step)

    fps = {"cuda": [], "torch": []}
    for impl in ("cuda", "torch", "torch", "cuda"):
        fps[impl].append(step_fps(impl))
    print(f"[4] p={p} 8x1080p ME embed+detect step: kernels "
          f"{max(fps['cuda']):.1f} fps (runs {fps['cuda'][0]:.1f}, "
          f"{fps['cuda'][1]:.1f}), plain path {max(fps['torch']):.1f} fps "
          f"(runs {fps['torch'][0]:.1f}, {fps['torch'][1]:.1f})", flush=True)

    coeffs = wide_coefficients(frames_d, p)
    pairs = {f"me_gram_wide_p{p}": (
        lambda: kernels.wide_gram_partials(frames_d, p),
        lambda: kernels.lag_partials_plain(frames_d, p))}
    for mask in ("me", "nvf"):
        c = coeffs[mask]
        pairs[f"embed_field_{mask}_p{p}"] = (
            lambda c=c, m=mask: kernels.embed_field(
                frames_d, wm_d, c if m == "me" else None, m, p),
            lambda c=c, m=mask: kernels.embed_field_plain(frames_d, wm_d, c,
                                                          m, p))
        pairs[f"detect_partials_{mask}_p{p}"] = (
            lambda c=c, m=mask: kernels.detect_partials(frames_d, wm_d, c, m,
                                                        p),
            lambda c=c, m=mask: kernels.detect_partials_plain(frames_d, wm_d,
                                                              c, m, p))
    times = {}
    for name, (kernel_fn, plain_fn) in pairs.items():
        times[name] = (cuda_ms(kernel_fn), cuda_ms(plain_fn))
        print(f"[4] {name} at 8x1080x1920: kernel {times[name][0]:.4f} ms, "
              f"plain {times[name][1]:.4f} ms", flush=True)
    gram_ms = cuda_ms(lambda: kernels.me_gram_wide(frames_d, p))
    plain_gram_ms = cuda_ms(lambda: kernels.me_gram_wide_plain(frames_d, p))
    print(f"[4] p={p} assembled Gram (lag kernel + assembly) {gram_ms:.4f} "
          f"ms, plain {plain_gram_ms:.4f} ms", flush=True)
    return times


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms, what binds it) for moving ``nbytes`` and doing ``flops``
    on an H100 SXM at its data-sheet peaks."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def kernel_bound(kernel: str, mask: str, p: int) -> tuple[float, str]:
    """The bound of one kernel call at 8 x 1080 x 1920: each input read
    once, each output written once, and the flops the function needs, per
    pixel (a multiply-add counts 2; the detect tail's ring is not counted):

    * the 3x3 Gram: 13 lag products (the TPU kernel's lag form);
    * the wide Gram: one product per canonical lag and lane of each row;
    * the NVF mask: separable p x p box sums of x and x^2, shared by
      neighbouring centres as ops/nvf.py shares its row sums (4(p-1) adds),
      one square, and 6 for the mean, E[x^2], the variance and var/(1+var);
    * a (p*p-1)-tap prediction error: a product and a subtraction a tap.
    """
    pixels = BATCH * ROWS * COLS
    frame_bytes = 4 * pixels
    wm_bytes = 4 * ROWS * COLS
    k = p * p - 1
    nvf_flops = 4 * (p - 1) + 1 + 6
    if kernel == "me_gram":
        return bound(frame_bytes + 4 * BATCH * 81, 2 * 13 * pixels)
    if kernel == "me_gram_wide":
        h = p // 2
        lags = ((4 * h + 1) ** 2 + 1) // 2
        lanes = BATCH * lags * (COLS + 2 * h)
        return bound(frame_bytes + 4 * lanes, 2 * lanes * ROWS)
    if kernel == "embed_field":
        mask_flops = 2 * k + 1 if mask == "me" else nvf_flops
        return bound(2 * frame_bytes + wm_bytes + 8 * BATCH,
                     (mask_flops + 4) * pixels)    # u, u^2, max
    taps = 2 * (k if mask == "me" else 8)          # detect tail
    mask_flops = 1 if mask == "me" else nvf_flops
    return bound(frame_bytes + wm_bytes + 12 * BATCH,
                 (2 * taps + mask_flops + 7) * pixels)   # u, three sums


def kernel_row(name: str, kernel: str, mask: str, p: int, launches: int,
               errors: tuple, times: tuple) -> dict:
    source, replaces = KERNEL_SOURCES[kernel]
    bound_ms, bound_by = kernel_bound(kernel, mask, p)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": errors[0], "max_rel_err": errors[1],
            "ms": times[0], "plain_ms": times[1], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def main() -> int:
    kind = phase_card_and_build()
    frames = make_frames()
    check(abs(float(frames.astype(np.float64).sum())
              - JAX_REFERENCE["frames_sum"]) < 1e-3,
          "numpy's generator gave other frames than the reference numbers "
          "were computed from")
    frames_d = torch.from_numpy(frames).cuda()
    wm_d = torch.from_numpy(
        generate_watermark(ROWS, COLS, SEED).astype(np.float32)).cuda()

    errors = phase_kernels(frames_d, wm_d)
    errors.update(phase_wide_kernels(frames_d, wm_d))
    counts = phase_main_path(frames)
    wide_counts = {p: phase_wide_main_path(frames, p) for p in WIDE_P}
    times = phase_timing(frames_d, wm_d)
    for p in WIDE_P:
        times.update(phase_wide_timing(frames_d, wm_d, p))

    rows = [kernel_row("me_gram", "me_gram", "me", 3,
                       counts["all"]["me_gram"], errors["me_gram"],
                       times["me_gram"])]
    for kernel in ("embed_field", "detect_partials"):
        nvf_launches = counts["nvf"][kernel]
        rows.append(kernel_row(kernel, kernel, "me", 3,
                               counts["all"][kernel] - nvf_launches,
                               errors[kernel], times[kernel]))
        name = f"{kernel}_nvf_p3"
        rows.append(kernel_row(name, kernel, "nvf", 3, nvf_launches,
                               errors[name], times[name]))
    for p in WIDE_P:
        me, nvf = wide_counts[p]["me"], wide_counts[p]["nvf"]
        rows.append(kernel_row(f"me_gram_wide_p{p}", "me_gram_wide", "me", p,
                               me["me_gram_wide"] + nvf["me_gram_wide"],
                               errors[f"me_gram_wide_p{p}"],
                               times[f"me_gram_wide_p{p}"]))
        for kernel in ("embed_field", "detect_partials"):
            for mask, launched in (("me", me), ("nvf", nvf)):
                name = f"{kernel}_{mask}_p{p}"
                rows.append(kernel_row(name, kernel, mask, p,
                                       launched[kernel], errors[name],
                                       times[name]))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
