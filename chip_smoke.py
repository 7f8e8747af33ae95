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
   inputs and coefficients, at 8 x 1080 x 1920 and at 3 x 37 x 83.
3. The main path, through ``BatchedWatermark(1080, 1920, 28390211, p=3,
   psnr=40, device="cuda")``: ME and NVF embed then detect of 8 frames,
   ``embed_luma_u8`` and one single-frame ``Watermark`` round trip, held to
   numbers the JAX package computed on the CPU from the same frames. The
   kernels' launch counters are zeroed just before and read just after.
4. Timing with CUDA events: the chained 8-frame ME embed+detect step
   through the kernels and through the plain path (``impl="torch"``), and
   each kernel beside its plain version.

The line before the last is ``{"kernels": [...]}`` (per kernel: launches in
phase 3; ``max_abs_err`` of its main output against the plain version at
8 x 1080 x 1920 — the Gram, u_raw, or the correlation formed from the
detect sums; ``max_rel_err`` of its reductions; ``ms``/``plain_ms`` per
call from phase 4). The last line is
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
from watermarking_gpu_tpu_torch.ops.me import solve_coefficients_spd

ROWS, COLS, BATCH = 1080, 1920, 8
SEED = 28390211
PSNR = 40.0

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
    "embed_field": ("watermarking_gpu_tpu_torch/csrc/fused.cu",
                    "watermarking_gpu_tpu/ops/pallas/fused.py:885"),
    "detect_partials": ("watermarking_gpu_tpu_torch/csrc/fused.cu",
                        "watermarking_gpu_tpu/ops/pallas/fused.py:300"),
}


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
                worst_sum = max(worst_sum, rel_err(g, w))
            worst_u = max(worst_u, float((got[0] - want[0]).abs().max()))

            got = kernels.detect_partials(img, wm, coeffs, mask)
            want = kernels.detect_partials_plain(img, wm, coeffs, mask)
            for g, w in zip(got, want):
                check(torch.allclose(g, w, rtol=SUM_RTOL, atol=0),
                      f"detect_partials {mask} {label}: rel err "
                      f"{rel_err(g, w):.3e}")
                worst_detect = max(worst_detect, rel_err(g, w))
            corr = got[0] / torch.sqrt(got[1] * got[2])
            corr_plain = want[0] / torch.sqrt(want[1] * want[2])
            worst_corr = max(worst_corr,
                             float((corr - corr_plain).abs().max()))
        after = kernels.launch_counts()
        check(all(after[k] > before[k] for k in after),
              f"{label}: a launch counter did not rise: {before} -> {after}")
        torch.cuda.synchronize()
        print(f"[2] {label}: me_gram rel {rel_err(gram, gram_plain):.2e}; "
              f"embed_field u_raw abs {worst_u:.2e}, sums rel "
              f"{worst_sum:.2e}; detect_partials sums rel "
              f"{worst_detect:.2e}, corr abs {worst_corr:.2e}: ok",
              flush=True)
        if main_shape:
            errors["embed_field"] = (worst_u, worst_sum)
            errors["detect_partials"] = (worst_corr, worst_detect)
    return errors


def _close(got, want, atol=0.0, rtol=0.0) -> bool:
    return bool(np.all(np.abs(np.asarray(got) - np.asarray(want))
                       <= atol + rtol * np.abs(np.asarray(want))))


def phase_main_path(frames: np.ndarray) -> dict[str, int]:
    engine = BatchedWatermark(ROWS, COLS, SEED, p=3, psnr=PSNR,
                              device="cuda")
    frames_d = torch.from_numpy(frames).cuda()
    lumas_d = torch.from_numpy(frames.astype(np.uint8)).cuda()
    single = Watermark(ROWS, COLS, SEED, p=3, psnr=PSNR, device="cuda")
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    results = {}
    for mask in ("me", "nvf"):
        marked, strength = engine.embed(frames_d, mask_type=mask)
        results[mask] = (marked, strength, engine.detect(marked, mask),
                         engine.detect(frames_d, mask))
    lumas_out, lumas_strength = engine.embed_luma_u8(lumas_d, "me")
    single_marked, single_strength = single.embed(frames[0])
    single_corr = single.detect(single_marked)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()

    check(all(n > 0 for n in counts.values()),
          f"a kernel was never launched on the main path: {counts}")
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
    print(f"[3] launches on the main path: {counts}", flush=True)
    return counts


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
    pairs = {
        "me_gram": (lambda: kernels.me_gram(frames_d),
                    lambda: kernels.me_gram_plain(frames_d)),
        "embed_field": (
            lambda: kernels.embed_field(frames_d, wm_d, coeffs, "me"),
            lambda: kernels.embed_field_plain(frames_d, wm_d, coeffs, "me")),
        "detect_partials": (
            lambda: kernels.detect_partials(frames_d, wm_d, coeffs, "me"),
            lambda: kernels.detect_partials_plain(frames_d, wm_d, coeffs,
                                                  "me")),
    }
    times = {}
    for name, (kernel_fn, plain_fn) in pairs.items():
        times[name] = (cuda_ms(kernel_fn), cuda_ms(plain_fn))
        print(f"[4] {name} at 8x1080x1920 (ME): kernel "
              f"{times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms",
              flush=True)
    return times


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
    counts = phase_main_path(frames)
    times = phase_timing(frames_d, wm_d)

    rows = [{"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": counts[name],
             "max_abs_err": errors[name][0], "max_rel_err": errors[name][1],
             "ms": times[name][0], "plain_ms": times[name][1]}
            for name, (source, replaces) in KERNEL_SOURCES.items()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
