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
   kernels (the 3x3 Gram's two kernels, the lag sums over row strips and
   the assembly from the plain lag sums, and the Gram of both against the
   direct per-pair sums, bit-identical over two calls), then for p = 5,
   7, 9 the wide Gram's two kernels (the same checks, the Gram against the
   plain lag form ``me_gram_wide_plain`` and, at the small shape, the
   direct per-pair sums ``gram_direct(p)``), and the embed field (u_raw
   bit-identical to the plain version's, as are two calls) and detect tail
   at ME and NVF p; then at p = 3, 5, 7, 9 the multi-candidate detect at
   ME and NVF against the 64-candidate bank (70 at the small shape: a full
   chunk of 64 and a partial one) and the standalone prediction error and
   NVF mask. The 8x8 solve kernel (``spd_solve8``) on the kernel Gram of
   each shape, against its plain version, the unrolled (B,)-vector
   Cholesky: coefficients and valid flags bit-identical, as are two calls
   (a difference up to 1e-6 relative would be reported and pass). The
   3x3 Gram with that solve in its assembly kernel (``me_gram_solve8``)
   at each shape, at B = 1 (1080 x 1920), 7 and 300, and on a constant
   frame between two real ones: Gram, coefficients and valid flags
   bit-identical to the two calls ``spd_solve8(me_gram(x))`` and to the
   plain solve of its Gram, two calls too, and within 1e-4 of its plain
   version ``spd_solve8_plain(me_gram_plain(x))`` (the plain Gram sums in
   another order); the constant frame invalid with zero coefficients. The
   wide solve kernel (``spd_solve_wide``) at p = 5, 7, 9 on the kernel's
   wide Gram of each shape, on 1, 8 and 300 random SPD systems a k and on
   a batch of a frame's, a constant frame's and a zero Gram, against its
   plain version, the blocked Cholesky (TF32 off): coefficients within
   1e-4, valid flags identical, two calls bit-identical; and against a
   float64 ``torch.linalg.solve`` of the same systems, where its error on
   the frames' wide Grams may be at most WIDE_SOLVE_ACCURACY times the
   plain blocked solve's (printed on the random systems too). The embed finish
   (``embed_finish``) at each shape on the embed field at ME and NVF,
   frame 1's solve forced to fail, into the f32 frames, an RGB output and
   the frames as u8, and on an NVF constant frame (NaN pixels), f32 and
   u8: pixels and strengths bit-identical to its plain version, the eager
   tail (NaN equal to NaN), as are two calls.
3. The main paths, through ``BatchedWatermark(1080, 1920, 28390211, p=P,
   psnr=40, device="cuda")``. P=3: ME and NVF embed then detect of 8
   frames, ``embed_luma_u8`` and one single-frame ``Watermark`` round trip.
   P = 5, 7, 9: ME and NVF embed then detect of 8 frames. Identification
   at ME and NVF P = 3, 5, 7, 9: ``IdentifierService`` answers 16
   single-frame requests (8 marked frames, 8 clean) against the
   64-candidate bank. Each is held to numbers the JAX package computed on
   the CPU from the same frames (identification at ME and NVF P = 3, 5,
   7, 9), and its kernels' launch counters are zeroed just before it and
   read just after; the wide solve kernel must run once an analysis at ME
   P = 5, 7, 9 (embed, detect, identification) and never at P=3 or in an
   NVF detect, every 3x3 Gram must solve in its assembly kernel
   (``me_gram_solve8``, one count a Gram) and ``spd_solve8`` never run
   alone on a single device, and the embed finish once an embed.
4. Timing with CUDA events: the chained 8-frame ME embed+detect step at
   each P through the kernels and through the plain path
   (``impl="torch"``), each kernel beside its plain version (the wide Gram
   as its two kernels together; the prediction error also beside one
   ``conv2d``; the 8x8 solve at B = 8 beside the plain unrolled solve and
   the library pair ``cholesky_ex`` + ``cholesky_solve``; the wide solve at
   B = 8 and each P beside the plain blocked solve and the same library
   pair; the embed finish into the f32 frames and into u8 lumas beside its
   plain version), and the identification of 8 frames against 64
   candidates
   (ME) at each P through the kernel, through the plain route and as 64
   looped detects. Last, after every timing, the device time a call of the
   3x3 and the wide Gram's two kernels, of the 8x8 and the wide solve
   kernels, of the embed field and the detect tail at each mask and P, and
   of the embed finish in both forms, from one ``torch.profiler`` session;
   the 3x3 Gram with the solve in its assembly beside the two calls it
   replaces, by CUDA events and device time; then each P's step's device
   kernels and busy time, from a ``torch.profiler`` session of 5 steps.
5. The entry points a user runs, at 1080 x 1920 (run before phase 4's
   profiler timings, since it times them too). The CLI: a PNG of
   ``make_cli_image()`` and a ``.dat`` of the engines' watermark in a
   temporary directory, ``cli.main([ini])`` in process at p = 3 and 5 (20
   loops, FPS, saves on), then ``python -m watermarking_gpu_tpu_torch`` at
   p=3 as a subprocess; strengths and correlations held to the JAX
   package's CPU numbers for the same PNG, the saved ``*_W_ME.png`` read
   back byte-equal to the engine's truncated output and within 0.5 dB of
   PSNR 40. The video pipeline on a raw ``.yuv`` clip of 24 frames:
   ``embed_video`` at intervals 1 and 5 (batches of 8), its chroma and the
   frames between samples equal to the input and its marked lumas
   byte-equal to a synchronous ``embed_luma_u8`` of the same frames, then
   ``detect_video`` of both outputs and of the clean clip, per-frame
   correlations held to the JAX package's. Each run's launch counters are
   zeroed just before it and read just after, and must show the 3x3
   Gram's kernels and the embed field or the detect tail (the CLI both,
   and at p=5 the wide Gram's kernels too).
6. The sharded routes of ``parallel/`` (run before phase 4's profiler
   timings, at 8 x 1080 x 1920, the watermark of phase 3 and
   ``make_bank()``); on one card every mesh names cuda:0 for each shard,
   so no transfer between devices is measured. First the halo forms
   against their plain halo forms on the same extended shards, at 270- and
   540-row shards (space 4 and 2), every shard position: the 3x3 Gram's
   two kernels, the embed field and the detect tail at ME p=3 and NVF p=3
   and 5, with the shards' Grams summed against the unsharded kernel Gram;
   the wide Gram's lag kernel at ME p = 5, 7, 9, the shards' sums folded
   and assembled with the frame's banks by the assembly kernel against its
   plain version and the frame's wide Gram; the multi-candidate kernel at
   ME p = 3, 5, 9 and NVF p=3 against the 64-candidate bank, the shards'
   sums added up against the frame's. Then each one's ms on an interior
   shard (and, after phase 4's profiler timings, its device ms). Then,
   each run's launch counters zeroed just before it and read just after,
   with its ms from CUDA events (each hybrid route run four times, the
   first run's time printed as cold, the others' as warm): hybrid embed then
   detect on data=2 x
   space=2 (ME p = 3, 5, 9, NVF p=3 and 5, ``impl="cuda"``) held to the
   single-device kernel route (correlations 1e-4, strengths 1e-4
   relative, pixels 1e-2) and to the JAX numbers; spatial detect on data=1
   x space=4 (ME p=3 and p=9 on ``impl="cuda"``, ME p=9 on
   ``impl="torch"``); DP embed and detect on data=4 at ME p=5 (the wide
   Gram per shard); ``make_dp_detect_many`` at ME p=5 (16 candidates a
   shard) and ``make_mesh_detect_many`` on data=2 x space=2 (ME p=3,
   ``impl="torch"`` and ``"cuda"``) and on space=4 (ME p=9, NVF p=5,
   ``impl="cuda"``), where the embedded candidate must win, within 1e-4 of
   single-device identification and 3e-4 of the JAX numbers; each kernel
   route's launches counted exactly (a halo-form kernel once a shard, the
   wide Gram's assembly and the wide solve once a space row); and the
   services with
   ``mesh=`` (the detector and embedder on data=2 x space=2, the
   identifier on data=2 and on data=2 x space=2, a p=5 detector on data=2
   x space=2), their answers equal to the mesh functions'.
7. The tools and the examples a user runs (run before phase 4's profiler
   timings), each through its entry point on the card, its launch
   counters zeroed just before and read just after, held to the JAX
   package's own tools and examples (``JAX_TOOLS_REFERENCE``):
   ``generate_watermark`` (the .dat byte-equal to ``save_watermark``'s,
   with and without ``--repeat-blocks 4``); ``calibrate_threshold`` on
   phase 5's PNG at its defaults (8 images, 256 nulls, FPR 1e-6) at ME p=3,
   NVF p=3 and ME p=5 (the null matrix one ``detect_many`` dispatch; the
   host's matrix generation, the upload and the null dispatch timed);
   ``evaluate_robustness`` at ME and NVF, then ME with Pillow hidden (its
   JPEG rows skipped, 9 attacks in one batch); the image and the
   identification examples on the PNG, the video and the serving examples
   at their own sizes.

The line before the last is ``{"kernels": [...]}``, one row per kernel,
window and mask (the 3x3 Gram serves both masks), and ``replaces_kind``
("pallas", or "xla" for the 8x8 and the wide solves and the embed finish,
which replace XLA code of the JAX package's jitted step, not a Pallas
kernel): launches in its part of
phase 3 (0 for the standalone prediction error and NVF mask, which no main
path runs; for the 3x3 and the wide Gram both kernels' launches, one each a
Gram; for the 8x8 solve kernel alone, one a solve of a folded 3x3 Gram,
phase 6's only; for its fused variant ``me_gram_solve8`` (the solve in the
3x3 Gram's assembly kernel), one a single-device 3x3 Gram, those of every
phase-3 run: the p=3 path, the NVF parts at p = 5, 7, 9 and the
identification at p=3 and NVF; for the wide solve, one a solve at ME p,
the main path's and identification's; for the embed finish, one a fused
embed of any mask, p and form, every phase-3 run's), plus the launches of
phase 6's
and phase 7's runs at that kernel, mask and p;
``max_abs_err`` of
its main output against the plain version at 8 x 1080 x 1920 (the Gram,
u_raw, the correlation formed from the detect sums, the coefficients, or
the standalone op's output) and ``max_rel_err`` of
its reductions (of the output, relative to its largest value, for the
standalone ops); ``ms`` and ``plain_ms`` per call from phase 4 (CUDA
events around the wrapper; the embed finish's into the f32 frames at ME,
its u8 form in ``u8_form``); for the 3x3 Gram, the embed field, the
detect tail, the embed finish, the fused solve and the standalone
prediction error and NVF mask ``device_ms``, its kernels' device time a
call from the profiler (the fused solve's row also
carries ``two_calls``, the ms and device ms of ``spd_solve8(me_gram(x))``,
and ``solve_tail_device_ms``, what the solve adds to the assembly
kernel);
``bound_ms``, the least time an H100 could take for the same work (the
larger of the bytes the function must move over 3.35 TB/s and the flops it
needs over 67 TFLOP/s f32, NVIDIA's data-sheet peaks for the SXM part at
700 W; see ``kernel_bound``), and ``bound_by``; ``library_ms``: for the
prediction error one grouped ``conv2d`` over the edge-padded frames (the
pad included, cuDNN's TF32 off), for the 8x8 solve the library pair
``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve`` (the port's
kernel route never calls it; its plain route does at p > 3) and the same
pair for the wide solves, null for the rest, which no single PyTorch call
computes. The p=3 rows of the 3x3 Gram, the embed field and
the detect tail, the wide Gram's rows (its lag kernel) and the
multi-candidate kernel's rows at ME p = 3, 5, 9 and NVF p=3 also carry
``halo_form``: per shard height (270, 540) the halo form's ms, plain ms,
bound, and device ms on an interior shard.
The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import importlib.metadata
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from watermarking_gpu_tpu_torch import (DetectorService, EmbedderService,
                                        IdentifierService)
from watermarking_gpu_tpu_torch.cli import main as cli
from watermarking_gpu_tpu_torch.io.config import Settings
from watermarking_gpu_tpu_torch.io.images import (add_suffix_before_extension,
                                                  read_png, write_png)
from watermarking_gpu_tpu_torch.io.matfile import (generate_watermark,
                                                   save_watermark)
from watermarking_gpu_tpu_torch.models import (BatchedWatermark, Watermark,
                                               batch_detect, batch_embed,
                                               pad_to_batch)
from watermarking_gpu_tpu_torch.ops import cuda as kernels
from watermarking_gpu_tpu_torch.ops import rgb_to_gray, strength_factor
from watermarking_gpu_tpu_torch.ops.cuda import build
from watermarking_gpu_tpu_torch.ops.cuda.fused import (MASK_CODES,
                                                      stencil_reach)
from watermarking_gpu_tpu_torch.ops.me import (gram_direct,
                                               solve_coefficients_spd,
                                               solve_coefficients_spd_wide)
from watermarking_gpu_tpu_torch.ops.neighbors import neighbor_offsets
from watermarking_gpu_tpu_torch.ops.pipelines import detect_many_pipeline
from watermarking_gpu_tpu_torch.parallel import (make_dp_detect,
                                                 make_dp_detect_many,
                                                 make_dp_embed,
                                                 make_hybrid_detect,
                                                 make_hybrid_embed, make_mesh,
                                                 make_mesh_detect_many,
                                                 make_spatial_detect)
from watermarking_gpu_tpu_torch.tools import (calibrate_threshold,
                                              evaluate_robustness)
from watermarking_gpu_tpu_torch.tools import \
    generate_watermark as generate_tool
from watermarking_gpu_tpu_torch.video import (detect_video, embed_video,
                                              frame_bytes, synthesize)

ROWS, COLS, BATCH = 1080, 1920, 8
SEED = 28390211
PSNR = 40.0
WIDE_P = (5, 7, 9)
ALL_P = (3, *WIDE_P)
# identification: a bank of 64 candidates, the engines' own watermark in
# slot ENGINE_CANDIDATE and N(0, 1) decoys from BANK_SEED elsewhere (the
# geometry of the JAX package's detect_many_1080p_n64_p5 row)
N_CANDIDATES = 64
BANK_SEED = 9041
ENGINE_CANDIDATE = 17
IDENTIFY_CASES = tuple((mask, p) for p in ALL_P for mask in ("me", "nvf"))
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
SUM_RTOL = 1e-4
# the 8x8 solve kernel against its plain version: the same rounded
# operations in the same order, so bit-identical is expected; a difference
# up to this, relative to a system's largest coefficient, passes and shows
SOLVE_RTOL = 1e-6
# operations of one 8x8 solve: the factorisation's products and sums with
# its 8 square roots and 8 reciprocals (248), each substitution's products,
# sums and 8 divisions (72 each)
SOLVE_OPS = 248 + 2 * 72    # cholesky_ops(8)
# the wide solve kernel against its plain version (the blocked Cholesky):
# the wide solves' bound, their 8-term sums in another order than the
# plain version's matmuls
WIDE_SOLVE_ATOL = 1e-4
# the wide solve kernel's error against a float64 solve of the frames'
# systems, at most this times the plain blocked f32 solve's: a schedule of
# its own may not trade accuracy for speed
WIDE_SOLVE_ACCURACY = 2.0
CORR_ATOL = 5e-4
STRENGTH_RTOL = 5e-3
PIXEL_ATOL, PIXEL_RTOL = 1e-2, 1e-2

# detect_many's column for the engine's own watermark against detect on the
# same frames: the same kernels' sums, finished in another order
DETECT_MANY_ATOL = 1e-5

KERNEL_SOURCES = {
    "me_gram": ("watermarking_gpu_tpu_torch/csrc/me_gram.cu",
                "watermarking_gpu_tpu/ops/pallas/me_kernel.py:101"),
    "me_gram_wide": ("watermarking_gpu_tpu_torch/csrc/me_gram_wide.cu",
                     "watermarking_gpu_tpu/ops/pallas/me_gram_wide.py:182"),
    "embed_field": ("watermarking_gpu_tpu_torch/csrc/fused.cu",
                    "watermarking_gpu_tpu/ops/pallas/fused.py:885"),
    "detect_partials": ("watermarking_gpu_tpu_torch/csrc/fused.cu",
                        "watermarking_gpu_tpu/ops/pallas/fused.py:300"),
    "detect_many": ("watermarking_gpu_tpu_torch/csrc/detect_many.cu",
                    "watermarking_gpu_tpu/ops/pallas/fused.py:683"),
    "prediction_error": (
        "watermarking_gpu_tpu_torch/csrc/predict.cu",
        "watermarking_gpu_tpu/ops/pallas/predict_kernel.py:56"),
    "nvf_mask": ("watermarking_gpu_tpu_torch/csrc/nvf.cu",
                 "watermarking_gpu_tpu/ops/pallas/nvf_kernel.py:24"),
    # not a Pallas kernel: XLA code of the JAX package's jitted step
    "spd_solve8": ("watermarking_gpu_tpu_torch/csrc/spd_solve.cu",
                   "watermarking_gpu_tpu/ops/me.py:279"),
    # the same solve, in the 3x3 Gram's assembly kernel (row 13's fused
    # variant)
    "me_gram_solve8": ("watermarking_gpu_tpu_torch/csrc/me_gram.cu",
                       "watermarking_gpu_tpu/ops/me.py:279"),
    "spd_solve_wide": ("watermarking_gpu_tpu_torch/csrc/spd_solve.cu",
                       "watermarking_gpu_tpu/ops/me.py:420"),
    "embed_finish": ("watermarking_gpu_tpu_torch/csrc/embed_finish.cu",
                     "watermarking_gpu_tpu/ops/pipelines.py:293"),
}
XLA_KERNELS = ("spd_solve8", "me_gram_solve8", "spd_solve_wide",
               "embed_finish")
STANDALONE_KERNELS = ("prediction_error", "nvf_mask")
# the 3x3 Gram's two kernels (the me_gram row), each with its count
GRAM_KERNELS = ("me_gram_lags", "me_gram_assemble")
# and the 8x8 solve of its system in the assembly kernel
# (``me_gram_solve8``, its own count a call): every single-device run of
# the 3x3 predictor; ``spd_solve8`` alone solves only the Gram that the
# spatial routes fold (phase 6)
GRAM_SOLVE_KERNELS = (*GRAM_KERNELS, "me_gram_solve8")
# the embed field and the finish that scales it into the output: every
# fused embed
EMBED_KERNELS = ("embed_field", "embed_finish")
P3_KERNELS = (*GRAM_SOLVE_KERNELS, *EMBED_KERNELS, "detect_partials")
# the wide Gram's two kernels (the me_gram_wide rows), each with its count
WIDE_GRAM_KERNELS = ("wide_lag_strips", "wide_assemble")
# and the wide solve of its system: every ME analysis at p > 3
WIDE_GRAM_SOLVE_KERNELS = (*WIDE_GRAM_KERNELS, "spd_solve_wide")
# calls of the one-call fused embed and detect (``ops/cuda/chain.py``), not
# kernels: each of the chain's kernels counts in its own row
CHAIN_COUNTERS = ("embed_chain", "detect_chain")


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


def make_bank() -> np.ndarray:
    """The (64, 1080, 1920) f32 candidate bank."""
    bank = np.random.default_rng(BANK_SEED).standard_normal(
        (N_CANDIDATES, ROWS, COLS), dtype=np.float32)
    bank[ENGINE_CANDIDATE] = generate_watermark(ROWS, COLS, SEED)
    return bank


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
    power = smi.stdout.strip().splitlines()[0]
    print(power, flush=True)
    # the plain blocked solve's matmuls (the wide solve kernel's oracle)
    # and the one convolution timed as a yardstick (conv_prediction_error)
    # must run in full f32
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
    return kind, power


def check_embed_field(img: torch.Tensor, wm: torch.Tensor,
                      coeffs: torch.Tensor, mask: str, p: int,
                      label: str) -> tuple[float, float]:
    """The embed field against its plain version: u_raw and max mask
    bit-identical (the same rounded operations), sum u_raw^2 within
    SUM_RTOL (another summation order), and two calls bit-identical.
    Returns (u_raw max abs err, sums max rel err)."""
    got = kernels.embed_field(img, wm, coeffs if mask == "me" else None,
                              mask, p)
    want = kernels.embed_field_plain(img, wm, coeffs, mask, p)
    u_err = float((got[0] - want[0]).abs().max())
    check(torch.equal(got[0], want[0]), f"embed_field {mask} {label}: "
          f"u_raw not bit-identical to the plain version, max abs err "
          f"{u_err:.3e}")
    check(torch.equal(got[2], want[2]), f"embed_field {mask} {label}: max "
          f"mask {got[2].tolist()} against {want[2].tolist()}")
    sums_err = rel_err(got[1], want[1])
    check(sums_err <= SUM_RTOL, f"embed_field {mask} {label}: sum u_raw^2 "
          f"rel err {sums_err:.3e}")
    again = kernels.embed_field(img, wm, coeffs if mask == "me" else None,
                                mask, p)
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          f"embed_field {mask} {label}: two calls differ")
    return u_err, sums_err


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal dtypes, shapes and bits, NaN equal to NaN."""
    nan = got.isnan()
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(nan, want.isnan())
            and torch.equal(got[~nan], want[~nan]))


def finish_numerator(u_raw: torch.Tensor) -> float:
    """sf * sqrt(n) of the fused embed at PSNR, n a frame's pixels."""
    return strength_factor(PSNR) * math.sqrt(u_raw.shape[-2]
                                             * u_raw.shape[-1])


def check_embed_finish(u_raw, output, sum_u2, max_e, valid, mask: str,
                       label: str) -> tuple[tuple, tuple[float, float]]:
    """The embed finish against its plain version on the same inputs:
    pixels and strengths bit-identical, NaN equal to NaN, as are two
    calls. Returns (the kernel's (pixels, strengths), (max abs err of the
    pixels, max rel err of the strengths), NaN left out)."""
    args = (u_raw, output, sum_u2, max_e, valid, finish_numerator(u_raw),
            mask)
    got = kernels.embed_finish(*args)
    want = kernels.embed_finish_plain(*args)
    px_err = float((got[0].double() - want[0].double()).nan_to_num().abs()
                   .max())
    finite = want[1].isfinite() & (want[1] != 0)
    s_err = rel_err(got[1][finite], want[1][finite]) if finite.any() else 0.0
    check(same_bits(got[0], want[0]), f"embed_finish {label}: pixels not "
          f"bit-identical to the plain version, max abs err {px_err:.3e}")
    check(same_bits(got[1], want[1]), f"embed_finish {label}: strengths "
          f"{got[1].tolist()} against {want[1].tolist()}")
    again = kernels.embed_finish(*args)
    check(all(same_bits(a, g) for a, g in zip(again, got)),
          f"embed_finish {label}: two calls differ")
    return got, (px_err, s_err)


def check_finish_cases(img: torch.Tensor, wm: torch.Tensor,
                       coeffs: torch.Tensor, label: str
                       ) -> tuple[float, float]:
    """The embed finish on the embed field of ``img`` at ME (its frames'
    coefficients) and NVF p=3, frame 1's solve forced to fail: into the
    f32 frames, into an RGB output and into the frames as u8 (the video's
    form); then an NVF constant frame (sum u_raw^2 = 0: NaN pixels), f32
    and u8. Returns the worst (pixel, strength) errors."""
    worst = (0.0, 0.0)
    valid = torch.ones(img.shape[0], dtype=torch.bool, device=img.device)
    valid[1] = False
    outputs = {"f32": img, "rgb": torch.stack([img, img * 0.5, 255 - img],
                                              dim=-1),
               "u8": img.to(torch.uint8)}
    for mask in ("me", "nvf"):
        field = kernels.embed_field(img, wm, coeffs if mask == "me" else None,
                                    mask)
        for form, output in outputs.items():
            _, errs = check_embed_finish(field[0], output, *field[1:], valid,
                                         mask, f"{mask} {form} {label}")
            worst = tuple(map(max, worst, errs))
    del outputs
    flat = img.clone()
    flat[-1] = 77.0
    field = kernels.embed_field(flat, wm, None, "nvf")
    check(float(field[1][-1]) == 0.0, f"embed_finish {label}: a constant "
          f"frame's sum u_raw^2 is {float(field[1][-1])}")
    for output in (flat, flat.to(torch.uint8)):
        (marked, _), errs = check_embed_finish(
            field[0], output, *field[1:], torch.ones_like(valid), "nvf",
            f"nvf constant frame {output.dtype} {label}")
        check(output.dtype == torch.uint8 or bool(marked[-1].isnan().all()),
              f"embed_finish {label}: the NVF constant frame is not NaN")
        worst = tuple(map(max, worst, errs))
    return worst


def check_gram(img: torch.Tensor, label: str) -> tuple[float, ...]:
    """The 3x3 Gram's two kernels, each against its plain version on the
    same inputs (the lag kernel's strip sums; the assembly kernel's Gram
    from the plain sums), the Gram of both against the direct per-pair sums
    ``me_gram_plain`` within SUM_RTOL, and two calls bit-identical.
    Returns the Gram's (max abs err, max rel err), then the lag and the
    assembly kernel's max rel err."""
    sums = kernels.me_gram_lags(img)
    sums_plain = kernels.gram_lags_plain(img)
    lag_err = rel_err(sums, sums_plain)
    check(lag_err <= SUM_RTOL, f"me_gram {label}: lag kernel rel err "
          f"{lag_err:.3e}")
    assemble_err = rel_err(kernels.me_gram_assemble(sums_plain, img),
                           kernels.assemble_lags_plain(sums_plain, img))
    check(assemble_err <= SUM_RTOL, f"me_gram {label}: assembly kernel rel "
          f"err {assemble_err:.3e}")
    del sums, sums_plain
    gram = kernels.me_gram(img)
    plain = kernels.me_gram_plain(img)
    gram_err = rel_err(gram, plain)
    check(torch.allclose(gram, plain, rtol=SUM_RTOL, atol=0),
          f"me_gram {label}: rel err {gram_err:.3e}")
    check(torch.equal(kernels.me_gram(img), gram),
          f"me_gram {label}: two calls differ")
    return (float((gram - plain).abs().max()), gram_err, lag_err,
            assemble_err)


def check_solve(gram: torch.Tensor, label: str) -> tuple[float, float, bool]:
    """The 8x8 solve kernel against its plain version on the same (B, 9, 9)
    Gram: valid flags equal, coefficients within SOLVE_RTOL of each
    system's largest, and two calls bit-identical. Returns (max abs err,
    max rel err, bit-identical)."""
    got = kernels.spd_solve8(gram)
    want = kernels.spd_solve8_plain(gram)
    check(got[1].dtype == torch.bool and torch.equal(got[1], want[1]),
          f"spd_solve8 {label}: valid {got[1].tolist()} against "
          f"{want[1].tolist()}")
    abs_err = float((got[0] - want[0]).abs().max())
    scale = want[0].abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    rel = float(((got[0] - want[0]).abs() / scale).max())
    check(rel <= SOLVE_RTOL, f"spd_solve8 {label}: coefficients rel err "
          f"{rel:.3e} against the plain solve")
    again = kernels.spd_solve8(gram)
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          f"spd_solve8 {label}: two calls differ")
    return abs_err, rel, all(torch.equal(g, w) for g, w in zip(got, want))


def check_gram_solve(img: torch.Tensor, label: str
                     ) -> tuple[float, float, bool]:
    """The 3x3 Gram with the solve in its assembly kernel
    (``me_gram_solve8``): its Gram, coefficients and valid flags
    bit-identical to the two-call form ``spd_solve8(me_gram(x))`` and to
    the plain solve of its Gram, and two calls bit-identical; against its
    plain version, ``spd_solve8_plain(me_gram_plain(x))`` (the Gram's sums
    in another order, so not bit for bit), valid flags equal and
    coefficients within WIDE_SOLVE_ATOL, the solves' bound for a frame's
    Gram summed in another order. Returns (max abs err, max rel err)
    against the plain version and whether it matched it bit for bit."""
    gram, coeffs, valid = kernels.me_gram_solve8(img)
    two_calls = kernels.me_gram(img)
    check(torch.equal(gram, two_calls), f"me_gram_solve8 {label}: its Gram "
          f"differs from me_gram's")
    for name, want in (("spd_solve8(me_gram(x))", kernels.spd_solve8(
            two_calls)), ("the plain solve of its Gram",
                          kernels.spd_solve8_plain(gram))):
        check(torch.equal(valid, want[1]) and torch.equal(coeffs, want[0]),
              f"me_gram_solve8 {label}: not bit-identical to {name}: valid "
              f"{valid.tolist()} vs {want[1].tolist()}, coefficients abs "
              f"{float((coeffs - want[0]).abs().max()):.3e}")
    again = kernels.me_gram_solve8(img)
    check(all(torch.equal(g, a) for g, a in zip((gram, coeffs, valid),
                                                again)),
          f"me_gram_solve8 {label}: two calls differ")
    plain_coeffs, plain_valid = kernels.spd_solve8_plain(
        kernels.me_gram_plain(img))
    abs_err = float((coeffs - plain_coeffs).abs().max())
    scale = plain_coeffs.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    rel = float(((coeffs - plain_coeffs).abs() / scale).max())
    check(torch.equal(valid, plain_valid) and abs_err <= WIDE_SOLVE_ATOL,
          f"me_gram_solve8 {label}: against the plain Gram's solve valid "
          f"{valid.tolist()} vs {plain_valid.tolist()}, abs {abs_err:.3e}")
    return abs_err, rel, bool(torch.equal(coeffs, plain_coeffs))


def solve_text(result: tuple[float, float, bool]) -> str:
    return ("bit-identical" if result[2] else
            f"abs {result[0]:.2e}, rel {result[1]:.2e}") + " (two calls too)"


def random_spd_grams(batch: int, seed: int, k: int = 8,
                     ridge: float = 1e4) -> torch.Tensor:
    """(batch, k+1, k+1) Grams 3e5 A A^T + ridge I of N(0, 1) A: positive
    definite, with a frame Gram's scale (~1e7 on the diagonal). The wide
    solves take ridge 1e5, a frame Gram's conditioning at p = 5-9 (cond(Rx)
    ~2e2 at k = 24 to ~1e3 at k = 80; ~7e3 at k = 80 without it, where f32
    solves in any order differ by ~1e-4)."""
    a = np.random.default_rng(seed).normal(size=(batch, k + 1, k + 1))
    return torch.from_numpy((3e5 * (a @ a.transpose(0, 2, 1))
                             + ridge * np.eye(k + 1)).astype(np.float32)
                            ).cuda()


def check_solve_wide(gram: torch.Tensor, label: str
                     ) -> tuple[float, float, bool]:
    """The wide solve kernel against its plain version (the blocked
    Cholesky) on the same (B, k+1, k+1) Gram: valid flags equal,
    coefficients within WIDE_SOLVE_ATOL, and two calls bit-identical.
    Returns (max abs err, max err relative to each system's largest
    coefficient, bit-identical)."""
    got = kernels.spd_solve_wide(gram)
    want = kernels.spd_solve_wide_plain(gram)
    check(got[1].dtype == torch.bool and torch.equal(got[1], want[1]),
          f"spd_solve_wide {label}: valid {got[1].tolist()} against "
          f"{want[1].tolist()}")
    abs_err = float((got[0] - want[0]).abs().max())
    check(abs_err <= WIDE_SOLVE_ATOL, f"spd_solve_wide {label}: "
          f"coefficients abs err {abs_err:.3e} against the plain solve")
    scale = want[0].abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    rel = float(((got[0] - want[0]).abs() / scale).max())
    again = kernels.spd_solve_wide(gram)
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          f"spd_solve_wide {label}: two calls differ")
    return abs_err, rel, all(torch.equal(g, w) for g, w in zip(got, want))


def solve_accuracy(gram: torch.Tensor) -> tuple[float, float]:
    """(kernel, plain blocked solve) largest error against a float64
    ``torch.linalg.solve`` of the valid systems of a (B, k+1, k+1) Gram."""
    k = gram.shape[-1] - 1
    plain, valid = kernels.spd_solve_wide_plain(gram)
    exact = torch.linalg.solve(gram[valid, :k, :k].double(),
                               gram[valid, :k, k].double())
    kernel = kernels.spd_solve_wide(gram)[0][valid]
    return (float((kernel.double() - exact).abs().max()),
            float((plain[valid].double() - exact).abs().max()))


def accuracy_text(errors: tuple[float, float]) -> str:
    return (f"against float64 {errors[0]:.2e} (the plain blocked solve "
            f"{errors[1]:.2e}, {errors[0] / errors[1]:.2f}x)")


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
        gram_errors = check_gram(img, label)
        solved = check_solve(kernels.me_gram(img), label)
        fused = check_gram_solve(img, label)
        gram_plain = kernels.me_gram_plain(img)
        coeffs, valid = solve_coefficients_spd(gram_plain[:, :8, :8],
                                               gram_plain[:, :8, 8])
        check(bool(valid.all()), f"{label}: solve flagged a frame singular")
        if main_shape:
            errors["me_gram"] = gram_errors[:2]
            errors["spd_solve8"] = solved[:2]
            errors["me_gram_solve8"] = fused[:2]
        worst_u = worst_sum = worst_corr = worst_detect = 0.0
        for mask in ("me", "nvf"):
            u_err, sums_err = check_embed_field(img, wm, coeffs, mask, 3,
                                                label)

            corr_err, detect_err = detect_errors(
                kernels.detect_partials(img, wm, coeffs, mask),
                kernels.detect_partials_plain(img, wm, coeffs, mask))
            check(detect_err <= SUM_RTOL, f"detect_partials {mask} {label}: "
                  f"rel err {detect_err:.3e}")
            worst_u, worst_sum = max(worst_u, u_err), max(worst_sum, sums_err)
            worst_corr = max(worst_corr, corr_err)
            worst_detect = max(worst_detect, detect_err)
            if main_shape:
                suffix = "" if mask == "me" else "_nvf_p3"
                errors["embed_field" + suffix] = (u_err, sums_err)
                errors["detect_partials" + suffix] = (corr_err, detect_err)
        finish_errors = check_finish_cases(img, wm, coeffs, label)
        if main_shape:
            errors["embed_finish"] = finish_errors
        after = kernels.launch_counts()
        check(all(after[k] > before[k] for k in P3_KERNELS),
              f"{label}: a launch counter did not rise: {before} -> {after}")
        torch.cuda.synchronize()
        print(f"[2] {label}: me_gram lag kernel rel {gram_errors[2]:.2e}, "
              f"assembly kernel rel {gram_errors[3]:.2e}, Gram rel "
              f"{gram_errors[1]:.2e} (two calls bit-identical); "
              f"embed_field u_raw abs {worst_u:.2e} (bit-identical, as are "
              f"two calls), sums rel "
              f"{worst_sum:.2e}; detect_partials sums rel "
              f"{worst_detect:.2e}, corr abs {worst_corr:.2e}; spd_solve8 "
              f"on the kernel Gram {solve_text(solved)}; me_gram_solve8 "
              f"(the solve in the assembly kernel) bit-identical to "
              f"spd_solve8(me_gram(x)) and to the plain solve of its Gram "
              f"(two calls too), against the plain Gram's solve abs "
              f"{fused[0]:.2e}, rel {fused[1]:.2e}; embed_finish at ME "
              f"and NVF, frame 1 invalid, into f32, RGB and u8 outputs, and "
              f"an NVF constant frame's NaN: bit-identical (two calls too): "
              f"ok", flush=True)
    for batch in (1, 8, 300):
        solved = check_solve(random_spd_grams(batch, batch), f"B={batch}")
        print(f"[2] spd_solve8 on {batch} random SPD systems "
              f"({-(-batch // 128)} blocks): {solve_text(solved)}: ok",
              flush=True)
    flat = kernels.me_gram(torch.full((1, 40, 96), 77.0, device="cuda"))
    mixed = torch.cat([kernels.me_gram(frames_d[:1]), flat,
                       torch.zeros_like(flat)]).contiguous()
    solved = check_solve(mixed, "singular")
    coeffs, valid = kernels.spd_solve8(mixed)
    check(valid.tolist() == [True, False, False] and not coeffs[1:].any(),
          f"spd_solve8: a constant frame's and a zero system came back "
          f"{valid.tolist()}, {coeffs[1:].tolist()}")
    print(f"[2] spd_solve8 on a frame's, a constant frame's and a zero "
          f"Gram: valid [True, False, False], the singular ones zeros; "
          f"{solve_text(solved)}: ok", flush=True)
    # the fused form at B = 1, an odd batch and a batch of hundreds (grid
    # (13, B)), and with a constant frame between real ones
    gen = np.random.default_rng(7)
    for shape in ((1, ROWS, COLS), (7, 200, 300), (300, 40, 96)):
        img = torch.from_numpy(np.clip(gen.normal(128, 40, shape), 0, 255)
                               .astype(np.float32)).cuda()
        result = check_gram_solve(img, f"B={shape[0]}")
        print(f"[2] me_gram_solve8 on {'x'.join(map(str, shape))}: "
              f"bit-identical to spd_solve8(me_gram(x)) (two calls too), "
              f"against the plain Gram's solve abs {result[0]:.2e}: ok",
              flush=True)
    mixed = frames_d[:3].clone()
    mixed[1] = 77.0
    check_gram_solve(mixed, "constant frame")
    _, coeffs, valid = kernels.me_gram_solve8(mixed)
    check(valid.tolist() == [True, False, True] and not coeffs[1].any(),
          f"me_gram_solve8: a constant frame came back {valid.tolist()}, "
          f"{coeffs[1].tolist()}")
    print("[2] me_gram_solve8 on a constant frame between two real ones: "
          "valid [True, False, True], its coefficients zeros, bit-identical "
          "to spd_solve8(me_gram(x)): ok", flush=True)
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
    check(counts["spd_solve_wide"] == 0,
          f"the wide solve ran at p=3: {counts}")
    check(counts["spd_solve8"] == 0 and counts["me_gram_solve8"]
          == counts["me_gram_assemble"] == counts["me_gram_lags"],
          f"a single-device 3x3 Gram without its solve, or the solve kernel "
          f"alone: {counts}")
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


def host_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Host milliseconds per call of ``fn``: the host clock around
    ``iters`` calls with no synchronize between them, after one. The card
    runs behind without pacing the host while its launch queue has room
    (``iters`` calls of a few launches each), so this is what the host
    spends to enqueue a call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds * 1e3 / iters


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
    # the embed finish on the ME field: into the f32 frames (the step's
    # form) and into u8 lumas (the video's)
    field = kernels.embed_field(frames_d, wm_d, coeffs, "me")
    valid = torch.ones(BATCH, dtype=torch.bool, device=frames_d.device)
    for name, output in (("embed_finish", frames_d),
                         ("embed_finish_u8", frames_d.to(torch.uint8))):
        args = (field[0], output, *field[1:], valid,
                finish_numerator(field[0]), "me")
        pairs[name] = (lambda a=args: kernels.embed_finish(*a),
                       lambda a=args: kernels.embed_finish_plain(*a))
    times = {}
    for name, (kernel_fn, plain_fn) in pairs.items():
        times[name] = (cuda_ms(kernel_fn), cuda_ms(plain_fn))
        label = name if name.endswith("_p3") else f"{name} (ME p=3)"
        print(f"[4] {label} at 8x1080x1920: kernel {times[name][0]:.4f} ms, "
              f"plain {times[name][1]:.4f} ms", flush=True)
    times["spd_solve8"] = solve_times(kernels.me_gram(frames_d))
    times.update(gram_solve_times(frames_d))
    return times


def gram_solve_times(frames_d: torch.Tensor) -> dict:
    """ms a call of the 3x3 Gram with the solve in its assembly kernel
    (``me_gram_solve8``) beside the two calls it replaces,
    ``spd_solve8(me_gram(x))``, CUDA events in turns fused, two calls, two
    calls, fused (the least of each pair), and of its plain version
    ``spd_solve8_plain(me_gram_plain(x))``: {"me_gram_solve8": (fused,
    plain), "me_gram_solve8_two_calls": two calls}."""
    fns = {"fused": lambda: kernels.me_gram_solve8(frames_d),
           "two calls": lambda: kernels.spd_solve8(kernels.me_gram(frames_d))}
    runs: dict[str, list[float]] = {name: [] for name in fns}
    for name in (*fns, *reversed(fns)):
        runs[name].append(cuda_ms(fns[name], iters=50))
    plain = cuda_ms(lambda: kernels.spd_solve8_plain(
        kernels.me_gram_plain(frames_d)), iters=10)
    fused, two = min(runs["fused"]), min(runs["two calls"])
    gram = kernels.me_gram(frames_d)
    host = {"fused": [], "two calls": [], "me_gram": [], "spd_solve8": []}
    fns.update(me_gram=lambda: kernels.me_gram(frames_d),
               spd_solve8=lambda: kernels.spd_solve8(gram))
    for name in (*host, *reversed(host)):
        host[name].append(host_ms(fns[name]))
    host = {name: min(ms) for name, ms in host.items()}
    print(f"[4] me_gram_solve8 (the 3x3 Gram with the 8x8 solve in its "
          f"assembly, B={frames_d.shape[0]}): {fused:.4f} ms a call (runs "
          f"{runs['fused'][0]:.4f}, {runs['fused'][1]:.4f}); the two calls "
          f"spd_solve8(me_gram(x)) {two:.4f} ms (runs "
          f"{runs['two calls'][0]:.4f}, {runs['two calls'][1]:.4f}); plain "
          f"{plain:.4f} ms; host ms a call (enqueue, host_ms): fused "
          f"{host['fused']:.4f}, two calls {host['two calls']:.4f} "
          f"(me_gram {host['me_gram']:.4f}, spd_solve8 "
          f"{host['spd_solve8']:.4f})", flush=True)
    return {"me_gram_solve8": (fused, plain),
            "me_gram_solve8_two_calls": two,
            "me_gram_solve8_host": host}


def library_solve(gram: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The k-unknown systems of a (B, k+1, k+1) Gram by the library pair:
    one ``cholesky_ex`` and one ``cholesky_solve`` (the yardstick of the
    kernels line's ``library_ms``; the kernel route never calls it)."""
    k = gram.shape[-1] - 1
    lower, info = torch.linalg.cholesky_ex(gram[:, :k, :k])
    return torch.cholesky_solve(gram[:, :k, k:], lower)[:, :, 0], info == 0


def solve_times(gram: torch.Tensor, wide: bool = False
                ) -> tuple[float, float, float]:
    """(kernel, plain solve, library pair) ms a call of the 8x8 solve
    kernel, or with ``wide`` the wide one, on the frames' (8, k+1, k+1)
    Gram, CUDA events, in turns kernel, plain, library, library, plain,
    kernel (the least of each pair)."""
    kernel, plain = ((kernels.spd_solve_wide, kernels.spd_solve_wide_plain)
                     if wide else (kernels.spd_solve8,
                                   kernels.spd_solve8_plain))
    fns = {"kernel": lambda: kernel(gram), "plain": lambda: plain(gram),
           "library": lambda: library_solve(gram)}
    # the plain blocked solve is thousands of launches a call
    iters = {"kernel": 50, "plain": 10 if wide else 50, "library": 50}
    runs: dict[str, list[float]] = {name: [] for name in fns}
    for name in (*fns, *reversed(fns)):
        runs[name].append(cuda_ms(fns[name], iters=iters[name]))
    coeffs, _ = library_solve(gram)
    lib_err = float((coeffs - kernel(gram)[0]).abs().max())
    ms = tuple(min(runs[name]) for name in fns)
    k = gram.shape[-1] - 1
    label = (f"spd_solve_wide p={math.isqrt(k + 1)} ({k} unknowns"
             if wide else "spd_solve8 (8x8 solve")
    print(f"[4] {label}, B={gram.shape[0]}): kernel "
          f"{ms[0]:.4f} ms (runs {runs['kernel'][0]:.4f}, "
          f"{runs['kernel'][1]:.4f}), plain "
          f"{'blocked' if wide else 'unrolled'} solve {ms[1]:.4f} ms, "
          f"library cholesky_ex + cholesky_solve {ms[2]:.4f} ms (its "
          f"coefficients abs {lib_err:.1e} from the kernel's)", flush=True)
    return ms


def predictor_coefficients(img: torch.Tensor) -> dict[int, torch.Tensor]:
    """The frames' (p*p-1)-tap ME predictor at each p from the plain Gram
    and solves (p=3's is also NVF detection's at every p)."""
    coeffs = {}
    for p in ALL_P:
        k = p * p - 1
        if p == 3:
            gram = kernels.me_gram_plain(img)
            coeffs[p], valid = solve_coefficients_spd(gram[:, :k, :k],
                                                      gram[:, :k, k])
        else:
            gram = kernels.me_gram_wide_plain(img, p)
            coeffs[p], valid = solve_coefficients_spd_wide(gram[:, :k, :k],
                                                           gram[:, :k, k])
        check(bool(valid.all()), f"p={p}: the solve flagged a frame")
    return coeffs


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
            # each kernel against its plain version on the same inputs
            sums, edges = kernels.wide_lag_strips(img, p)
            sums_plain, edges_plain = kernels.lag_strips_plain(img, p)
            lag_err = max(rel_err(sums, sums_plain),
                          rel_err(edges, edges_plain))
            check(lag_err <= SUM_RTOL, f"me_gram_wide {label}: lag kernel "
                  f"rel err {lag_err:.3e}")
            assembled = kernels.wide_assemble(
                sums_plain, edges_plain, *kernels.frame_banks(img, p), p,
                img.shape[1])
            assembled_plain = kernels.assemble_strips_plain(
                sums_plain, edges_plain, *kernels.frame_banks(img, p), p)
            assemble_err = rel_err(assembled, assembled_plain)
            check(assemble_err <= SUM_RTOL, f"me_gram_wide {label}: "
                  f"assembly kernel rel err {assemble_err:.3e}")
            del sums_plain, edges_plain
            # the Gram of both against the plain lag form and, at the small
            # shape, the direct per-pair sums, which share nothing with it
            gram = kernels.me_gram_wide(img, p)
            plain = kernels.me_gram_wide_plain(img, p)
            check(torch.allclose(gram, plain, rtol=SUM_RTOL, atol=0),
                  f"me_gram_wide {label}: Gram rel err against the plain "
                  f"lag form {rel_err(gram, plain):.3e}")
            check(torch.equal(kernels.me_gram_wide(img, p), gram),
                  f"me_gram_wide {label}: two calls differ")
            worst = {"gram": rel_err(gram, plain)}
            if not main_shape:
                direct = gram_direct(img, p)
                check(torch.allclose(gram, direct, rtol=SUM_RTOL, atol=0),
                      f"me_gram_wide {label}: Gram rel err against the "
                      f"direct sums {rel_err(gram, direct):.3e}")
                worst["direct"] = rel_err(gram, direct)
            else:
                errors[f"me_gram_wide_p{p}"] = (
                    float((gram - plain).abs().max()), worst["gram"])
            solved = check_solve_wide(gram, label)
            accuracy = solve_accuracy(gram)
            if main_shape:
                errors[f"spd_solve_wide_p{p}"] = solved[:2]
                check(accuracy[0] <= WIDE_SOLVE_ACCURACY * accuracy[1],
                      f"spd_solve_wide {label}: error against float64 "
                      f"{accuracy[0]:.3e}, over {WIDE_SOLVE_ACCURACY}x the "
                      f"plain blocked solve's {accuracy[1]:.3e}")
            coeffs = predictor_coefficients(img)
            for mask in ("me", "nvf"):
                c = coeffs[p if mask == "me" else 3]
                u_err, sums_err = check_embed_field(img, wm, c, mask, p,
                                                    label)
                corr_err, detect_err = detect_errors(
                    kernels.detect_partials(img, wm, c, mask, p),
                    kernels.detect_partials_plain(img, wm, c, mask, p))
                check(detect_err <= SUM_RTOL, f"detect_partials {mask} "
                      f"{label}: rel err {detect_err:.3e}")
                worst[mask] = (u_err, sums_err, corr_err, detect_err)
                if main_shape:
                    errors[f"embed_field_{mask}_p{p}"] = (u_err, sums_err)
                    errors[f"detect_partials_{mask}_p{p}"] = (corr_err,
                                                              detect_err)
            after = kernels.launch_counts()
            check(all(after[n] > before[n] for n in
                      (*WIDE_GRAM_SOLVE_KERNELS, "embed_field",
                       "detect_partials")),
                  f"{label}: a launch counter did not rise: {before} -> "
                  f"{after}")
            torch.cuda.synchronize()
            masks = "; ".join(
                f"{m}: u_raw abs {worst[m][0]:.2e} (bit-identical), sums rel "
                f"{worst[m][1]:.2e}, detect sums rel {worst[m][3]:.2e}, corr "
                f"abs {worst[m][2]:.2e}" for m in ("me", "nvf"))
            direct_note = (f", against the direct sums "
                           f"{worst['direct']:.2e}" if "direct" in worst
                           else "")
            print(f"[2] {label}: me_gram_wide lag kernel rel {lag_err:.2e}, "
                  f"assembly kernel rel {assemble_err:.2e}, Gram rel against "
                  f"the plain lag form {worst['gram']:.2e}{direct_note}, two "
                  f"calls bit-identical; spd_solve_wide on the kernel Gram "
                  f"{solve_text(solved)}, {accuracy_text(accuracy)}; "
                  f"{masks}: ok", flush=True)
        k = p * p - 1
        for batch in (1, 8, 300):
            systems = random_spd_grams(batch, batch + p, k, ridge=1e5)
            solved = check_solve_wide(systems, f"p={p} B={batch}")
            print(f"[2] spd_solve_wide on {batch} random SPD systems of {k} "
                  f"unknowns ({batch} blocks): {solve_text(solved)}, "
                  f"{accuracy_text(solve_accuracy(systems))}: ok",
                  flush=True)
        flat = kernels.me_gram_wide(torch.full((1, 40, 96), 77.0,
                                               device="cuda"), p)
        mixed = torch.cat([kernels.me_gram_wide(frames_d[:1], p), flat,
                           torch.zeros_like(flat)]).contiguous()
        solved = check_solve_wide(mixed, f"p={p} singular")
        coeffs, valid = kernels.spd_solve_wide(mixed)
        check(valid.tolist() == [True, False, False] and not coeffs[1:].any(),
              f"spd_solve_wide p={p}: a constant frame's and a zero system "
              f"came back {valid.tolist()}")
        print(f"[2] spd_solve_wide p={p} on a frame's, a constant frame's and "
              f"a zero wide Gram: valid [True, False, False], the singular "
              f"ones zeros; {solve_text(solved)}: ok", flush=True)
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

    check(all(counts["me"][n] > 0 for n in WIDE_GRAM_KERNELS)
          and all(counts["nvf"][n] > 0 for n in GRAM_SOLVE_KERNELS)
          and total["embed_field"] > 0 and total["detect_partials"] > 0
          and counts["me"]["embed_finish"] == counts["nvf"]["embed_finish"]
          == 1,
          f"p={p}: a kernel was never launched on the main path (or the "
          f"embed finish not once an embed): {counts}")
    # one wide solve an ME analysis (the embed and two detects), none in
    # the NVF part (its 3x3 predictor)
    check(counts["nvf"]["spd_solve8"] == 0 and counts["nvf"]["me_gram_solve8"]
          == counts["nvf"]["me_gram_assemble"],
          f"p={p}: the NVF part's 3x3 Grams did not solve in their assembly: "
          f"{counts['nvf']}")
    check(counts["me"]["spd_solve_wide"] == counts["me"]["wide_assemble"] == 3
          and counts["nvf"]["spd_solve_wide"] == 0,
          f"p={p}: wide solves {counts['me']['spd_solve_wide']} (ME), "
          f"{counts['nvf']['spd_solve_wide']} (NVF), expected 3 and 0")
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

    coeffs = predictor_coefficients(frames_d)
    pairs = {f"me_gram_wide_p{p}": (
        lambda: kernels.me_gram_wide(frames_d, p),
        lambda: kernels.me_gram_wide_plain(frames_d, p))}
    for mask in ("me", "nvf"):
        c = coeffs[p if mask == "me" else 3]
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
    times[f"spd_solve_wide_p{p}"] = solve_times(
        kernels.me_gram_wide(frames_d, p), wide=True)
    return times


def device_ms(fns, patterns: dict[str, str], calls: int = 20,
              tries: int = 3) -> dict[str, float]:
    """Device ms a call of each kernel whose name holds ``patterns[key]``,
    keyed as ``patterns``, from torch.profiler's kernel records of one
    session over ``calls`` calls of each of ``fns`` in turn (CUDA events
    around a call would count the wrappers' host time when it exceeds a
    kernel's); each fn launches each of its kernels once a call. The
    profiler may drop records: a mean is over the records it kept, and a
    session that kept none of some kernel is run again. Run after every
    other timing: the profiler's tracing may stay attached and slow later
    launches."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                for _ in range(calls):
                    fn()
            torch.cuda.synchronize()
        total = dict.fromkeys(patterns, 0.0)
        seen = dict.fromkeys(patterns, 0)
        for event in prof.events():
            if event.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for key, pattern in patterns.items():
                if pattern in event.name:
                    total[key] += event.device_time_total / 1e3
                    seen[key] += 1
        if all(seen.values()):
            return {key: total[key] / seen[key] for key in patterns}
    check(False, f"the profiler kept no record of "
          f"{[patterns[key] for key, n in seen.items() if not n]}")


def detect_errors(got: tuple, want: tuple) -> tuple[float, float]:
    """(max abs err of the correlations, max rel err of the sums) of a
    detect kernel's (dot, norm_u, norm_z) against the plain version's: the
    detect tail's, (B,) each, or the multi-candidate kernel's, (B, N) and
    norm_z (B,). A dot's error is taken relative to sqrt(norm_u * norm_z),
    the most |dot| can be: a watermark that the frame does not carry has a
    dot near 0, where an error relative to the dot itself means nothing
    (fused multiply-adds in e_u move it by more than 1e-4 of itself)."""
    dot, norm_u, norm_z = got
    dot_w, norm_u_w, norm_z_w = want
    spread = (1,) * (dot.ndim - 1)   # norm_z against each candidate
    scale = torch.sqrt(norm_u_w * norm_z_w.reshape(-1, *spread))
    sums = max(float(((dot - dot_w).abs() / scale).max()),
               rel_err(norm_u, norm_u_w), rel_err(norm_z, norm_z_w))
    corr = dot / torch.sqrt(norm_u * norm_z.reshape(-1, *spread))
    return float((corr - dot_w / scale).abs().max()), sums


def row_name(kernel: str, mask: str, p: int) -> str:
    """The kernels line's row name of the embed field or the detect tail
    ("embed_field", "detect_partials") at mask and p."""
    if p == 3:
        return kernel + ("" if mask == "me" else "_nvf_p3")
    return f"{kernel}_{mask}_p{p}"


def device_split(frames_d: torch.Tensor, wm_d: torch.Tensor) -> dict:
    """Device ms a call of the 3x3 Gram's two kernels (keyed
    "me_gram_lags", "me_gram_assemble", and their sum "me_gram"), of the
    8x8 solve kernel on the frames' Gram ("spd_solve8"), of the
    wide Gram's two kernels and the wide solve kernel at p = 5, 7, 9 (keyed
    "wide_lag_strips_p5", ..., "spd_solve_wide_p5", ...) and of the embed
    field and the detect tail at ME and NVF p = 3, 5, 7, 9 (keyed by
    kernel row name), of the standalone prediction error and NVF mask at
    each p ("prediction_error_p3", ..., "nvf_mask_p3", ...) and of the
    embed finish into f32 frames and u8 lumas ("embed_finish",
    "embed_finish_u8"), from one ``device_ms`` session;
    each
    kernel is told apart by its name and template arguments. The 3x3
    assembly kernel is a programmatic dependent launch: it may start
    beside the lag kernel's last wave and wait there, so its device time
    holds that wait and the sum counts the overlap twice; CUDA events
    around ``me_gram`` (phase 4) time the pair as it runs."""
    coeffs = predictor_coefficients(frames_d)
    gram = kernels.me_gram(frames_d)
    fns = [lambda: kernels.me_gram(frames_d),
           lambda: kernels.spd_solve8(gram),
           lambda: kernels.me_gram_solve8(frames_d)]
    # the lag kernel serves both forms of the 3x3 Gram alike; the assembly
    # kernel without the solve and with it
    patterns = {"me_gram_lags": "me_gram_lags_kernel",
                "me_gram_assemble": "me_gram_assemble_kernel<false>",
                "me_gram_assemble_solve8": "me_gram_assemble_kernel<true>",
                "spd_solve8": "spd_solve8_kernel"}
    for p in WIDE_P:
        fns.append(lambda p=p: kernels.me_gram_wide(frames_d, p))
        for kernel in WIDE_GRAM_KERNELS:
            patterns[f"{kernel}_p{p}"] = f"{kernel}_kernel<{p // 2}>"
        wide_gram = kernels.me_gram_wide(frames_d, p)
        fns.append(lambda g=wide_gram: kernels.spd_solve_wide(g))
        patterns[f"spd_solve_wide_p{p}"] = (
            f"spd_solve_wide_kernel<{p * p - 1}>")
    for p in ALL_P:
        for mask in ("me", "nvf"):
            c = coeffs[p if mask == "me" else 3]
            fns.append(lambda c=c, m=mask, p=p: kernels.embed_field(
                frames_d, wm_d, c if m == "me" else None, m, p))
            patterns[row_name("embed_field", mask, p)] = (
                f"embed_field_kernel<{MASK_CODES[mask]}, {p // 2}>")
            fns.append(lambda c=c, m=mask,
                       p=p: kernels.detect_partials(frames_d, wm_d, c, m, p))
            half = (p // 2, 0) if mask == "me" else (1, p // 2)
            patterns[row_name("detect_partials", mask, p)] = (
                f"detect_tail_kernel<{MASK_CODES[mask]}, {half[0]}, "
                f"{half[1]}>")
    # the standalone ops, which no main path runs
    for p in ALL_P:
        fns.append(lambda p=p: kernels.prediction_error(frames_d, coeffs[p],
                                                        p))
        patterns[f"prediction_error_p{p}"] = (
            f"prediction_error_kernel<{p // 2}>")
        fns.append(lambda p=p: kernels.nvf_mask(frames_d, p))
        patterns[f"nvf_mask_p{p}"] = f"nvf_mask_kernel<{p // 2}>"
    field = kernels.embed_field(frames_d, wm_d, coeffs[3], "me")
    valid = torch.ones(BATCH, dtype=torch.bool, device=frames_d.device)
    for name, output, dtype in (
            ("embed_finish", frames_d, "float"),
            ("embed_finish_u8", frames_d.to(torch.uint8), "unsigned char")):
        fns.append(lambda o=output: kernels.embed_finish(
            field[0], o, *field[1:], valid, finish_numerator(field[0]),
            "me"))
        patterns[name] = f"embed_finish_kernel<{dtype}"
    split = device_ms(fns, patterns)
    split["me_gram"] = sum(split[name] for name in GRAM_KERNELS)
    split["me_gram_solve8"] = (split["me_gram_lags"]
                               + split["me_gram_assemble_solve8"])
    return split


def step_kernels(frames_d: torch.Tensor, wm_d: torch.Tensor, p: int,
                 steps: int = 5) -> tuple[float, float, float]:
    """(device kernels, device busy ms, host ms) a step of phase 4's
    chained 8-frame ME embed+detect step at window p through the kernels:
    the first two from torch.profiler's kernel records over ``steps``
    steps after 3 (the records it drops make a count low, never high), the
    host's enqueue time from ``host_ms`` over 20 steps."""
    sf = strength_factor(PSNR)
    state = {"frames": frames_d}

    def step():
        marked, _ = batch_embed(state["frames"], state["frames"], wm_d, sf,
                                "me", p=p, impl="cuda")
        batch_detect(marked, wm_d, "me", p=p, impl="cuda")
        state["frames"] = marked
    host = host_ms(step, iters=20)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    records = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (len(records) / steps,
            sum(e.device_time_total for e in records) / 1e3 / steps, host)


def halo_device_split(frames_d: torch.Tensor, wm_d: torch.Tensor,
                      bank_d: torch.Tensor) -> dict:
    """Device ms a call of the halo forms on an interior shard of 270 and
    of 540 rows (phase 6's shards; ``halo_timing_pairs``), one
    ``device_ms`` session a shard height: {(row name, shard rows): ms}, the
    3x3 Gram as its two kernels' sum (counting the assembly's wait, as
    ``device_split``), the wide Gram as its lag kernel."""
    coeffs = predictor_coefficients(frames_d)
    split = {}
    for space in HALO_SPACES:
        rows = ROWS // space
        pairs = halo_timing_pairs(frames_d, wm_d, bank_d, coeffs, rows)
        patterns = {}
        for pair in pairs.values():
            patterns.update(pair[-1])
        times = device_ms([pair[3] for pair in pairs.values()], patterns)
        times["me_gram"] = sum(times.pop(name) for name in GRAM_KERNELS)
        split.update({(name, rows): ms for name, ms in times.items()})
    return split


def phase_identify_kernels(frames_d: torch.Tensor,
                           bank_d: torch.Tensor) -> dict:
    """The multi-candidate kernel at ME and NVF p = 3, 5, 7, 9 and the
    standalone prediction error and NVF mask at each p, against their plain
    versions on the same inputs, at 8 x 1080 x 1920 with the 64-candidate
    bank and at 3 x 37 x 83 with 70 (a full chunk and a partial one).
    Returns per-row (max abs err, max rel err) at the main path's shape: for
    the standalone ops the error of the output, relative to its largest
    value."""
    errors = {}
    gen = np.random.default_rng(7)
    small = torch.from_numpy(np.clip(gen.normal(128, 40, (3, 37, 83)), 0,
                                     255).astype(np.float32)).cuda()
    small_bank = torch.from_numpy(
        gen.normal(size=(70, 37, 83)).astype(np.float32)).cuda()
    for img, bank in ((frames_d, bank_d), (small, small_bank)):
        label = "x".join(str(n) for n in img.shape) + f" N={bank.shape[0]}"
        coeffs = predictor_coefficients(img)
        before = kernels.launch_counts()
        worst = {}
        for p in ALL_P:
            for mask in ("me", "nvf"):
                c = coeffs[p if mask == "me" else 3]
                name = f"detect_many_{mask}_p{p}"
                worst[name] = detect_errors(
                    kernels.detect_many_partials(img, bank, c, mask, p),
                    kernels.detect_many_partials_plain(img, bank, c, mask,
                                                       p))
                check(worst[name][1] <= SUM_RTOL,
                      f"{name} {label}: sums rel err {worst[name][1]:.3e}")
            for name, got, want in (
                    (f"prediction_error_p{p}",
                     kernels.prediction_error(img, coeffs[p], p),
                     kernels.prediction_error_plain(img, coeffs[p], p)),
                    (f"nvf_mask_p{p}", kernels.nvf_mask(img, p),
                     kernels.nvf_mask_plain(img, p))):
                abs_err = float((got - want).abs().max())
                check(same_bits(got, want),
                      f"{name} {label}: not bit-identical to the plain "
                      f"version, max abs err {abs_err:.3e}")
                worst[name] = (abs_err, abs_err / float(want.abs().max()))
            # one (H, W) frame, as the JAX package's standalone ops take it
            check(same_bits(kernels.prediction_error(img[1], coeffs[p][1], p),
                            kernels.prediction_error_plain(
                                img[1:2], coeffs[p][1:2], p)[0])
                  and same_bits(kernels.nvf_mask(img[1], p),
                                kernels.nvf_mask_plain(img[1:2], p)[0]),
                  f"p={p} {label}: the (H, W) form of a standalone op is "
                  f"not bit-identical to the plain version")
        after = kernels.launch_counts()
        check(all(after[k] > before[k] for k in ("detect_many",
                                                  *STANDALONE_KERNELS)),
              f"{label}: a launch counter did not rise: {before} -> {after}")
        torch.cuda.synchronize()
        many = [v for k, v in worst.items() if k.startswith("detect_many")]
        alone = [v[0] for k, v in worst.items()
                 if not k.startswith("detect_many")]
        print(f"[2] {label}: detect_many at ME and NVF p = 3, 5, 7, 9: sums "
              f"rel {max(v[1] for v in many):.2e}, corr abs "
              f"{max(v[0] for v in many):.2e}; prediction_error and nvf_mask "
              f"at p = 3, 5, 7, 9, (B, H, W) and (H, W): bit-identical (max "
              f"abs {max(alone):.2e}): ok", flush=True)
        if img is frames_d:
            errors = worst
    return errors


# Computed by the JAX package (watermarking_gpu_tpu, impl="xla") on the CPU
# from make_frames()[0] and make_bank(), by
#   JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py \
#       --identify me:3 nvf:3 me:5
# and, for ME P = 7 and 9,
#   JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py \
#       --identify me:7 me:9
# and, for NVF P = 5, 7 and 9,
#   JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py \
#       --identify nvf:5 nvf:7 nvf:9
# embed_pipeline(frame, frame, W, strength_factor(40), mask, p), then
# detect_many_pipeline of the marked frame ("marked") and of the clean one
# ("clean") against the 64 candidates.
JAX_IDENTIFY_REFERENCE = {
    "me:3": {
        "marked": [
            0.0017552983, 0.00014382071, -0.0018654284, 0.0001468621,
            0.0017927657, 0.00062137615, -0.00090063305, -0.00042619949,
            -0.00045865678, 0.00038274075, 0.0017631896, 0.00058080896,
            0.00064095668, 0.0018760331, 5.8335041e-05, -0.00074456859,
            -0.0021302777, 0.13074884, 0.0013008174, 0.0016730988,
            -0.00058278959, -0.001004977, 0.0011185304, -0.0026744769,
            0.00048616325, -0.00077599147, -0.0003328952, 0.00081145635,
            0.0014747133, -0.00015034007, 0.001363015, -0.0016008483,
            -0.0013679459, -0.00025787891, -0.0005918605, 0.0006442481,
            0.0014857535, -0.00050474418, -1.5598327e-05, -0.0012532339,
            0.00070143113, -0.00047819992, 0.0001299976, -0.0016357674,
            -0.0019876733, 0.0012452999, 0.0020823926, -0.0025590986,
            0.00059093052, 0.0006884234, 0.0013996022, -0.0023637824,
            -0.00044351231, 0.0010576192, -0.0019242701, 0.0016971288,
            -0.00039102283, -0.0028198911, 0.00053389109, 0.0012218122,
            -0.00040352333, -0.00014954612, 0.00074560603, -0.00077578408
        ],
        "clean": [
            0.0017267846, 0.00025560416, -0.0018353035, -8.7694985e-05,
            0.0017734254, 0.00046537339, -0.00091460889, -0.00055918656,
            -0.00058077404, 0.00058088318, 0.0018424572, 0.00045071857,
            0.00058116368, 0.0017080955, -5.993298e-05, -0.00057210075,
            -0.0022044461, 0.0025358004, 0.0013010749, 0.0016764931,
            -0.00067069248, -0.0011443954, 0.00099732832, -0.002869467,
            0.00075503316, -0.00086469162, -0.00026037975, 0.00079075218,
            0.0016330237, 2.9812172e-05, 0.0012925394, -0.0016199449,
            -0.0014971279, -0.00044898008, -0.00040614154, 0.00064401963,
            0.0014739499, -0.00060653285, 0.00016949855, -0.00092805055,
            0.00075579097, -0.00055393542, -3.6036683e-05, -0.0015370235,
            -0.0019907432, 0.0010663744, 0.0021840085, -0.0025268288,
            0.00084589026, 0.00067189493, 0.0015506481, -0.0020951899,
            -0.0004601808, 0.0010172608, -0.0018797873, 0.0017469638,
            -0.0005439886, -0.0029137484, 0.00063733722, 0.0013196426,
            -0.000509798, 0.00011311319, 0.00076401012, -0.0006682729
        ],
    },
    "nvf:3": {
        "marked": [
            0.0010897518, -0.00015956207, -0.001705746, -0.0002358171,
            0.0008560968, 0.00017494419, -0.00066261698, -0.00069295347,
            -0.00047956032, 0.00035944048, 0.00056917476, 0.00067755836,
            0.00054929749, 0.0011871544, 0.00013105322, -4.7004123e-05,
            -0.0013993357, 0.064629048, 0.00073509291, 0.00047868665,
            -0.00029170068, -0.00046572209, 0.00064929872, -0.0019589493,
            0.00047422809, -0.00035314402, 0.00024273194, -0.00031655654,
            0.00072595797, -4.4386663e-05, 0.00022747672, -0.00059329456,
            -0.00070312154, -0.000197355, -0.00018196579, 0.00023098792,
            0.00096172717, -0.00023531748, 0.00046521763, -0.00040429295,
            0.00054482953, -0.00076846546, 1.5431659e-05, -0.0011165764,
            -0.0016560366, 0.00075277081, 0.0016842539, -0.0019023294,
            0.00014822048, 0.0008747704, 0.00067494222, -0.0011038077,
            -0.00019170568, 0.00029556913, -0.00076003972, 0.0011802538,
            -0.00039353728, -0.0016703639, 0.00026855548, 0.00064459187,
            1.7453693e-05, -0.00017259442, 0.00051019312, -0.00077316962
        ],
        "clean": [
            0.0010633613, -0.00022940896, -0.0016081939, -0.00022946249,
            0.000838576, 0.00015674757, -0.00064241519, -0.00066409499,
            -0.0004397523, 0.00046326368, 0.0005986141, 0.00058678578,
            0.00055010483, 0.001180599, 9.8895711e-05, -5.688889e-05,
            -0.0014362235, 0.0010031174, 0.00064474536, 0.00054077368,
            -0.00027581741, -0.00049798517, 0.00059886416, -0.0020099499,
            0.00049835467, -0.00033391244, 0.00023770684, -0.0002548726,
            0.00076621014, -7.1520822e-06, 0.00024938612, -0.00054448837,
            -0.00068698695, -0.00021345087, -0.00014821715, 0.00024068565,
            0.00098714931, -0.00027290138, 0.00041630288, -0.00027624305,
            0.00044931768, -0.00080113148, -1.295463e-05, -0.0010944083,
            -0.0016094391, 0.00068748015, 0.0015870727, -0.0018314261,
            0.00023747935, 0.00084795716, 0.00064099109, -0.00099015771,
            -0.00011965273, 0.00034967682, -0.0008061385, 0.0012515103,
            -0.00041192718, -0.0016974667, 0.00033930488, 0.00064388983,
            1.7170951e-05, -0.00023165405, 0.00054546283, -0.0007842757
        ],
    },
    "me:5": {
        "marked": [
            0.0010921702, -0.0001131691, -0.0014025306, 0.00047552775,
            0.00081037841, 0.00046637637, -0.00061571295, -0.00090878457,
            0.00017740854, 0.00082211115, 0.00095937517, 0.00057844864,
            0.0011404399, 0.0019181786, 0.00021033989, -0.00088455563,
            -0.00234053, 0.12827303, 0.0013835474, 0.0012716141,
            -4.1829386e-05, -0.001418134, 0.0015290165, -0.0028418628,
            0.00073770009, -0.00063309452, -0.00096036756, 0.00019890592,
            0.0010983624, -0.0010262864, 0.00077679835, -0.00081793126,
            -0.001624485, 0.00017870798, -0.00047321123, 0.00094616314,
            0.0010921274, 1.4619524e-05, 0.00020212936, -0.0014956029,
            0.00093008351, 4.6851292e-05, 0.0007359155, -0.0014918179,
            -0.0014105467, 0.0011209545, 0.00039589539, -0.002776809,
            0.00047802605, -0.00050010614, 0.00092517876, -0.0017550683,
            -0.00056431186, 0.001146596, -0.0017540314, 0.00057969394,
            -0.00076561229, -0.0021527261, -0.00044839634, 0.00067821477,
            -0.00065086235, 0.0006740645, 0.0008439059, -0.001308544
        ],
        "clean": [
            0.0010522075, -3.6737576e-05, -0.0014178704, 0.00029064654,
            0.00084022258, 0.00041263504, -0.00055605394, -0.0011074878,
            0.00011833732, 0.00099553517, 0.0011300021, 0.00053352531,
            0.0011113416, 0.001717019, 5.7098105e-06, -0.00074817485,
            -0.0023097803, 0.0020096984, 0.0012189421, 0.001211462,
            -0.00016844361, -0.0015340176, 0.0014314897, -0.0031154773,
            0.0011099247, -0.00077867083, -0.0010043228, 0.00022511685,
            0.0012937764, -0.00090821029, 0.000782063, -0.00087854656,
            -0.0017965343, -7.545657e-05, -0.00041542188, 0.00093036855,
            0.0012008979, 7.3608255e-08, 0.00030188981, -0.0013403258,
            0.00097576232, 8.6618202e-05, 0.00052758114, -0.0013861564,
            -0.0014844654, 0.0010013024, 0.00044941634, -0.0027692113,
            0.00073779415, -0.00058946974, 0.0011951715, -0.0015547489,
            -0.00051712431, 0.00096969842, -0.0017540461, 0.00078220799,
            -0.00090443116, -0.0022667209, -0.00041370094, 0.00082209503,
            -0.00069406384, 0.00095467299, 0.00080348772, -0.0011433944
        ],
    },
    "me:7": {
        "marked": [
            0.0013118761, 0.00010727708, -0.0014377378, 0.00013284988,
            0.0009104186, 0.0003984148, -0.0010149747, -0.00096890976,
            0.00019009941, 0.0009186058, 0.000814956, 0.00057032605,
            0.0012030496, 0.0020901812, -0.00033833444, -0.0006746183,
            -0.0016473511, 0.127101, 0.0012238172, 0.0013791171,
            -0.00017039948, -0.0014822171, 0.0012044227, -0.0023877653, 0.00044600188,
            -0.00066592067, -0.00034872844, -0.0001491863, 0.00068371807,
            -0.0008874119, 0.0005533109, -6.73654e-05, -0.0015673701,
            -9.236658e-05, -0.00012904243, 0.00079977245, 0.00061924366,
            0.00031557024, -0.00014565534, -0.0015054274, 0.0010607565,
            -4.3173797e-05, 0.00056049693, -0.0011423717, -0.0012138172,
            0.0014816662, 0.00016004396, -0.0026739375, 0.0005757925,
            8.866932e-06, 0.00059709913, -0.0015424949, -0.00036022483,
            0.001074894, -0.0016772286, 0.00019456167, -0.00038016733,
            -0.002354206, 0.00021737511, 0.0009984979, -0.0005499544,
            0.0010287131, 0.00091437047, -0.0013223005
        ],
        "clean": [
            0.0012869328, 0.00017927462, -0.0014223331, -5.5364144e-05,
            0.00094385585, 0.00036135787, -0.00089477154, -0.0011828316,
            0.00010832493, 0.0010758027, 0.0009804232, 0.00048692152,
            0.00119147, 0.0019207314, -0.0004883442, -0.00049850415,
            -0.0016766952, 0.0013779975, 0.0010422028, 0.0013461937,
            -0.00035781867, -0.0015830565, 0.0012072896, -0.0027126172,
            0.0008471249, -0.00082357024, -0.0004409312, -8.110672e-05,
            0.0008705253, -0.00072444446, 0.000624379, -0.00013539009,
            -0.0016803605, -0.00026967403, -4.1021638e-05, 0.0008027514,
            0.00065093994, 0.00031470877, -1.648547e-05, -0.0013850149,
            0.0011221475, -6.796074e-05, 0.00033653897, -0.0010558404,
            -0.0012746988, 0.0013757582, 0.00023738302, -0.002551831,
            0.000765359, -1.5582955e-05, 0.0008109311, -0.0012626001,
            -0.00033464594, 0.00094407087, -0.001706533, 0.0003786731,
            -0.0005445159, -0.0023723491, 0.00024849054, 0.0010810664,
            -0.00057555886, 0.0013180409, 0.0008585623, -0.0011476484
        ],
    },
    "me:9": {
        "marked": [
            0.0011999512, 0.00023995772, -0.0013787708, 3.586472e-05,
            0.0007746614, 0.00039150062, -0.0009986861, -0.0009517684,
            0.00017814215, 0.0009036398, 0.000845812, 0.0006043239,
            0.00096944696, 0.0019732225, -0.0005082573, -0.0008308137,
            -0.0016798568, 0.1267925, 0.0014780951, 0.001333386, -0.0002322665,
            -0.0017527321, 0.0011658714, -0.0021970375, 0.00076109904,
            -0.0008391614, -0.0006324984, -0.0003040298, 0.00066992594,
            -0.0008629607, 0.0008238604, -9.427592e-05, -0.0016616882,
            2.531108e-05, -0.00024696073, 0.0007699413, 0.0005711744,
            3.387279e-05, 7.3814525e-05, -0.0015050627, 0.0011135504,
            6.6128785e-05, 0.00069843984, -0.0009198811, -0.0010736538,
            0.0014698812, 0.00026584693, -0.0024882755, 0.00041494746,
            -0.00018913348, 0.00053900876, -0.0017607061, -0.00048932486,
            0.0013220938, -0.0014837444, 2.7320617e-05, -0.00043304716,
            -0.0022392042, 0.00021728812, 0.0011266625, -0.0005038622,
            0.000985184, 0.0008308417, -0.0012717214
        ],
        "clean": [
            0.0011667473, 0.00032169366, -0.0014031129, -0.00016436579,
            0.0007899324, 0.00036539437, -0.00082661986, -0.0011756272,
            9.345835e-05, 0.0010666775, 0.000984863, 0.0005274467,
            0.00095572695, 0.0018376024, -0.00064946327, -0.00069050747,
            -0.0016962028, 0.0012903732, 0.0012900587, 0.0013251709,
            -0.0004175352, -0.0018434355, 0.0011231472, -0.0024958383,
            0.0011372045, -0.0009900457, -0.0006923131, -0.00019119265,
            0.0008503522, -0.0007540661, 0.0008717579, -0.00015372454,
            -0.0017491278, -0.0001279326, -0.00018769538, 0.00076258735,
            0.0006136241, 4.769083e-05, 0.00024155533, -0.0014061235,
            0.0011883981, 3.973436e-05, 0.00048292865, -0.0007928224,
            -0.001146491, 0.0013407385, 0.00034985328, -0.0023365445,
            0.00060269877, -0.0002153088, 0.00076076377, -0.0015166035,
            -0.00048420145, 0.0011960096, -0.0014876559, 0.00021996474,
            -0.00057815085, -0.002231386, 0.00024799575, 0.0012353995,
            -0.00054459996, 0.0012849686, 0.00080741965, -0.0011193274
        ],
    },
    "nvf:5": {
        "marked": [
            0.0010890065, -0.00015925169, -0.0017056885, -0.00023585395,
            0.00085627538, 0.00017460555, -0.00066249759, -0.00069257902,
            -0.00047987685, 0.00035954578, 0.00056908652, 0.00067807629,
            0.00054950669, 0.0011868491, 0.00013136301, -4.6908004e-05,
            -0.0013988727, 0.064616695, 0.00073539099, 0.00047823347,
            -0.00029165196, -0.00046540771, 0.00064911565, -0.001958668,
            0.00047368574, -0.00035307123, 0.00024323213, -0.00031675314,
            0.00072603481, -4.4575652e-05, 0.00022774919, -0.00059318595,
            -0.00070322619, -0.00019758835, -0.00018173776, 0.00023108498,
            0.00096148311, -0.00023516658, 0.00046483058, -0.00040433925,
            0.00054459466, -0.00076811883, 1.5660355e-05, -0.0011166554,
            -0.0016559486, 0.0007526991, 0.0016842132, -0.0019021517,
            0.00014834382, 0.00087417907, 0.00067501195, -0.0011034728,
            -0.0001916226, 0.0002955641, -0.00075966242, 0.0011801367,
            -0.0003936385, -0.0016698381, 0.000268056, 0.00064440229,
            1.7699571e-05, -0.00017243343, 0.00051018927, -0.00077295728
        ],
        "clean": [
            0.0010626417, -0.00022910569, -0.0016081805, -0.00022947096,
            0.00083879731, 0.00015640908, -0.00064217288, -0.00066364842,
            -0.00044005091, 0.00046328353, 0.0005984715, 0.00058728002,
            0.00055031164, 0.0011803568, 9.9302284e-05, -5.6806792e-05,
            -0.0014358255, 0.0010025421, 0.000645008, 0.00054033968,
            -0.00027579244, -0.00049775204, 0.0005986687, -0.002009637,
            0.00049776532, -0.00033376136, 0.00023820433, -0.00025513017,
            0.000766229, -7.3043411e-06, 0.00024961759, -0.00054448709,
            -0.00068707392, -0.00021366835, -0.0001480131, 0.0002407724,
            0.00098699634, -0.00027272274, 0.00041584653, -0.00027633214,
            0.00044914175, -0.000800838, -1.273559e-05, -0.0010945201,
            -0.0016093355, 0.00068743527, 0.0015869839, -0.0018312914,
            0.00023750663, 0.00084736367, 0.0006410302, -0.00098980032,
            -0.00011950694, 0.00034967175, -0.0008057396, 0.0012513638,
            -0.00041196143, -0.0016968825, 0.00033870593, 0.00064368558,
            1.7461431e-05, -0.00023139901, 0.00054547901, -0.00078400021
        ],
    },
    "nvf:7": {
        "marked": [
            0.0010889918, -0.00015927399, -0.0017054983, -0.00023580239,
            0.00085624878, 0.00017454677, -0.00066259335, -0.00069257221,
            -0.00047975665, 0.00035962241, 0.00056906132, 0.00067812222,
            0.00054935674, 0.0011869525, 0.00013120615, -4.6873607e-05,
            -0.0013986964, 0.064614825, 0.00073539023, 0.00047830454,
            -0.00029159154, -0.00046545299, 0.00064919866, -0.0019586298,
            0.00047374444, -0.00035318467, 0.00024323507, -0.00031685323,
            0.00072588946, -4.4778029e-05, 0.0002277334, -0.00059312634,
            -0.00070311315, -0.00019749075, -0.00018160252, 0.00023119051,
            0.00096120022, -0.00023509841, 0.00046479807, -0.00040441184,
            0.00054460316, -0.00076807447, 1.5620606e-05, -0.0011165846,
            -0.0016559669, 0.00075274991, 0.0016842912, -0.0019021123,
            0.00014844806, 0.00087430299, 0.00067508407, -0.0011033923,
            -0.00019171913, 0.00029571768, -0.00075955171, 0.0011799913,
            -0.00039352328, -0.0016697021, 0.00026794747, 0.00064427039,
            1.7646254e-05, -0.00017247652, 0.00051011646, -0.00077296252
        ],
        "clean": [
            0.0010626338, -0.00022913933, -0.0016080122, -0.00022941241,
            0.00083876459, 0.00015635788, -0.00064227288, -0.00066364033,
            -0.00043992224, 0.00046338642, 0.00059845007, 0.00058732741,
            0.00055016577, 0.0011804462, 9.914644e-05, -5.6785437e-05,
            -0.0014356184, 0.0010026225, 0.00064500183, 0.00054039073,
            -0.00027571255, -0.00049780327, 0.00059875328, -0.0020095375,
            0.00049778441, -0.00033390214, 0.00023822422, -0.00025525648,
            0.00076606497, -7.4926888e-06, 0.00024959451, -0.00054439163,
            -0.00068696006, -0.00021356012, -0.00014790303, 0.00024085642,
            0.0009867003, -0.00027263339, 0.00041582188, -0.00027640394,
            0.00044915121, -0.00080077985, -1.2781119e-05, -0.0010944498,
            -0.0016093472, 0.00068748865, 0.0015870398, -0.0018312376,
            0.00023762311, 0.00084750727, 0.00064108416, -0.00098974456,
            -0.00011962762, 0.0003498453, -0.00080564484, 0.0012512242,
            -0.00041184822, -0.0016967435, 0.00033861864, 0.00064357737,
            1.7428576e-05, -0.00023142394, 0.00054538564, -0.00078400661
        ],
    },
    "nvf:9": {
        "marked": [
            0.0010890235, -0.00015919199, -0.0017054698, -0.00023582592,
            0.00085629942, 0.00017440029, -0.0006626033, -0.00069251255,
            -0.00047963753, 0.00035958664, 0.00056909578, 0.0006779937,
            0.00054930989, 0.0011869345, 0.00013114631, -4.6726462e-05,
            -0.0013987211, 0.064614251, 0.00073552557, 0.0004782936,
            -0.00029157021, -0.00046541376, 0.00064918201, -0.0019586473,
            0.00047385736, -0.00035331908, 0.000243285, -0.00031681123,
            0.00072601269, -4.4799603e-05, 0.00022777302, -0.00059316045,
            -0.00070305838, -0.00019752697, -0.00018157286, 0.00023114224,
            0.00096116628, -0.00023506132, 0.00046492985, -0.00040436912,
            0.00054464169, -0.00076816272, 1.5631555e-05, -0.001116577,
            -0.0016559967, 0.00075278094, 0.0016842965, -0.0019021066,
            0.00014832665, 0.00087442662, 0.00067507249, -0.0011034959,
            -0.00019172032, 0.00029565539, -0.00075953751, 0.001179994,
            -0.00039356833, -0.0016695926, 0.00026790562, 0.0006443059,
            1.7761606e-05, -0.00017256547, 0.00051013957, -0.0007729365
        ],
        "clean": [
            0.0010626604, -0.0002290433, -0.0016079881, -0.00022940904,
            0.0008388093, 0.0001562003, -0.00064229761, -0.00066358777,
            -0.00043980815, 0.00046335702, 0.00059848209, 0.00058719923,
            0.00055009947, 0.0011804296, 9.908036e-05, -5.6626905e-05,
            -0.0014356551, 0.0010027749, 0.00064513995, 0.0005403969,
            -0.00027570815, -0.00049775938, 0.00059873064, -0.0020095713,
            0.0004978964, -0.00033404125, 0.00023828585, -0.00025519886,
            0.00076617603, -7.5259122e-06, 0.00024962847, -0.00054441707,
            -0.00068691466, -0.00021357941, -0.00014788739, 0.00024081818,
            0.0009866578, -0.00027260234, 0.00041595593, -0.00027635676,
            0.00044918433, -0.00080085191, -1.2751072e-05, -0.0010944251,
            -0.0016093795, 0.00068751996, 0.0015870561, -0.0018312407,
            0.00023750926, 0.00084763771, 0.00064107921, -0.00098987448,
            -0.00011964113, 0.00034980581, -0.00080564065, 0.0012512207,
            -0.00041189254, -0.0016966346, 0.00033857048, 0.00064361817,
            1.7542352e-05, -0.00023151303, 0.00054539862, -0.00078396802
        ],
    },
}


def phase_identify(frames: np.ndarray, bank: np.ndarray) -> dict:
    """Identification through ``IdentifierService(BatchedWatermark(1080,
    1920, 28390211, p=P, psnr=40, device="cuda"), bank)`` at ME and NVF
    P = 3, 5, 7, 9: 16 single-frame requests, the 8 frames marked by the
    engine, then the 8 clean ones. Returns each case's launch counts, zeroed
    just before its requests and read just after."""
    frames_d = torch.from_numpy(frames).cuda()
    counts = {}
    for mask, p in IDENTIFY_CASES:
        engine = BatchedWatermark(ROWS, COLS, SEED, p=p, psnr=PSNR,
                                  device="cuda")
        marked, _ = engine.embed(frames_d, mask_type=mask)
        direct = engine.detect(marked, mask).cpu().numpy()
        requests = np.concatenate([marked.cpu().numpy(), frames])
        service = IdentifierService(engine, bank, mask_type=mask,
                                    batch_size=BATCH)
        try:
            service.warmup()
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            start = time.perf_counter()
            futures = [service.submit(frame) for frame in requests]
            scores = np.stack([f.result(timeout=600) for f in futures])
            seconds = time.perf_counter() - start
            torch.cuda.synchronize()
            counts[(mask, p)] = kernels.launch_counts()
            stats = service.stats()
        finally:
            service.close()
        label = f"P={p} {mask}"
        wide = mask == "me" and p > 3
        grams = WIDE_GRAM_SOLVE_KERNELS if wide else GRAM_SOLVE_KERNELS
        check(counts[(mask, p)]["detect_many"] > 0
              and all(counts[(mask, p)][n] > 0 for n in grams),
              f"{label}: a kernel was never launched: {counts[(mask, p)]}")
        check(counts[(mask, p)]["spd_solve8"] == 0
              and counts[(mask, p)]["me_gram_solve8"]
              == counts[(mask, p)]["me_gram_assemble"],
              f"{label}: a 3x3 Gram without its solve, or the solve kernel "
              f"alone: {counts[(mask, p)]}")
        # one wide solve an analysis (a batch), at ME p > 3 only
        check(counts[(mask, p)]["spd_solve_wide"]
              == (counts[(mask, p)]["wide_assemble"] if wide else 0),
              f"{label}: wide solves {counts[(mask, p)]['spd_solve_wide']} "
              f"against {counts[(mask, p)]['wide_assemble']} wide Grams")
        check(scores.shape == (2 * BATCH, N_CANDIDATES)
              and bool(np.isfinite(scores).all()),
              f"{label}: bad scores {scores.shape}")
        own = scores[:BATCH, ENGINE_CANDIDATE]
        check((scores[:BATCH].argmax(axis=1) == ENGINE_CANDIDATE).all(),
              f"{label}: marked frames' argmax "
              f"{scores[:BATCH].argmax(axis=1)}, not {ENGINE_CANDIDATE}")
        clean_max = float(np.abs(scores[BATCH:]).max())
        check(clean_max < 0.2 * own.min(),
              f"{label}: clean frames correlate too well: {clean_max} vs "
              f"{own.min()}")
        own_err = float(np.abs(own - direct).max())
        check(own_err <= DETECT_MANY_ATOL,
              f"{label}: detect_many's own column {own} vs detect {direct}")
        ref = JAX_IDENTIFY_REFERENCE.get(f"{mask}:{p}")
        jax_note = ""
        if ref is not None:
            jax_err = max(np.abs(scores[0] - ref["marked"]).max(),
                          np.abs(scores[BATCH] - ref["clean"]).max())
            check(jax_err <= CORR_ATOL,
                  f"{label}: correlations differ from JAX's by {jax_err}")
            jax_note = f", JAX max abs diff {jax_err:.2e}"
        print(f"[3] identify {label}: {len(requests)} requests in "
              f"{stats['batches']} batches, {seconds:.3f} s; argmax "
              f"{ENGINE_CANDIDATE} on every marked frame (corr "
              f"{own.mean():.6f}, best decoy "
              f"{np.delete(scores[:BATCH], ENGINE_CANDIDATE, 1).max():.2e}, "
              f"clean max {clean_max:.2e}), own column vs detect "
              f"{own_err:.1e}{jax_note}; launches {counts[(mask, p)]}: ok",
              flush=True)
    return counts


def conv_prediction_error(img: torch.Tensor, weight: torch.Tensor,
                          p: int) -> torch.Tensor:
    """The prediction error by one PyTorch call: a grouped conv2d over the
    edge-padded frames (the pad included), weight 1 at the centre and -c_k
    at the taps (``prediction_weight``)."""
    h = p // 2
    padded = F.pad(img[None], (h, h, h, h), mode="replicate")
    return F.conv2d(padded, weight, groups=img.shape[0])[0]


def prediction_weight(coeffs: torch.Tensor, p: int) -> torch.Tensor:
    h = p // 2
    weight = torch.zeros(coeffs.shape[0], 1, p, p, device=coeffs.device)
    weight[:, 0, h, h] = 1.0
    for k, (dr, dc) in enumerate(neighbor_offsets(p)):
        weight[:, 0, h + dr, h + dc] = -coeffs[:, k]
    return weight


def phase_identify_timing(frames_d: torch.Tensor,
                          bank_d: torch.Tensor) -> dict:
    """CUDA events: each new kernel beside its plain version (and the
    prediction error beside one conv2d), then the identification of 8 frames
    against 64 candidates (ME) at each p through the kernel, through the
    plain route, and as 64 looped detects."""
    coeffs = predictor_coefficients(frames_d)
    times = {}
    bounds = {f"detect_many_{mask}_p{p}": kernel_bound("detect_many", mask,
                                                       p)[0]
              for (mask, p) in IDENTIFY_CASES}
    for p in ALL_P:
        for mask in ("me", "nvf"):
            c = coeffs[p if mask == "me" else 3]
            times[f"detect_many_{mask}_p{p}"] = (
                cuda_ms(lambda: kernels.detect_many_partials(
                    frames_d, bank_d, c, mask, p), iters=5, warmup=1),
                cuda_ms(lambda: kernels.detect_many_partials_plain(
                    frames_d, bank_d, c, mask, p), iters=2, warmup=1))
        weight = prediction_weight(coeffs[p], p)
        library_err = float((conv_prediction_error(frames_d, weight, p)
                             - kernels.prediction_error_plain(
                                 frames_d, coeffs[p], p)).abs().max())
        check(library_err < 1e-2, f"p={p}: conv2d's prediction error differs "
              f"from the plain version by {library_err}")
        times[f"prediction_error_p{p}"] = (
            cuda_ms(lambda: kernels.prediction_error(frames_d, coeffs[p], p)),
            cuda_ms(lambda: kernels.prediction_error_plain(frames_d,
                                                           coeffs[p], p)),
            cuda_ms(lambda: conv_prediction_error(frames_d, weight, p)))
        times[f"nvf_mask_p{p}"] = (
            cuda_ms(lambda: kernels.nvf_mask(frames_d, p)),
            cuda_ms(lambda: kernels.nvf_mask_plain(frames_d, p)))
        print(f"[4] p={p} at 8x1080x1920 (N=64): " + "; ".join(
            f"{name} kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms"
            + (f", conv2d {t[2]:.4f} ms (max abs diff {library_err:.1e})"
               if len(t) > 2 else "")
            + (f", {t[0] / bounds[name]:.2f}x its bound {bounds[name]:.4f} ms"
               if name in bounds else "")
            for name, t in times.items() if name.endswith(f"_p{p}")),
            flush=True)

    for p in ALL_P:
        kernel_engine = BatchedWatermark(ROWS, COLS, SEED, p=p, psnr=PSNR,
                                         device="cuda")
        plain_engine = BatchedWatermark(ROWS, COLS, SEED, p=p, psnr=PSNR,
                                        impl="torch", device="cuda")
        kernel_ms = cuda_ms(lambda: kernel_engine.detect_many(frames_d,
                                                              bank_d),
                            iters=5, warmup=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        plain_ms = cuda_ms(lambda: plain_engine.detect_many(frames_d, bank_d),
                           iters=2, warmup=1)
        peak_gb = (torch.cuda.max_memory_allocated() - resident) / 1e9
        looped_ms = cuda_ms(lambda: [batch_detect(frames_d, bank_d[c], "me",
                                                  p=p)
                                     for c in range(N_CANDIDATES)],
                            iters=2, warmup=1)
        print(f"[4] p={p} identify 8x1080p against 64 candidates (ME): "
              f"kernel {kernel_ms:.3f} ms ({BATCH * 1e3 / kernel_ms:.1f} "
              f"fps), plain route {plain_ms:.3f} ms "
              f"({BATCH * 1e3 / plain_ms:.1f} fps, peak {peak_gb:.2f} GB "
              f"above the resident {resident / 1e9:.2f}), 64 looped detects "
              f"{looped_ms:.3f} ms ({BATCH * 1e3 / looped_ms:.1f} fps)",
              flush=True)
    return times


# Phase 5: the entry points a user runs, at 1080 x 1920. The CLI reads
# make_cli_image() from a PNG at p = 3 and 5; the video pipeline marks and
# checks a raw .yuv clip of VIDEO_FRAMES frames from
# synthesize(1920, 1080, VIDEO_FRAMES, seed=VIDEO_SEED).
CLI_P = (3, 5)
CLI_LOOPS = 20
PSNR_DB_ATOL = 0.5
VIDEO_FRAMES = 24
VIDEO_SEED = 1080
VIDEO_BATCH = 8
VIDEO_INTERVALS = (1, 5)

# Computed by the JAX package (impl="xla") on the CPU by
#   JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --cli --video
# "cli": at each p, Watermark(1080, 1920, W, p, psnr=40) on make_cli_image()
# read back through Pillow from the port's PNG: the NVF and ME strengths of
# embed(gray, rgb, mask) and detect() of the watermarked image's gray, as
# the CLI prints them. "video": the per-frame correlations detect_video
# prints for the clip marked by embed_video at each interval (embed_batch
# and detect_batch 8; detection at the same interval) and for the clean
# clip at interval 1.
JAX_ENTRY_REFERENCE = {
    "cli": {
        "3": {
            "strength_nvf": 2.553189992904663,
            "strength_me": 10.71573257446289,
            "corr_nvf": 0.06463144719600677,
            "corr_me": 0.1307435929775238,
        },
        "5": {
            "strength_nvf": 2.552610158920288,
            "strength_me": 10.093928337097168,
            "corr_nvf": 0.06461911648511887,
            "corr_me": 0.12826628983020782,
        },
    },
    "video": {
        "interval1": [
            0.34796714782714844, 0.34991639852523804, 0.34777724742889404,
            0.3510364592075348, 0.3493712842464447, 0.34869104623794556,
            0.3504444658756256, 0.35079094767570496, 0.35065123438835144,
            0.348241925239563, 0.3479624092578888, 0.3479935824871063,
            0.35113295912742615, 0.34953954815864563, 0.35193565487861633,
            0.3493148684501648, 0.35005876421928406, 0.3479342460632324,
            0.3494919538497925, 0.35019317269325256, 0.3479554057121277,
            0.34799009561538696, 0.350464403629303, 0.34952065348625183
        ],
        "interval5": [
            0.34796714782714844, 0.34869104623794556, 0.3479624092578888,
            0.3493148684501648, 0.3479554057121277
        ],
        "clean": [
            -0.0017139727715402842, 0.000454888358945027,
            -0.002133120084181428, 0.001667678589001298,
            0.00022140980581752956, -0.0012832757784053683,
            0.0015511909732595086, 0.0015388367464765906,
            0.0015376899391412735, -0.001114666578359902,
            -0.001881719334051013, -0.0012257491471245885,
            0.002403293503448367, 0.0003697437059599906, 0.003345880890265107,
            7.417337201331975e-06, 0.0002675862633623183,
            -0.002366571454331279, 0.0005118843400850892,
            0.0009939452866092324, -0.0019003114430233836,
            -0.0018290451262146235, 0.0016151993768289685,
            0.00011034154158551246
        ],
    },
}


def make_cli_image() -> np.ndarray:
    """Phase 5's (1080, 1920, 3) uint8 image: frames 0, 1 and 2 of
    make_frames() as its red, green and blue, truncated."""
    return np.stack(make_frames()[:3], axis=-1).astype(np.uint8)


def write_cli_ini(directory: str, png: str, dat: str, p: int) -> str:
    path = os.path.join(directory, f"settings_p{p}.ini")
    with open(path, "w") as f:
        f.write(f"[paths]\nimage = {png}\nwatermark = {dat}\n\n"
                f"[options]\nopencl_device = 0\n"
                f"save_watermarked_files_to_disk = true\n"
                f"execution_time_in_fps = true\n\n"
                f"[parameters]\np = {p}\npsnr = {PSNR}\n"
                f"loops_for_test = {CLI_LOOPS}\n")
    return path


def parse_cli(out: str) -> dict:
    """The numbers the CLI printed: the load time, the four FPS lines (NVF
    and ME embed, NVF and ME detect), strengths and correlations."""
    found = {
        "load_s": re.findall(r"Time to load and transfer RGB image from "
                             r"disk to [^:]+: (\S+)", out),
        "fps": re.findall(r"^FPS: (\S+) FPS$", out, re.M),
        "strength": re.findall(r"Watermark strength \(parameter a\): (\S+)",
                               out),
        "corr_nvf": re.findall(r"^Correlation \[NVF\]: (\d\.\d{16})$", out,
                               re.M),
        "corr_me": re.findall(r"^Correlation \[ME\]: (\d\.\d{16})$", out,
                              re.M)}
    check([len(v) for v in found.values()] == [1, 4, 2, 1, 1],
          f"the CLI printed other lines than expected:\n{out}")
    return {"load_s": float(found["load_s"][0]),
            "fps": [float(v) for v in found["fps"]],
            "strength_nvf": float(found["strength"][0]),
            "strength_me": float(found["strength"][1]),
            "corr_nvf": float(found["corr_nvf"][0]),
            "corr_me": float(found["corr_me"][0])}


def launched(counts: dict[str, int]) -> dict[str, int]:
    return {name: n for name, n in counts.items() if n}


def check_cli_numbers(got: dict, p: int, label: str) -> str:
    ref = JAX_ENTRY_REFERENCE["cli"][str(p)]
    for key in ("corr_nvf", "corr_me"):
        check(abs(got[key] - ref[key]) <= CORR_ATOL,
              f"{label}: {key} {got[key]} vs JAX {ref[key]}")
    for key in ("strength_nvf", "strength_me"):
        check(_close(got[key], ref[key], rtol=STRENGTH_RTOL),
              f"{label}: {key} {got[key]} vs JAX {ref[key]}")
    return (f"corr NVF {got['corr_nvf']:.6f} / ME {got['corr_me']:.6f} (JAX "
            f"{ref['corr_nvf']:.6f} / {ref['corr_me']:.6f}), strength NVF "
            f"{got['strength_nvf']:.5f} / ME {got['strength_me']:.5f} (JAX "
            f"{ref['strength_nvf']:.5f} / {ref['strength_me']:.5f})")


def phase_cli() -> None:
    """``cli.main([ini])`` in process at p = 3 and 5, each run's launch
    counts zeroed just before it and read just after, then ``python -m
    watermarking_gpu_tpu_torch`` once as a subprocess, from a PNG in a
    temporary directory."""
    image = make_cli_image()
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "frame.png")
        write_png(png, image)
        dat = os.path.join(tmp, "w.dat")
        save_watermark(dat, generate_watermark(ROWS, COLS, SEED))
        for p in CLI_P:
            ini = write_cli_ini(tmp, png, dat, p)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            buffer = io.StringIO()
            with contextlib.redirect_stdout(buffer):
                rc = cli.main([ini])
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            out = buffer.getvalue()
            check(rc == 0, f"CLI p={p} exited {rc}:\n{out}")
            got = parse_cli(out)
            numbers = check_cli_numbers(got, p, f"CLI p={p}")
            ran = (*P3_KERNELS, *(WIDE_GRAM_SOLVE_KERNELS if p > 3 else ()))
            check(all(counts[name] > 0 for name in ran),
                  f"CLI p={p}: a kernel was never launched: {counts}")
            check((p != 3) == ("generalized" in out),
                  f"CLI p={p}: the p NOTE line is wrong:\n{out}")
            # the saved ME image against the engine's output, truncated
            saved = read_png(add_suffix_before_extension(png, "_W_ME"))
            engine = Watermark(ROWS, COLS, dat, p=p, psnr=PSNR,
                               device="cuda")
            rgb = torch.from_numpy(image.astype(np.float32)).cuda()
            marked, _ = engine.embed(rgb_to_gray(rgb), rgb, "me")
            want = marked.cpu().numpy().astype(np.uint8)
            check(np.array_equal(saved, want),
                  f"CLI p={p}: *_W_ME.png differs from the engine's output "
                  f"at {int((saved != want).sum())} bytes")
            mse = np.mean((saved.astype(np.float64) - image) ** 2)
            psnr_db = 10 * np.log10(255.0 ** 2 / mse)
            check(abs(psnr_db - PSNR) <= PSNR_DB_ATOL,
                  f"CLI p={p}: *_W_ME.png at {psnr_db:.3f} dB")
            fps = got["fps"]
            print(f"[5] CLI p={p}, 1080x1920 PNG: load and upload "
                  f"{got['load_s']:.6f} s; FPS NVF embed {fps[0]:.2f}, ME "
                  f"embed {fps[1]:.2f}, NVF detect {fps[2]:.2f}, ME detect "
                  f"{fps[3]:.2f} ({CLI_LOOPS} loops, CUDA events); "
                  f"{numbers}; *_W_ME.png byte-equal to the engine's "
                  f"truncated output, {psnr_db:.3f} dB; launches "
                  f"{launched(counts)}: ok", flush=True)
        start = time.perf_counter()
        result = subprocess.run(
            [sys.executable, "-m", "watermarking_gpu_tpu_torch",
             write_cli_ini(tmp, png, dat, 3)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - start
        check(result.returncode == 0, f"python -m watermarking_gpu_tpu_torch"
              f" exited {result.returncode}:\n{result.stdout}\n"
              f"{result.stderr}")
        got = parse_cli(result.stdout)
        numbers = check_cli_numbers(got, 3, "python -m")
        check("Using device [0]: " in result.stdout,
              f"python -m: no device banner:\n{result.stdout}")
        print(f"[5] python -m watermarking_gpu_tpu_torch (p=3): rc 0 in "
              f"{seconds:.1f} s, {numbers}: ok", flush=True)


def check_marked_clip(marked: np.ndarray, original: np.ndarray,
                      interval: int, engine: BatchedWatermark) -> None:
    """Chroma and the frames between samples equal the input; the sampled
    lumas equal one synchronous ``embed_luma_u8`` of the same frames in
    the pipeline's batches."""
    luma = ROWS * COLS
    check(marked.shape == original.shape,
          f"interval {interval}: {marked.shape} frames written")
    check(np.array_equal(marked[:, luma:], original[:, luma:]),
          f"interval {interval}: chroma differs from the input")
    followers = np.ones(len(original), bool)
    followers[::interval] = False
    check(np.array_equal(marked[followers], original[followers]),
          f"interval {interval}: a frame between samples differs")
    sampled = original[::interval, :luma].reshape(-1, ROWS, COLS)
    got = marked[::interval, :luma].reshape(-1, ROWS, COLS)
    for start in range(0, len(sampled), VIDEO_BATCH):
        real = len(sampled[start:start + VIDEO_BATCH])
        want, _ = engine.embed_luma_u8(pad_to_batch(
            sampled[start:start + VIDEO_BATCH], VIDEO_BATCH))
        want = want[:real].cpu().numpy()
        check(np.array_equal(got[start:start + real], want),
              f"interval {interval}: marked luma of frames {start}.. "
              f"differs from a synchronous embed at "
              f"{int((got[start:start + real] != want).sum())} bytes")


def video_settings(path: str, dat: str, interval: int, **kw) -> Settings:
    return Settings(video=path, watermark=dat, p=3, psnr=PSNR,
                    watermark_interval=interval, embed_batch=VIDEO_BATCH,
                    detect_batch=VIDEO_BATCH,
                    raw_video_size=f"{COLS}x{ROWS}", **kw)


def stats_line(stats: dict) -> str:
    return ", ".join(f"{key} {stats[key]:.4f}" if isinstance(stats[key],
                                                             float)
                     else f"{key} {stats[key]}"
                     for key in ("read_s", "prep_s", "collect_s", "emit_s",
                                 "write_s", "wall_s", "batches")
                     if key in stats)


def phase_video() -> None:
    """``embed_video`` of the raw clip at intervals 1 and 5, then
    ``detect_video`` of both outputs and of the clean clip, on one engine,
    each run's launch counts zeroed just before it and read just after."""
    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "clip.yuv")
        with open(clip, "wb") as f:
            f.write(synthesize(COLS, ROWS, VIDEO_FRAMES, seed=VIDEO_SEED))
        original = np.fromfile(clip, np.uint8).reshape(
            VIDEO_FRAMES, frame_bytes(COLS, ROWS))
        dat = os.path.join(tmp, "w.dat")
        save_watermark(dat, generate_watermark(ROWS, COLS, SEED))
        engine = BatchedWatermark(ROWS, COLS, dat, p=3, psnr=PSNR,
                                  device="cuda")
        warm = original[:VIDEO_BATCH, :ROWS * COLS].reshape(VIDEO_BATCH, ROWS,
                                                            COLS)
        engine.embed_luma_u8(warm)
        engine.detect(warm)
        torch.cuda.synchronize()
        outputs = {}
        for interval in VIDEO_INTERVALS:
            out_path = os.path.join(tmp, f"marked_{interval}.yuv")
            stats = {}
            kernels.reset_launch_counts()
            frames = embed_video(video_settings(
                clip, dat, interval, encode_watermark_file_path=out_path),
                engine=engine, out=io.StringIO(), stats=stats)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            name = f"embed interval {interval}"
            check(frames == VIDEO_FRAMES, f"{name}: {frames} frames")
            check(all(counts[k] > 0 for k in (*GRAM_SOLVE_KERNELS,
                                                     *EMBED_KERNELS)),
                  f"{name}: a kernel was never launched: {counts}")
            check_marked_clip(np.fromfile(out_path, np.uint8).reshape(
                original.shape), original, interval, engine)
            outputs[interval] = out_path
            print(f"[5] video {name}, 1080x1920 raw .yuv, {frames} frames, "
                  f"batches of {VIDEO_BATCH}: {frames / stats['wall_s']:.1f}"
                  f" fps ({stats_line(stats)}); chroma and the frames "
                  f"between samples equal the input, the marked lumas "
                  f"byte-equal to a synchronous embed_luma_u8; launches "
                  f"{launched(counts)}: ok", flush=True)
        corrs = {}
        for name, path, interval in (
                ("interval1", outputs[1], 1), ("interval5", outputs[5], 5),
                ("clean", clip, 1)):
            stats = {}
            kernels.reset_launch_counts()
            frames, results = detect_video(video_settings(path, dat,
                                                          interval),
                                           engine=engine, out=io.StringIO(),
                                           stats=stats)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            label = f"detect {name}"
            check(all(counts[k] > 0 for k in (*GRAM_SOLVE_KERNELS,
                                                      "detect_partials")),
                  f"{label}: a kernel was never launched: {counts}")
            ref = JAX_ENTRY_REFERENCE["video"][name]
            check([i for i, _ in results] == list(range(0, VIDEO_FRAMES,
                                                        interval)),
                  f"{label}: frames {[i for i, _ in results]}")
            corrs[name] = np.array([c for _, c in results])
            err = float(np.abs(corrs[name] - ref).max())
            check(err <= CORR_ATOL, f"{label}: correlations "
                  f"{corrs[name].tolist()} vs JAX {ref}")
            print(f"[5] video {label}: {frames} frames, {len(results)} "
                  f"sampled, {frames / stats['wall_s']:.1f} fps "
                  f"({stats_line(stats)}); corr min {corrs[name].min():.6f}"
                  f" max {corrs[name].max():.6f}, JAX max abs diff "
                  f"{err:.2e}; launches {launched(counts)}: ok",
                  flush=True)
        marked_min = min(corrs["interval1"].min(), corrs["interval5"].min())
        clean_max = float(np.abs(corrs["clean"]).max())
        check(clean_max < 0.2 * marked_min,
              f"video: clean clip correlates too well: {clean_max} vs "
              f"marked {marked_min}")
        print(f"[5] video: marked frames correlate at least "
              f"{marked_min:.6f}, the clean clip at most {clean_max:.2e}: ok",
              flush=True)


# Phase 7: the tools and the examples a user runs, on phase 5's PNG and
# watermark: calibrate_threshold at its defaults for each of these runs
# (name -> extra arguments), evaluate_robustness for each mask, the
# identification example against IDENTIFY_N candidates.
CALIBRATE_RUNS = {"me:3": [], "nvf:3": ["--mask", "nvf"], "me:5": ["--p", "5"]}
ROBUSTNESS_MASKS = ("me", "nvf")
IDENTIFY_N = 16


# Computed by the JAX package on the CPU by
#   JAX_PLATFORMS=cpu python tools/chip_smoke_reference.py --tools
# from its own tools and examples run in process, their engines wrapped so
# that what they compute is recorded at full precision: "calibrate",
# tools/calibrate_threshold.py on make_cli_image()'s PNG at its defaults for
# each of CALIBRATE_RUNS (the null matrix's mean, per-image std range and
# max, z, the threshold, the 8 signals, their mean and min); "robustness",
# tools/evaluate_robustness.py on the PNG for each mask (the strength and
# each attack's correlation, Pillow's JPEG included); the image and
# identification examples on the PNG (and the watermark of phase 5), the
# video and serving examples at their own sizes.
JAX_TOOLS_REFERENCE = {
    "calibrate": {
        "me:3": {
            "mean": 0.00015261606313288212,
            "std_min": 0.0012685440015047789,
            "std_max": 0.0012915056431666017,
            "max": 0.0036530019715428352,
            "z": 4.753424308817089,
            "threshold": 0.006291690382335456,
            "signal_mean": 0.1320761600509286,
            "signal_min": 0.11555091291666031,
            "signals": [
                0.12312136590480804, 0.1355436146259308, 0.11555091291666031,
                0.13508909940719604, 0.14077609777450562, 0.14473362267017365,
                0.12514498829841614, 0.13664957880973816
            ],
        },
        "nvf:3": {
            "mean": 3.0767150747124106e-05,
            "std_min": 0.0007536179618909955,
            "std_max": 0.0007794869015924633,
            "max": 0.002117675496265292,
            "z": 4.753424308817089,
            "threshold": 0.003735999137181253,
            "signal_mean": 0.06536913802847266,
            "signal_min": 0.05813652276992798,
            "signals": [
                0.06140398234128952, 0.06700316816568375, 0.05813652276992798,
                0.06633887439966202, 0.06949272751808167, 0.07136756181716919,
                0.061904799193143845, 0.06730546802282333
            ],
        },
        "me:5": {
            "mean": 0.00015403619909193367,
            "std_min": 0.0011525211157277226,
            "std_max": 0.0011959221446886659,
            "max": 0.003256813623011112,
            "z": 4.753424308817089,
            "threshold": 0.005838761593107706,
            "signal_mean": 0.1304125413298607,
            "signal_min": 0.11357805877923965,
            "signals": [
                0.12190355360507965, 0.1333783119916916, 0.11357805877923965,
                0.13372111320495605, 0.14044779539108276, 0.14272354543209076,
                0.12330865114927292, 0.1342393010854721
            ],
        },
    },
    "robustness": {
        "me": {
            "strength": 10.71573257446289,
            "rows": {
                "none": 0.13074438273906708,
                "clean image (no mark)": 0.002547062933444977,
                "gaussian noise sigma=2": 0.12357740104198456,
                "gaussian noise sigma=5": 0.12835440039634705,
                "gaussian noise sigma=10": 0.12266657501459122,
                "gaussian noise sigma=20": 0.1049024686217308,
                "u8 quantization": 0.13075986504554749,
                "jpeg q=90": 0.1290653944015503,
                "jpeg q=70": 0.11977176368236542,
                "jpeg q=50": 0.10415923595428467,
                "jpeg q=30": 0.07468228787183762,
                "brightness x0.9": 0.13074378669261932,
                "brightness x1.1": 0.1274552345275879,
            },
        },
        "nvf": {
            "strength": 2.553189992904663,
            "rows": {
                "none": 0.06463152915239334,
                "clean image (no mark)": 0.0010087157133966684,
                "gaussian noise sigma=2": 0.061557698994874954,
                "gaussian noise sigma=5": 0.06408118456602097,
                "gaussian noise sigma=10": 0.06285511702299118,
                "gaussian noise sigma=20": 0.05778689682483673,
                "u8 quantization": 0.06463789194822311,
                "jpeg q=90": 0.0643056258559227,
                "jpeg q=70": 0.06199311465024948,
                "jpeg q=50": 0.05730001628398895,
                "jpeg q=30": 0.04189842939376831,
                "brightness x0.9": 0.06463517248630524,
                "brightness x1.1": 0.06456219404935837,
            },
        },
    },
    "image_example": {
        "NVF": {
            "strength": 2.553189992904663,
            "corr_marked": 0.06463152915239334,
            "corr_clean": 0.0010087161790579557,
        },
        "ME": {
            "strength": 10.71573257446289,
            "corr_marked": 0.13074438273906708,
            "corr_clean": 0.002547062234953046,
        },
    },
    "identify_example": {
        "strength": 10.715357780456543,
        "corrs": [
            -0.0014704472851008177, 0.0007601346005685627,
            -6.837120599811897e-05, -0.0007407297380268574,
            0.0002059407124761492, -0.0016588715370744467,
            -0.000643152859993279, 3.979267262366193e-07, 0.12899911403656006,
            0.00040226077544502914, -0.000161426913109608,
            0.0025110600981861353, -0.0009410659549757838,
            -0.00024063784803729504, -0.0006080802995711565,
            0.0006757103838026524
        ],
    },
    "video_example": {
        "marked": [
            0.4251946806907654, 0.4239501953125, 0.42341554164886475,
            0.42151013016700745, 0.42682328820228577, 0.418636292219162
        ],
        "clean": [
            0.0014001285890117288, -0.001505363266915083,
            -0.0013665473088622093, -0.0052162110805511475,
            0.003661304246634245, -0.00888986699283123
        ],
    },
    "serving_example": {
        "corrs": [
            0.22329863905906677, 0.22279970347881317, 0.22107531130313873,
            0.21943901479244232, 0.22127707302570343, 0.22008714079856873,
            0.22518585622310638, 0.22009222209453583, 0.2187434881925583,
            0.21974335610866547, 0.22059966623783112, 0.2245413213968277,
            0.2233869731426239, 0.22743423283100128, 0.22019323706626892,
            0.22712230682373047, 0.22241586446762085, 0.2267526537179947,
            0.2230176478624344, 0.2209503948688507, 0.2225261926651001,
            0.22389940917491913, 0.22547534108161926, 0.22712966799736023,
            0.22496360540390015, 0.2186424881219864, 0.2236294001340866,
            0.22086410224437714, 0.22223041951656342, 0.22425629198551178,
            0.22674748301506042, 0.23098234832286835
        ],
        "scores": [
            0.22329863905906677, 0.0028511204291135073, -0.0024862049613147974,
            -0.0032479658257216215, 0.001203165389597416,
            -0.0004792766412720084, -0.0016611478058621287,
            -0.0013771953526884317
        ],
    },
}


# Phase 6: the sharded routes of parallel/ on the card, at 8 x 1080 x 1920.
# On one card every mesh names cuda:0 for each of its shards, so the
# collectives' copies are no copies: the phase measures the routes and
# their kernels, not a transfer between devices.
# the p=3 kernels' halo forms (the 3x3 Gram, the embed field, the detect
# tail) are checked at these (mask, p); the hybrid route runs them and ME
# p = 5, 9 (the wide Gram's halo form)
HALO_CASES = (("me", 3), ("nvf", 3), ("nvf", 5))
MESH_CASES = (*HALO_CASES, ("me", 5), ("me", 9))
# the multi-candidate kernel's halo form is checked at these (mask, p)
MANY_HALO_CASES = (("me", 3), ("me", 5), ("me", 9), ("nvf", 3))
HALO_SPACES = (4, 2)                               # 270- and 540-row shards
# the sharded routes against the single-device kernel route on the same
# card: the same kernels' sums over other row splits and in another order
# (__graft_entry__.py:78-80)
MESH_CORR_ATOL, MESH_STRENGTH_RTOL, MESH_PIXEL_ATOL = 1e-4, 1e-4, 1e-2
# timed runs of each hybrid route after its first, cold one
HYBRID_WARM_RUNS = 3
# identification over the mesh against JAX_IDENTIFY_REFERENCE
MESH_IDENTIFY_ATOL = 3e-4


def one_card_mesh(data: int, space: int = 1):
    """A data x space mesh that names cuda:0 for every shard."""
    return make_mesh(data, space,
                     devices=[torch.device("cuda", 0)] * (data * space))


def padded_rows(x: torch.Tensor, halo: int) -> torch.Tensor:
    """(..., H, W) edge-replicated by ``halo`` rows above and below; rows
    [start, stop + 2 halo) of it are the shard [start, stop) as
    exchange_row_halo extends it (``halo_extended``, padding once)."""
    lead, (rows, cols) = x.shape[:-2], x.shape[-2:]
    return F.pad(x.reshape(-1, 1, rows, cols), (0, 0, halo, halo),
                 mode="replicate").reshape(*lead, rows + 2 * halo, cols)


def halo_extended(frames: torch.Tensor, start: int, stop: int,
                  halo: int) -> torch.Tensor:
    """Rows [start - halo, stop + halo) of the edge-replicated frames: a
    row shard as exchange_row_halo extends it."""
    return padded_rows(frames, halo)[..., start:stop + 2 * halo,
                                     :].contiguous()


def check_halo_shard(frames_d, wm_d, coeffs, mask: str, p: int, start: int,
                     stop: int, label: str) -> tuple[dict, float]:
    """The halo forms of the 3x3 Gram's two kernels, the embed field and
    the detect tail on rows [start, stop) of the frames against their plain
    halo forms (the tolerances of phase 2; u_raw bit-identical), the Gram at
    each halo the routes give it: the detect tail's ``stencil_reach`` and
    the embed field's max(1, p // 2). Returns the shard's kernel Grams
    {halo: Gram} and the worst error."""
    reach = stencil_reach(mask, p)
    half = max(1, p // 2)
    ext = halo_extended(frames_d, start, stop, reach)
    w_ext = halo_extended(wm_d, start, stop, reach)
    worst = 0.0
    errs, grams = {}, {}
    for halo in sorted({half, reach}):
        g_ext = halo_extended(frames_d, start, stop, halo)
        where = (g_ext, halo, halo, start, ROWS)
        plain_sums = kernels.gram_lags_plain(g_ext, halo, halo)
        errs[f"lag kernel (halo {halo})"] = rel_err(
            kernels.me_gram_lags(*where), plain_sums)
        errs[f"assembly kernel (halo {halo})"] = rel_err(
            kernels.me_gram_assemble(plain_sums, *where),
            kernels.assemble_lags_plain(plain_sums, g_ext, halo, halo))
        grams[halo] = kernels.me_gram(*where)
        errs[f"Gram (halo {halo})"] = rel_err(
            grams[halo], kernels.me_gram_plain(g_ext, halo, halo))
    e_ext = halo_extended(frames_d, start, stop, half)
    got = kernels.embed_field(e_ext, wm_d[start:stop],
                              coeffs if mask == "me" else None, mask, p,
                              half, half)
    want = kernels.embed_field_plain(e_ext, wm_d[start:stop], coeffs, mask,
                                     p, half, half)
    check(torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]),
          f"{label}: embed field halo form: u_raw or max mask not "
          f"bit-identical to the plain halo form (max abs err "
          f"{float((got[0] - want[0]).abs().max()):.3e})")
    errs["embed field sums"] = rel_err(got[1], want[1])
    _, errs["detect tail sums"] = detect_errors(
        kernels.detect_partials(ext, w_ext, coeffs, mask, p, reach, reach,
                                start, ROWS),
        kernels.detect_partials_plain(ext, w_ext, coeffs, mask, p, reach,
                                      reach, start, ROWS))
    for what, err in errs.items():
        check(err <= SUM_RTOL, f"{label}: {what} (halo form) rel err "
              f"{err:.3e}")
        worst = max(worst, err)
    return grams, worst


def check_wide_halo(frames_d: torch.Tensor, p: int, space: int) -> str:
    """The wide Gram's two kernels in their halo forms at ME p: the lag
    kernel on every shard of ``space`` (top, interior, bottom) with the 2h
    rows of halo the routes give it, against its plain halo form; the
    shards' sums and edges folded over strips, lane blocks and shards and
    assembled with the frame's banks by the assembly kernel, against its
    plain version on the same inputs and against the frame's kernel Gram.
    Returns the errors as text."""
    rows = ROWS // space
    reach = stencil_reach("me", p)
    padded = padded_rows(frames_d, reach)
    lag_err, sums, edges = 0.0, 0.0, 0.0
    for index in range(space):
        start = index * rows
        ext = padded[:, start:start + rows + 2 * reach].contiguous()
        got = kernels.wide_lag_strips(ext, p, reach, reach, start, ROWS)
        want = kernels.lag_strips_plain(ext, p, reach, reach)
        err = max(rel_err(g, w) for g, w in zip(got, want))
        check(err <= SUM_RTOL, f"wide lag kernel p={p}, {rows}-row shard "
              f"{index}: rel err {err:.3e} against its plain halo form")
        lag_err = max(lag_err, err)
        sums = sums + got[0].sum(dim=(2, 3), keepdim=True)
        edges = edges + got[1].sum(dim=2, keepdim=True)
    banks = kernels.frame_banks(frames_d, p)
    gram = kernels.wide_assemble(sums, edges, *banks, p, ROWS)
    assemble_err = rel_err(gram, kernels.assemble_strips_plain(
        sums, edges, *banks, p))
    frame_err = rel_err(gram, kernels.me_gram_wide(frames_d, p))
    check(assemble_err <= SUM_RTOL and frame_err <= SUM_RTOL,
          f"wide Gram p={p} over {space} shards: assembly kernel rel err "
          f"{assemble_err:.3e} against its plain version, {frame_err:.3e} "
          f"against the frame's Gram")
    return (f"lag kernel rel {lag_err:.2e}; folded and assembled: assembly "
            f"kernel rel {assemble_err:.2e}, vs the frame's wide Gram rel "
            f"{frame_err:.2e}")


def check_many_halo(frames_d: torch.Tensor, bank_d: torch.Tensor,
                    coeffs: torch.Tensor, mask: str, p: int,
                    space: int) -> str:
    """The multi-candidate kernel in its halo form on every shard of
    ``space`` with ``stencil_reach`` rows of halo, against its plain halo
    form (phase 2's tolerances); the shards' sums added up against the
    frame's kernel sums. Returns the errors as text."""
    rows = ROWS // space
    reach = stencil_reach(mask, p)
    padded = padded_rows(frames_d, reach)
    padded_bank = padded_rows(bank_d, reach)
    worst, total = 0.0, None
    for index in range(space):
        start = index * rows
        where = (mask, p, reach, reach, start, ROWS)
        ext = padded[:, start:start + rows + 2 * reach].contiguous()
        bank = padded_bank[:, start:start + rows + 2 * reach].contiguous()
        got = kernels.detect_many_partials(ext, bank, coeffs, *where)
        err = detect_errors(got, kernels.detect_many_partials_plain(
            ext, bank, coeffs, *where))[1]
        check(err <= SUM_RTOL, f"detect_many {mask} p={p}, {rows}-row shard "
              f"{index}: sums rel err {err:.3e} against the plain halo form")
        worst = max(worst, err)
        total = got if total is None else tuple(
            a + b for a, b in zip(total, got))
        del bank, got
    frame_err = detect_errors(total, kernels.detect_many_partials(
        frames_d, bank_d, coeffs, mask, p))[1]
    check(frame_err <= SUM_RTOL, f"detect_many {mask} p={p} over {space} "
          f"shards: summed sums rel err {frame_err:.3e} against the frame's")
    return (f"sums rel {worst:.2e}; shards' sums added up vs the frame's "
            f"rel {frame_err:.2e}")


def halo_timing_pairs(frames_d: torch.Tensor, wm_d: torch.Tensor,
                      bank_d: torch.Tensor, coeffs: dict,
                      rows: int) -> dict:
    """The halo forms on the first interior shard of ``rows`` rows, each
    beside its plain halo form: the p=3 kernels at ME and NVF, the wide
    Gram's lag kernel at ME p = 5, 7, 9 and the multi-candidate kernel at
    MANY_HALO_CASES: {row name: (kernel, mask, p, kernel fn, plain fn,
    halo, {kernel name: its profiler pattern})}."""
    start, stop = rows, 2 * rows
    pairs = {}
    for mask in ("me", "nvf"):
        reach = stencil_reach(mask, 3)
        ext = halo_extended(frames_d, start, stop, reach)
        w_ext = halo_extended(wm_d, start, stop, reach)
        e_ext = halo_extended(frames_d, start, stop, 1)
        w_own = wm_d[start:stop]
        c = coeffs[3] if mask == "me" else None
        code = MASK_CODES[mask]
        name = row_name("embed_field", mask, 3)
        pairs[name] = (
            "embed_field", mask, 3,
            lambda c=c, m=mask, e=e_ext: kernels.embed_field(
                e, w_own, c, m, 3, 1, 1),
            lambda m=mask, e=e_ext: kernels.embed_field_plain(
                e, w_own, coeffs[3], m, 3, 1, 1),
            1, {name: f"embed_field_kernel<{code}, 1>"})
        name = row_name("detect_partials", mask, 3)
        where = (mask, 3, reach, reach, start, ROWS)
        pairs[name] = (
            "detect_partials", mask, 3,
            lambda x=ext, w=w_ext, a=where: kernels.detect_partials(
                x, w, coeffs[3], *a),
            lambda x=ext, w=w_ext, a=where: kernels.detect_partials_plain(
                x, w, coeffs[3], *a),
            reach, {name: f"detect_tail_kernel<{code}, 1, {code}>"})
        if mask == "me":
            pairs["me_gram"] = (
                "me_gram", mask, 3,
                lambda x=ext, r=reach: kernels.me_gram(x, r, r, start, ROWS),
                lambda x=ext, r=reach: kernels.me_gram_plain(x, r, r),
                reach, {gram: f"{gram}_kernel" for gram in GRAM_KERNELS})
    for p in WIDE_P:
        reach = stencil_reach("me", p)
        ext = halo_extended(frames_d, start, stop, reach)
        name = f"me_gram_wide_p{p}"
        pairs[name] = (
            "me_gram_wide", "me", p,
            lambda x=ext, p=p, r=reach: kernels.wide_lag_strips(
                x, p, r, r, start, ROWS),
            lambda x=ext, p=p, r=reach: kernels.lag_strips_plain(x, p, r, r),
            reach, {name: f"wide_lag_strips_kernel<{p // 2}>"})
    for mask, p in MANY_HALO_CASES:
        reach = stencil_reach(mask, p)
        ext = halo_extended(frames_d, start, stop, reach)
        bank = halo_extended(bank_d, start, stop, reach)
        c = coeffs[p if mask == "me" else 3]
        where = (mask, p, reach, reach, start, ROWS)
        half = (p // 2, 0) if mask == "me" else (1, p // 2)
        name = f"detect_many_{mask}_p{p}"
        pairs[name] = (
            "detect_many", mask, p,
            lambda x=ext, b=bank, c=c, a=where: kernels.detect_many_partials(
                x, b, c, *a),
            lambda x=ext, b=bank, c=c, a=where:
                kernels.detect_many_partials_plain(x, b, c, *a),
            reach, {name: f"detect_many_kernel<{MASK_CODES[mask]}, "
                          f"{half[0]}, {half[1]}>"})
    return pairs


def phase_halo_kernels(frames_d: torch.Tensor, wm_d: torch.Tensor,
                       bank_d: torch.Tensor) -> dict:
    """[6] The halo-form kernels against their plain halo forms at 270- and
    540-row shards (space 4 and 2) at every shard position: the p=3
    kernels at HALO_CASES, the shards' 3x3 Grams at each halo summed
    against the unsharded kernel Gram; the wide Gram's two kernels at ME
    p = 5, 7, 9 (``check_wide_halo``); the multi-candidate kernel at
    MANY_HALO_CASES against the 64-candidate bank (``check_many_halo``).
    Then each kernel's ms in its halo form on an interior shard. Returns
    {(row name, shard rows): (ms, plain ms, bound ms, bound by)}."""
    coeffs = predictor_coefficients(frames_d)
    frame_gram = kernels.me_gram(frames_d)
    times = {}
    for space in HALO_SPACES:
        rows = ROWS // space
        for mask, p in HALO_CASES:
            grams, worst = {}, 0.0
            for index in range(space):
                where = ("top" if index == 0 else "bottom"
                         if index == space - 1 else "interior")
                shard_grams, err = check_halo_shard(
                    frames_d, wm_d, coeffs[3], mask, p, index * rows,
                    (index + 1) * rows,
                    f"{mask} p={p} {rows}-row shard {index} ({where})")
                for halo, gram in shard_grams.items():
                    grams.setdefault(halo, []).append(gram)
                worst = max(worst, err)
            sum_errs = {halo: rel_err(sum(parts), frame_gram)
                        for halo, parts in grams.items()}
            for halo, err in sum_errs.items():
                check(err <= SUM_RTOL, f"{mask} p={p} {rows}-row shards: "
                      f"the shards' Grams at halo {halo} sum to the frame's "
                      f"within {err:.3e}")
            print(f"[6] halo forms, {mask} p={p}, {space} shards of {rows} "
                  f"rows (top, interior, bottom): worst rel err {worst:.2e} "
                  f"against the plain halo forms, u_raw bit-identical; "
                  f"shards' Grams summed vs the frame's kernel Gram rel "
                  + ", ".join(f"{err:.2e} (halo {halo})"
                              for halo, err in sorted(sum_errs.items()))
                  + ": ok", flush=True)
        for p in WIDE_P:
            print(f"[6] wide Gram halo forms, me p={p}, {space} shards of "
                  f"{rows} rows (top, interior, bottom): "
                  f"{check_wide_halo(frames_d, p, space)}: ok", flush=True)
        for mask, p in MANY_HALO_CASES:
            text = check_many_halo(frames_d, bank_d,
                                   coeffs[p if mask == "me" else 3], mask, p,
                                   space)
            print(f"[6] detect_many halo form, {mask} p={p}, N="
                  f"{N_CANDIDATES}, {space} shards of {rows} rows (top, "
                  f"interior, bottom): {text}: ok", flush=True)
        torch.cuda.empty_cache()
        # times on the first interior shard
        for name, (kernel, mask, p, kernel_fn, plain_fn, halo,
                   _) in halo_timing_pairs(frames_d, wm_d, bank_d, coeffs,
                                           rows).items():
            bound_ms, bound_by = kernel_bound(kernel, mask, p, rows=rows,
                                              halo=halo)
            # the plain multi-candidate form takes ~0.1-1 s a call
            many = kernel == "detect_many"
            times[(name, rows)] = (
                cuda_ms(kernel_fn, *((5, 1) if many else ())),
                cuda_ms(plain_fn, *((2, 1) if many else ())),
                bound_ms, bound_by)
            ms, plain_ms = times[(name, rows)][:2]
            print(f"[6] {name} halo form, {rows}-row interior shard of "
                  f"8x{COLS} (halo {halo}): kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}), {bound_ms / ms:.0%} of it", flush=True)
        torch.cuda.empty_cache()
    return times


def run_counted(fn):
    """(fn's result, the kernels' launches in it, its ms by CUDA events):
    the counters zeroed just before, read just after."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    torch.cuda.synchronize()
    return result, kernels.launch_counts(), start.elapsed_time(end)


def add_counts(total: dict, counts: dict, mask: str, p: int) -> None:
    """Add a run's launches to the kernels line's rows (row name ->
    launches), a run at one mask and p."""
    for kernel, n in counts.items():
        if not n or kernel in CHAIN_COUNTERS:
            continue
        if kernel in GRAM_KERNELS:
            name = "me_gram"
        elif kernel in ("spd_solve8", "me_gram_solve8", "embed_finish"):
            name = kernel
        elif kernel == "spd_solve_wide":
            name = f"spd_solve_wide_p{p}"
        elif kernel in WIDE_GRAM_KERNELS:
            name = f"me_gram_wide_p{p}"
        elif kernel == "detect_many":
            name = f"detect_many_{mask}_p{p}"
        else:
            name = row_name(kernel, mask, p)
        total[name] = total.get(name, 0) + n


def jax_numbers(mask: str, p: int) -> dict:
    return JAX_REFERENCE[mask] if p == 3 else JAX_WIDE_REFERENCE[p][mask]


def check_route(label: str, corr, strength, marked, ref) -> str:
    """Hold a sharded route's (corr (B,), strength (B,), marked) to the
    single-device kernel route's ``ref`` (MESH_* tolerances); returns the
    worst differences as text."""
    ref_corr, ref_strength, ref_marked = ref
    corr_err = float((corr - ref_corr).abs().max())
    s_err = rel_err(strength, ref_strength)
    check(corr_err <= MESH_CORR_ATOL, f"{label}: corr differs from the "
          f"single-device route by {corr_err:.3e}")
    check(s_err <= MESH_STRENGTH_RTOL, f"{label}: strength rel err "
          f"{s_err:.3e} against the single-device route")
    text = f"corr {corr_err:.1e}, strength rel {s_err:.1e}"
    if marked is not None:
        px_err = float((marked - ref_marked).abs().max())
        check(px_err <= MESH_PIXEL_ATOL, f"{label}: pixels differ from the "
              f"single-device route by {px_err:.3e}")
        text += f", pixels {px_err:.1e}"
    return text


def check_jax(label: str, corr: np.ndarray, strength, ref: dict) -> str:
    """Hold correlations (and strengths) of frames 0.. to the JAX CPU
    numbers (CORR_ATOL, STRENGTH_RTOL)."""
    n = len(corr)
    corr_err = float(np.abs(corr - np.asarray(ref["corr"][:n])).max())
    check(corr_err <= CORR_ATOL, f"{label}: corr {corr} vs JAX "
          f"{ref['corr'][:n]}")
    text = f"JAX corr {corr_err:.1e}"
    if strength is not None:
        s_err = float(np.abs(strength / np.asarray(ref["strength"][:n])
                             - 1).max())
        check(s_err <= STRENGTH_RTOL, f"{label}: strength {strength} vs JAX "
              f"{ref['strength'][:n]}")
        text += f", strength rel {s_err:.1e}"
    return text


def phase_mesh(frames: np.ndarray, bank: np.ndarray, power: str) -> dict:
    """[6] The sharded routes through their entry points on one card;
    returns the launches of every run by kernels-line row."""
    frames_d = torch.from_numpy(frames).cuda()
    wm_d = torch.from_numpy(
        generate_watermark(ROWS, COLS, SEED).astype(np.float32)).cuda()
    bank_d = torch.from_numpy(bank).cuda()
    sf = strength_factor(PSNR)
    launches: dict[str, int] = {}
    hybrid = one_card_mesh(2, 2)
    print(f"[6] one card: every mesh names cuda:0 for each shard, e.g. "
          f"{hybrid}; no transfer between devices is measured", flush=True)

    # hybrid embed then detect, data=2 x space=2 (540-row shards)
    for mask, p in MESH_CASES:
        label = f"hybrid 2x2 {mask} p={p}"

        def step():
            marked, strength = make_hybrid_embed(hybrid, mask, sf, p=p)(
                frames_d, frames_d, wm_d)
            return marked, strength, make_hybrid_detect(hybrid, mask, p=p)(
                marked, wm_d)
        # the first run warms the route up (its time printed as "cold"),
        # then HYBRID_WARM_RUNS timed ones
        runs = [run_counted(step) for _ in range(1 + HYBRID_WARM_RUNS)]
        (marked, strength, corr), counts, _ = runs[-1]
        cold_ms, warm_ms = runs[0][2], [ms for _, _, ms in runs[1:]]
        # per data row, one launch a space shard of the embed field, the
        # embed finish and the detect tail, and of the Gram's lag kernel (ME
        # embed and detect, NVF detect); the Gram's assembly and its solve
        # once a space row
        if mask == "me" and p != 3:
            want = {"wide_lag_strips": 8, "wide_assemble": 4,
                    "spd_solve_wide": 4}
        else:
            grams = 8 if mask == "me" else 4
            want = {"me_gram_lags": grams, "me_gram_assemble": grams,
                    "spd_solve8": grams // 2}
        want.update(embed_field=4, embed_finish=4, detect_partials=4)
        for _, run, _ in runs:
            check({k: n for k, n in run.items() if n} == want,
                  f"{label}: launches {launched(run)}, expected {want}")
            add_counts(launches, run, mask, p)
        marked, strength, corr = (t.gather() for t in (marked, strength,
                                                       corr))
        ref_marked, ref_strength = batch_embed(frames_d, frames_d, wm_d, sf,
                                               mask, p=p)
        ref_corr = batch_detect(ref_marked, wm_d, mask, p=p)
        text = check_route(label, corr, strength, marked,
                           (ref_corr, ref_strength, ref_marked))
        text += ", " + check_jax(label, corr.cpu().numpy(),
                                 strength.cpu().numpy(), jax_numbers(mask, p))
        print(f"[6] {label}: corr {float(corr.mean()):.6f}, strength "
              f"{float(strength.mean()):.5f}; vs single device {text}; "
              f"embed+detect {min(warm_ms):.2f}–{max(warm_ms):.2f} ms warm "
              f"({len(warm_ms)} runs), {cold_ms:.2f} ms cold ({power}); "
              f"launches {launched(counts)} a run: ok", flush=True)
    del marked, ref_marked

    # spatial detect, data=1 x space=4 (270-row shards)
    spatial = one_card_mesh(1, 4)
    for p, impl in ((3, "cuda"), (9, "torch"), (9, "cuda")):
        label = f"spatial 1x4 me p={p} impl={impl}"
        marked0, _ = batch_embed(frames_d[:1], frames_d[:1], wm_d, sf, "me",
                                 p=p)
        ref = batch_detect(marked0, wm_d, "me", p=p)
        detect = make_spatial_detect(spatial, "me", p=p, impl=impl)
        corr, counts, ms = run_counted(lambda: detect(marked0[0], wm_d))
        if impl == "cuda":
            want = ({"me_gram_lags": 4, "me_gram_assemble": 4,
                     "spd_solve8": 1} if p == 3
                    else {"wide_lag_strips": 4, "wide_assemble": 1,
                          "spd_solve_wide": 1})
            want["detect_partials"] = 4
            check({k: n for k, n in counts.items() if n} == want,
                  f"{label}: launches {launched(counts)}, expected {want}")
        else:
            check(not any(counts.values()), f"{label}: the plain route "
                  f"launched kernels: {counts}")
        add_counts(launches, counts, "me", p)
        corr = float(corr)
        err = abs(corr - float(ref[0]))
        check(err <= MESH_CORR_ATOL, f"{label}: corr {corr} vs single "
              f"device {float(ref[0])}")
        text = check_jax(label, np.array([corr]), None, jax_numbers("me", p))
        print(f"[6] {label}: corr {corr:.6f}, vs single device {err:.1e}, "
              f"{text}; detect {ms:.2f} ms ({power}); launches "
              f"{launched(counts)}: ok", flush=True)

    # frame-parallel, data=4, ME p=5: the wide Gram per shard
    dp = one_card_mesh(4)
    label = "DP 4 me p=5"

    def dp_step():
        marked, strength = make_dp_embed(dp, "me", sf, p=5)(
            frames_d, frames_d, wm_d)
        return marked, strength, make_dp_detect(dp, "me", p=5)(marked, wm_d)
    (marked, strength, corr), counts, ms = run_counted(dp_step)
    check(all(counts[k] > 0 for k in (*WIDE_GRAM_SOLVE_KERNELS,
                                      *EMBED_KERNELS, "detect_partials")),
          f"{label}: a kernel was never launched: {counts}")
    add_counts(launches, counts, "me", 5)
    marked, strength, corr = (t.gather() for t in (marked, strength, corr))
    ref_marked, ref_strength = batch_embed(frames_d, frames_d, wm_d, sf,
                                           "me", p=5)
    ref_corr = batch_detect(ref_marked, wm_d, "me", p=5)
    text = check_route(label, corr, strength, marked,
                       (ref_corr, ref_strength, ref_marked))
    text += ", " + check_jax(label, corr.cpu().numpy(),
                             strength.cpu().numpy(), jax_numbers("me", 5))
    print(f"[6] {label}: corr {float(corr.mean()):.6f}; vs single device "
          f"{text}; embed+detect {ms:.2f} ms ({power}); launches "
          f"{launched(counts)}: ok", flush=True)
    del marked, ref_marked

    # identification: the bank split 16 a shard over data=4 (ME p=5); over
    # data=2 x space=2 (ME p=3, plain and kernels) and over space=4 (ME p=9,
    # NVF p=5: rows split, the whole bank on each shard)
    for mesh, mask, p, impl, make in (
            (dp, "me", 5, "cuda", make_dp_detect_many),
            (hybrid, "me", 3, "torch", make_mesh_detect_many),
            (hybrid, "me", 3, "cuda", make_mesh_detect_many),
            (spatial, "me", 9, "cuda", make_mesh_detect_many),
            (spatial, "nvf", 5, "cuda", make_mesh_detect_many)):
        label = (f"{make.__name__} {mesh.shape['data']}x"
                 f"{mesh.shape['space']} {mask} p={p} impl={impl}")
        marked0, _ = batch_embed(frames_d[:1], frames_d[:1], wm_d, sf, mask,
                                 p=p)
        ref = detect_many_pipeline(marked0[0], bank_d, mask, p=p)
        fn = make(mesh, mask, p=p, impl=impl)
        scores, counts, ms = run_counted(lambda: fn(marked0[0], bank_d))
        if impl == "torch":
            want = {}
        elif mesh is dp:       # the single-device kernels on each shard
            want = {"wide_lag_strips": 4, "wide_assemble": 4,
                    "spd_solve_wide": 4}
        else:   # the halo forms; the Gram and its solve once a space row
            rows = mesh.shape["data"]
            want = ({"wide_lag_strips": 4, "wide_assemble": rows,
                     "spd_solve_wide": rows}
                    if mask == "me" and p != 3 else
                    {"me_gram_lags": 4, "me_gram_assemble": 4,
                     "spd_solve8": rows})
        if impl == "cuda":
            want["detect_many"] = 4
        check({k: n for k, n in counts.items() if n} == want,
              f"{label}: launches {launched(counts)}, expected {want}")
        add_counts(launches, counts, mask, p)
        scores = scores.gather()
        check(int(scores.argmax()) == ENGINE_CANDIDATE,
              f"{label}: argmax {int(scores.argmax())}, not "
              f"{ENGINE_CANDIDATE}")
        err = float((scores - ref).abs().max())
        check(err <= MESH_CORR_ATOL, f"{label}: differs from single-device "
              f"identification by {err:.3e}")
        jax_err = float(np.abs(scores.cpu().numpy() - np.asarray(
            JAX_IDENTIFY_REFERENCE[f"{mask}:{p}"]["marked"])).max())
        check(jax_err <= MESH_IDENTIFY_ATOL, f"{label}: differs from JAX by "
              f"{jax_err:.3e}")
        print(f"[6] {label}: argmax {ENGINE_CANDIDATE} (corr "
              f"{float(scores[ENGINE_CANDIDATE]):.6f}), vs single device "
              f"{err:.1e}, JAX {jax_err:.1e}; {ms:.2f} ms ({power}); "
              f"launches {launched(counts)}: ok", flush=True)

    # the services over a mesh of data=2 (the detector and embedder with
    # space=2 as well; the identifier over data=2 alone and over data=2 x
    # space=2; a p=5 detector over data=2 x space=2): answers equal to the
    # mesh functions'
    engine = BatchedWatermark(ROWS, COLS, SEED, p=3, psnr=PSNR,
                              device="cuda")
    wide_engine = BatchedWatermark(ROWS, COLS, SEED, p=5, psnr=PSNR,
                                   device="cuda")
    requests = frames[:4]
    pair = one_card_mesh(2)
    services = (
        ("DetectorService", 3, hybrid, DetectorService(
            engine, "me", batch_size=4, mesh=hybrid),
         lambda: make_hybrid_detect(hybrid, "me")(requests, wm_d)),
        ("EmbedderService", 3, hybrid, EmbedderService(
            engine, "me", batch_size=4, mesh=hybrid),
         lambda: make_hybrid_embed(hybrid, "me", sf)(
             requests, requests, wm_d)),
        ("IdentifierService", 3, pair, IdentifierService(
            engine, bank_d, "me", batch_size=4, mesh=pair),
         lambda: make_dp_detect_many(pair, "me", batched=True)(
             requests, bank_d)),
        ("IdentifierService", 3, hybrid, IdentifierService(
            engine, bank_d, "me", batch_size=4, mesh=hybrid),
         lambda: make_mesh_detect_many(hybrid, "me", batched=True)(
             requests, bank_d)),
        ("DetectorService", 5, hybrid, DetectorService(
            wide_engine, "me", batch_size=4, mesh=hybrid),
         lambda: make_hybrid_detect(hybrid, "me", p=5)(requests, wm_d)))
    for name, p, mesh, service, direct in services:
        try:
            service.warmup(dtypes=(np.float32,))

            def serve():
                return [f.result(timeout=600)
                        for f in [service.submit(x) for x in requests]]
            answers, counts, ms = run_counted(serve)
        finally:
            service.close()
        gram = "me_gram_lags" if p == 3 else "wide_lag_strips"
        check(counts[gram] > 0, f"{name} p={p}: launches {counts}")
        add_counts(launches, counts, "me", p)
        want = direct()
        if name == "EmbedderService":
            got_px = np.stack([a[0] for a in answers])
            got_s = np.array([a[1] for a in answers], np.float32)
            same = (np.array_equal(got_px, np.asarray(want[0]))
                    and np.array_equal(got_s, np.asarray(want[1])))
        else:
            same = np.array_equal(np.asarray(answers, np.float32),
                                  np.asarray(want))
        shape = ", ".join(f"{axis}={n}" for axis, n in mesh.shape.items()
                          if n > 1)
        check(same, f"{name} p={p} over {shape}: answers differ from the "
              f"mesh function's")
        print(f"[6] {name} me p={p} (mesh {shape}): {len(requests)} requests "
              f"in {ms:.1f} ms ({power}), answers equal to the mesh "
              f"function's; launches {launched(counts)}: ok", flush=True)
    print(f"[6] launches of the sharded routes by kernels-line row: "
          f"{launches}", flush=True)
    return launches


TOOLS_ATOL = 3e-4    # calibration and identification against JAX (3e-4)


def load_example(name: str):
    """The module of ``examples/<name>_torch.py``."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class CountsAtLines(io.StringIO):
    """Captured standard output that also keeps the launch counts at the
    moment the first line starting with each of ``prefixes`` is written (a
    run's launches up to that line: the counters are host integers)."""

    def __init__(self, prefixes: tuple[str, ...]):
        super().__init__()
        self.prefixes, self.at = prefixes, {}

    def write(self, text: str) -> int:
        for prefix in self.prefixes:
            if text.startswith(prefix) and prefix not in self.at:
                self.at[prefix] = kernels.launch_counts()
        return super().write(text)


def run_entry(fn, prefixes: tuple[str, ...] = ()):
    """(fn's result, its standard output, the kernels' launches in it, its
    seconds by CUDA events, the counts at ``prefixes``' lines):
    ``run_counted`` with the standard output captured."""
    buffer = CountsAtLines(prefixes)
    with contextlib.redirect_stdout(buffer):
        result, counts, ms = run_counted(fn)
    return result, buffer.getvalue(), counts, ms / 1e3, buffer.at


def check_ran(label: str, counts: dict, names) -> None:
    check(all(counts[name] > 0 for name in names),
          f"{label}: a kernel of its path was never launched: {counts}")


def phase_tools_generate(tmp: str) -> None:
    """``generate_watermark`` in process: the .dat byte-equal to
    ``save_watermark(generate_watermark(...))``, with and without
    ``--repeat-blocks 4``; no kernel launched."""
    for repeat in (1, 4):
        path = os.path.join(tmp, f"generated_{repeat}.dat")
        extra = [] if repeat == 1 else ["--repeat-blocks", str(repeat)]
        rc, out, counts, seconds, _ = run_entry(lambda: generate_tool.main(
            [str(ROWS), str(COLS), str(SEED), path, *extra]))
        check(rc == 0 and out == f"Successfully wrote {ROWS * COLS} random "
              f"floats to {path}.\n", f"generate_watermark: rc {rc}:\n{out}")
        want = os.path.join(tmp, "want.dat")
        save_watermark(want, generate_watermark(ROWS, COLS, SEED,
                                                repeat_blocks=repeat))
        with open(path, "rb") as got, open(want, "rb") as expected:
            check(got.read() == expected.read(), f"generate_watermark "
                  f"{extra}: the .dat differs from save_watermark's")
        check(not launched(counts), f"generate_watermark launched {counts}")
        print(f"[7] generate_watermark {ROWS} {COLS} {SEED} "
              f"{' '.join(extra)}: rc 0 in {seconds:.2f} s, the .dat "
              f"byte-equal to save_watermark(generate_watermark(...)); no "
              f"launch: ok", flush=True)


def phase_tools_calibrate(png: str, power: str, launches: dict) -> None:
    """``calibrate_threshold`` at its defaults (8 images, 256 nulls, FPR
    1e-6) for each of CALIBRATE_RUNS, held to JAX_TOOLS_REFERENCE."""
    for name, argv in CALIBRATE_RUNS.items():
        mask, p = name.split(":")
        p = int(p)
        res = {}
        rc, out, counts, seconds, _ = run_entry(
            lambda: calibrate_threshold.main([png, *argv], results=res))
        label = f"calibrate_threshold {name}"
        check(rc == 0 and res["misses"] == 0, f"{label}: rc {rc}:\n{out}")
        ref = JAX_TOOLS_REFERENCE["calibrate"][name]
        errors = {key: abs(res[key] - ref[key]) for key in (
            "mean", "std_min", "std_max", "max", "signal_mean",
            "signal_min")}
        errors["signals"] = float(np.abs(res["signals"]
                                         - ref["signals"]).max())
        check(max(errors.values()) <= TOOLS_ATOL,
              f"{label}: differs from JAX's {ref}: {errors}")
        threshold_err = abs(res["threshold"] - ref["threshold"])
        check(threshold_err <= (1 + ref["z"]) * TOOLS_ATOL,
              f"{label}: threshold {res['threshold']} vs JAX "
              f"{ref['threshold']}")
        check(res["nulls"].shape == (8, 256), f"{label}: nulls "
              f"{res['nulls'].shape}")
        grams = (WIDE_GRAM_SOLVE_KERNELS if mask == "me" and p > 3
                 else GRAM_SOLVE_KERNELS)
        check_ran(label, counts, (*grams, *EMBED_KERNELS, "detect_partials",
                                  "detect_many"))
        check(counts["detect_many"] == 1, f"{label}: the null matrix took "
              f"{counts['detect_many']} dispatches")
        add_counts(launches, counts, mask, p)
        print(f"[7] {label} (1080x1920 PNG, 8 images x 256 nulls, FPR "
              f"1e-6): rc 0 in {seconds:.1f} s; host matrices "
              f"{res['host_s']:.2f} s, images and bank upload "
              f"{res['upload_ms']:.1f} ms, null dispatch {res['null_ms']:.3f} ms (CUDA events, "
              f"{power}); threshold {res['threshold']:.6f} (JAX "
              f"{ref['threshold']:.6f}), null mean {res['mean']:+.2e} std "
              f"{res['std_min']:.6f}..{res['std_max']:.6f} max "
              f"{res['max']:.6f}, signals mean {res['signal_mean']:.6f} min "
              f"{res['signal_min']:.6f}; JAX max abs diff "
              f"{max(errors.values()):.1e}; launches {launched(counts)}: ok",
              flush=True)


@contextlib.contextmanager
def pillow_hidden():
    """``from PIL import ...`` raises ImportError inside, as where Pillow
    is not installed."""
    saved = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        yield
    finally:
        if saved is None:
            del sys.modules["PIL"]
        else:
            sys.modules["PIL"] = saved


def phase_tools_robustness(png: str, launches: dict) -> None:
    """``evaluate_robustness`` at its defaults for each mask, then ME with
    Pillow hidden (the JPEG rows skipped, 9 attacks in the batch), held to
    JAX_TOOLS_REFERENCE: each correlation that ran, the strength, and the
    mark's lead over the clean image (above 0.1 at ME, the JAX test's
    bound, tests/test_cli.py:269; at NVF and PSNR 40 the JAX numbers
    themselves lead by 0.064, so NVF is held to JAX's lead)."""
    installed = importlib.util.find_spec("PIL") is not None
    pillow = (f"Pillow {importlib.metadata.version('pillow')}" if installed
              else "no Pillow")
    first = {}
    for mask, hidden in (*((mask, False) for mask in ROBUSTNESS_MASKS),
                         ("me", True)):
        res = {}
        with pillow_hidden() if hidden else contextlib.nullcontext():
            rc, out, counts, seconds, _ = run_entry(
                lambda: evaluate_robustness.main([png, "--mask", mask],
                                                 results=res))
        jpeg = installed and not hidden
        label = f"evaluate_robustness {mask}"
        check(rc == 0, f"{label}: rc {rc}:\n{out}")
        ref = JAX_TOOLS_REFERENCE["robustness"][mask]
        rows = dict(res["rows"])
        check(list(rows) == list(ref["rows"]), f"{label}: rows {list(rows)}")
        check(_close(res["strength"], ref["strength"], rtol=STRENGTH_RTOL),
              f"{label}: strength {res['strength']} vs {ref['strength']}")
        errs = []
        for name, corr in res["rows"]:
            if name.startswith("jpeg") and not jpeg:
                check(corr is None and any(
                    line.startswith(name) and line.endswith(
                        evaluate_robustness.JPEG_SKIPPED)
                    for line in out.splitlines()),
                      f"{label}: {name} is not printed as skipped:\n{out}")
                continue
            errs.append(abs(corr - ref["rows"][name]))
            check(errs[-1] <= CORR_ATOL, f"{label}: {name} {corr} vs JAX "
                  f"{ref['rows'][name]}")
        lead = rows["none"] - rows["clean image (no mark)"]
        jax_lead = ref["rows"]["none"] - ref["rows"]["clean image (no mark)"]
        check(lead >= jax_lead - 2 * CORR_ATOL and (mask != "me" or lead
                                                    > 0.1),
              f"{label}: the mark leads the clean image by {lead} (JAX "
              f"{jax_lead})")
        check(res["batch"] == (13 if jpeg else 9), f"{label}: batch of "
              f"{res['batch']}")
        check_ran(label, counts, (*GRAM_SOLVE_KERNELS, *EMBED_KERNELS,
                                  "detect_partials"))
        check(counts["embed_field"] == counts["embed_finish"]
              == counts["detect_partials"] == 1,
              f"{label}: not one embed and one batched detect: {counts}")
        add_counts(launches, counts, mask, 3)
        note = ""
        if hidden:
            other = dict(first[mask])
            diff = max(abs(corr - other[name]) for name, corr in res["rows"]
                       if corr is not None)
            note = f", against the run with every attack {diff:.1e}"
        first.setdefault(mask, res["rows"])
        print(f"[7] {label} (1080x1920 PNG, p=3, PSNR 40; "
              f"{'Pillow hidden' if hidden else pillow}): rc 0 "
              f"in {seconds:.2f} s; strength {res['strength']:.5f} (JAX "
              f"{ref['strength']:.5f}); {res['batch']} attacks in one "
              f"detect, none {rows['none']:+.6f}, clean "
              f"{rows['clean image (no mark)']:+.6f} (lead {lead:.6f}, JAX "
              f"{jax_lead:.6f}), JAX max abs diff {max(errs):.1e}{note}; "
              f"JPEG rows {'held to JAX' if jpeg else 'printed as skipped'};"
              f" launches {launched(counts)}: ok", flush=True)


def phase_examples(png: str, dat: str, tmp: str, launches: dict) -> None:
    """The four examples through their ``main(..., device="cuda")``, held to
    JAX_TOOLS_REFERENCE."""
    ref = JAX_TOOLS_REFERENCE["image_example"]
    got, _, counts, seconds, at = run_entry(
        lambda: load_example("image_watermark").main(
            png, dat, device="cuda", out_dir=tmp), ("NVF:",))
    nvf = at["NVF:"]
    me = {name: counts[name] - nvf[name] for name in counts}
    for mask, run in (("NVF", nvf), ("ME", me)):
        check(_close(got[mask]["strength"], ref[mask]["strength"],
                     rtol=STRENGTH_RTOL)
              and all(abs(got[mask][key] - ref[mask][key]) <= CORR_ATOL
                      for key in ("corr_marked", "corr_clean")),
              f"image example {mask}: {got[mask]} vs JAX {ref[mask]}")
        check(read_png(got[mask]["path"]).shape == (ROWS, COLS),
              f"image example: {got[mask]['path']} not written")
        check_ran(f"image example {mask}", run, (
            *GRAM_SOLVE_KERNELS, *EMBED_KERNELS, "detect_partials"))
        add_counts(launches, run, mask.lower(), 3)
    print(f"[7] image_watermark example (1080x1920 PNG): {seconds:.2f} s; "
          + "; ".join(f"{mask} strength {got[mask]['strength']:.5f} "
                      f"corr(marked) {got[mask]['corr_marked']:.6f} "
                      f"corr(clean) {got[mask]['corr_clean']:+.6f}"
                      for mask in ("NVF", "ME"))
          + f", within the JAX bounds; both PNGs written; launches NVF "
          f"{launched(nvf)}, ME {launched(me)}: ok", flush=True)

    ref = JAX_TOOLS_REFERENCE["identify_example"]
    got, _, counts, seconds, _ = run_entry(
        lambda: load_example("identify_watermark").main(
            png, IDENTIFY_N, device="cuda"))
    err = float(np.abs(got["corrs"] - ref["corrs"]).max())
    check(got["best"] == IDENTIFY_N // 2 and err <= TOOLS_ATOL
          and _close(got["strength"], ref["strength"], rtol=STRENGTH_RTOL),
          f"identify example: {got} vs JAX {ref}")
    check_ran("identify example", counts, (*GRAM_SOLVE_KERNELS,
                                           *EMBED_KERNELS, "detect_many"))
    add_counts(launches, counts, "me", 3)
    print(f"[7] identify_watermark example (1080x1920 PNG, "
          f"{IDENTIFY_N} candidates): {seconds:.2f} s; identified "
          f"#{got['best']} (corr {got['corrs'][got['best']]:.6f}), JAX max "
          f"abs diff {err:.1e}; launches {launched(counts)}: ok", flush=True)

    ref = JAX_TOOLS_REFERENCE["video_example"]
    got, _, counts, seconds, _ = run_entry(
        lambda: load_example("video_watermark").main(device="cuda"))
    corrs = {name: np.array([c for _, c in got[name]]) for name in got}
    err = max(float(np.abs(corrs[name] - ref[name]).max())
              for name in ("marked", "clean"))
    margin = corrs["marked"].min() - np.abs(corrs["clean"]).max()
    jax_margin = min(ref["marked"]) - max(abs(c) for c in ref["clean"])
    check(err <= CORR_ATOL and margin >= jax_margin - 2 * CORR_ATOL,
          f"video example: {corrs} vs JAX {ref}")
    check_ran("video example", counts, (*GRAM_SOLVE_KERNELS,
                                        *EMBED_KERNELS, "detect_partials"))
    add_counts(launches, counts, "me", 3)
    print(f"[7] video_watermark example (640x360, 60 frames, interval 10):"
          f" {seconds:.2f} s; marked min {corrs['marked'].min():.6f}, clean "
          f"max |corr| {np.abs(corrs['clean']).max():.2e}, margin "
          f"{margin:.6f} (JAX {jax_margin:.6f}), JAX max abs diff "
          f"{err:.1e}; launches {launched(counts)}: ok", flush=True)

    ref = JAX_TOOLS_REFERENCE["serving_example"]
    got, _, counts, seconds, _ = run_entry(
        lambda: load_example("serving_demo").main(device="cuda"))
    err = float(np.abs(np.asarray(got["corrs"]) - ref["corrs"]).max())
    score_err = float(np.abs(got["scores"] - ref["scores"]).max())
    check(err <= CORR_ATOL and score_err <= TOOLS_ATOL
          and got["identified"] == 0,
          f"serving example: {got} vs JAX {ref}")
    check_ran("serving example", counts, (*GRAM_SOLVE_KERNELS,
                                          *EMBED_KERNELS, "detect_partials",
                                          "detect_many"))
    add_counts(launches, counts, "me", 3)
    print(f"[7] serving_demo example (32 frames of 360x640): {seconds:.2f} s"
          f" ({len(got['corrs']) / got['seconds']:.1f} fps embed+detect "
          f"through the services); correlations {min(got['corrs']):.6f}.."
          f"{max(got['corrs']):.6f}, JAX max abs diff {err:.1e}; identified "
          f"candidate 0 (scores JAX max abs diff {score_err:.1e}); launches "
          f"{launched(counts)}: ok", flush=True)


def phase_tools(power: str) -> dict:
    """[7] The tools and the examples a user runs, each through its entry
    point on the card; returns their launches by kernels-line row."""
    launches: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "frame.png")
        write_png(png, make_cli_image())
        dat = os.path.join(tmp, "w.dat")
        save_watermark(dat, generate_watermark(ROWS, COLS, SEED))
        phase_tools_generate(tmp)
        phase_tools_calibrate(png, power, launches)
        phase_tools_robustness(png, launches)
        phase_examples(png, dat, tmp, launches)
    print(f"[7] launches of the tools and examples by kernels-line row: "
          f"{launches}", flush=True)
    return launches


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms, what binds it) for moving ``nbytes`` and doing ``flops``
    on an H100 SXM at its data-sheet peaks."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def cholesky_ops(n: int) -> int:
    """Operations of an n-unknown Cholesky solve, as SOLVE_OPS counts them
    at n = 8: per column j of the factor j products and sums, a
    subtraction, a square root and a reciprocal, and per entry below it j
    products and sums, a subtraction and a product; per row of each
    substitution i products and sums, a subtraction and a division."""
    factor = sum(2 * j + 3 + (n - 1 - j) * (2 * j + 2) for j in range(n))
    return factor + 2 * sum(2 * i + 2 for i in range(n))


def kernel_bound(kernel: str, mask: str, p: int, rows: int = ROWS,
                 halo: int = 0, channels: int = 1,
                 itemsize: int = 4) -> tuple[float, str]:
    """The bound of one kernel call at 8 x 1080 x 1920 (or, in its halo
    form, on a shard of 8 x ``rows`` x 1920 extended by ``halo`` rows each
    side: the extended frames, and the detect tail's extended watermark
    and the multi-candidate kernel's extended bank, read once, the wide
    Gram's lag kernel reading only the rows below; the outputs over the
    owned rows): each input read once, each output written once, and the
    flops the function needs, per owned pixel (a multiply-add counts 2;
    the detect tail's ring is not counted):

    * the 3x3 Gram: 13 lag products (the TPU kernel's lag form);
    * the wide Gram: one product per canonical lag and lane of each row;
    * the NVF mask: separable p x p box sums of x and x^2, shared by
      neighbouring centres as ops/nvf.py shares its row sums (4(p-1) adds),
      one square, and 6 for the mean, E[x^2], the variance and var/(1+var);
    * a (p*p-1)-tap prediction error: a product and a subtraction a tap;
    * the multi-candidate detect: it reads the frames and the 64-candidate
      bank once each and writes two sums per frame and candidate; per
      frame, candidate and pixel u = mask * W_c, e_u and the two sums
      (2k + 5 flops, k taps), and per frame and pixel e_z, the mask and
      e_z^2;
    * the 8x8 solve: it reads what a Cholesky solve of each frame's system
      needs, Rx's lower triangle (36) and rx (8), and writes 8
      coefficients and a valid byte; SOLVE_OPS operations a system;
    * the 3x3 Gram with the solve in its assembly: the Gram's frames read,
      its Gram, 8 coefficients and a valid byte written a frame; the
      Gram's 13 lag products a pixel and SOLVE_OPS a frame;
    * the wide solve: likewise Rx's lower triangle (k(k + 1)/2) and rx (k)
      read, k coefficients and a valid byte written; ``cholesky_ops(k)``
      operations a system;
    * the embed finish: u_raw (4 bytes a pixel) read, the output (``channels``
      elements a pixel of ``itemsize`` bytes) read and the marked frames
      written, sum u_raw^2, max |e| and valid read and the strength written
      a frame; a product, a sum and the clamp's two comparisons an element.
    """
    pixels = BATCH * rows * COLS
    frame_bytes = 4 * BATCH * (rows + 2 * halo) * COLS   # read
    out_bytes = 4 * pixels                               # written
    wm_bytes = 4 * rows * COLS
    k = p * p - 1
    nvf_flops = 4 * (p - 1) + 1 + 6
    if kernel == "me_gram":
        return bound(frame_bytes + 4 * BATCH * 81, 2 * 13 * pixels)
    if kernel == "embed_finish":
        elems = pixels * channels
        return bound(4 * pixels + 2 * itemsize * elems + 13 * BATCH,
                     4 * elems)
    if kernel == "spd_solve8":
        return bound(BATCH * (4 * (36 + 8) + 4 * 8 + 1), BATCH * SOLVE_OPS)
    if kernel == "me_gram_solve8":
        return bound(frame_bytes + BATCH * (4 * 81 + 4 * 8 + 1),
                     2 * 13 * pixels + BATCH * SOLVE_OPS)
    if kernel == "spd_solve_wide":
        return bound(BATCH * (4 * (k * (k + 1) // 2 + k) + 4 * k + 1),
                     BATCH * cholesky_ops(k))
    if kernel == "me_gram_wide":
        h = p // 2
        lags = ((4 * h + 1) ** 2 + 1) // 2
        lanes = BATCH * lags * (COLS + 2 * h)
        return bound(4 * BATCH * (rows + halo) * COLS + 4 * lanes,
                     2 * lanes * rows)
    if kernel == "embed_field":
        mask_flops = 2 * k + 1 if mask == "me" else nvf_flops
        return bound(frame_bytes + out_bytes + wm_bytes + 8 * BATCH,
                     (mask_flops + 4) * pixels)    # u, u^2, max
    if kernel == "prediction_error":
        return bound(frame_bytes + out_bytes + 4 * BATCH * k,
                     2 * k * pixels)
    if kernel == "nvf_mask":
        return bound(frame_bytes + out_bytes, nvf_flops * pixels)
    taps = k if mask == "me" else 8
    mask_flops = 1 if mask == "me" else nvf_flops
    if kernel == "detect_many":
        n = N_CANDIDATES
        bank_bytes = 4 * n * (rows + 2 * halo) * COLS
        return bound(frame_bytes + bank_bytes + 4 * BATCH * (taps + 2 * n
                                                             + 1),
                     ((2 * taps + 5) * n + 2 * taps + mask_flops + 2)
                     * pixels)
    wm_bytes = 4 * (rows + 2 * halo) * COLS
    return bound(frame_bytes + wm_bytes + 12 * BATCH,       # detect tail
                 (4 * taps + mask_flops + 7) * pixels)      # u, three sums


def kernel_row(name: str, kernel: str, mask: str, p: int, launches: int,
               errors: tuple, times: tuple,
               device: dict | None = None) -> dict:
    """One row of the kernels line; ``times`` is (ms, plain ms) or (ms,
    plain ms, library ms); ``device`` maps row names to the kernel's
    device ms (``device_ms``; rows without a kernel of their own there
    have none)."""
    source, replaces = KERNEL_SOURCES[kernel]
    bound_ms, bound_by = kernel_bound(kernel, mask, p)
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces,
           "replaces_kind": "xla" if kernel in XLA_KERNELS else "pallas",
           "launches": launches,
           "max_abs_err": errors[0], "max_rel_err": errors[1],
           "ms": times[0], "plain_ms": times[1], "bound_ms": bound_ms,
           "bound_by": bound_by,
           "library_ms": times[2] if len(times) > 2 else None}
    if device is not None and name in device:
        row["device_ms"] = device[name]
    return row


def main() -> int:
    kind, power = phase_card_and_build()
    frames = make_frames()
    check(abs(float(frames.astype(np.float64).sum())
              - JAX_REFERENCE["frames_sum"]) < 1e-3,
          "numpy's generator gave other frames than the reference numbers "
          "were computed from")
    frames_d = torch.from_numpy(frames).cuda()
    wm_d = torch.from_numpy(
        generate_watermark(ROWS, COLS, SEED).astype(np.float32)).cuda()

    bank = make_bank()
    bank_d = torch.from_numpy(bank).cuda()

    errors = phase_kernels(frames_d, wm_d)
    errors.update(phase_wide_kernels(frames_d, wm_d))
    errors.update(phase_identify_kernels(frames_d, bank_d))
    counts = phase_main_path(frames)
    wide_counts = {p: phase_wide_main_path(frames, p) for p in WIDE_P}
    identify_counts = phase_identify(frames, bank)
    times = phase_timing(frames_d, wm_d)
    for p in WIDE_P:
        times.update(phase_wide_timing(frames_d, wm_d, p))
    times.update(phase_identify_timing(frames_d, bank_d))
    # phases 5 and 6 time their runs too, so they run before the
    # profiler's timings
    phase_cli()
    phase_video()
    halo_times = phase_halo_kernels(frames_d, wm_d, bank_d)
    mesh_launches = phase_mesh(frames, bank, power)
    tool_launches = phase_tools(power)
    split = device_split(frames_d, wm_d)
    halo_split = halo_device_split(frames_d, wm_d, bank_d)
    for (name, shard_rows), ms in sorted(halo_split.items()):
        print(f"[6] {name} halo form, {shard_rows}-row interior shard of "
              f"8x{COLS} (device time a call, torch.profiler): {ms:.4f} ms "
              f"(CUDA events with the wrapper "
              f"{halo_times[(name, shard_rows)][0]:.4f} ms; {power})",
              flush=True)
    print(f"[4] 3x3 Gram split (device time a call, torch.profiler): lag "
          f"kernel {split['me_gram_lags']:.4f} ms, assembly kernel "
          f"{split['me_gram_assemble']:.4f} ms, together "
          f"{split['me_gram']:.4f} ms (CUDA events with the wrapper "
          f"{times['me_gram'][0]:.4f} ms; launches on the p=3 main path "
          f"{counts['all']['me_gram_lags']} + "
          f"{counts['all']['me_gram_assemble']})", flush=True)
    print(f"[4] spd_solve8 (device time a call, torch.profiler): "
          f"{split['spd_solve8']:.4f} ms (CUDA events with the wrapper "
          f"{times['spd_solve8'][0]:.4f} ms; launches on the folded Grams "
          f"of phase 6 {mesh_launches.get('spd_solve8', 0)}, on phase 3's "
          f"single-device paths {counts['all']['spd_solve8']})", flush=True)
    print(f"[4] me_gram_solve8 (device time a call, torch.profiler): lag "
          f"kernel {split['me_gram_lags']:.4f} ms + assembly kernel with the "
          f"solve {split['me_gram_assemble_solve8']:.4f} ms = "
          f"{split['me_gram_solve8']:.4f} ms, against the two calls' "
          f"{split['me_gram']:.4f} + {split['spd_solve8']:.4f} = "
          f"{split['me_gram'] + split['spd_solve8']:.4f} ms (the assembly "
          f"alone {split['me_gram_assemble']:.4f}); CUDA events with the "
          f"wrapper {times['me_gram_solve8'][0]:.4f} ms against "
          f"{times['me_gram_solve8_two_calls']:.4f} ms; launches on the p=3 "
          f"main path {counts['all']['me_gram_solve8']} calls, in "
          f"identification at ME p=3 "
          f"{identify_counts[('me', 3)]['me_gram_solve8']}", flush=True)
    for p in ALL_P:
        n_kernels, busy, host = step_kernels(frames_d, wm_d, p)
        print(f"[4] p={p} ME embed+detect step through the kernels: "
              f"{n_kernels:.0f} device kernels a step, device busy "
              f"{busy:.4f} ms a step (torch.profiler, 5 steps), host "
              f"{host:.4f} ms a step (enqueue, host_ms; {power})",
              flush=True)
    for p in WIDE_P:
        name = f"spd_solve_wide_p{p}"
        bound_ms, bound_by = kernel_bound("spd_solve_wide", "me", p)
        print(f"[4] spd_solve_wide p={p} ({p * p - 1} unknowns, B={BATCH}; "
              f"device time a call, torch.profiler): {split[name]:.4f} ms, "
              f"its bound {bound_ms:.7f} ms ({bound_by}), the library pair "
              f"{times[name][2]:.4f} ms "
              f"(CUDA events with the wrapper {times[name][0]:.4f} ms; "
              f"launches on the main path "
              f"{wide_counts[p]['me']['spd_solve_wide']}, in identification "
              f"{identify_counts[('me', p)]['spd_solve_wide']})", flush=True)
    for p in WIDE_P:
        print(f"[4] p={p} wide Gram split (device time a call, "
              f"torch.profiler): lag kernel "
              f"{split[f'wide_lag_strips_p{p}']:.4f} ms, assembly kernel "
              f"{split[f'wide_assemble_p{p}']:.4f} ms "
              f"(me_gram_wide_p{p} times both with the wrappers, "
              f"{times[f'me_gram_wide_p{p}'][0]:.4f} ms; launches on the "
              f"main path {wide_counts[p]['me']['wide_lag_strips']} + "
              f"{wide_counts[p]['me']['wide_assemble']})", flush=True)
    finish_runs = [counts["all"], *(wide_counts[p][mask] for p in WIDE_P
                                    for mask in ("me", "nvf")),
                   *identify_counts.values()]
    finish_launches = sum(run["embed_finish"] for run in finish_runs)
    for name, form, itemsize in (("embed_finish", "f32 frames", 4),
                                 ("embed_finish_u8", "u8 lumas", 1)):
        bound_ms = kernel_bound("embed_finish", "me", 3,
                                itemsize=itemsize)[0]
        print(f"[4] embed finish into {form} (8x1080x1920, device time a "
              f"call, torch.profiler): {split[name]:.4f} ms, "
              f"{split[name] / bound_ms:.2f}x its bytes bound "
              f"{bound_ms:.4f} ms (CUDA events with the wrapper "
              f"{times[name][0]:.4f} ms, the plain tail {times[name][1]:.4f}"
              f" ms; {power}; launches on the main paths of phase 3 "
              f"{finish_launches}, either form)", flush=True)
    for p in ALL_P:
        for kernel, label in (("embed_field", "embed field"),
                              ("detect_partials", "detect tail")):
            print(f"[4] p={p} {label} (device time a call, torch.profiler): "
                  + "; ".join(
                      f"{mask.upper()} kernel "
                      f"{split[row_name(kernel, mask, p)]:.4f} ms (CUDA "
                      f"events with the wrapper "
                      f"{times[row_name(kernel, mask, p)][0]:.4f} ms)"
                      for mask in ("me", "nvf")), flush=True)

    for p in ALL_P:
        print(f"[4] p={p} standalone ops (device time a call, "
              f"torch.profiler): " + "; ".join(
                  f"{kernel} {split[f'{kernel}_p{p}']:.4f} ms (CUDA events "
                  f"with the wrapper {times[f'{kernel}_p{p}'][0]:.4f} ms, "
                  f"its bound {kernel_bound(kernel, 'me', p)[0]:.4f} ms)"
                  for kernel in STANDALONE_KERNELS), flush=True)

    rows = [kernel_row("me_gram", "me_gram", "me", 3,
                       sum(counts["all"][n] for n in GRAM_KERNELS),
                       errors["me_gram"], times["me_gram"], split)]
    # the 8x8 solve: every phase-3 run that solves a 3x3-predictor system
    solve_runs = [counts["all"], *(wide_counts[p]["nvf"] for p in WIDE_P),
                  *identify_counts.values()]
    rows.append(kernel_row("spd_solve8", "spd_solve8", "me", 3,
                           sum(run["spd_solve8"] for run in solve_runs),
                           errors["spd_solve8"], times["spd_solve8"],
                           split))
    # row 13's fused variant: the Gram with the solve in its assembly, one
    # count a call, beside the two calls it replaces
    fused = kernel_row("me_gram_solve8", "me_gram_solve8", "me", 3,
                       sum(run["me_gram_solve8"] for run in solve_runs),
                       errors["me_gram_solve8"],
                       (*times["me_gram_solve8"], None), split)
    fused["two_calls"] = {
        "ms": times["me_gram_solve8_two_calls"],
        "device_ms": split["me_gram"] + split["spd_solve8"],
        "host_ms": times["me_gram_solve8_host"]["two calls"]}
    fused["host_ms"] = times["me_gram_solve8_host"]["fused"]
    fused["solve_tail_device_ms"] = (split["me_gram_assemble_solve8"]
                                     - split["me_gram_assemble"])
    rows.append(fused)
    for kernel in ("embed_field", "detect_partials"):
        nvf_launches = counts["nvf"][kernel]
        rows.append(kernel_row(kernel, kernel, "me", 3,
                               counts["all"][kernel] - nvf_launches,
                               errors[kernel], times[kernel], split))
        name = f"{kernel}_nvf_p3"
        rows.append(kernel_row(name, kernel, "nvf", 3, nvf_launches,
                               errors[name], times[name], split))
    # the embed finish: one row for every mask, p and form, timed at the
    # step's (ME, f32 frames), its u8 form beside it
    finish = kernel_row("embed_finish", "embed_finish", "me", 3,
                        finish_launches, errors["embed_finish"],
                        times["embed_finish"], split)
    u8_bound = kernel_bound("embed_finish", "me", 3, itemsize=1)
    finish["u8_form"] = {"ms": times["embed_finish_u8"][0],
                         "plain_ms": times["embed_finish_u8"][1],
                         "bound_ms": u8_bound[0], "bound_by": u8_bound[1],
                         "device_ms": split["embed_finish_u8"]}
    rows.append(finish)
    for p in WIDE_P:
        me, nvf = wide_counts[p]["me"], wide_counts[p]["nvf"]
        rows.append(kernel_row(f"me_gram_wide_p{p}", "me_gram_wide", "me", p,
                               sum(run[n] for run in (me, nvf)
                                   for n in WIDE_GRAM_KERNELS),
                               errors[f"me_gram_wide_p{p}"],
                               times[f"me_gram_wide_p{p}"]))
        # the wide solve: once an ME analysis (phase 3's ME part, and
        # identification at ME p)
        name = f"spd_solve_wide_p{p}"
        rows.append(kernel_row(name, "spd_solve_wide", "me", p,
                               me["spd_solve_wide"]
                               + identify_counts[("me", p)]["spd_solve_wide"],
                               errors[name], times[name], split))
        for kernel in ("embed_field", "detect_partials"):
            for mask, launched in (("me", me), ("nvf", nvf)):
                name = f"{kernel}_{mask}_p{p}"
                rows.append(kernel_row(name, kernel, mask, p,
                                       launched[kernel], errors[name],
                                       times[name], split))
    for p in ALL_P:
        for mask in ("me", "nvf"):
            name = f"detect_many_{mask}_p{p}"
            rows.append(kernel_row(
                name, "detect_many", mask, p,
                identify_counts[(mask, p)]["detect_many"], errors[name],
                times[name]))
    # the standalone ops: no main path launches them (their modules say why)
    runs = [counts["all"], *(wide_counts[p][mask] for p in WIDE_P
                             for mask in ("me", "nvf")),
            *identify_counts.values()]
    for kernel in STANDALONE_KERNELS:
        launched = sum(run[kernel] for run in runs)
        check(launched == 0, f"{kernel} ran on a main path {launched} times")
        for p in ALL_P:
            name = f"{kernel}_p{p}"
            rows.append(kernel_row(name, kernel, "me", p, launched,
                                   errors[name], times[name], split))
    # the sharded routes' launches (phase 6) and the halo forms' times
    for row in rows:
        row["launches"] += mesh_launches.pop(row["name"], 0)
        halo = {str(shard_rows): dict(
            zip(("ms", "plain_ms", "bound_ms", "bound_by"), timing),
            device_ms=halo_split[(name, shard_rows)])
            for (name, shard_rows), timing in halo_times.items()
            if name == row["name"]}
        if halo:
            row["halo_form"] = halo
    check(not mesh_launches, f"phase 6 launches without a row: "
          f"{mesh_launches}")
    # the tools' and examples' launches (phase 7)
    for row in rows:
        row["launches"] += tool_launches.pop(row["name"], 0)
    check(not tool_launches, f"phase 7 launches without a row: "
          f"{tool_launches}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
