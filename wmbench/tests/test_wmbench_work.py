"""The work counts at 8 x 1080 x 1920: the frozen per-kernel bounds give
PERF.md §6's bound column, and the operations' counts stay at or under
what their kernels' bounds add up to (each input read once)."""

import pytest

from wmbench.work import counts, kernels, peaks

# PERF.md §6, "bound ms (by)", 8 x 1080 x 1920, 64 candidates
BOUND_COLUMN = {
    ("me_gram", "me", 3): (0.0198, "bytes"),
    ("embed_field", "me", 3): (0.0421, "bytes"),
    ("embed_field", "me", 9): (0.0421, "bytes"),
    ("detect_tail", "me", 3): (0.0223, "bytes"),
    ("detect_tail", "me", 5): (0.0257, "operations"),
    ("detect_tail", "me", 7): (0.0495, "operations"),
    ("detect_tail", "me", 9): (0.0812, "operations"),
    ("me_gram_wide", "me", 5): (0.0206, "bytes"),
    ("me_gram_wide", "me", 7): (0.0422, "operations"),
    ("me_gram_wide", "me", 9): (0.0721, "operations"),
    ("detect_many", "me", 3): (0.3375, "operations"),
    ("detect_many", "me", 5): (0.8525, "operations"),
    ("detect_many", "me", 7): (1.6250, "operations"),
    ("detect_many", "me", 9): (2.6550, "operations"),
    ("detect_many", "nvf", 3): (0.3409, "operations"),
    ("embed_finish", "me", 3): (0.0594, "bytes"),
    ("prediction_error", "me", 3): (0.0396, "bytes"),
    ("nvf_mask", "nvf", 3): (0.0396, "bytes"),
}
CONFIG = {"mask": "me", "rows": 1080, "cols": 1920}


@pytest.mark.parametrize("key", sorted(BOUND_COLUMN))
def test_kernel_bounds_match_the_bound_column(key):
    want_ms, want_by = BOUND_COLUMN[key]
    got_ms, got_by = kernels.kernel_bound(*key)
    assert got_ms == pytest.approx(want_ms, abs=5e-5)
    assert got_by == want_by


def test_cholesky_ops_counts_the_8x8_solve():
    assert kernels.cholesky_ops(8) == kernels.SOLVE_OPS
    assert [kernels.cholesky_ops(k) for k in (24, 48, 80)] == [
        6424, 43952, 190160]


@pytest.mark.parametrize("p", [3, 5, 7, 9])
def test_a_step_counts_each_input_once(p):
    nbytes, flops = counts("step", {**CONFIG, "p": p}, {"batch": 8})
    pixels = 8 * 1080 * 1920
    assert nbytes == 8 * pixels + 4 * 1080 * 1920 + 64
    gram = "me_gram" if p == 3 else "me_gram_wide"
    kernel_ms = sum(kernels.kernel_bound(name, "me", p)[0] for name in
                    (gram, gram, "embed_field", "embed_finish",
                     "detect_tail"))
    least, _ = peaks.least_seconds(nbytes, flops, "NVIDIA H100 80GB HBM3")
    assert least * 1e3 <= kernel_ms


def test_step_and_identification_least_times():
    name = "NVIDIA H100 80GB HBM3"
    p3 = peaks.least_seconds(*counts("step", {**CONFIG, "p": 3},
                                     {"batch": 8}), name)
    p9 = peaks.least_seconds(*counts("step", {**CONFIG, "p": 9},
                                     {"batch": 8}), name)
    identify = peaks.least_seconds(*counts(
        "identify", {**CONFIG, "p": 3}, {"batch": 8, "candidates": 64}),
        name)
    assert p3[1] == "bytes" and p3[0] * 1e3 == pytest.approx(0.04209, 1e-3)
    assert p9[1] == "flops" and p9[0] * 1e3 == pytest.approx(0.2667, 1e-3)
    assert identify[1] == "flops"
    multi = kernels.kernel_bound("detect_many", "me", 3)[0]
    gram = 2 * 13 * 8 * 1080 * 1920 / peaks.F32_FLOPS_PER_S * 1e3
    assert identify[0] * 1e3 == pytest.approx(multi + gram, rel=1e-3)
