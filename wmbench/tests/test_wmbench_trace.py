"""The trace's reduction: busy time as the union of device intervals, the
window as the span of every record, and idle gaps labelled by the
innermost host record covering their middle."""

from wmbench import trace


def test_busy_window_ops_and_gaps():
    device = [(100, 200, "k1"), (150, 250, "k2"), (400, 500, "k1"),
              (600, 650, "Memcpy HtoD (Pageable -> Device)")]
    host = [(0, 1000, "outer"), (260, 390, "aten::copy_"),
            (520, 580, "cudaLaunchKernel")]
    summary = trace.summarize(device, host)
    assert summary["busy_s"] == 300e-9
    assert summary["window_s"] == 1000e-9
    assert summary["ops"]["k1"] == (2, 200e-9)
    assert trace.kernels(summary) == (3, 300e-9)
    assert trace.kernels(summary, "k2") == (1, 100e-9)
    gaps = dict(summary["breakdown"]["idle_gaps"])
    assert gaps["aten::copy_"] == 150e-9
    assert gaps["cudaLaunchKernel"] == 100e-9
    assert gaps["outer"] == 100e-9 + 350e-9
    names = [name for name, _ in summary["breakdown"]["device_ops"]]
    assert names[0] == "k1"


def test_no_host_record_means_python_and_empty_traces():
    summary = trace.summarize([(10, 20, "k"), (40, 50, "k")], [],
                              host_s=1e-6)
    assert dict(summary["breakdown"]["idle_gaps"]) == {trace.NO_OP: 20e-9}
    assert summary["window_s"] == 1e-6
    empty = trace.summarize([], [], host_s=0.5)
    assert empty["busy_s"] == 0.0 and empty["window_s"] == 0.5
