"""What the A/B tools (``tools/ab_*.py``) share: building variants of the
package's kernel sources, timing them on one GPU in turns, and their
inputs.

A build is named on a tool's command line as ``name=[source@]flags``: the
``source`` (by default the tool's own sources in
``watermarking_gpu_tpu_torch/csrc``; a directory holding them; ``git:REV``,
those sources and their headers at git revision REV; or one ``.cu`` file)
built by its own ``nvcc`` into a shared library with the extra compiler
``flags``. Every build's C entry points are declared with the package's
signatures (``build.SIGNATURES``). Builds compare within one call on one
card, measured in turns: every build in order, then in reverse.

Importing this module needs neither a GPU nor ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (ALL_P, COLS, ROWS, SEED, SUM_RTOL,  # noqa: E402,F401
                        detect_errors, make_bank, make_frames,
                        predictor_coefficients, random_spd_grams, rel_err)
from watermarking_gpu_tpu_torch.io.matfile import \
    generate_watermark  # noqa: E402
from watermarking_gpu_tpu_torch.ops.cuda import build  # noqa: E402

# ~1 ms of the H100's clocks: the calls a CUDA-event timing measures wait
# behind it, so that the host's launches do not set their pace
SLEEP_CYCLES = 2_000_000
# what a profiler trace says of a kernel's launch
LAUNCH_KEYS = ("registers per thread", "shared memory", "blocks per SM",
               "grid")
# a profiler timing's calls a session, and its sessions before it gives up
PROFILED_CALLS, PROFILED_TRIES = 20, 3


def parse_spec(arg: str) -> tuple[str, str | None, list[str]]:
    """``name=[source@]flags`` -> (name, source or None, flags); the name
    (letters, digits, ``_``, ``.``, ``-``) names the build's library."""
    name, equals, spec = arg.partition("=")
    if not equals or not re.fullmatch(r"[\w.-]+", name):
        raise ValueError(f"a build is name=[source@]flags, not {arg!r}")
    source, at, flags = spec.partition("@")
    return (name, source, flags.split()) if at else (name, None,
                                                     spec.split())


def git_sources(rev: str, out: Path) -> Path:
    """The package's kernel sources and headers at git revision ``rev``,
    written into ``out``."""
    csrc = build.CSRC_DIR.relative_to(ROOT)
    names = subprocess.run(
        ["git", "-C", str(ROOT), "ls-tree", "--name-only", f"{rev}:{csrc}"],
        capture_output=True, text=True, check=True).stdout.split()
    out.mkdir(parents=True)
    for name in names:
        if name.endswith((".cu", ".cuh")):
            (out / name).write_text(subprocess.run(
                ["git", "-C", str(ROOT), "show", f"{rev}:{csrc}/{name}"],
                capture_output=True, text=True, check=True).stdout)
    return out


def source_files(source: str | None, defaults: tuple[str, ...],
                 out: Path) -> list[Path]:
    """The files a build of ``source`` compiles (see the module's
    docstring); ``out`` takes the sources of a git revision."""
    if source is None:
        return [build.CSRC_DIR / name for name in defaults]
    if source.startswith("git:"):
        directory = git_sources(source[4:], out)
    elif Path(source).is_dir():
        directory = Path(source)
    else:
        return [Path(source)]
    return [directory / name for name in defaults]


def instantiation(line: str, kernel: str) -> str:
    """``kernel<args>`` as a ptxas line's mangled symbol names it (integer
    and bool template arguments)."""
    args = re.match(r"I((?:L[a-z]+-?\d+E)+)E", line.split(kernel, 1)[1])
    if args is None:
        return kernel
    return f"{kernel}<{', '.join(re.findall(r'L[a-z]+(-?\d+)E', args[1]))}>"


def build_variants(args: list[str], defaults: tuple[str, ...],
                   kernels: tuple[str, ...],
                   out: Path) -> dict[str, ctypes.CDLL]:
    """Build each ``name=[source@]flags`` of ``args`` (``defaults``: the
    tool's sources in the package) into ``out/<name>.so``, every ``nvcc``
    started together, and print ptxas' registers, shared memory and spills
    of each instantiation of ``kernels``. Returns the loaded libraries by
    name."""
    nvcc = build.find_nvcc()
    processes = {}
    for name, source, flags in map(parse_spec, args):
        files = source_files(source, defaults, out / f"{name}_src")
        processes[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", *flags, "-I",
             str(build.CSRC_DIR), "-o", str(out / f"{name}.so"),
             *map(str, files)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libraries = {}
    for name, process in processes.items():
        log = process.communicate()[0]
        if process.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            kernel = next((k for k in kernels if k in line), None)
            if "Compiling entry" in line and kernel:
                report = [x.split(":", 1)[-1].strip()
                          for x in lines[i + 1:i + 4]
                          if "Used" in x or "spill" in x]
                print(f"{name} {instantiation(line, kernel)}: "
                      f"{' / '.join(report)}", flush=True)
        library = ctypes.CDLL(str(out / f"{name}.so"))
        for entry, argtypes in build.SIGNATURES.items():
            if hasattr(library, entry):
                getattr(library, entry).argtypes = argtypes
                getattr(library, entry).restype = ctypes.c_int
        libraries[name] = library
    return libraries


def require_card() -> None:
    """Exit unless there is a GPU; print its name and power limit."""
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_code(code: int, entry: str) -> None:
    """Raise if a C entry point refused its launch."""
    if code:
        raise RuntimeError(f"{entry}: CUDA error {code}")


def frames() -> torch.Tensor:
    """``chip_smoke.py``'s 8 x 1080 x 1920 f32 frames on the card."""
    return torch.from_numpy(make_frames()).cuda()


def watermark() -> torch.Tensor:
    """The engines' (1080, 1920) watermark on the card."""
    return torch.from_numpy(generate_watermark(ROWS, COLS, SEED)).cuda()


def bank() -> torch.Tensor:
    """``chip_smoke.py``'s 64-candidate bank on the card."""
    return torch.from_numpy(make_bank()).cuda()


def events_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """ms a call of ``fn``: CUDA events around ``iters`` calls after
    ``warmup``, queued behind SLEEP_CYCLES of ``torch.cuda._sleep``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(fn, names: tuple[str, ...]) -> dict[str, tuple[float, str]]:
    """Device ms a call of each kernel ``fn`` launches (once a call), keyed
    by the first of ``names`` its name holds, else by its name's first 40
    characters, from one ``torch.profiler`` session over PROFILED_CALLS
    calls; beside it, its launch's LAUNCH_KEYS from the session's trace.
    The profiler may drop records: a mean is over the records it kept, and
    a session that kept none is run again, up to PROFILED_TRIES sessions.
    Run it after every CUDA-event timing, whose launches its tracing may
    slow."""
    fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        for _ in range(PROFILED_TRIES):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]
            ) as prof:
                for _ in range(PROFILED_CALLS):
                    fn()
                torch.cuda.synchronize()
            prof.export_chrome_trace(str(trace))
            kept: dict[str, list[dict]] = {}
            for event in json.loads(trace.read_text())["traceEvents"]:
                if event.get("cat") == "kernel":
                    name = event.get("name", "")
                    key = next((n for n in names if n in name), name[:40])
                    kept.setdefault(key, []).append(event)
            if kept:
                return {key: (sum(e["dur"] for e in events) / 1e3
                              / len(events),
                              ", ".join(f"{k} {events[0]['args'][k]}"
                                        for k in LAUNCH_KEYS
                                        if k in events[0].get("args", {})))
                        for key, events in kept.items()}
    raise SystemExit(f"the profiler kept no kernel record in "
                     f"{PROFILED_TRIES} sessions")


def in_turns(fns: dict, measure=events_ms) -> dict[str, list]:
    """``measure(fn)`` of each of ``fns`` in turns: in order, then in
    reverse. Returns each one's two measurements by name."""
    runs = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:
        runs[name].append(measure(fns[name]))
    return runs
