"""Video watermarking pipeline: interval-sampled luma embed / detect, on
the card.

Re-designs the reference's synchronous frame loop
(``Watermark_GPU/main.cpp:245-410``) as the JAX package's pipeline does:

* decode and encode run in-process through libav, in ffmpeg child
  processes, or on raw ``.yuv`` files, pumped by prefetching reader/writer
  threads (``pump.py``, C++ when built);
* sampled lumas batch into one device dispatch per ``embed_batch`` /
  ``detect_batch`` frames, and one batch stays in flight while the next
  fills: the lumas are staged in pinned host buffers and uploaded without
  the host waiting, the results come back into pinned buffers on a side
  stream, and the host waits only on that copy's event when it must write
  the results in stream order (``_Staging``);
* detection prints one correlation per sampled frame (``main.cpp:392-410``).

Semantics match the reference: only every ``watermark_interval``-th frame is
watermarked (ME mask, luma only), chroma and the frames between samples
pass through byte for byte, and watermarked luma is written back as
truncated u8.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..io.config import Settings
from ..models import MaskType
from ..models.batched import BatchedWatermark
from ..utils.timing import execution_time
from . import ffmpeg as ff
from .pump import FrameReader, FrameWriter
from .rawyuv import frame_bytes, split_planes


class FrameSource:
    """Uniform frame source over in-process libav decode, ffmpeg-subprocess
    decode, or a raw .yuv file.

    The in-process decoder is the PRIMARY path (the reference decodes
    in-process too, main.cpp:422-437): frame/slice-threaded libav behind a
    prefetching ring. The ffmpeg child remains for installs without the
    native library; raw ``.yuv`` needs neither.
    """

    def __init__(self, settings: Settings):
        from . import libav

        path = settings.video
        self._proc = None
        self._file = None
        self._inproc = None
        if not path.endswith(".yuv") and libav.available():
            try:
                decoder = libav.LibavDecoder(path)
            except RuntimeError:
                if not ff.ffmpeg_path():
                    raise   # no subprocess fallback exists: surface it
                # system libav may lack a demuxer/codec the full ffmpeg
                # binary has — fall through to the subprocess decoder
                print("NOTE: in-process decode could not open the input; "
                      "falling back to the ffmpeg subprocess decoder")
                decoder = None
        else:
            decoder = None
        if decoder is not None:
            try:
                # same contract + messages as the subprocess path: the
                # reference aborts on non-4:2:0 (main.cpp:458-459); the
                # default converts with a NOTE
                ff.check_pixel_format(
                    ff.VideoInfo(decoder.width, decoder.height, decoder.fps,
                                 decoder.pix_fmt),
                    settings.strict_pixel_format)
            except Exception:
                decoder.close()
                raise
            self.width, self.height = decoder.width, decoder.height
            self.fps = decoder.fps
            self._inproc = decoder
            self.reader = libav.DecoderReader(decoder)
            return
        if path.endswith(".yuv"):
            if not settings.raw_video_size:
                raise RuntimeError(
                    "raw .yuv input requires raw_video_size = WxH in "
                    "[parameters_video]")
            w, h = settings.raw_video_size.lower().split("x")
            self.width, self.height = int(w), int(h)
            if self.width % 2 or self.height % 2:
                raise RuntimeError(
                    "yuv420p requires even frame dimensions, got "
                    f"{self.width}x{self.height}")
            self.fps = settings.raw_video_fps
            self._file = open(path, "rb")
            fd = self._file.fileno()
        else:
            info = ff.probe(path)
            self.width, self.height, self.fps = (info.width, info.height,
                                                 info.fps)
            ff.check_pixel_format(info, settings.strict_pixel_format)
            self._proc = ff.open_decoder(path)
            fd = self._proc.stdout.fileno()
        self.reader = FrameReader(fd, frame_bytes(self.width, self.height))

    def next(self):
        return self.reader.next()

    def close(self):
        self.reader.close()
        if self._proc is not None:
            self._proc.stdout.close()
            self._proc.wait()
        if self._file is not None:
            self._file.close()


def _translate_encode_options(encode_options: str
                              ) -> tuple[str | None, str]:
    """ffmpeg-CLI ``encode_options`` -> (codec name, AVOption k=v list).

    The reference's ini carries CLI-style options for its ffmpeg child
    (``-c:v libx265 -preset fast -crf 23``, main.cpp:284); the in-process
    encoder takes the codec by name plus an AVOption dict, so the common
    ``-key value`` pairs translate directly (unknown AVOptions are
    ignored by libav, matching ffmpeg CLI leniency per-codec).
    """
    import shlex

    def is_value(tok: str | None) -> bool:
        if tok is None:
            return False
        if not tok.startswith("-"):
            return True
        try:               # negative numbers are values ("-qmin -1"),
            float(tok)     # not flags
            return True
        except ValueError:
            return False

    tokens = shlex.split(encode_options or "")
    codec = None
    pairs = []
    skipped = []
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        value = tokens[i + 1] if i + 1 < len(tokens) else None
        if (tok in ("-c:v", "-codec:v", "-vcodec")
                and value is not None and not value.startswith("-")):
            # codec names are never numeric/flag-shaped; "-vcodec -an"
            # must fall through to the skipped/NOTE path, not request a
            # nonsense "-an" encoder
            codec = value
            i += 2
        elif tok.startswith("-") and is_value(value):
            pairs.append(f"{tok[1:]}={value}")
            i += 2
        else:
            skipped.append(tok)
            i += 1
    if skipped:
        # valueless flags have no AVOption k=v form; say so rather than
        # silently encoding with different parameters than the ini asked
        print(f"NOTE: encode_options tokens not translatable to AVOptions, "
              f"ignored by the in-process encoder: {' '.join(skipped)}")
    return codec, ",".join(pairs)


class FrameSink:
    """Uniform frame sink over an ffmpeg-subprocess encoder, the in-process
    libav encoder, or a raw .yuv file.

    Preference order for encoded outputs: the ffmpeg child (honors the
    reference's full ``encode_options`` CLI string, main.cpp:284-294), then
    the in-process encoder (codec + common options translated from
    ``encode_options``; the path for installs with no ffmpeg binary at
    all), then raw ``.yuv``.
    """

    def __init__(self, settings: Settings, source: FrameSource):
        from . import libav

        out_path = settings.encode_watermark_file_path
        self._proc = None
        self._file = None
        self._inproc = None
        if out_path.endswith(".yuv"):
            self._file = open(out_path, "wb")
            fd = self._file.fileno()
        elif not ff.ffmpeg_path() and libav.available():
            codec_pref, options = _translate_encode_options(
                settings.encode_options)
            codec = libav.pick_encoder(codec_pref)
            if codec is None:
                raise RuntimeError("No usable in-process encoder codec")
            if codec_pref and codec != codec_pref:
                print(f"NOTE: encoder '{codec_pref}' unavailable "
                      f"in-process; using '{codec}'")
            # pass the source container so its audio/subtitle tracks are
            # stream-copied into the output (the ffmpeg-subprocess path
            # does this with `-c:s copy -c:a copy -map`, main.cpp:287-289;
            # raw .yuv inputs have no side tracks to carry)
            copy_from = (settings.video
                         if not settings.video.endswith(".yuv") else None)
            encoder = libav.LibavEncoder(out_path, source.width,
                                         source.height, source.fps, codec,
                                         options, copy_from=copy_from)
            for line in encoder.notes.splitlines():
                print(line)
            self._inproc = encoder
            self.writer = libav.EncoderWriter(encoder)
            return
        elif not ff.ffmpeg_path():
            raise RuntimeError(
                "No ffmpeg binary and no in-process encoder (make -C "
                "native): set encode_watermark_file_path to a .yuv path "
                "for raw output")
        else:
            self._proc = ff.open_encoder(out_path, source.width,
                                         source.height, source.fps,
                                         settings.encode_options,
                                         settings.video)
            fd = self._proc.stdin.fileno()
        self.writer = FrameWriter(fd, frame_bytes(source.width,
                                                  source.height))

    def put(self, frame_bytes_: bytes):
        self.writer.put(frame_bytes_)

    def close(self):
        self.writer.close()
        if self._proc is not None:
            self._proc.stdin.close()
            self._proc.wait()
        if self._file is not None:
            self._file.close()


# host-side frame buffering allowed per in-flight embed batch: a batch of B
# sampled frames spans B*interval stream frames, all held until its device
# results land (at most two batches exist: one in flight, one accumulating)
_EMBED_BATCH_BUDGET_BYTES = 128 * 1024 * 1024


class _Buffers:
    """One batch's host buffers, its device input, and the event after the
    copy of its results to the host."""

    def __init__(self, batch_shape: tuple, out_shape: tuple,
                 out_dtype: torch.dtype, device: torch.device):
        pinned = device.type == "cuda"
        self.inputs = torch.empty(batch_shape, dtype=torch.uint8,
                                  pin_memory=pinned)
        self.outputs = torch.empty(out_shape, dtype=out_dtype,
                                   pin_memory=pinned)
        self.device_inputs = (torch.empty(batch_shape, dtype=torch.uint8,
                                          device=device) if pinned else None)
        self.event: torch.cuda.Event | None = None
        self.result: torch.Tensor | None = None

    def fill(self, frames: list, width: int, height: int) -> None:
        """Copy the frames' luma planes into the host input, padding the
        batch with the last real frame (results past it are dropped)."""
        lumas = self.inputs.numpy()
        for i, frame in enumerate(frames):
            lumas[i] = split_planes(frame, width, height)[0]
        lumas[len(frames):] = lumas[len(frames) - 1]

    def upload(self) -> torch.Tensor:
        """The lumas on the device; on the card a copy the host does not
        wait for, on the current stream ahead of the kernels."""
        if self.device_inputs is None:
            return self.inputs
        self.device_inputs.copy_(self.inputs, non_blocking=True)
        return self.device_inputs

    def wait(self) -> np.ndarray:
        """The results, once their copy to the host has landed."""
        if self.event is not None:
            self.event.synchronize()
            self.event = self.result = None
        return self.outputs.numpy()


class _Staging:
    """Two sets of ``_Buffers`` between the frame loop and the device: one
    batch in flight while the next fills.

    On a CUDA device the host buffers are pinned. ``_Buffers.upload``
    copies a batch's lumas to the device with ``non_blocking=True`` on the
    current stream, ahead of its kernels; ``download`` makes a side stream
    wait for them, copies the results into the pinned outputs there and
    records an event, which is all that ``_Buffers.wait`` waits for.
    ``take`` waits for a set's last event before the set is filled again:
    its upload and its download have then both landed, so neither pinned
    buffer is written while a copy reads it or read while a copy writes it.
    On the CPU the buffers are plain tensors and each step is synchronous.
    """

    def __init__(self, batch_size: int, height: int, width: int,
                 out_shape: tuple, out_dtype: torch.dtype,
                 device: torch.device):
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)
        self._sets = [_Buffers((batch_size, height, width),
                               (batch_size, *out_shape), out_dtype, device)
                      for _ in range(2)]
        self._turn = 0

    def take(self) -> _Buffers:
        buffers = self._sets[self._turn]
        self._turn ^= 1
        buffers.wait()
        return buffers

    def download(self, buffers: _Buffers, result: torch.Tensor) -> None:
        if self._stream is None:
            buffers.outputs.copy_(result)
            return
        self._stream.wait_stream(torch.cuda.current_stream(result.device))
        with torch.cuda.stream(self._stream):
            buffers.outputs.copy_(result, non_blocking=True)
            buffers.event = torch.cuda.Event()
            buffers.event.record(self._stream)
        # the result's memory stays allocated until the copy has read it
        buffers.result = result


def embed_video(settings: Settings, engine: BatchedWatermark | None = None,
                out=None, stats: dict | None = None,
                device: "str | torch.device" = "cuda") -> int:
    """Watermark every interval-th frame; stream everything to the sink.

    Sampled lumas cross the link as uint8 and batch into one device
    dispatch each (``embed_luma_u8`` widens and truncates on the device);
    one batch stays in flight while the next accumulates (``_Staging``),
    so transfers, compute and frame IO overlap, and at interval=1 the
    dispatch cost amortizes over ``embed_batch`` frames. The engine, when
    not given, is built on ``device``.

    ``stats``: optional dict; when given, filled with the pipeline's wait
    decomposition (seconds blocked on the source pump / device results /
    the sink pump, batch assembly and dispatch, output frame assembly, wall
    time, batch and frame counts).
    """
    out = sys.stdout if out is None else out
    waits = {"read_s": 0.0, "collect_s": 0.0, "write_s": 0.0,
             "prep_s": 0.0, "emit_s": 0.0, "batches": 0}
    source = FrameSource(settings)
    sink = None
    frames = 0
    start = time.perf_counter()
    try:
        sink = FrameSink(settings, source)
        interval = settings.watermark_interval
        width, height = source.width, source.height
        if engine is None:
            engine = BatchedWatermark(height, width, settings.watermark,
                                      p=settings.p, psnr=settings.psnr,
                                      device=device)
        span_bytes = frame_bytes(width, height) * max(1, interval)
        batch_size = max(1, min(max(1, settings.embed_batch),
                                _EMBED_BATCH_BUDGET_BYTES // span_bytes))
        staging = _Staging(batch_size, height, width, (height, width),
                           torch.uint8, engine.device)

        # each item: [sampled frame, followers until the next sample]
        items: list[list] = []
        pending: list[tuple[int, list, _Buffers]] = []
        luma_size = width * height
        fb = frame_bytes(width, height)

        def dispatch():
            nonlocal items
            if not items:
                return
            t0 = time.perf_counter()               # host batch assembly
            buffers = staging.take()
            buffers.fill([frame for frame, _ in items], width, height)
            marked, _ = engine.embed_luma_u8(buffers.upload(), MaskType.ME)
            staging.download(buffers, marked)
            waits["prep_s"] += time.perf_counter() - t0
            pending.append((len(items), items, buffers))
            waits["batches"] += 1
            items = []

        def collect(block_all=False):
            while pending and (block_all or len(pending) > 1):
                real, batch_items, buffers = pending.pop(0)
                t0 = time.perf_counter()
                host = buffers.wait()              # the u8 copy's event
                waits["collect_s"] += time.perf_counter() - t0
                for i, (frame, followers) in enumerate(batch_items[:real]):
                    # ONE copy assembles the output frame (marked luma +
                    # source chroma) into a fresh buffer, which the writers
                    # take zero-copy; the pinned buffer is free again after
                    t0 = time.perf_counter()
                    emitted = np.empty(fb, np.uint8)
                    emitted[:luma_size] = host[i].ravel()
                    emitted[luma_size:] = frame[luma_size:]
                    waits["emit_s"] += time.perf_counter() - t0
                    t0 = time.perf_counter()
                    sink.put(emitted)
                    for follower in followers:
                        sink.put(follower)
                    waits["write_s"] += time.perf_counter() - t0

        start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            frame = source.next()
            waits["read_s"] += time.perf_counter() - t0
            if frame is None:
                break
            if frames % interval == 0:
                items.append([frame, []])
                if len(items) >= batch_size:
                    dispatch()
                    collect()          # keep at most one batch in flight
            elif items:
                items[-1][1].append(frame)
            elif pending:
                # follower of the last item of the in-flight batch (its list
                # is still growing until the next sample arrives)
                pending[-1][1][-1][1].append(frame)
            else:
                sink.put(frame)         # zero-copy passthrough
            frames += 1
        dispatch()
        collect(block_all=True)
    finally:
        elapsed = time.perf_counter() - start
        source.close()
        if sink is not None:
            sink.close()
    if stats is not None:
        stats.update(waits, wall_s=elapsed, frames=frames)
    print(f"\nWatermark embedding total execution time: "
          f"{execution_time(False, elapsed)}", file=out)
    return frames


def detect_video(settings: Settings, engine: BatchedWatermark | None = None,
                 out=None, stats: dict | None = None,
                 device: "str | torch.device" = "cuda"
                 ) -> tuple[int, list[tuple[int, float]]]:
    """Print per-sampled-frame detector correlations (reference format).

    Sampled lumas batch into one dispatch per ``detect_batch`` frames
    (a remainder batch is padded to the same shape), staged and collected
    as in ``embed_video``; ``stats`` gets the read, prep and collect waits,
    wall time, batch and frame counts.
    """
    out = sys.stdout if out is None else out
    waits = {"read_s": 0.0, "collect_s": 0.0, "prep_s": 0.0, "batches": 0}
    source = FrameSource(settings)
    results: list[tuple[int, float]] = []
    frames = 0
    start = time.perf_counter()
    try:
        interval = settings.watermark_interval
        batch_size = max(1, settings.detect_batch)
        if engine is None:
            engine = BatchedWatermark(source.height, source.width,
                                      settings.watermark, p=settings.p,
                                      psnr=settings.psnr, device=device)
        staging = _Staging(batch_size, source.height, source.width, (),
                           torch.float32, engine.device)
        pending: list[tuple[list[int], _Buffers]] = []
        batch_ids: list[int] = []
        batch_frames: list[np.ndarray] = []

        def dispatch():
            nonlocal batch_ids, batch_frames
            if not batch_frames:
                return
            t0 = time.perf_counter()
            buffers = staging.take()
            buffers.fill(batch_frames, source.width, source.height)
            corr = engine.detect(buffers.upload(), MaskType.ME)
            staging.download(buffers, corr)
            waits["prep_s"] += time.perf_counter() - t0
            pending.append((batch_ids, buffers))
            waits["batches"] += 1
            batch_ids, batch_frames = [], []

        def collect(block_all=False):
            while pending and (block_all or len(pending) > 1):
                ids, buffers = pending.pop(0)
                t0 = time.perf_counter()
                corr = buffers.wait()
                waits["collect_s"] += time.perf_counter() - t0
                for frame_id, value in zip(ids, corr[:len(ids)]):
                    results.append((frame_id, float(value)))
                    print(f"Correlation for frame: {frame_id}: {value:g}",
                          file=out)

        start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            frame = source.next()
            waits["read_s"] += time.perf_counter() - t0
            if frame is None:
                break
            if frames % interval == 0:
                batch_ids.append(frames)
                batch_frames.append(frame)
                if len(batch_frames) >= batch_size:
                    dispatch()
                    collect()     # keep at most one batch in flight
            frames += 1
        dispatch()
        collect(block_all=True)
    finally:
        elapsed = time.perf_counter() - start
        source.close()
    if stats is not None:
        stats.update(waits, wall_s=elapsed, frames=frames)

    print(f"\nWatermark detection total execution time: "
          f"{execution_time(False, elapsed)}", file=out)
    if frames:
        per_frame = execution_time(settings.execution_time_in_fps,
                                   elapsed / frames)
        print(f"\nWatermark detection average execution time per frame: "
              f"{per_frame}", file=out)
    return frames, results


def test_for_video(settings: Settings,
                   device: "str | torch.device" = "cuda") -> int:
    """CLI dispatch, mirroring testForVideo (main.cpp:245-316)."""
    if settings.encode_watermark_file_path:
        embed_video(settings, device=device)
    elif settings.watermark_detection:
        detect_video(settings, device=device)
    return 0
