"""In-process libav video decode/encode (ctypes over native/libwmdecode.so).

The reference decodes IN-PROCESS with libav (frame- or slice-threaded
decoder, ``Watermark_GPU/main.cpp:422-437``) and encodes by
piping raw yuv420p to an ffmpeg CLI subprocess (``main.cpp:284-294``). This
module gives the framework both halves in-process:

* ``LibavDecoder`` — avformat/avcodec decode with the reference's exact
  threading policy, emitting de-padded packed yuv420p frames; non-4:2:0
  inputs are swscale-converted (the documented extension of the
  reference's whitelist; ``strict`` restores the abort contract).
* ``LibavEncoder`` — real encoded output files (codec by name + AVOption
  dict) where the reference needs an external ffmpeg binary.

Both are wrapped in prefetching/buffering threads (``DecoderReader`` /
``EncoderWriter``) with the same depth-bounded ring semantics as the frame
pump (``pump.py``), so decode/encode IO overlaps device compute.

Everything degrades gracefully: ``available()`` is False when the shared
library is not built (no libav dev packages) and callers fall back to the
ffmpeg-subprocess / raw-``.yuv`` paths. Framework-free: the same module as
the JAX package's, over the same ``native/libwmdecode.so``.
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading

import numpy as np

from .rawyuv import frame_bytes

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native",
    "libwmdecode.so")

_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        _lib = False
        return _lib
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        _lib = False
        return _lib
    lib.wmd_open.restype = ctypes.c_void_p
    lib.wmd_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                             ctypes.c_int]
    lib.wmd_width.restype = ctypes.c_int
    lib.wmd_width.argtypes = [ctypes.c_void_p]
    lib.wmd_height.restype = ctypes.c_int
    lib.wmd_height.argtypes = [ctypes.c_void_p]
    lib.wmd_fps.restype = ctypes.c_double
    lib.wmd_fps.argtypes = [ctypes.c_void_p]
    lib.wmd_pix_fmt_name.restype = ctypes.c_char_p
    lib.wmd_pix_fmt_name.argtypes = [ctypes.c_void_p]
    lib.wmd_error.restype = ctypes.c_char_p
    lib.wmd_error.argtypes = [ctypes.c_void_p]
    lib.wmd_read.restype = ctypes.c_int
    lib.wmd_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.wmd_close.argtypes = [ctypes.c_void_p]
    lib.wme_open.restype = ctypes.c_void_p
    lib.wme_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_double, ctypes.c_char_p,
                             ctypes.c_char_p, ctypes.c_char_p,
                             ctypes.c_char_p, ctypes.c_int]
    lib.wme_notes.restype = ctypes.c_char_p
    lib.wme_notes.argtypes = [ctypes.c_void_p]
    lib.wmt_stream_count.restype = ctypes.c_int
    lib.wmt_stream_count.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.wme_write.restype = ctypes.c_int
    lib.wme_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.wme_error.restype = ctypes.c_char_p
    lib.wme_error.argtypes = [ctypes.c_void_p]
    lib.wme_close.restype = ctypes.c_int
    lib.wme_close.argtypes = [ctypes.c_void_p]
    lib.wme_codec_available.restype = ctypes.c_int
    lib.wme_codec_available.argtypes = [ctypes.c_char_p]
    _lib = lib
    return _lib


def available() -> bool:
    """Is the in-process libav path built, loadable, and not opted out?

    ``WM_NO_INPROC_VIDEO=1`` routes the pipeline back to the
    ffmpeg-subprocess paths (checked per call, not cached — tests and
    deployments can flip it at runtime)."""
    if os.environ.get("WM_NO_INPROC_VIDEO"):
        return False
    return bool(_load_lib())


def codec_available(name: str) -> bool:
    lib = _load_lib()
    return bool(lib) and bool(lib.wme_codec_available(name.encode()))


def stream_count(path: str, kind: str = "audio") -> int:
    """Streams of ``kind`` ('video'/'audio'/'subtitle') in a container
    (-1 if unreadable or the library is absent)."""
    lib = _load_lib()
    if not lib:
        return -1
    media = {"video": 0, "audio": 1, "subtitle": 3}[kind]
    return int(lib.wmt_stream_count(os.fspath(path).encode(), media))


def pick_encoder(preferred: str | None = None) -> str | None:
    """First available encoder: the caller's preference, then the lossless
    ffv1, then the ubiquitous mpeg4 (None if the library is absent)."""
    if not available():
        return None
    for name in ([preferred] if preferred else []) + ["ffv1", "mpeg4"]:
        if name and codec_available(name):
            return name
    return None


class LibavDecoder:
    """Synchronous in-process decoder; see DecoderReader for the pumped
    form the pipeline uses."""

    def __init__(self, path: str, strict: bool = False):
        lib = _load_lib()
        if not lib:
            raise RuntimeError("libwmdecode.so not built (make -C native)")
        self._lib = lib
        err = ctypes.create_string_buffer(512)
        self._handle = lib.wmd_open(os.fspath(path).encode(),
                                    1 if strict else 0, err, len(err))
        if not self._handle:
            raise RuntimeError(err.value.decode() or "decoder open failed")
        self.width = lib.wmd_width(self._handle)
        self.height = lib.wmd_height(self._handle)
        self.fps = lib.wmd_fps(self._handle)
        self.pix_fmt = lib.wmd_pix_fmt_name(self._handle).decode()
        self._buf = ctypes.create_string_buffer(
            frame_bytes(self.width, self.height))

    def read(self) -> np.ndarray | None:
        """Next packed yuv420p frame as uint8, or None at EOF."""
        rc = self._lib.wmd_read(self._handle, self._buf)
        if rc < 0:
            raise IOError(self._lib.wmd_error(self._handle).decode())
        if rc == 0:
            return None
        # one copy (frombuffer views the ctypes buffer; .raw would copy
        # a second time on the decode hot path)
        return np.frombuffer(self._buf, dtype=np.uint8).copy()

    def close(self):
        if self._handle:
            self._lib.wmd_close(self._handle)
            self._handle = None


class DecoderReader:
    """FrameReader-compatible prefetching wrapper over LibavDecoder: a
    reader thread keeps a depth-bounded ring of decoded frames so decode
    overlaps device compute (pump.py semantics)."""

    def __init__(self, decoder: LibavDecoder, depth: int = 4):
        self._decoder = decoder
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self):
        try:
            while not self._stop.is_set():
                frame = self._decoder.read()
                self._queue.put(frame)
                if frame is None:
                    return
        except Exception as exc:            # surfaced on the next next()
            self._queue.put(exc)

    def next(self) -> np.ndarray | None:
        item = self._queue.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        while True:                          # unblock the producer
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            # the pump is still inside wmd_read (wedged demuxer/IO):
            # freeing the native decoder under it would be a
            # use-after-free; leak the handle instead (daemon thread)
            return
        self._decoder.close()


class LibavEncoder:
    """Synchronous in-process encoder (packed yuv420p in, encoded file
    out).

    ``copy_from`` names a container whose audio/subtitle streams are
    remuxed into the output via libavformat stream copy, interleaved
    against the video clock — the in-process equivalent of the
    reference's ``-c:s copy -c:a copy -map`` ffmpeg-child flags
    (``Watermark_GPU/main.cpp:287-289``). Tracks the
    output container cannot carry are dropped with a NOTE line in
    ``self.notes`` (callers print them)."""

    def __init__(self, path: str, width: int, height: int, fps: float,
                 codec: str, options: str = "",
                 copy_from: str | None = None):
        lib = _load_lib()
        if not lib:
            raise RuntimeError("libwmdecode.so not built (make -C native)")
        self._lib = lib
        err = ctypes.create_string_buffer(512)
        self._handle = lib.wme_open(os.fspath(path).encode(), width, height,
                                    float(fps), codec.encode(),
                                    options.encode(),
                                    os.fspath(copy_from).encode()
                                    if copy_from else None, err, len(err))
        if not self._handle:
            raise RuntimeError(err.value.decode() or "encoder open failed")
        self.notes = lib.wme_notes(self._handle).decode()
        self.frame_bytes = frame_bytes(width, height)

    def write(self, frame):
        """Encode one packed yuv420p frame (bytes or uint8 array; arrays
        pass zero-copy — the C side copies into the AVFrame itself)."""
        if isinstance(frame, np.ndarray):
            if frame.dtype != np.uint8 or not frame.flags.c_contiguous:
                frame = np.ascontiguousarray(frame, dtype=np.uint8)
            nbytes, src = frame.nbytes, frame.ctypes.data_as(
                ctypes.c_char_p)
        else:
            nbytes, src = len(frame), frame
        if nbytes != self.frame_bytes:
            raise ValueError(f"frame is {nbytes} bytes, expected "
                             f"{self.frame_bytes}")
        if self._lib.wme_write(self._handle, src) < 0:
            raise IOError(self._lib.wme_error(self._handle).decode())

    def close(self):
        if self._handle:
            rc = self._lib.wme_close(self._handle)
            self._handle = None
            if rc < 0:
                raise IOError("encoder close/flush failed")


class EncoderWriter:
    """FrameWriter-compatible buffering wrapper over LibavEncoder: encode
    runs on its own thread behind a depth-bounded queue so the device
    never waits on the codec."""

    def __init__(self, encoder: LibavEncoder, depth: int = 4):
        self._encoder = encoder
        self.frame_bytes = encoder.frame_bytes
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._error: Exception | None = None
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _pump(self):
        while True:
            data = self._queue.get()
            if data is None:
                return
            if self._error is not None:
                continue   # drain: blocked producers/close() must unblock
            try:
                self._encoder.write(data)
            except Exception as exc:
                # record and KEEP CONSUMING (dropping frames) until the
                # close sentinel — exiting here would leave producers
                # blocked forever on the full bounded queue
                self._error = exc

    def put(self, frame):
        # arrays are enqueued by reference (zero-copy; LibavEncoder.write
        # hands the pointer to C) — callers must not mutate them after
        if self._error is not None:
            raise IOError(f"encoder failed: {self._error}")
        self._queue.put(frame)

    def close(self):
        self._queue.put(None)
        self._thread.join()
        self._encoder.close()
        if self._error is not None:
            raise IOError(f"encoder failed: {self._error}")
