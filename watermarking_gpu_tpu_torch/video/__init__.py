"""Video pipeline: libav, ffmpeg and raw-yuv IO, threaded frame pumps,
interval-sampled luma watermarking with overlapped device compute."""

from .pipeline import (FrameSink, FrameSource, detect_video, embed_video,
                       test_for_video)
from .pump import FrameReader, FrameWriter, native_available
from .rawyuv import frame_bytes, join_planes, split_planes, synthesize

__all__ = [
    "FrameReader", "FrameSink", "FrameSource", "FrameWriter", "detect_video",
    "embed_video", "frame_bytes", "join_planes", "native_available",
    "split_planes", "synthesize", "test_for_video",
]
