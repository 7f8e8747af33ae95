"""settings.ini configuration, schema-compatible with the reference.

The reference is driven entirely by a ``settings.ini`` parsed with inih
(``Watermark_GPU/main.cpp:65-66`` and per-key defaults at the
call sites). Sections and keys (``settings.ini:1-25``):

    [paths]            image, watermark, video
    [options]          opencl_device, save_watermarked_files_to_disk,
                       execution_time_in_fps
    [parameters]       p, psnr, loops_for_test
    [parameters_video] watermark_interval, encode_watermark_file_path,
                       encode_options, watermark_detection

Presence of a non-empty ``video`` path selects video mode
(``main.cpp:126-129``).
``opencl_device`` maps to a CUDA device index here (``cuda:N``). The same
fields and parsing as the JAX package's ``io/config.py``, so one
``settings.ini`` drives both packages.
"""

from __future__ import annotations

import configparser
import os
from dataclasses import dataclass, field


@dataclass
class Settings:
    # [paths]
    image: str = "NO_IMAGE"
    watermark: str = ""
    video: str = ""
    # [options]
    device: int = 0
    save_watermarked_files_to_disk: bool = False
    execution_time_in_fps: bool = False
    # extension: time the benchmark loops with pipelined dispatch + one sync
    # (true device time) instead of the reference's per-call blocking loop
    pipelined_timing: bool = True
    # extension of the JAX package (its persistent executable cache); parsed
    # so that one ini drives both packages. The port has no such cache to
    # enable: its kernels are built once per source hash into _build/
    compilation_cache_dir: str = ""
    # [parameters]
    p: int = -1
    psnr: float = -1.0
    loops_for_test: int = 5
    # [parameters_video]
    watermark_interval: int = 30
    encode_watermark_file_path: str = ""
    encode_options: str = "-c:v libx265 -preset fast -crf 23"
    watermark_detection: bool = False
    # extensions beyond the reference schema (documented in README):
    # raw .yuv input support for ffmpeg-less environments, and detection
    # batching across sampled frames
    raw_video_size: str = ""       # "WxH", required for .yuv inputs
    raw_video_fps: float = 30.0
    detect_batch: int = 8
    embed_batch: int = 8           # sampled frames per embed dispatch (cap;
    #                                host buffering bounds the effective size)
    # reference parity: abort on non-YUV420P/YUVJ420P inputs (main.cpp:458)
    # instead of the default convert-to-yuv420p-and-note behavior
    strict_pixel_format: bool = False
    # provenance
    source_path: str = field(default="", compare=False)

    @property
    def is_video_mode(self) -> bool:
        return self.video != ""


def _get(parser: configparser.ConfigParser, section: str, key: str, default):
    if not parser.has_option(section, key):
        return default
    raw = parser.get(section, key).strip()
    if raw == "":
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        try:
            return int(raw)
        except ValueError:
            return default
    if isinstance(default, float):
        try:
            return float(raw)
        except ValueError:
            return default
    return raw


def load_settings(path: str | os.PathLike = "settings.ini") -> Settings:
    """Parse a reference-schema settings.ini into a Settings object."""
    parser = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
    read = parser.read(path)
    if not read:
        raise FileNotFoundError(f"Could not load {path} file")
    s = Settings(source_path=str(path))
    s.image = _get(parser, "paths", "image", s.image)
    s.watermark = _get(parser, "paths", "watermark", s.watermark)
    s.video = _get(parser, "paths", "video", s.video)
    s.device = _get(parser, "options", "opencl_device", s.device)
    s.save_watermarked_files_to_disk = _get(
        parser, "options", "save_watermarked_files_to_disk",
        s.save_watermarked_files_to_disk)
    s.execution_time_in_fps = _get(
        parser, "options", "execution_time_in_fps", s.execution_time_in_fps)
    s.pipelined_timing = _get(parser, "options", "pipelined_timing",
                              s.pipelined_timing)
    s.compilation_cache_dir = _get(parser, "options",
                                   "compilation_cache_dir",
                                   s.compilation_cache_dir)
    s.p = _get(parser, "parameters", "p", s.p)
    s.psnr = _get(parser, "parameters", "psnr", s.psnr)
    s.loops_for_test = _get(parser, "parameters", "loops_for_test",
                            s.loops_for_test)
    s.watermark_interval = _get(parser, "parameters_video",
                                "watermark_interval", s.watermark_interval)
    s.encode_watermark_file_path = _get(
        parser, "parameters_video", "encode_watermark_file_path",
        s.encode_watermark_file_path)
    s.encode_options = _get(parser, "parameters_video", "encode_options",
                            s.encode_options)
    s.watermark_detection = _get(parser, "parameters_video",
                                 "watermark_detection", s.watermark_detection)
    s.raw_video_size = _get(parser, "parameters_video", "raw_video_size",
                            s.raw_video_size)
    s.raw_video_fps = _get(parser, "parameters_video", "raw_video_fps",
                           s.raw_video_fps)
    s.detect_batch = _get(parser, "parameters_video", "detect_batch",
                          s.detect_batch)
    s.embed_batch = _get(parser, "parameters_video", "embed_batch",
                         s.embed_batch)
    s.strict_pixel_format = _get(parser, "parameters_video",
                                 "strict_pixel_format",
                                 s.strict_pixel_format)
    return s
