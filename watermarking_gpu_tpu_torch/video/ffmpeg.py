"""ffmpeg subprocess management for video decode/encode.

Mirrors the reference's process topology: decode in one direction, encode by
piping raw yuv420p into an ffmpeg child built from ``encode_options``
(``Watermark_GPU/main.cpp:284-294``). The reference decodes
in-process with libav; here decode is also an ffmpeg child emitting rawvideo
on stdout — same frames, one code path.

Everything degrades gracefully when no ffmpeg binary exists:
``ffmpeg_path()`` returns None and callers fall back to the in-process
encoder or raw ``.yuv`` file IO (``rawyuv.py``). Framework-free: the same
module as the JAX package's.
"""

from __future__ import annotations

import json
import os
import re
import shlex
import shutil
import subprocess


def ffmpeg_path() -> str | None:
    return os.environ.get("WM_FFMPEG") or shutil.which("ffmpeg")


def ffprobe_path() -> str | None:
    return os.environ.get("WM_FFPROBE") or shutil.which("ffprobe")


# the reference only accepts these decoder outputs (main.cpp:458-459); any
# other input is converted to yuv420p by the decode child unless strict
SUPPORTED_PIX_FMTS = ("yuv420p", "yuvj420p")


class VideoInfo:
    def __init__(self, width: int, height: int, fps: float,
                 pix_fmt: str = ""):
        self.width = width
        self.height = height
        self.fps = fps
        self.pix_fmt = pix_fmt


def probe(path: str) -> VideoInfo:
    """Stream geometry/rate/format via ffprobe, or ffmpeg -i as fallback."""
    probe_bin = ffprobe_path()
    if probe_bin:
        out = subprocess.run(
            [probe_bin, "-v", "error", "-select_streams", "v:0",
             "-show_entries", "stream=width,height,avg_frame_rate,pix_fmt",
             "-of", "json", path],
            capture_output=True, text=True, check=True).stdout
        stream = json.loads(out)["streams"][0]
        num, den = stream["avg_frame_rate"].split("/")
        fps = float(num) / float(den) if float(den) else 30.0
        return VideoInfo(int(stream["width"]), int(stream["height"]), fps,
                         stream.get("pix_fmt", ""))
    ff = ffmpeg_path()
    if not ff:
        raise RuntimeError("No ffmpeg/ffprobe binary available")
    result = subprocess.run([ff, "-i", path], capture_output=True, text=True)
    match = re.search(r"(\d{2,5})x(\d{2,5})", result.stderr)
    fps_match = re.search(r"([\d.]+) fps", result.stderr)
    fmt_match = re.search(r"Video: \w+[^,]*, (\w+)", result.stderr)
    if not match:
        raise RuntimeError(f"Could not probe video geometry of {path}")
    return VideoInfo(int(match.group(1)), int(match.group(2)),
                     float(fps_match.group(1)) if fps_match else 30.0,
                     fmt_match.group(1) if fmt_match else "")


def check_pixel_format(info: VideoInfo, strict: bool) -> None:
    """Reference parity contract for input formats.

    The reference aborts on anything but YUV420P/YUVJ420P
    (``main.cpp:458-459``). By default this framework instead lets the
    decode child convert to yuv420p (documented extension) and says so;
    ``strict_pixel_format = true`` restores the reference's abort.
    """
    if not info.pix_fmt or info.pix_fmt in SUPPORTED_PIX_FMTS:
        return
    if strict:
        raise RuntimeError(
            f"Video format {info.pix_fmt} is not supported, please use a "
            f"video with YUV420P or YUVJ420P pixel format")
    print(f"NOTE: input pixel format {info.pix_fmt} will be converted to "
          f"yuv420p by the decoder")


def open_decoder(path: str) -> subprocess.Popen:
    """ffmpeg child decoding `path` to yuv420p rawvideo on stdout."""
    ff = ffmpeg_path()
    if not ff:
        raise RuntimeError("No ffmpeg binary available for decoding")
    return subprocess.Popen(
        [ff, "-v", "error", "-i", path, "-f", "rawvideo",
         "-pix_fmt", "yuv420p", "-"],
        stdout=subprocess.PIPE)


def open_encoder(output_path: str, width: int, height: int, fps: float,
                 encode_options: str, source_path: str) -> subprocess.Popen:
    """ffmpeg child encoding raw yuv420p from stdin.

    Command mirrors the reference (``main.cpp:287-289``): stream 0 is the
    raw watermarked video on stdin, stream 1 the original file contributing
    audio/subtitles unchanged.
    """
    ff = ffmpeg_path()
    if not ff:
        raise RuntimeError("No ffmpeg binary available for encoding")
    cmd = ([ff, "-y", "-f", "rawvideo", "-pix_fmt", "yuv420p",
            "-s", f"{width}x{height}", "-r", f"{fps:.3f}", "-i", "-",
            "-i", source_path]
           + shlex.split(encode_options)
           + ["-c:s", "copy", "-c:a", "copy", "-map", "1:s?", "-map", "0:v",
              "-map", "1:a?", "-max_interleave_delta", "0", output_path])
    # echo the assembled command like the reference (main.cpp:290)
    print(f"\nFFmpeg encode command: {shlex.join(cmd)}\n")
    return subprocess.Popen(cmd, stdin=subprocess.PIPE)
