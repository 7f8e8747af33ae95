"""The port's host IO against the JAX package's and Pillow's: the PNG codec
(``io/images.py``), the settings.ini parser (``io/config.py``).

Inputs come from numpy seeds at small sizes. The reader is held bit-exact:
to the array a PNG was made from, to Pillow's decode of the same file, and
to the JAX package's loaders (which read through Pillow). Every row filter
is covered by PNGs whose IDAT the test builds by hand with a reference
filter written as a plain loop, so filters 1-4 are exercised whether or not
Pillow is installed; PNGs that Pillow writes (its adaptive filter choice)
are read where Pillow imports.
"""

import dataclasses
import struct
import zlib

import numpy as np
import pytest

from watermarking_gpu_tpu import io as jax_io
from watermarking_gpu_tpu_torch import io as port_io
from watermarking_gpu_tpu_torch.io.images import read_png, write_png

COLOR_TYPES = {0: 1, 2: 3, 4: 2, 6: 4}     # PNG colour type -> channels
PIL_MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def make_image(channels: int, shape=(23, 37), seed=7) -> np.ndarray:
    """A textured uint8 image (gradients make every filter's predictions
    matter; noise makes the sums wrap)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    base = 120 + 90 * np.sin(xx / 5.0) * np.cos(yy / 4.0)
    image = base[..., None] + rng.normal(0, 30, shape + (channels,))
    image = np.clip(image, 0, 255).astype(np.uint8)
    return image[..., 0] if channels == 1 else image


def paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def filter_rows(image: np.ndarray, kinds: list[int]) -> bytes:
    """The PNG row filters, one byte at a time (the encoder's side)."""
    height = image.shape[0]
    bpp = 1 if image.ndim == 2 else image.shape[2]
    rows = image.reshape(height, -1).tolist()
    prior = [0] * len(rows[0])
    out = bytearray()
    for kind, row in zip(kinds, rows):
        out.append(kind)
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            c = prior[i - bpp] if i >= bpp else 0
            b = prior[i]
            predictor = (0, a, b, (a + b) // 2, paeth(a, b, c))[kind]
            out.append((x - predictor) % 256)
        prior = row
    return bytes(out)


def chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def build_png(width: int, height: int, color: int, idat: bytes, depth=8,
              interlace=0, pieces=1) -> bytes:
    header = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0,
                         interlace)
    data = zlib.compress(idat)
    step = -(-len(data) // pieces)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + b"".join(chunk(b"IDAT", data[i:i + step])
                       for i in range(0, len(data), step))
            + chunk(b"IEND", b""))


def pillow_read(path) -> np.ndarray | None:
    """Pillow's decode of ``path``, or None where Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    with Image.open(path) as img:
        return np.asarray(img)


@pytest.mark.parametrize("kinds", ["0", "1", "2", "3", "4", "mixed"])
@pytest.mark.parametrize("color", sorted(COLOR_TYPES))
def test_png_read_every_filter(tmp_path, color, kinds):
    """Colour types 0/2/4/6 x filter types 0-4 (and all five alternating
    row by row, in three IDAT chunks): bit-exact to the source array and to
    Pillow's decode."""
    image = make_image(COLOR_TYPES[color])
    height, width = image.shape[:2]
    row_kinds = ([int(kinds)] * height if kinds != "mixed"
                 else [y % 5 for y in range(height)])
    path = tmp_path / "f.png"
    path.write_bytes(build_png(width, height, color,
                               filter_rows(image, row_kinds),
                               pieces=1 if kinds != "mixed" else 3))
    got = read_png(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, image)
    pillow = pillow_read(path)
    if pillow is not None:
        np.testing.assert_array_equal(got, pillow)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_read_matches_pillow_writes(tmp_path, channels):
    """PNGs Pillow writes (its own filter choice per row), at a width
    where every filter occurs."""
    Image = pytest.importorskip("PIL.Image")
    image = make_image(channels, shape=(40, 97), seed=channels)
    path = tmp_path / "pillow.png"
    Image.fromarray(image, PIL_MODES[channels]).save(path)
    np.testing.assert_array_equal(read_png(path), image)
    np.testing.assert_array_equal(read_png(path), pillow_read(path))


@pytest.mark.parametrize("channels", [1, 3])
def test_png_write(tmp_path, channels):
    """The port writes gray and RGB with filter 0; Pillow reads the array
    back, and so does the port."""
    image = make_image(channels, seed=11)
    path = tmp_path / "w.png"
    write_png(path, image)
    np.testing.assert_array_equal(read_png(path), image)
    pillow = pillow_read(path)
    if pillow is not None:
        np.testing.assert_array_equal(pillow, image)
    raw = zlib.decompress(path.read_bytes()[33 + 8:-12 - 4])
    assert raw[::image[0].size + 1] == bytes(image.shape[0])  # filter 0
    with pytest.raises(ValueError, match="uint8"):
        write_png(path, image.astype(np.float32))
    with pytest.raises(ValueError, match="shape"):
        write_png(path, np.zeros((4, 4, 2), np.uint8))


def test_unsupported_png_raises(tmp_path):
    """16-bit, palette and interlaced PNGs, a bad CRC and a file that is
    not a PNG raise ValueError naming what they are."""
    gray = make_image(1, shape=(4, 6))
    cases = {
        "16-bit": build_png(6, 4, 0, filter_rows(
            np.repeat(gray, 2, axis=1), [0] * 4), depth=16),
        "palette": build_png(6, 4, 3, filter_rows(gray, [0] * 4)),
        "interlaced": build_png(6, 4, 0, filter_rows(gray, [0] * 4),
                                interlace=1),
        "CRC mismatch": build_png(6, 4, 0, filter_rows(gray, [0] * 4))
        .replace(b"IEND\xaeB`\x82", b"IEND\xaeB`\x83"),
        "not a PNG": b"GIF89a" + bytes(40),
    }
    for what, data in cases.items():
        path = tmp_path / "bad.png"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=what):
            read_png(path)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_loaders_match_jax(tmp_path, channels):
    """load_image_rgb / load_image_gray equal the JAX package's (Pillow's
    convert("RGB"): gray replicated, alpha dropped) bit for bit."""
    image = make_image(channels, seed=20 + channels)
    height, width = image.shape[:2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    path = tmp_path / "x.png"
    path.write_bytes(build_png(width, height, color,
                               filter_rows(image, [4] * height)))
    rgb = port_io.load_image_rgb(path)
    assert rgb.dtype == np.float32 and rgb.shape == (height, width, 3)
    np.testing.assert_array_equal(rgb, jax_io.load_image_rgb(path))
    np.testing.assert_array_equal(port_io.load_image_gray(path),
                                  jax_io.load_image_gray(path))


def test_save_image_u8_truncates_as_jax(tmp_path):
    rng = np.random.default_rng(3)
    for shape in ((20, 30), (20, 30, 3)):
        image = rng.uniform(0, 255.99, size=shape).astype(np.float32)
        port_io.save_image_u8(tmp_path / "port.png", image)
        jax_io.save_image_u8(tmp_path / "jax.png", image)
        got = port_io.load_image_rgb(tmp_path / "port.png")
        np.testing.assert_array_equal(
            got, jax_io.load_image_rgb(tmp_path / "jax.png"))
        floor = np.floor(image)
        np.testing.assert_array_equal(
            got, np.broadcast_to(floor[..., None], got.shape)
            if image.ndim == 2 else floor)


def test_add_suffix():
    for path in ("a/b.png", "noext", "x.y/z.png"):
        assert (port_io.add_suffix_before_extension(path, "_W_ME")
                == jax_io.add_suffix_before_extension(path, "_W_ME"))


@pytest.mark.parametrize("text", [
    """
[paths]
image = samples/images/512.png
watermark = samples/w_512.dat
; video = off

[options]
opencl_device = 1
execution_time_in_fps = true
pipelined_timing = false
compilation_cache_dir = /tmp/cache

[parameters]
p = 5
psnr = 37.5
loops_for_test = 7

[parameters_video]
watermark_interval = 15
watermark_detection = true
encode_watermark_file_path = out.mkv
encode_options = -c:v ffv1
embed_batch = 4
detect_batch = 16
raw_video_size = 1920x1080
raw_video_fps = 24
strict_pixel_format = true
""",
    """
[paths]
video = clip.yuv   # inline comment
watermark = w.dat

[parameters]
p = 3
psnr = x
loops_for_test =
""",
    ""])
def test_settings_match_jax(tmp_path, text):
    """One settings.ini parses to the same fields in both packages."""
    path = tmp_path / "settings.ini"
    path.write_text(text)
    got = dataclasses.asdict(port_io.load_settings(path))
    assert got == dataclasses.asdict(jax_io.load_settings(path))
    assert got["source_path"] == str(path)


def test_settings_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        port_io.load_settings(tmp_path / "nope.ini")
