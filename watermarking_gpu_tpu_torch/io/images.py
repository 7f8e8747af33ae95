"""Image file IO: an 8-bit PNG codec in stdlib ``zlib`` and numpy.

The reference loads PNGs with ``af::loadImage(file, true)`` (float RGB on the
0..255 range, ``Watermark_GPU/main.cpp:153``) and saves watermarked outputs
as u8 with ``af::saveImageNative`` after a plain cast (``main.cpp:235-237``).
The functions here mirror both, as the JAX package's ``io/images.py`` does:
float32 0..255 in, truncating u8 cast out (values are already clamped to
[0, 255] by the embedder).

The codec needs no Pillow, which the GPU machine does not have. It reads
8-bit, non-interlaced PNGs of colour types 0 (gray), 2 (RGB), 4 (gray +
alpha) and 6 (RGBA) with all five row filters, joins multiple IDAT chunks
and checks every chunk's CRC. Any other PNG (16-bit, palette, interlaced)
raises ``ValueError`` naming what it found, where a silent conversion would
hide it. It writes gray or RGB with filter 0.

Unfiltering: None and Up take whole rows, Sub a per-channel cumulative sum
modulo 256. Avg and Paeth depend on the pixel to their left, so they cannot
take a row at once; an image that holds them is unfiltered along
anti-diagonals instead (a pixel needs its left, upper and upper-left
neighbours, all on the two diagonals before its own), vectorised across the
rows and channels of each diagonal: H + W - 1 steps for the whole image.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel, for the types the codec reads
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
COLOR_TYPE_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha",
                    6: "RGBA"}
BT601_WEIGHTS = np.array([0.299, 0.587, 0.114], dtype=np.float32)


def _chunks(data: bytes, path) -> list[tuple[bytes, bytes]]:
    """(type, body) of each chunk up to IEND, every CRC checked."""
    chunks, pos = [], len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: PNG ends without an IEND chunk")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: CRC mismatch in the {kind!r} chunk")
        chunks.append((kind, body))
        pos += 12 + length
        if kind == b"IEND":
            return chunks


def _unfilter_rows(kinds: np.ndarray, filtered: np.ndarray,
                   bpp: int) -> np.ndarray:
    """Rows filtered with None, Sub or Up only, one row at a time."""
    out = np.empty_like(filtered)
    prior = np.zeros(filtered.shape[1], np.uint8)
    for y, kind in enumerate(kinds):
        row = filtered[y]
        if kind == 0:
            out[y] = row
        elif kind == 1:     # Sub: a running sum of each channel, modulo 256
            out[y] = np.cumsum(row.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        else:               # Up
            out[y] = row + prior
        prior = out[y]
    return out


def _unfilter_diagonals(kinds: np.ndarray, filtered: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Any mix of the five filters, one anti-diagonal of pixels at a time."""
    height, stride = filtered.shape
    width = stride // bpp
    samples = filtered.reshape(height, width, bpp).astype(np.int16)
    # recon with a zero row above and a zero column on the left, which are
    # the neighbours the filters see outside the image
    recon = np.zeros((height + 1, width + 1, bpp), np.int16)
    kinds = kinds.astype(np.intp)
    for step in range(height + width - 1):
        ys = np.arange(max(0, step - width + 1), min(height, step + 1))
        xs = step - ys
        left = recon[ys + 1, xs]
        up = recon[ys, xs + 1]
        up_left = recon[ys, xs]
        estimate = left + up - up_left
        d_left = np.abs(estimate - left)
        d_up = np.abs(estimate - up)
        d_up_left = np.abs(estimate - up_left)
        paeth = np.where((d_left <= d_up) & (d_left <= d_up_left), left,
                         np.where(d_up <= d_up_left, up, up_left))
        predictor = np.choose(kinds[ys, None],
                              [np.zeros_like(left), left, up,
                               (left + up) >> 1, paeth])
        recon[ys + 1, xs + 1] = (samples[ys, xs] + predictor) & 255
    return recon[1:, 1:].reshape(height, stride).astype(np.uint8)


def read_png(path: str | os.PathLike) -> np.ndarray:
    """Decode a PNG to uint8 (H, W) for gray, else (H, W, C) with C = 3
    (RGB), 2 (gray + alpha) or 4 (RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(PNG_SIGNATURE)] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    chunks = _chunks(data, path)
    if chunks[0][0] != b"IHDR" or len(chunks[0][1]) != 13:
        raise ValueError(f"{path}: PNG does not start with an IHDR chunk")
    (width, height, depth, color, compression, filter_method,
     interlace) = struct.unpack(">IIBBBBB", chunks[0][1])
    name = COLOR_TYPE_NAMES.get(color, "unknown")
    if color not in CHANNELS:
        raise ValueError(f"{path}: PNG colour type {color} ({name}) is not "
                         f"supported; only 0, 2, 4 and 6 are")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit {name} PNG is not supported; "
                         f"only 8 bits a sample are")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced (method {interlace}) PNG is "
                         f"not supported")
    if compression != 0 or filter_method != 0 or not width or not height:
        raise ValueError(f"{path}: invalid PNG header (compression "
                         f"{compression}, filter method {filter_method}, "
                         f"{width}x{height})")
    bpp = CHANNELS[color]
    stride = width * bpp
    raw = zlib.decompress(b"".join(body for kind, body in chunks
                                   if kind == b"IDAT"))
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: image data holds {len(raw)} bytes, "
                         f"expected {height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    kinds = rows[:, 0]
    if kinds.max() > 4:
        raise ValueError(f"{path}: unknown row filter type {kinds.max()}")
    unfilter = (_unfilter_rows if kinds.max() <= 2
                else _unfilter_diagonals)
    image = unfilter(kinds, rows[:, 1:], bpp)
    return image.reshape(height, width, bpp) if bpp > 1 else image.reshape(
        height, width)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path: str | os.PathLike, image: np.ndarray) -> None:
    """Encode uint8 (H, W) as a gray PNG or (H, W, 3) as RGB, filter 0."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {image.dtype}")
    if image.ndim == 2:
        color = 0
    elif image.ndim == 3 and image.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3), got shape "
                         f"{image.shape}")
    height, width = image.shape[:2]
    rows = np.zeros((height, 1 + image[0].size), np.uint8)   # filter 0
    rows[:, 1:] = image.reshape(height, -1)
    header = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))


def load_image_rgb(path: str | os.PathLike) -> np.ndarray:
    """Load an image as float32 (H, W, 3) on 0..255 (gray replicated,
    alpha dropped)."""
    image = read_png(path)
    if image.ndim == 2:
        image = image[..., None]
    color = image[..., :3] if image.shape[2] >= 3 else image[..., :1]
    return np.broadcast_to(color, image.shape[:2] + (3,)).astype(np.float32)


def load_image_gray(path: str | os.PathLike) -> np.ndarray:
    """Load an image and return BT.601 luma as float32 (H, W) on 0..255."""
    return load_image_rgb(path) @ BT601_WEIGHTS


def save_image_u8(path: str | os.PathLike, image: np.ndarray) -> None:
    """Save a float image (H, W) or (H, W, 3) as 8-bit, truncating cast."""
    write_png(path, np.asarray(image).astype(np.uint8))


def add_suffix_before_extension(path: str, suffix: str) -> str:
    """'img.png', '_W_NVF' -> 'img_W_NVF.png' (Utilities.cpp:7-11)."""
    root, ext = os.path.splitext(path)
    return f"{root}{suffix}{ext}"
