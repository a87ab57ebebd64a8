"""Image decoding for texture import without PIL.

The JAX package decodes image files with PIL (``im.convert("RGB")``), the
reference with its vendored stb_image. ``AtlasBuilder.load_image`` takes
PIL where it can be imported, so both packages decode a file alike; where
it cannot, this decoder reads the formats a scene can carry without it:

* PNG, 8 bits per sample, not interlaced, colour types 0 (grey), 2 (RGB),
  3 (palette), 4 (grey + alpha) and 6 (RGBA), every row filter; the IDAT
  stream inflates with ``zlib`` and the rows unfilter in the native
  library (runtime/native/pngfilter.cpp), or in Python without it;
* binary PPM (P6) with a maximum value of 255.

Alpha is dropped and grey is replicated, as PIL's conversion to RGB does.
Anything else (JPEG, 16-bit or sub-byte samples, interlaced PNG) raises
``UnsupportedImageError`` naming the file and its format.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: samples per pixel of each PNG colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class UnsupportedImageError(ValueError):
    """An image file this decoder does not read."""


def sniff_format(head: bytes) -> str:
    """The format an image file's first bytes announce."""
    if head.startswith(PNG_SIGNATURE):
        return "PNG"
    if head[:2] == b"P6":
        return "PPM (P6)"
    if head[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if head[:2] in (b"P1", b"P2", b"P3", b"P4", b"P5"):
        return f"PNM ({head[:2].decode()})"
    return "unknown"


def decode_image(path: str | Path) -> np.ndarray:
    """Decode ``path`` to an [H, W, 3] uint8 RGB image."""
    path = Path(path)
    data = path.read_bytes()
    fmt = sniff_format(data[:8])
    if fmt == "PNG":
        return _decode_png(data, path)
    if fmt == "PPM (P6)":
        return _decode_ppm(data, path)
    raise UnsupportedImageError(f"{path}: {fmt} images are not supported without PIL")


def _decode_png(data: bytes, path: Path) -> np.ndarray:
    pos = len(PNG_SIGNATURE)
    header = None
    palette = None
    idat = []
    while pos + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {tag!r}")
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise UnsupportedImageError(
            f"{path}: PNG with bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace} is not supported without PIL (8-bit, non-interlaced, "
            "colour types 0, 2, 3, 4 and 6 are)"
        )
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    bpp = _CHANNELS[ctype]
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    rows = unfilter(np.frombuffer(raw, np.uint8)[: height * (stride + 1)], height,
                    stride, bpp, path)
    px = rows.reshape(height, width, bpp)
    if ctype == 3:
        if int(px.max(initial=0)) >= palette.shape[0]:
            raise ValueError(f"{path}: palette index past the PLTE entries")
        return palette[px[..., 0]]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def unfilter(raw: np.ndarray, height: int, stride: int, bpp: int, path="image"):
    """Undo the PNG row filters of ``height`` rows of ``1 + stride`` bytes
    → [height * stride] uint8. Native where the library is built."""
    from clraytracer_tpu_torch.runtime.build import native_lib

    out = np.empty(height * stride, np.uint8)
    lib = native_lib()
    if lib is not None:
        src = np.ascontiguousarray(raw, np.uint8)
        u8 = ctypes.POINTER(ctypes.c_ubyte)
        rc = lib.clrt_png_unfilter(
            src.ctypes.data_as(u8), height, stride, bpp, out.ctypes.data_as(u8)
        )
        if rc != 0:
            raise ValueError(f"{path}: PNG row {-rc - 1} has an unknown filter type")
        return out
    return _unfilter_py(raw, height, stride, bpp, path)


def _unfilter_py(raw: np.ndarray, height: int, stride: int, bpp: int, path="image"):
    """Python version of ``clrt_png_unfilter`` (runtime/native/pngfilter.cpp)."""
    lines = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ft, cur = int(lines[y, 0]), lines[y, 1:]
        if ft == 0:
            row = cur.copy()
        elif ft == 1:
            # Sub: a running sum per byte lane of the pixel (wraps mod 256)
            row = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ft == 2:
            row = cur + prior
        elif ft in (3, 4):
            row = bytearray(stride)
            b_row = prior.tolist()
            for i, x in enumerate(cur.tolist()):
                a = row[i - bpp] if i >= bpp else 0
                b = b_row[i]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = b_row[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                row[i] = (x + pred) & 0xFF
            row = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"{path}: PNG row {y} has an unknown filter type")
        out[y] = row
        prior = out[y]
    return out.reshape(-1)


def _decode_ppm(data: bytes, path: Path) -> np.ndarray:
    """Binary PPM: ``P6``, width, height and maxval as whitespace-separated
    ASCII (``#`` comments allowed), one whitespace byte, then the samples."""
    fields = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            pos = data.find(b"\n", pos)
            if pos < 0:
                break
            continue
        start = pos
        while pos < len(data) and data[pos : pos + 1].isdigit():
            pos += 1
        if start == pos:
            raise ValueError(f"{path}: malformed PPM header")
        fields.append(int(data[start:pos]))
    if len(fields) < 3:
        raise ValueError(f"{path}: malformed PPM header")
    width, height, maxval = fields
    if maxval != 255:
        raise UnsupportedImageError(
            f"{path}: PPM with maximum value {maxval} is not supported without PIL "
            "(255 is)"
        )
    pos += 1  # the single whitespace byte after maxval
    n = width * height * 3
    if len(data) < pos + n:
        raise ValueError(f"{path}: PPM image data is truncated")
    return np.frombuffer(data, np.uint8, n, pos).reshape(height, width, 3).copy()
