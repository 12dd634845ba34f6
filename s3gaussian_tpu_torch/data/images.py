"""Image files for the scene readers (counterpart of the PIL calls in the
JAX package's readers).

A file is decoded by its content, as ``PIL.Image.open`` does, whatever its
name says.  An 8-bit, non-interlaced grayscale, gray+alpha, RGB or RGBA
PNG is decoded here with numpy and the standard library's ``zlib`` (every
one of the five row filters); every other file (JPEG, palette or 16-bit
PNG, ...) goes through PIL.  A resize, needed only when the stored size
differs from the load size, goes through PIL's ``BILINEAR`` (images) or
``NEAREST`` (masks), as the JAX readers do.  Where PIL is needed and
missing, the call raises ``ImportError`` naming the file.  A file always
takes the same path, so it decodes the same way on every machine.

``write_png`` writes the PNGs the decoder reads (every row "Up"-filtered).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> (channels, PIL mode) of the 8-bit types decoded here
_COLOR_TYPES = {0: (1, "L"), 4: (2, "LA"), 2: (3, "RGB"), 6: (4, "RGBA")}


def _pil(path: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: reading this file needs Pillow, which is "
                          f"not installed") from e
    return Image


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _png_header(data: bytes):
    """(width, height, channels, mode) of a PNG this module decodes, else
    None."""
    if not data.startswith(PNG_SIGNATURE):
        return None
    kind, ihdr = next(_chunks(data))
    if kind != b"IHDR":
        return None
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if depth != 8 or interlace != 0 or ctype not in _COLOR_TYPES:
        return None
    return (w, h) + _COLOR_TYPES[ctype]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters of [H, W, C] filtered bytes."""
    h, w, c = raw.shape
    if filters.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(filters.max())} is not valid")
    if (filters <= 2).all():
        # None, Sub and Up: whole rows at once (uint8 arithmetic wraps)
        out = np.empty_like(raw)
        prev = np.zeros((w, c), np.uint8)
        for r in range(h):
            x = raw[r]
            if filters[r] == 1:
                x = np.cumsum(x, axis=0, dtype=np.uint8)
            elif filters[r] == 2:
                x = x + prev
            out[r] = x
            prev = out[r]
        return out
    # Average and Paeth predict from the pixel on the left, so a row is
    # sequential; pixel (r, i) needs only pixels of smaller r + i, so the
    # decode runs along anti-diagonals, every row's filter at once
    out = np.zeros((h + 1, w + 1, c), np.int32)   # row 0 / column 0 = 0
    src = raw.astype(np.int32)
    f = filters.astype(np.int32)
    for t in range(h + w - 1):
        r = np.arange(max(0, t - w + 1), min(h, t + 1))
        i = t - r
        a, b, cc = out[r + 1, i], out[r, i + 1], out[r, i]
        fr = f[r][:, None]
        pred = np.select([fr == 1, fr == 2, fr == 3, fr == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, cc)], 0)
        out[r + 1, i + 1] = (src[r, i] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit non-interlaced PNG -> uint8 [H, W] (gray) or [H, W, C]."""
    head = _png_header(data)
    if head is None:
        raise ValueError("not an 8-bit non-interlaced gray/RGB(A) PNG")
    w, h, c, _ = head
    idat = b"".join(body for kind, body in _chunks(data) if kind == b"IDAT")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8)
    rows = rows[:h * (1 + w * c)].reshape(h, 1 + w * c)
    out = _unfilter(rows[:, 1:].reshape(h, w, c), rows[:, 0])
    return out[..., 0] if c == 1 else out


def read_image(path: str):
    """(uint8 array, PIL mode) of a file this module decodes, else
    (None, PIL image)."""
    with open(path, "rb") as f:
        data = f.read()
    head = _png_header(data)
    if head is not None:
        return decode_png(data), head[3]
    return None, _pil(path).open(path)


def _to_rgb(arr: np.ndarray, mode: str) -> np.ndarray:
    """PIL's ``convert("RGB")`` of an L/LA/RGB/RGBA array."""
    if mode in ("L", "LA"):
        gray = arr if mode == "L" else arr[..., 0]
        return np.repeat(gray[..., None], 3, axis=-1)
    return arr[..., :3]


def _to_rgba(arr: np.ndarray, mode: str) -> np.ndarray:
    """PIL's ``convert("RGBA")`` of an L/LA/RGB/RGBA array."""
    if mode == "RGBA":
        return arr
    if mode == "LA":
        return np.concatenate([_to_rgb(arr, mode), arr[..., 1:]], -1)
    opaque = np.full(arr.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([_to_rgb(arr, mode), opaque], -1)


def _resize(path: str, arr: np.ndarray, size_hw: Sequence[int],
            nearest: bool) -> np.ndarray:
    if tuple(arr.shape[:2]) == tuple(size_hw):
        return arr                   # PIL returns a copy at the same size
    Image = _pil(path)
    img = Image.fromarray(arr).resize((size_hw[1], size_hw[0]),
                                      Image.NEAREST if nearest
                                      else Image.BILINEAR)
    return np.asarray(img)


def load_rgb(path: str, size_hw: Optional[Sequence[int]] = None
             ) -> np.ndarray:
    """float32 [H, W, 3] in [0, 1]: ``convert("RGB")``, then a bilinear
    resize to ``size_hw`` (h, w) when given."""
    arr, mode = read_image(path)
    if arr is None:
        arr = np.asarray(mode.convert("RGB"))
    else:
        arr = _to_rgb(arr, mode)
    if size_hw is not None:
        arr = _resize(path, arr, size_hw, nearest=False)
    return np.asarray(arr, dtype=np.float32) / 255.0


def load_rgba(path: str) -> np.ndarray:
    """float32 [H, W, 4] in [0, 1]: ``convert("RGBA")``."""
    arr, mode = read_image(path)
    arr = (np.asarray(mode.convert("RGBA")) if arr is None
           else _to_rgba(arr, mode))
    return np.asarray(arr, dtype=np.float32) / 255.0


def load_channel0(path: str, size_hw: Sequence[int]) -> np.ndarray:
    """The file's first channel as stored (a palette image's indices),
    nearest-resized to ``size_hw``: what the readers' masks are made of."""
    arr, img = read_image(path)
    if arr is None:
        arr = np.asarray(img)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return _resize(path, np.ascontiguousarray(arr), size_hw, nearest=True)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path: str, arr: np.ndarray, level: int = 6) -> None:
    """uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> PNG,
    every row Up-filtered."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    gray = arr.ndim == 2
    c = 1 if gray else arr.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[c]
    h, w = arr.shape[:2]
    rows = arr.reshape(h, w * c)
    up = rows.copy()
    up[1:] -= rows[:-1]                     # wraps mod 256
    body = np.concatenate([np.full((h, 1), 2, np.uint8), up], 1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0,
                                            0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(body.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))
