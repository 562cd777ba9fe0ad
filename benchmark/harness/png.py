"""The benchmark's own PNG codec (8-bit RGB), on zlib and numpy.

The encoder is a frozen copy of `raytracing_c_tpu_torch/io/image_io.py`'s
`encode_png` at commit f272015 (a filter chosen per row by the least sum of
absolute filtered bytes, as libpng and Pillow choose, zlib level 6), so
that the inputs the benchmark writes are PNGs as image tools write them.
The decoder reads what any encoder writes of colour type 2 or 6 (filters
0-4, not interlaced); the benchmark decodes the program's output with it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_ROWS_PER_PASS = 256


def _filter_rows(x: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    up = np.concatenate([prior[None], x[:-1]])
    left = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
    ul = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    a, b, c = left.astype(np.int16), up.astype(np.int16), ul.astype(np.int16)
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    avg = (left >> 1) + (up >> 1) + (left & up & 1)
    cand = np.stack([x, x - left, x - up, x - avg, x - paeth])
    score = np.abs(cand.view(np.int8).astype(np.int16)).sum(axis=2, dtype=np.int32)
    kind = score.argmin(axis=0)
    return np.concatenate([kind.astype(np.uint8)[:, None], cand[kind, np.arange(len(x))]], 1)


def encode(img: np.ndarray) -> bytes:
    """(H, W, 3) u8 -> PNG bytes."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"png.encode: need (H, W, 3) u8, got {img.shape}")
    flat = img.reshape(h, w * 3)
    z = zlib.compressobj(6)
    idat = []
    for y in range(0, h, _ROWS_PER_PASS):
        prior = flat[y - 1] if y else np.zeros(w * 3, np.uint8)
        idat.append(z.compress(_filter_rows(flat[y:y + _ROWS_PER_PASS], prior, 3).tobytes()))
    idat.append(z.flush())

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", b"".join(idat)) + chunk(b"IEND", b"")


def decode(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit RGB or RGBA, not interlaced) -> (H, W, 3) u8."""
    if data[:8] != SIGNATURE:
        raise ValueError("png.decode: not a PNG")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", ihdr)
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(f"png.decode: depth {depth}, colour type {ctype}, interlace "
                         f"{interlace} is not read here")
    bpp = 3 if ctype == 2 else 4
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)[:h * (stride + 1)]
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, f = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = f.copy()
        elif kind == 1:
            cur = (np.cumsum(f.reshape(w, bpp).astype(np.int64), axis=0) % 256
                   ).astype(np.uint8).reshape(-1)
        elif kind == 2:
            cur = f + prior
        elif kind in (3, 4):
            cur = _unfilter_sequential(kind, f.tolist(), prior.tolist(), bpp)
        else:
            raise ValueError(f"png.decode: filter type {kind}")
        out[y] = cur
        prior = out[y]
    return np.ascontiguousarray(out.reshape(h, w, bpp)[..., :3])


def _unfilter_sequential(kind: int, f: list, up: list, bpp: int) -> np.ndarray:
    """Average (3) or Paeth (4) on one row, byte by byte."""
    cur = [0] * len(f)
    for i, v in enumerate(f):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            cur[i] = (v + ((a + b) >> 1)) & 255
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (v + pred) & 255
    return np.asarray(cur, np.uint8)
