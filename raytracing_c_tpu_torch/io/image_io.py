"""Image decode/encode.

Counterpart of `raytracing_c_tpu/io/image_io.py`, without PIL: PNG is
decoded and encoded here on zlib + numpy (8-bit colour types 0/2/3/4/6,
non-interlaced, filters 0-4, alpha dropped), so a model's textures and the
environment map load where Pillow is absent. Other formats (JPEG) decode
through Pillow only where it imports. Encoders PNG/QOI/PPM are picked by
the output suffix (driver.c:839-874). QOI goes through the native C codec
(`raytracing_c_tpu_torch/native`, built with the system C compiler at first
use; it raises if none builds it); `qoi_encode_plain`/`qoi_decode_plain`,
the JAX package's pure-Python codec, are its plain version.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from raytracing_c_tpu_torch.utils import spans

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: PNG colour type -> samples per pixel (grey, RGB, palette, grey+alpha, RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


# ---------------------------------------------------------------------------
# Decoders
# ---------------------------------------------------------------------------


def load_image_rgb_u8(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) u8. Raises OSError when the file
    cannot be read and ValueError when it cannot be decoded."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_image_rgb_u8(data, name=path)


def decode_image_rgb_u8(data: bytes, name: str = "<image bytes>") -> np.ndarray:
    """Decode an in-memory image (glTF bufferView images) to (H, W, 3) u8,
    inside a `decode` span."""
    with spans.span("decode"):
        if data[:8] == _PNG_SIGNATURE:
            return decode_png(data, name)
        try:
            import io

            from PIL import Image
        except ImportError:
            what = "JPEG" if data[:2] == b"\xff\xd8" else "a non-PNG image"
            raise ValueError(f"{what} needs Pillow: {name}") from None
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"), np.uint8)


def png_scanlines(data: bytes, name: str = "<png bytes>"):
    """Parse an 8-bit, non-interlaced PNG down to its filtered scanlines.
    Returns (width, height, colour type, palette bytes or None, filter type
    per row (H,) u8, filtered rows (H, W * samples) u8)."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"not a PNG file: {name}")
    pos, ihdr, plte, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = body
        elif tag == b"PLTE":
            plte = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None or len(ihdr) != 13:
        raise ValueError(f"PNG without a valid IHDR: {name}")
    w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(">IIBBBBB", ihdr)
    if depth != 8:
        raise ValueError(f"{depth}-bit PNG is not supported (8-bit only): {name}")
    if interlace:
        raise ValueError(f"interlaced PNG is not supported: {name}")
    if ctype not in _PNG_CHANNELS or (ctype == 3 and plte is None):
        raise ValueError(f"PNG colour type {ctype} is not supported: {name}")
    stride = w * _PNG_CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data ({e}): {name}") from e
    if len(raw) < h * (stride + 1):
        raise ValueError(f"truncated PNG data: {name}")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    ftypes = rows[:, 0]
    if h and int(ftypes.max()) > 4:
        raise ValueError(f"PNG filter type {int(ftypes.max())} is not defined: {name}")
    return w, h, ctype, plte, ftypes, rows[:, 1:]


def decode_png(data: bytes, name: str = "<png bytes>") -> np.ndarray:
    """8-bit, non-interlaced PNG -> (H, W, 3) u8 (grey replicated, palette
    looked up, alpha dropped)."""
    w, h, ctype, plte, ftypes, filtered = png_scanlines(data, name)
    ch = _PNG_CHANNELS[ctype]
    px = _unfilter(ftypes, filtered.reshape(h, w, ch))
    if ctype == 3:
        palette = np.frombuffer(plte, np.uint8, len(plte) // 3 * 3).reshape(-1, 3)
        if px.size and int(px.max()) >= len(palette):
            raise ValueError(f"PNG palette index out of range: {name}")
        return palette[px[..., 0]]
    if ch <= 2:
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _unfilter(ftypes: np.ndarray, filtered: np.ndarray) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth) of
    (H, W, samples) u8 scanlines.

    A pixel's filter reads its reconstructed left, upper and upper-left
    neighbours, so rows cannot run in parallel and a row's Average or Paeth
    pixels cannot either; but every pixel on one anti-diagonal x + y = s
    depends only on the diagonals s - 1 and s - 2. The pixels are laid out
    skewed, diagonal by diagonal (row s of `rec` holds diagonal s - 2 by
    y + 1, row 0 of each is the zero row above the image), and each
    diagonal is one vectorised step: W + H - 1 steps for the image."""
    h, w, ch = filtered.shape
    if (ftypes <= 2).all():  # None / Sub / Up only: whole rows at a time
        out = np.empty_like(filtered)
        prior = np.zeros((w, ch), np.uint8)
        for y in range(h):
            line = filtered[y]
            if ftypes[y] == 1:
                line = np.cumsum(line, axis=0, dtype=np.uint8)
            elif ftypes[y] == 2:
                line = line + prior
            out[y] = prior = line
        return out
    diag = np.zeros((w + h - 1, h, ch), np.int16)
    for y in range(h):
        diag[y:y + w, y] = filtered[y]
    rec = np.zeros((w + h + 1, h + 1, ch), np.int16)
    sub, up, avg, paeth = (np.repeat(ftypes[:, None] == k, ch, axis=1) for k in (1, 2, 3, 4))
    sub, up, avg = (m.astype(np.int16) for m in (sub, up, avg))
    for s in range(w + h - 1):
        y0, y1 = max(0, s - w + 1), min(h, s + 1)
        a = rec[s + 1, y0 + 1:y1 + 1]  # left
        b = rec[s + 1, y0:y1]  # up
        c = rec[s, y0:y1]  # upper left
        pred = a * sub[y0:y1] + b * up[y0:y1]
        if avg[y0:y1].any():
            pred += ((a + b) >> 1) * avg[y0:y1]
        if paeth[y0:y1].any():
            pa, pb = np.abs(b - c), np.abs(a - c)
            pc = np.abs(a + b - 2 * c)
            pred = np.where(paeth[y0:y1], np.where((pa <= pb) & (pa <= pc), a,
                                                   np.where(pb <= pc, b, c)), pred)
        np.bitwise_and(diag[s, y0:y1] + pred, 255, out=rec[s + 2, y0 + 1:y1 + 1])
    out = np.empty_like(filtered)
    for y in range(h):
        out[y] = rec[y + 2:y + 2 + w, y + 1]
    return out


# ---------------------------------------------------------------------------
# Encoders
# ---------------------------------------------------------------------------

#: rows filtered per pass of the encoder (bounds its temporaries)
_PNG_ROWS_PER_PASS = 256


def _filter_rows(x: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """PNG-filter (n, stride) u8 rows x whose row above the first is `prior`:
    each row takes the filter whose output has the least sum of absolute
    values as signed bytes (libpng's and Pillow's heuristic). Returns
    (n, stride + 1) u8 with the filter type first."""
    up = np.concatenate([prior[None], x[:-1]])
    left = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
    ul = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    a, b, c = left.astype(np.int16), up.astype(np.int16), ul.astype(np.int16)
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    avg = (left >> 1) + (up >> 1) + (left & up & 1)  # (left + up) >> 1 in 8 bits
    cand = np.stack([x, x - left, x - up, x - avg, x - paeth])  # u8, wrapping as PNG does
    score = np.abs(cand.view(np.int8).astype(np.int16)).sum(axis=2, dtype=np.int32)  # (5, n)
    kind = score.argmin(axis=0)
    return np.concatenate([kind.astype(np.uint8)[:, None], cand[kind, np.arange(len(x))]], 1)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) u8 -> PNG bytes (colour type 2, a filter chosen per row,
    zlib level 6)."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"encode_png: need (H, W, 3) u8, got {img.shape}")
    flat = img.reshape(h, w * 3)
    z = zlib.compressobj(6)
    idat = []
    for y in range(0, h, _PNG_ROWS_PER_PASS):
        prior = flat[y - 1] if y else np.zeros(w * 3, np.uint8)
        idat.append(z.compress(_filter_rows(flat[y:y + _PNG_ROWS_PER_PASS], prior, 3).tobytes()))
    idat.append(z.flush())

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", b"".join(idat))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def write_ppm(path: str, img: np.ndarray) -> None:
    """Binary P6 PPM."""
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(img).tobytes())


def write_qoi(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(qoi_encode(img))


def write_image(path: str, img: np.ndarray, warn=print) -> None:
    """Format dispatch by suffix with the reference's default-to-PNG warning
    (driver.c:839-851), inside a `write` span."""
    with spans.span("write"):
        ext = os.path.splitext(path)[1].lower()
        if ext == ".png":
            write_png(path, img)
        elif ext == ".qoi":
            write_qoi(path, img)
        elif ext == ".ppm":
            write_ppm(path, img)
        else:
            warn(
                f"output format not recognized for output path '{path}', "
                "defaulting to png"
            )
            write_png(path, img)


# ---------------------------------------------------------------------------
# QOI (spec: qoiformat.org): the native codec, and the JAX package's
# pure-Python codec as its plain version
# ---------------------------------------------------------------------------

_QOI_OP_INDEX = 0x00
_QOI_OP_DIFF = 0x40
_QOI_OP_LUMA = 0x80
_QOI_OP_RUN = 0xC0
_QOI_OP_RGB = 0xFE
_QOI_OP_RGBA = 0xFF


def qoi_encode(img: np.ndarray) -> bytes:
    """QOI bytes of an (H, W, 3) u8 image, from the native codec."""
    from raytracing_c_tpu_torch.native import qoi_native

    return qoi_native().encode(img)


def qoi_decode(data: bytes) -> np.ndarray:
    """(H, W, 3) u8 image of QOI bytes, from the native codec."""
    from raytracing_c_tpu_torch.native import qoi_native

    return qoi_native().decode(data)


def qoi_encode_plain(img: np.ndarray) -> bytes:
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"qoi_encode: need (H, W, 3) u8, got {img.shape}")
    out = bytearray()
    out += b"qoif"
    out += w.to_bytes(4, "big") + h.to_bytes(4, "big")
    out += bytes([3, 0])  # channels, colorspace=sRGB

    index = [(0, 0, 0, 0)] * 64
    prev = (0, 0, 0, 255)
    run = 0
    flat = img.reshape(-1, 3)
    for px in flat:
        cur = (int(px[0]), int(px[1]), int(px[2]), 255)
        if cur == prev:
            run += 1
            if run == 62:
                out.append(_QOI_OP_RUN | (run - 1))
                run = 0
            continue
        if run:
            out.append(_QOI_OP_RUN | (run - 1))
            run = 0
        hidx = (cur[0] * 3 + cur[1] * 5 + cur[2] * 7 + cur[3] * 11) % 64
        if index[hidx] == cur:
            out.append(_QOI_OP_INDEX | hidx)
        else:
            index[hidx] = cur
            dr = (cur[0] - prev[0]) & 0xFF
            dg = (cur[1] - prev[1]) & 0xFF
            db = (cur[2] - prev[2]) & 0xFF
            dr = dr - 256 if dr > 127 else dr
            dg = dg - 256 if dg > 127 else dg
            db = db - 256 if db > 127 else db
            if -2 <= dr <= 1 and -2 <= dg <= 1 and -2 <= db <= 1:
                out.append(
                    _QOI_OP_DIFF | ((dr + 2) << 4) | ((dg + 2) << 2) | (db + 2)
                )
            else:
                dr_dg = dr - dg
                db_dg = db - dg
                if -32 <= dg <= 31 and -8 <= dr_dg <= 7 and -8 <= db_dg <= 7:
                    out.append(_QOI_OP_LUMA | (dg + 32))
                    out.append(((dr_dg + 8) << 4) | (db_dg + 8))
                else:
                    out.append(_QOI_OP_RGB)
                    out += bytes(cur[:3])
        prev = cur
    if run:
        out.append(_QOI_OP_RUN | (run - 1))
    out += b"\x00" * 7 + b"\x01"
    return bytes(out)


def qoi_decode_plain(data: bytes) -> np.ndarray:
    if data[:4] != b"qoif":
        raise ValueError("not a QOI image")
    w = int.from_bytes(data[4:8], "big")
    h = int.from_bytes(data[8:12], "big")
    pos = 14
    out = np.zeros((w * h, 3), np.uint8)
    index = [(0, 0, 0, 0)] * 64
    px = (0, 0, 0, 255)
    i = 0
    while i < w * h:
        b0 = data[pos]
        pos += 1
        if b0 == _QOI_OP_RGB:
            px = (data[pos], data[pos + 1], data[pos + 2], px[3])
            pos += 3
        elif b0 == _QOI_OP_RGBA:
            px = tuple(data[pos : pos + 4])
            pos += 4
        elif (b0 & 0xC0) == _QOI_OP_INDEX:
            px = index[b0 & 0x3F]
        elif (b0 & 0xC0) == _QOI_OP_DIFF:
            dr = ((b0 >> 4) & 3) - 2
            dg = ((b0 >> 2) & 3) - 2
            db = (b0 & 3) - 2
            px = ((px[0] + dr) & 255, (px[1] + dg) & 255, (px[2] + db) & 255, px[3])
        elif (b0 & 0xC0) == _QOI_OP_LUMA:
            dg = (b0 & 0x3F) - 32
            b1 = data[pos]
            pos += 1
            dr = dg + ((b1 >> 4) & 0xF) - 8
            db = dg + (b1 & 0xF) - 8
            px = ((px[0] + dr) & 255, (px[1] + dg) & 255, (px[2] + db) & 255, px[3])
        elif (b0 & 0xC0) == _QOI_OP_RUN:
            run = (b0 & 0x3F) + 1
            out[i : i + run] = px[:3]
            i += run
            continue
        hidx = (px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64
        index[hidx] = px
        out[i] = px[:3]
        i += 1
    return out.reshape(h, w, 3)
