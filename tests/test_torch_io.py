"""The port's image I/O (io/image_io.py) against PIL and the JAX package's
io/image_io.py. Tolerance: none, every decode and encode is exact."""

import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from raytracing_c_tpu.io import image_io as jio
from raytracing_c_tpu_torch.io import image_io as tio
from raytracing_c_tpu_torch.native import png_native
from raytracing_c_tpu_torch.utils import spans


@pytest.fixture
def img(rng):
    # flat runs, noise and a gradient: every QOI op and PNG filter choice
    a = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    a[:10, :20] = [10, 200, 30]
    a[20:, 30:] = a[20:, 30:] // 2 * 2
    a[10:20] = np.linspace(0, 255, 47, dtype=np.uint8)[None, :, None]
    return a


@pytest.mark.parametrize("shape", [(33, 47), (1, 1), (1, 9), (9, 1)])
def test_png_encode_pil_decodes(tmp_path, rng, shape):
    a = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    tio.write_png(p, a)
    with Image.open(p) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), a)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_pil_encoded_png_decodes_like_jax(tmp_path, img, mode):
    """PIL picks a filter per row (None..Paeth) for RGB/RGBA/L/LA."""
    p = str(tmp_path / f"x_{mode}.png")
    im = Image.fromarray(img, "RGB")
    if mode == "RGBA":
        im.putalpha(Image.fromarray(img[..., 1]))
    im.convert(mode).save(p)
    np.testing.assert_array_equal(tio.load_image_rgb_u8(p), jio.load_image_rgb_u8(p))


def _png_with_filters(a: np.ndarray, kinds=None) -> bytes:
    """A PNG of (H, W, samples) u8 (samples 1-4: grey, grey + alpha, RGB,
    RGBA) whose row y uses filter type kinds[y] (default y % 5: None, Sub,
    Up, Average, Paeth), encoded from the unfiltered bytes by the spec."""
    h, w, ch = a.shape
    kinds = [y % 5 for y in range(h)] if kinds is None else kinds
    raw = a.reshape(h, w * ch).astype(np.int32)
    rows = []
    for y in range(h):
        x = raw[y]
        up = raw[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(ch, np.int32), x[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        kind = kinds[y]
        if kind == 0:
            f = x
        elif kind == 1:
            f = x - left
        elif kind == 2:
            f = x - up
        elif kind == 3:
            f = x - (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            f = x - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        rows.append(bytes([kind]) + (f & 255).astype(np.uint8).tobytes())

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_every_png_filter_type(img):
    data = _png_with_filters(img)
    with Image.open(io.BytesIO(data)) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), img)  # the file is valid
    np.testing.assert_array_equal(tio.decode_image_rgb_u8(data), img)


@pytest.mark.parametrize("ch", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (17, 5), (6, 40)])
def test_random_png_filters_decode(rng, ch, shape):
    """Any mix of row filters, and rows of None/Sub/Up only, at every
    sample count."""
    a = rng.integers(0, 256, (*shape, ch), dtype=np.uint8)
    want = np.repeat(a[..., :1], 3, axis=2) if ch <= 2 else a[..., :3]
    for kinds in (rng.integers(0, 5, shape[0]), rng.integers(0, 3, shape[0])):
        data = _png_with_filters(a, list(kinds))
        np.testing.assert_array_equal(tio.decode_png(data), want)


def test_png_encoder_picks_filters_per_row(rng):
    """encode_png filters like a real encoder (a mix of Sub..Paeth rows,
    chosen per row), and Pillow decodes what it writes."""
    y, x = np.mgrid[0:64, 0:96]
    a = np.stack([x * 2, y * 3, x + y], -1).astype(np.uint8)
    a[32:] = rng.integers(0, 256, (32, 96, 3), dtype=np.uint8)
    data = tio.encode_png(a)
    kinds = tio.png_scanlines(data)[4]
    assert len(set(kinds.tolist()) - {0}) >= 2
    with Image.open(io.BytesIO(data)) as im:
        np.testing.assert_array_equal(np.asarray(im), a)
    np.testing.assert_array_equal(tio.decode_png(data), a)


#: the filter types of test_native_unfilter_equals_plain's rows, by type
#: number, then random mixes of all five
UNFILTER_KINDS = ["none", "sub", "up", "average", "paeth", "mixed"]


@pytest.mark.parametrize("kinds", UNFILTER_KINDS)
@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (17, 5), (6, 40), (64, 257)])
@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_native_unfilter_equals_plain(rng, bpp, shape, kinds):
    """The native unfilter (native/png.c) against the plain `_unfilter`,
    byte for byte, on random filtered bytes (any byte, not only what an
    encoder writes): every row one filter type, or random mixes."""
    h, w = shape
    if kinds == "mixed":
        mixes = [rng.integers(0, 5, h) for _ in range(3)]
    else:
        mixes = [np.full(h, UNFILTER_KINDS.index(kinds))]
    for ftypes in mixes:
        rows = rng.integers(0, 256, (h, 1 + w * bpp), dtype=np.uint8)
        rows[:, 0] = ftypes
        want = tio._unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, bpp))
        np.testing.assert_array_equal(png_native().unfilter(rows, bpp),
                                      want.reshape(h, w * bpp))


@pytest.mark.parametrize("rows, bpp", [
    (np.zeros((4, 16), np.uint8)[:, ::2], 3),  # not contiguous
    (np.zeros((4, 16), np.int16), 3),
    (np.zeros((4, 16), np.uint8), 5),
    (np.zeros((4, 16), np.uint8), 2),  # 15 bytes a row, not whole pixels of 2
], ids=["strided", "int16", "bpp5", "partial_pixel"])
def test_native_unfilter_rejects_other_arrays(rows, bpp):
    with pytest.raises(ValueError, match="png unfilter"):
        png_native().unfilter(rows, bpp)


def test_encoded_noise_and_gradient_decode_as_plain(rng):
    """A 256x256 gradient under noise, filtered per row by encode_png:
    decode_png (the native unfilter) equals the plain unfilter and the
    image."""
    y, x = np.mgrid[0:256, 0:256]
    a = np.stack([x, y, (x + y) // 2], -1).astype(np.uint8)
    a += rng.integers(0, 24, a.shape, dtype=np.uint8)
    data = tio.encode_png(a)
    w, h, _, _, ftypes, filtered = tio.png_scanlines(data)
    plain = tio._unfilter(ftypes, filtered.reshape(h, w, 3))
    np.testing.assert_array_equal(plain, a)
    np.testing.assert_array_equal(tio.decode_png(data), plain)


def test_undefined_filter_type_raises(img):
    """A filter type above 4: decode_png raises png_scanlines' ValueError,
    which names the largest type and the file; the native routine on its
    own stops at the first."""
    data = _png_with_filters(img[:4], [0, 7, 9, 1])
    for decode in (tio.decode_png, tio.decode_image_rgb_u8):
        with pytest.raises(ValueError, match="^PNG filter type 9 is not defined: bad.png$"):
            decode(data, name="bad.png")
    rows = np.zeros((4, 1 + 3 * 5), np.uint8)
    rows[:, 0] = [0, 7, 9, 1]
    with pytest.raises(ValueError, match="^PNG filter type 7 is not defined$"):
        png_native().unfilter(rows, 3)


def test_decode_span_notes_the_rows_by_filter_type(img):
    """Under spans, one decode_image_rgb_u8 call records one `decode` span
    that notes the native unfilter and the rows of each filter type."""
    data = _png_with_filters(img)
    spans.enable()
    try:
        tio.decode_image_rgb_u8(data)
        records = spans.collect()
    finally:
        spans.disable()
    (rec,) = [r for r in records if r["name"] == "decode"]
    assert rec["attrs"]["unfilter"] == "native"
    got = [rec["attrs"][f"rows_{k}"] for k in ("none", "sub", "up", "avg", "paeth")]
    assert got == np.bincount(tio.png_scanlines(data)[4], minlength=5).tolist()
    assert sum(got) == img.shape[0] and min(got) > 0


def test_16_bit_png_raises(tmp_path):
    p = str(tmp_path / "deep.png")
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(p)
    with pytest.raises(ValueError, match="16-bit PNG") as e:
        tio.load_image_rgb_u8(p)
    assert p in str(e.value)


def test_interlaced_png_raises(img):
    data = bytearray(tio.encode_png(img))
    data[28] = 1  # IHDR interlace method (8 signature + 8 chunk header + 12)
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with pytest.raises(ValueError, match="interlaced"):
        tio.decode_image_rgb_u8(bytes(data), name="x.png")


def test_jpeg_decodes_like_jax_with_pillow(tmp_path, img):
    p = str(tmp_path / "x.jpg")
    Image.fromarray(img).save(p, quality=90)
    np.testing.assert_array_equal(tio.load_image_rgb_u8(p), jio.load_image_rgb_u8(p))


def test_jpeg_without_pillow_raises(tmp_path, img, monkeypatch):
    p = str(tmp_path / "x.jpg")
    Image.fromarray(img).save(p)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match=f"JPEG needs Pillow: {p}"):
        tio.load_image_rgb_u8(p)


def test_corrupt_png_raises():
    data = tio.encode_png(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError):
        tio.decode_png(data[:40] + b"garbage" + data[47:], name="bad.png")


def test_qoi_bytes_match_jax(img):
    data = tio.qoi_encode(img)
    assert data == jio._qoi_encode_py(img)
    np.testing.assert_array_equal(tio.qoi_decode(data), img)
    np.testing.assert_array_equal(jio._qoi_decode_py(data), img)


def test_ppm_roundtrip(tmp_path, img):
    p = str(tmp_path / "x.ppm")
    tio.write_ppm(p, img)
    with open(p, "rb") as f:
        assert f.readline() == b"P6\n"
        assert tuple(map(int, f.readline().split())) == (47, 33)
        assert f.readline() == b"255\n"
        np.testing.assert_array_equal(np.frombuffer(f.read(), np.uint8).reshape(33, 47, 3), img)


@pytest.mark.parametrize("ext", [".png", ".qoi", ".ppm"])
def test_write_image_dispatch(tmp_path, img, ext):
    p = str(tmp_path / f"x{ext}")
    warnings = []
    tio.write_image(p, img, warn=warnings.append)
    assert not warnings
    with open(p, "rb") as f:
        data = f.read()
    if ext == ".png":
        back = tio.decode_png(data)
    elif ext == ".qoi":
        back = tio.qoi_decode(data)
    else:
        back = np.frombuffer(data[-img.size:], np.uint8).reshape(img.shape)
    np.testing.assert_array_equal(back, img)


def test_unknown_suffix_warns_and_writes_png(tmp_path, img):
    warnings = []
    p = str(tmp_path / "x.bmpish")
    tio.write_image(p, img, warn=warnings.append)
    jwarn = []
    jio.write_image(str(tmp_path / "y.bmpish"), img, warn=jwarn.append)
    assert warnings and "defaulting to png" in warnings[0]
    assert warnings[0].replace("x.bmpish", "y.bmpish") == jwarn[0]
    assert os.path.exists(p)
    np.testing.assert_array_equal(tio.load_image_rgb_u8(p), img)
