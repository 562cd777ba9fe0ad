"""Native (C) host components, loaded through ctypes: the QOI codec, the
PNG decoder's unfilter and the lightmap bake's UV rasterizer.

The QOI codec (`qoi.c`) is the port's own copy of
`raytracing_c_tpu/native/qoi.c`; the unfilter (`png.c`) undoes a PNG's
row filters for `io/image_io.py:decode_png`; the rasterizer (`raster.c`)
makes the texel records of `render/lightmap.py:_rasterize`. Each source
is compiled with the system C compiler (`cc`, else `gcc`, else `clang`) at
first use into `raytracing_c_tpu_torch/_build/<stem>-<hash>/lib<stem>.so`,
the hash covering the source and the flags; `-ffp-contract=off` keeps the
rasterizer's float64 arithmetic in its plain version's order. There is no
quiet fallback: if no compiler builds it, `qoi_native()`, `png_native()`
or `raster_native()` raises with the compilers' messages; the pure-Python
codec and `_unfilter` in `io/image_io.py` and `_rasterize_plain` in
`render/lightmap.py` are the plain versions the tests hold them against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
QOI_SOURCE = _HERE / "qoi.c"
PNG_SOURCE = _HERE / "png.c"
RASTER_SOURCE = _HERE / "raster.c"
BUILD_DIR = _HERE.parent / "_build"
CC_FLAGS = ("-O2", "-ffp-contract=off", "-shared", "-fPIC")
_lock = threading.Lock()
_qoi = None
_png = None
_raster = None


def _build(source: Path) -> Path:
    """Compile the C file `source` unless a build of the same source and
    flags exists. Returns the library's path; raises RuntimeError if no
    compiler builds it."""
    key = hashlib.sha256(" ".join(CC_FLAGS).encode() + b"\0" + source.read_bytes())
    out_dir = BUILD_DIR / f"{source.stem}-{key.hexdigest()[:16]}"
    so = out_dir / f"lib{source.stem}.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{source.stem}.{os.getpid()}.tmp"
    errors = []
    for cc in ("cc", "gcc", "clang"):
        path = shutil.which(cc)
        if path is None:
            errors.append(f"{cc}: not found")
            continue
        cmd = [path, *CC_FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode == 0:
            os.replace(tmp, so)
            return so
        errors.append(f"{' '.join(cmd)} -> {proc.returncode}\n{proc.stdout}{proc.stderr}")
    raise RuntimeError(f"the native library {source.name} did not build:\n"
                       + "\n".join(errors))


class QoiNative:
    """The C codec's encode and decode of (H, W, 3) u8 images."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.qoi_encode_rgb.restype = ctypes.c_long
        lib.qoi_encode_rgb.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_char_p, ctypes.c_long]
        lib.qoi_decode_header.restype = ctypes.c_int
        lib.qoi_decode_header.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                          ctypes.POINTER(ctypes.c_int),
                                          ctypes.POINTER(ctypes.c_int)]
        lib.qoi_decode_rgb.restype = ctypes.c_int
        lib.qoi_decode_rgb.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
                                       ctypes.c_int, ctypes.c_int]

    def encode(self, img: np.ndarray) -> bytes:
        if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
            raise ValueError(f"qoi encode: need (H, W, 3) u8, got {img.shape} {img.dtype}")
        h, w, _ = img.shape
        cap = 14 + w * h * 4 + 8
        out = ctypes.create_string_buffer(cap)
        n = self._lib.qoi_encode_rgb(np.ascontiguousarray(img).tobytes(), w, h, out, cap)
        if n < 0:
            raise RuntimeError("qoi encode failed")
        return out.raw[:n]

    def decode(self, data: bytes) -> np.ndarray:
        w, h = ctypes.c_int(), ctypes.c_int()
        if self._lib.qoi_decode_header(data, len(data), w, h) != 0:
            raise ValueError("not a QOI image")
        # a run byte covers at most 62 pixels: a larger header is not this file's
        if w.value <= 0 or h.value <= 0 or w.value * h.value > 62 * len(data):
            raise ValueError(f"QOI header {w.value}x{h.value} does not fit {len(data)} bytes")
        out = ctypes.create_string_buffer(w.value * h.value * 3)
        if self._lib.qoi_decode_rgb(data, len(data), out, w.value, h.value) != 0:
            raise ValueError("qoi decode failed")
        return np.frombuffer(out.raw, np.uint8).reshape(h.value, w.value, 3)


def qoi_native() -> QoiNative:
    """The native QOI codec, built and loaded at the first call."""
    global _qoi
    with _lock:
        if _qoi is None:
            _qoi = QoiNative(ctypes.CDLL(str(_build(QOI_SOURCE))))
    return _qoi


class PngNative:
    """The C unfilter of a PNG's inflated scanlines."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.png_unfilter.restype = ctypes.c_int
        lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                                     ctypes.c_int, ctypes.c_void_p]

    def unfilter(self, rows: np.ndarray, bpp: int) -> np.ndarray:
        """(H, 1 + stride) u8 scanlines, each a filter type byte and its
        filtered bytes (a view of zlib's output: it is read in place), ->
        the (H, stride) u8 reconstructed bytes of `bpp` (1-4) bytes a
        pixel. Raises ValueError at the first filter type above 4."""
        if rows.dtype != np.uint8 or rows.ndim != 2 or not rows.flags.c_contiguous:
            raise ValueError(f"png unfilter: need C-contiguous (H, 1 + stride) u8 rows, "
                             f"got {rows.shape} {rows.dtype}")
        h, stride = rows.shape[0], rows.shape[1] - 1
        if not 1 <= bpp <= 4 or stride < 0 or stride % bpp:
            raise ValueError(f"png unfilter: {stride} bytes a row do not hold "
                             f"pixels of {bpp} bytes")
        out = np.empty((h, stride), np.uint8)
        kind = self._lib.png_unfilter(rows.ctypes.data, h, stride, bpp, out.ctypes.data)
        if kind:
            raise ValueError(f"PNG filter type {kind} is not defined")
        return out


def png_native() -> PngNative:
    """The native PNG unfilter, built and loaded at the first call."""
    global _png
    with _lock:
        if _png is None:
            _png = PngNative(ctypes.CDLL(str(_build(PNG_SOURCE))))
    return _png


class RasterNative:
    """The C rasterizer of triangles' UV boxes into lightmap texel records."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.raster_count.restype = ctypes.c_long
        lib.raster_count.argtypes = [ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
                                     ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
        lib.raster_fill.restype = ctypes.c_long
        lib.raster_fill.argtypes = [ctypes.c_long] + [ctypes.c_void_p] * 8 + [
            ctypes.c_long, ctypes.c_long] + [ctypes.c_void_p] * 5

    def rasterize(self, uv: np.ndarray, v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                  n0: np.ndarray, n1: np.ndarray, n2: np.ndarray, slots: np.ndarray,
                  width: int, height: int) -> tuple:
        """n triangles, in record order: (n, 3, 2) f32 UVs in [0, 1] units,
        (n, 3) f32 v0, e1, e2 and vertex normals n0, n1, n2, (n,) i64 slots,
        all C-contiguous -> (index (T,) i64, position (T, 3) f32, normal
        (T, 3) f32, slot (T,) i64, candidates, covered, overwritten) over a
        width x height atlas."""
        n = len(slots)
        for name, a, dtype, shape in (
                ("uv", uv, np.float32, (n, 3, 2)), ("v0", v0, np.float32, (n, 3)),
                ("e1", e1, np.float32, (n, 3)), ("e2", e2, np.float32, (n, 3)),
                ("n0", n0, np.float32, (n, 3)), ("n1", n1, np.float32, (n, 3)),
                ("n2", n2, np.float32, (n, 3)), ("slots", slots, np.int64, (n,))):
            if a.dtype != dtype or a.shape != shape or not a.flags.c_contiguous:
                raise ValueError(f"raster: need C-contiguous {shape} {np.dtype(dtype)} {name}, "
                                 f"got {a.shape} {a.dtype}")
        if width < 1 or height < 1:
            raise ValueError(f"raster: need an atlas of at least 1x1 texels, "
                             f"got {width}x{height}")
        candidates = ctypes.c_long()
        t = self._lib.raster_count(n, uv.ctypes.data, width, height, candidates)
        index, slot = np.empty(t, np.int64), np.empty(t, np.int64)
        position, normal = np.empty((t, 3), np.float32), np.empty((t, 3), np.float32)
        counts = np.zeros(2, np.int64)
        got = self._lib.raster_fill(n, *(a.ctypes.data for a in (uv, v0, e1, e2, n0, n1, n2,
                                                                  slots)),
                                    width, height, index.ctypes.data, position.ctypes.data,
                                    normal.ctypes.data, slot.ctypes.data, counts.ctypes.data)
        if got < 0:
            raise MemoryError(f"raster: no memory for the marks of a {width}x{height} atlas")
        if got != t:
            raise RuntimeError(f"raster: the fill pass wrote {got} of {t} records")
        return (index, position, normal, slot, candidates.value, int(counts[0]),
                int(counts[1]))


def raster_native() -> RasterNative:
    """The native lightmap rasterizer, built and loaded at the first call."""
    global _raster
    with _lock:
        if _raster is None:
            _raster = RasterNative(ctypes.CDLL(str(_build(RASTER_SOURCE))))
    return _raster
