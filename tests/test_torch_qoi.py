"""The port's native QOI codec (raytracing_c_tpu_torch/native) against its
plain version (the pure-Python codec in io/image_io.py) and the JAX
package's native codec; and the build of the native libraries (the QOI
codec and the PNG unfilter, which tests/test_torch_io.py checks).

Tolerance: none. Encoded bytes are compared whole, decoded pixels exactly.
"""

import hashlib

import numpy as np
import pytest

from raytracing_c_tpu.io import image_io as jio
from raytracing_c_tpu.native import qoi_native as jax_qoi_native
from raytracing_c_tpu_torch import native
from raytracing_c_tpu_torch.io import image_io as tio


def _images():
    rng = np.random.default_rng(8)
    noise = rng.integers(0, 256, (31, 47, 3), dtype=np.uint8)
    runs = np.repeat(rng.integers(0, 4, (20, 9, 1), dtype=np.uint8) * 60, 3, axis=2)
    runs = np.repeat(runs, 17, axis=1)  # runs longer than 62 pixels
    smooth = np.clip(np.cumsum(rng.integers(-2, 3, (24, 64, 3)), axis=1) + 128, 0,
                     255).astype(np.uint8)  # DIFF and LUMA ops
    palette = rng.integers(0, 256, (5, 3), dtype=np.uint8)[rng.integers(0, 5, (16, 16))]
    return {"noise": noise, "runs": runs, "smooth": smooth, "palette": palette,
            "one_pixel": noise[:1, :1], "one_row": noise[:1], "one_column": noise[:, :1]}


IMAGES = _images()


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_native_equals_plain_and_jax_native(name):
    img = IMAGES[name]
    data = tio.qoi_encode(img)
    assert data == tio.qoi_encode_plain(img)
    jax_codec = jax_qoi_native()
    assert jax_codec is not None
    assert data == jax_codec.encode(img)
    assert data == jio._qoi_encode_py(img)
    np.testing.assert_array_equal(tio.qoi_decode(data), img)
    np.testing.assert_array_equal(tio.qoi_decode_plain(data), img)
    np.testing.assert_array_equal(jax_codec.decode(data), img)


def test_write_qoi_goes_through_the_native_codec(tmp_path, monkeypatch):
    img = IMAGES["smooth"]
    calls = []
    codec = native.qoi_native()
    monkeypatch.setattr(native, "qoi_native", lambda: calls.append(1) or codec)
    tio.write_image(str(tmp_path / "a.qoi"), img)
    assert calls and tio.qoi_decode_plain((tmp_path / "a.qoi").read_bytes()).shape == img.shape


@pytest.mark.parametrize("bad", [np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8),
                                 np.zeros((4, 4, 3), np.float32)])
def test_encode_rejects_other_images(bad):
    with pytest.raises(ValueError):
        tio.qoi_encode(bad)


def test_decode_rejects_other_bytes():
    with pytest.raises(ValueError):
        tio.qoi_decode(b"\x89PNG\r\n\x1a\n" + bytes(20))
    data = bytearray(tio.qoi_encode(IMAGES["noise"]))
    data[4:12] = (1 << 20).to_bytes(4, "big") * 2  # a header far larger than its bytes
    with pytest.raises(ValueError, match="does not fit"):
        tio.qoi_decode(bytes(data))


def test_built_into_the_package_build_dir():
    native.qoi_native()
    built = list(native.BUILD_DIR.glob("qoi-*/libqoi.so"))
    assert built and all(p.stat().st_size > 0 for p in built)


@pytest.mark.parametrize("source", [native.QOI_SOURCE, native.PNG_SOURCE], ids=["qoi", "png"])
def test_build_keyed_by_source_and_flags(source, monkeypatch):
    """Each library builds into _build/<stem>-<hash of its flags and
    source>/, and a second build of the same source reuses it."""
    key = hashlib.sha256(" ".join(native.CC_FLAGS).encode() + b"\0" + source.read_bytes())
    so = native._build(source)
    assert so == native.BUILD_DIR / f"{source.stem}-{key.hexdigest()[:16]}" / f"lib{source.stem}.so"
    built = so.stat().st_mtime_ns
    monkeypatch.setattr(native.subprocess, "run", lambda *a, **k: pytest.fail("compiled again"))
    assert native._build(source) == so and so.stat().st_mtime_ns == built


def test_no_quiet_fallback(tmp_path, monkeypatch):
    """A source the compiler refuses raises with the compiler's message,
    and so does a machine without a C compiler."""
    bad = tmp_path / "qoi.c"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="did not build") as e:
        native._build(bad)
    assert "error" in str(e.value)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="cc: not found"):
        native._build(bad)
