"""The port's denoiser (ops/denoise.py, plain version of K3) against the
JAX package's `denoise_u8` and its Pallas kernel in interpret mode, and the
one build of every CUDA source (ops/cuda_build.py).

Tolerance: <= 1 u8, the bound tests/test_denoise_pallas.py uses, because
XLA fixes no order for the 9-luminance sum; flat images and a lone
firefly must come out exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_c_tpu.ops.denoise import denoise_u8 as jax_denoise
from raytracing_c_tpu.ops.denoise_pallas import denoise_u8_pallas
from raytracing_c_tpu_torch.ops import cuda_build
from raytracing_c_tpu_torch.ops import denoise as dn

TOL = 1


def _fireflies(shape, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[rng.random(shape[:2]) < 0.02] = [255, 255, 255]
    return img


def _both(img):
    want = np.asarray(jax_denoise(jnp.asarray(img)))
    got = dn.denoise_u8(torch.from_numpy(img)).numpy()
    return got, want


@pytest.mark.parametrize("shape", [(24, 256, 3), (13, 128, 3), (1, 50, 3), (50, 1, 3),
                                   (1, 1, 3), (2, 3, 3)])
def test_matches_jax(shape):
    img = _fireflies(shape, sum(shape))
    got, want = _both(img)
    assert got.shape == img.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= TOL


def test_flat_image_exact():
    img = np.full((16, 40, 3), 77, np.uint8)
    got, want = _both(img)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


def test_lone_firefly_exact():
    img = np.full((16, 32, 3), 90, np.uint8)
    img[7, 9] = [255, 250, 240]
    got, want = _both(img)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[7, 9], [90, 90, 90])  # replaced by the median
    assert (got != img).any(-1).sum() == 1


def test_luminance_ties_pick_the_stable_median():
    """(0, 10, 0) and (17, 0, 49) have the same float32 luminance. Around a
    firefly in a field of both, the median sample is a tie, and the stable
    sort must pick the same one as jnp.argsort: the fireflies' outputs are
    equal exactly and take both colours."""
    rng = np.random.default_rng(3)
    tie = np.array([[0, 10, 0], [17, 0, 49]], np.uint8)
    img = tie[rng.integers(0, 2, (24, 36))]
    ys, xs = np.meshgrid(np.arange(2, 24, 4), np.arange(2, 36, 4), indexing="ij")
    img[ys, xs] = 255
    got, want = _both(img)
    np.testing.assert_array_equal(got[ys, xs], want[ys, xs])
    picked = {tuple(int(v) for v in c) for c in got[ys, xs].reshape(-1, 3)}
    assert picked == {(0, 10, 0), (17, 0, 49)}
    assert np.abs(got.astype(int) - want.astype(int)).max() <= TOL


def test_matches_pallas_interpret():
    img = _fireflies((24, 256, 3), 11)
    want = np.asarray(denoise_u8_pallas(jnp.asarray(img), interpret=True))
    got = dn.denoise_u8(torch.from_numpy(img)).numpy()
    assert np.abs(got.astype(int) - want.astype(int)).max() <= TOL


def test_cpu_tensor_takes_plain_version():
    img = torch.from_numpy(_fireflies((9, 11, 3), 2))
    before = dn.denoise_u8.launches
    torch.testing.assert_close(dn.denoise_u8(img), dn.denoise_u8_plain(img), rtol=0, atol=0)
    assert dn.denoise_u8.launches == before


@pytest.mark.parametrize("bad", [
    torch.zeros((4, 4, 3), dtype=torch.float32),
    torch.zeros((4, 4), dtype=torch.uint8),
    torch.zeros((4, 4, 4), dtype=torch.uint8),
])
def test_bad_input_raises(bad):
    with pytest.raises(ValueError):
        dn.denoise_u8(bad)


def test_other_device_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        dn.denoise_u8(torch.empty((4, 4, 3), dtype=torch.uint8, device="meta"))


def test_build_key_covers_every_source(tmp_path, monkeypatch):
    """Editing any csrc/*.cu changes the build directory, so it rebuilds."""
    for name in ("a.cu", "b.cu"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    assert [p.name for p in cuda_build.sources()] == ["a.cu", "b.cu"]
    key = cuda_build.build_key()
    (tmp_path / "b.cu").write_text("// b.cu edited\n")
    assert cuda_build.build_key() != key


def test_package_sources_hold_both_kernels():
    assert {"traverse", "denoise"} <= {p.stem for p in cuda_build.sources()}


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_libraries()


def test_k3_bound_at_the_flagship():
    """K3's bound at 1920x1080 (utils/bounds.py): 12.4 MB of bytes and 196
    operations per pixel at the H100's non-FMA rate; operations bind."""
    from raytracing_c_tpu_torch.utils import bounds

    b = bounds.bound(bounds.k3_work(1080, 1920))
    assert bounds.K3_OPS_PER_PIXEL == 196
    assert b["bound_by"] == "operations"
    assert b["bytes_ms"] == pytest.approx(6 * 2_073_600 / 3.35e12 * 1e3, rel=1e-12)
    assert b["bound_ms"] == pytest.approx(196 * 2_073_600 / 33.5e12 * 1e3, rel=1e-12)
