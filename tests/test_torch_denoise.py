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
from raytracing_c_tpu_torch.utils.color import LUMA

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
    """K3's bound at 1920x1080 (utils/bounds.py): 12.4 MB of bytes and 105
    operations per pixel of the shared-memory design at the H100's rate of
    one instruction per lane per clock; operations bind."""
    from raytracing_c_tpu_torch.utils import bounds

    b = bounds.bound(bounds.k3_work(1080, 1920))
    assert bounds.K3_OPS_PER_PIXEL == 105
    assert b["bound_by"] == "operations"
    assert b["bytes_ms"] == pytest.approx(6 * 2_073_600 / 3.35e12 * 1e3, rel=1e-12)
    assert b["bound_ms"] == pytest.approx(105 * 2_073_600 / 33.5e12 * 1e3, rel=1e-12)


def _network(keys: np.ndarray) -> np.ndarray:
    """K3's median network (ops/denoise.py MEDIAN9_NETWORK) on (..., 9)
    keys; returns the key it leaves at position 4."""
    p = [keys[..., k].copy() for k in range(9)]
    for a, b in dn.MEDIAN9_NETWORK:
        p[a], p[b] = np.minimum(p[a], p[b]), np.maximum(p[a], p[b])
    return p[4]


def test_median_network_selects_the_median():
    """19 compare-exchanges, and the fifth smallest of every 0-1 input and
    of every permutation of 9 distinct keys."""
    import itertools

    assert len(dn.MEDIAN9_NETWORK) == 19
    bits = (np.arange(512)[:, None] >> np.arange(9)) & 1
    np.testing.assert_array_equal(_network(bits), np.sort(bits, 1)[:, 4])
    perms = np.array(list(itertools.permutations(range(9))))
    assert (_network(perms) == 4).all()


def _stable_median_and_network_pick(img: np.ndarray):
    """Per pixel, the neighbour index the plain version's stable sort puts
    in the middle, and the one K3's network picks from its keys."""
    f = torch.from_numpy(img).to(torch.float32) * (1.0 / 255.999)
    h, w, _ = img.shape
    ys, xs = torch.arange(h), torch.arange(w)
    lums = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = f[torch.clamp(ys + dy, 0, h - 1)][:, torch.clamp(xs + dx, 0, w - 1)]
            lums.append((s[..., 0] * LUMA[0] + s[..., 1] * LUMA[1]) + s[..., 2] * LUMA[2])
    lum = torch.stack(lums, -1)
    want = torch.sort(lum, dim=-1, stable=True)[1][..., 4].numpy()
    bits = lum.view(torch.int32).numpy().astype(np.int64)
    keys = (np.maximum(bits - dn.KEY_BASE, 0) << 4) | np.arange(9)
    assert keys.max() < 2**32
    return want, _network(keys) & 15


@pytest.mark.parametrize("seed", [0, 1])
def test_median_network_picks_the_stable_sort_median(seed):
    img = _fireflies((40, 64, 3), seed)
    img[:8] = 0  # a black band: all-zero keys, told apart by the index alone
    want, got = _stable_median_and_network_pick(img)
    np.testing.assert_array_equal(got, want)


def test_median_network_picks_the_stable_median_on_ties():
    """The planted luminance ties of test_luminance_ties_pick_the_stable_median."""
    rng = np.random.default_rng(3)
    tie = np.array([[0, 10, 0], [17, 0, 49]], np.uint8)
    img = tie[rng.integers(0, 2, (24, 36))]
    img[2::4, 2::4] = 255
    want, got = _stable_median_and_network_pick(img)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1


def test_luminance_keys_keep_the_order_of_every_u8_colour():
    """Every u8 colour's luminance is 0 or in [2^-13, 1), where float32 bits
    rise with the value, so K3's 27-bit key keeps the order."""
    c = torch.arange(256, dtype=torch.float32) * (1.0 / 255.999)
    g_b = (c[:, None] * LUMA[1], c[None, :] * LUMA[2])
    least, most = 1.0, 0.0
    for r in range(256):
        lum = ((c[r] * LUMA[0] + g_b[0]) + g_b[1]).reshape(-1)
        nz = lum[lum > 0]
        if nz.numel():
            least = min(least, float(nz.min()))
        most = max(most, float(lum.max()))
    assert least >= 2.0**-13 and most < 1.0
    keys = np.maximum(np.array([0, 0x39000000, 0x3F7FFFFF]) - dn.KEY_BASE, 0)
    assert keys.tolist() == [0, 1, 0x3F7FFFFF - dn.KEY_BASE] and keys[-1] < 2**27
