"""The CUDA kernels on the card against their plain PyTorch versions.

Every test here is marked `cuda` and skips where there is no GPU. The file
imports neither jax nor the JAX package, so it also runs on a machine with
only PyTorch; tests/conftest.py imports jax, so run it there without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: none. The kernels are built with --fmad=false and repeat the
plain versions' operation order, so hits and attribute planes are
bit-equal to the plain versions run on the same card.
"""

import numpy as np
import pytest
import torch

from raytracing_c_tpu_torch.models import scene as ps
from raytracing_c_tpu_torch.ops import traverse_cuda as tc
from raytracing_c_tpu_torch.render.renderer import render
from raytracing_c_tpu_torch.utils.vec3 import Vec3

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _soup_scene(n: int, seed: int) -> ps.Scene:
    """Random triangle soup in [-1, 1]^3 (the shape of tests/helpers.random_mesh)."""
    rng = np.random.default_rng(seed)
    pos = (rng.uniform(-1, 1, (n, 1, 3)) + rng.normal(0, 0.12, (n, 3, 3))).astype(np.float32)
    ng = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    mesh = ps.HostMesh(pos, np.repeat(ng[:, None], 3, 1).astype(np.float32),
                       rng.uniform(0, 1, (n, 3, 2)).astype(np.float32),
                       np.zeros(n, np.int32))
    return ps.build_scene(mesh, ps.MaterialTable.default(), ps.TextureAtlas.empty(),
                          ps.Background.constant((0.7, 0.8, 1.0)), ps.Camera.default())


def _rays(n: int, seed: int, device):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:64] = [1.0, 0.0, 0.0]  # axis-parallel: 0 * inf slabs
    o[:32, 1:] = 0.0  # ... with the origin on box planes too
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return Vec3(t(o[:, 0]), t(o[:, 1]), t(o[:, 2])), Vec3(t(d[:, 0]), t(d[:, 1]), t(d[:, 2]))


@pytest.mark.parametrize("n_tri,depth", [(900, 3), (15452, 4), (33000, 5)])
def test_kernels_match_plain(cuda_device, n_tri, depth):
    ts = _soup_scene(n_tri, 8).to(cuda_device)
    assert ts.bvh.depth == depth
    o, d = _rays(4096, 9, cuda_device)
    tc.reset_launch_counts()
    got = tc.bvh_traverse(o, d, ts.triangles, ts.bvh, fuse_attr=True)
    bare = tc.bvh_traverse(o, d, ts.triangles, ts.bvh)
    want = tc.bvh_traverse_plain(o, d, ts.triangles, fuse_attr=True)
    torch.cuda.synchronize()
    assert tc.launch_counts()["bvh_traverse"] == 2
    for k in ("tri", "t", "u", "v", "attrs"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    for k in ("tri", "t", "u", "v"):
        torch.testing.assert_close(bare[k], want[k], rtol=0, atol=0, msg=k)
    assert torch.isinf(got["dropped_min"]).all()
    assert (got["tri"] >= 0).float().mean() > 0.3
    attrs = tc.fetch_attrs(ts.triangles.attr_rows, got["tri"], got["u"], got["v"])
    torch.testing.assert_close(attrs, want["attrs"], rtol=0, atol=0)
    assert tc.launch_counts()["fetch_attrs"] == 1


def test_active_and_t_max(cuda_device):
    ts = _soup_scene(900, 3).to(cuda_device)
    o, d = _rays(2048, 4, cuda_device)
    i = torch.arange(2048, device=cuda_device)
    active = i % 3 != 0
    t_max = torch.where(i % 2 == 0, torch.full_like(o.x, 1.5), torch.full_like(o.x, float("inf")))
    got = tc.bvh_traverse(o, d, ts.triangles, ts.bvh, active=active, t_max=t_max)
    want = tc.bvh_traverse_plain(o, d, ts.triangles, active=active, t_max=t_max)
    for k in ("tri", "t", "u", "v"):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_bad_tables_raise(cuda_device):
    ts = _soup_scene(100, 1).to(cuda_device)
    o, d = _rays(64, 2, cuda_device)
    ts.bvh.nodes = ts.bvh.nodes.double()
    with pytest.raises(ValueError):
        tc.bvh_traverse(o, d, ts.triangles, ts.bvh)


def test_render_kernel_path_matches_brute(cuda_device):
    """render() through the kernels equals render() through the brute-force
    oracle, and the main path launched both kernels."""
    ts = _soup_scene(2000, 6).to(cuda_device)
    tc.reset_launch_counts()
    img_k, st_k = render(ts, 48, 40, spp=2, max_bounces=4, seed=1, method="bvh")
    counts = tc.launch_counts()
    img_b, st_b = render(ts, 48, 40, spp=2, max_bounces=4, seed=1, method="brute")
    assert counts["bvh_traverse"] > 0 and counts["fetch_attrs"] > 0
    np.testing.assert_array_equal(img_k, img_b)
    assert st_k.rays_traced == st_b.rays_traced
