"""The port's integrator and renderer against the JAX package.

Same scene arrays (carried across with scene_from_numpy), same seeds, the
same threefry streams. Tolerance: images bit-identical where reached, else
PSNR >= 45 dB (the cross-backend bound of test_golden.py:75); radiance
within 1e-4 (float32 ulps of the transcendentals compound over bounces);
ray counts exact.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from raytracing_c_tpu.render import integrator as jint
from raytracing_c_tpu.render import renderer as jren
from raytracing_c_tpu_torch.ops import cuda_build
from raytracing_c_tpu_torch.render import integrator as tint
from raytracing_c_tpu_torch.render import renderer as tren
from raytracing_c_tpu_torch.utils import rng as trng

from helpers import random_mesh, simple_scene
from torch_port_helpers import (aimed_rays, jvec, np3, port_scene, psnr, quad_sphere_scene,
                                set_thread_budget, tvec)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def scenes():
    js = simple_scene(random_mesh(900, np.random.default_rng(3)), bg=(0.7, 0.8, 1.0))
    jq = quad_sphere_scene()
    return {"soup": (js, port_scene(js)), "quad_sphere": (jq, port_scene(jq))}


def _rays(name, n=2048):
    rng = np.random.default_rng(17)
    if name == "soup":
        return aimed_rays(n, rng)
    o = np.tile([[0.0, 0.0, 3.0]], (n, 1)).astype(np.float32)
    d = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)), -np.ones((n, 1))], 1)
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", ["soup", "quad_sphere"])
def test_trace_dense_matches_jax(scenes, name):
    js, ts = scenes[name]
    o, d = _rays(name)
    uni = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (4, 4, len(o))))
    jrad, jrays = jint.trace(js, jvec(o), jvec(d), jax.numpy.asarray(uni), 4, method="brute")
    trad, trays = tint.trace(ts, tvec(o), tvec(d), torch.from_numpy(uni), 4, method="bvh")
    np.testing.assert_allclose(np3(jrad), np3(trad), **RAD_TOL)
    assert float(jrays) == int(trays)


@pytest.mark.parametrize("name,rr", [("soup", False), ("quad_sphere", False),
                                     ("quad_sphere", True)])
def test_trace_bucketed_matches_jax(scenes, name, rr):
    """rr (Russian roulette from bounce 3) draws 4 uniforms per bounce, the
    plain path 3: the slot-keyed stream must match at both widths."""
    js, ts = scenes[name]
    o, d = _rays(name)
    n_b = 6 if rr else 4
    jrad, jrays = jint.trace_bucketed(js, jvec(o), jvec(d), jax.random.PRNGKey(5), n_b,
                                      method="topk" if name == "soup" else "brute", rr=rr)
    trad, trays = tint.trace_bucketed(ts, tvec(o), tvec(d), trng.prng_key(5), n_b,
                                      method="bvh", rr=rr)
    np.testing.assert_allclose(np3(jrad), np3(trad), **RAD_TOL)
    assert float(jrays) == int(trays)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("name", ["soup", "quad_sphere"])
def test_render_matches_jax(scenes, name, compact):
    js, ts = scenes[name]
    kw = dict(spp=2, max_bounces=3, seed=7, compact=compact)
    jimg, jst = jren.render(js, 32, 32, method="topk" if name == "soup" else "auto", **kw)
    timg, tst = tren.render(ts, 32, 32, **kw)
    assert timg.shape == (32, 32, 3) and timg.dtype == np.uint8
    assert (timg == jimg).all() or psnr(timg, jimg) >= 45.0
    assert tst.rays_traced == jst.rays_traced
    assert tst.samples == 32 * 32 * 2 and tst.batches == jst.batches


@pytest.mark.parametrize("limit", [None, 2])
def test_render_batches_match_jax(scenes, limit):
    """Several batches (tile order, a padded last batch, per-batch keys)
    and limit_batches assemble the JAX package's image."""
    js, ts = scenes["soup"]
    kw = dict(spp=2, max_bounces=2, seed=3, batch_pixels=200, limit_batches=limit)
    jimg, jst = jren.render(js, 40, 24, method="topk", **kw)
    timg, tst = tren.render(ts, 40, 24, **kw)
    assert tst.batches == jst.batches == (limit or 5)
    assert (timg == jimg).all() or psnr(timg, jimg) >= 45.0
    assert tst.rays_traced == jst.rays_traced


def test_render_to_device_frame(scenes):
    """to_host=False hands back the frame buffer as a tensor on the scene's
    device, the same image the host copy holds (exact)."""
    ts = scenes["soup"][1]
    kw = dict(spp=1, max_bounces=2, seed=3, batch_pixels=200)
    host, st_h = tren.render(ts, 24, 16, **kw)
    frame, st_d = tren.render(ts, 24, 16, to_host=False, **kw)
    assert isinstance(frame, torch.Tensor) and frame.device == ts.device
    np.testing.assert_array_equal(frame.numpy(), host)
    assert st_d.rays_traced == st_h.rays_traced


def test_render_nee_casts_shadow_rays(scenes):
    """render(nee=True) runs: on the quad+sphere scene's
    constant sky it samples the sphere uniformly and casts a shadow ray per
    shaded vertex, so it traces more rays than the same render without
    nee (the NEE images are held against JAX's in test_torch_nee.py)."""
    ts = scenes["quad_sphere"][1]
    img, st = tren.render(ts, 8, 8, spp=2, max_bounces=3, nee=True)
    _, plain = tren.render(ts, 8, 8, spp=2, max_bounces=3)
    assert img.shape == (8, 8, 3) and img.std() > 0
    assert ts.env_light is None and st.rays_traced > plain.rays_traced


#: every kernel the package launches, by the name cuda_build counts it under
KERNELS = ("bvh_traverse", "bvh_traverse_wide", "fetch_attrs", "denoise_u8", "shade_bounce",
           "nee_add", "rng_fold_in", "rng_split", "rng_bits", "rng_bounce_uniforms")


def test_cpu_render_leaves_every_launch_count_at_zero(scenes):
    """The launch registry names every kernel of the package, and a CPU
    render with NEE (plain versions throughout) launches none of them."""
    ts = scenes["quad_sphere"][1]
    cuda_build.reset_launch_counts()
    _, st = tren.render(ts, 8, 8, spp=2, max_bounces=3, nee=True)
    assert st.rays_traced > 0
    assert cuda_build.launch_counts() == dict.fromkeys(KERNELS, 0)


def test_thread_budget_splits_the_cores_among_xdist_workers(monkeypatch):
    """torch_port_helpers gives each test process cpu_count // the xdist
    workers (at least one) intra-op threads: in force in this process, and
    for any worker count."""
    cores = os.cpu_count() or 1
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert torch.get_num_threads() == max(1, cores // workers)
    try:
        for n in (1, 2, 6, 4 * cores):
            monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", str(n))
            assert set_thread_budget() == max(1, cores // n) == torch.get_num_threads(), n
    finally:
        monkeypatch.undo()
        set_thread_budget()


def test_port_imports_no_jax(tmp_path):
    """The port renders end to end (also with NEE, and on two gloo ranks
    through render(mesh=), which gives the single-process dense image),
    saves and loads a scene cache, bakes a lightmap, round-trips QOI
    through the native codec, and its CLI loads a model, renders and
    denoises (-D), without importing jax or the JAX package."""
    obj = tmp_path / "quad.obj"
    obj.write_text("v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nf 1 2 3 4\n")
    png = tmp_path / "out.png"
    code = (
        "import sys, numpy as np\n"
        "from raytracing_c_tpu_torch.models import scene as ps\n"
        "from raytracing_c_tpu_torch.render.renderer import render\n"
        "p = np.array([[[-1,-1,0],[1,-1,0],[1,1,0]],[[-1,-1,0],[1,1,0],[-1,1,0]]], np.float32)\n"
        "n = np.zeros_like(p); n[..., 2] = 1\n"
        "uv = np.zeros((2, 3, 2), np.float32)\n"
        "mesh = ps.HostMesh(p, n, uv, np.zeros(2, np.int32))\n"
        "s = ps.build_scene(mesh, ps.MaterialTable.default(), ps.TextureAtlas.empty(),\n"
        "                   ps.Background.constant((0.5, 0.6, 0.7)), ps.Camera.default(),\n"
        "                   device='cpu')\n"
        "img, st = render(s, 16, 16, spp=1, max_bounces=2)\n"
        "assert img.shape == (16, 16, 3) and st.rays_traced > 0\n"
        "assert render(s, 8, 8, spp=1, max_bounces=2, nee=True)[1].rays_traced > 0\n"
        "from raytracing_c_tpu_torch.models import serialization\n"
        "from raytracing_c_tpu_torch.render.lightmap import bake_lightmap\n"
        "from raytracing_c_tpu_torch.io.image_io import qoi_decode, qoi_encode\n"
        f"serialization.save_scene_cache({str(tmp_path / 'c.npz')!r}, s)\n"
        f"s2 = serialization.load_scene_cache({str(tmp_path / 'c.npz')!r}, device='cpu')\n"
        "assert bake_lightmap(s2, 8, 8, samples=1, max_bounces=1).shape == (8, 8, 3)\n"
        "from raytracing_c_tpu_torch.parallel.launch import render_scene_cache, run_ranks\n"
        "kw = dict(width=16, height=16, spp=1, max_bounces=2, compact=False)\n"
        f"[(img_m, st_m, _)] = run_ranks(render_scene_cache, 2, 'gloo', ['cpu', 'cpu'], "
        f"{str(tmp_path / 'c.npz')!r}, [kw])\n"
        "img_s, st_s = render(s, **kw)\n"
        "assert (img_m == img_s).all() and st_m.rays_traced == st_s.rays_traced\n"
        "assert (qoi_decode(qoi_encode(img)) == img).all()\n"
        "from raytracing_c_tpu_torch import cli\n"
        "from raytracing_c_tpu_torch.io.image_io import load_image_rgb_u8\n"
        f"argv = ['-W', '16', '-H', '12', '-S', '1', '-B', '2', '-D', '--no-bg', '-O', {str(png)!r},"
        f" {str(obj)!r}]\n"
        "assert cli.main(argv, device='cpu') == 0\n"
        f"assert load_image_rgb_u8({str(png)!r}).shape == (12, 16, 3)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'raytracing_c_tpu.'))"
        " or m == 'raytracing_c_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
