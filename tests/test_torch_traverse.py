"""Traversal and hit attributes: the port against the JAX package, and the
CUDA kernels against their plain versions.

On the CPU the wrappers run the plain versions; they are held against the
JAX package's production path (`intersect_scene(method="pallas_fused")`,
the Pallas kernels in interpret mode) and its brute-force oracle on
random_mesh(900) with 1,024 rays. Tolerances: `tri` identical; t, u, v
and attribute planes within 1e-6 absolute / relative of the JAX brute
force and row gather (a float32 ulp or two of scheduling), and within 1e-4
of the Pallas kernel, whose staged Moller-Trumbore moves grazing hits by
more (traverse_pallas.py's module docstring: up to ~0.1% there).

The kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_c_tpu.ops import traverse as jtrav
from raytracing_c_tpu.ops import traverse_pallas as jtp
from raytracing_c_tpu.render import integrator as jint
from raytracing_c_tpu_torch.ops import traverse as ttrav
from raytracing_c_tpu_torch.ops import traverse_cuda as tc
from raytracing_c_tpu_torch.render import integrator as tint

from helpers import random_mesh, simple_scene
from torch_port_helpers import aimed_rays, jvec, np3, port_scene, tvec

TOL = dict(rtol=1e-6, atol=1e-6)
#: against the Pallas kernel (grazing-hit conditioning, see the docstring)
PALLAS_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def soup():
    rng = np.random.default_rng(21)
    js = simple_scene(random_mesh(900, rng), bg=(0.7, 0.8, 1.0))
    o, d = aimed_rays(1024, rng)
    d[:8] = [[1.0, 0.0, 0.0]] * 8  # axis-parallel rays: zero direction components
    return js, port_scene(js), o, d


@pytest.fixture(scope="module")
def jax_fused(soup):
    js, _, o, d = soup
    return jtrav.intersect_scene(js, jvec(o), jvec(d), method="pallas_fused")


def _assert_hits(want, got, tol=TOL):
    wt = np.asarray(want["t"])
    hit = np.isfinite(wt)
    np.testing.assert_array_equal(np.asarray(want["tri"]), got["tri"].numpy())
    np.testing.assert_allclose(wt, got["t"].numpy(), **tol)
    for k in ("u", "v"):
        np.testing.assert_allclose(np.asarray(want[k])[hit], got[k].numpy()[hit], **tol)
    return hit


def test_hits_match_jax_pallas_fused(soup, jax_fused):
    _, ts, o, d = soup
    got = ttrav.intersect_scene(ts, tvec(o), tvec(d), method="bvh", fuse_attr=True)
    hit = _assert_hits(jax_fused, got, PALLAS_TOL)
    assert 300 < hit.sum() < 1024


def test_hits_match_jax_bruteforce(soup):
    js, ts, o, d = soup
    want = jtrav.intersect_scene(js, jvec(o), jvec(d), method="brute")
    for method in ("bvh", "brute"):
        _assert_hits(want, ttrav.intersect_scene(ts, tvec(o), tvec(d), method=method))


def test_fused_attrs_match_jax(soup, jax_fused):
    """K1's fused attribute planes (plain version here) against the JAX
    Pallas epilogue, on hit lanes whose tier-0 winner the JAX repair tiers
    kept (`attrs_stale` lanes are refetched there, and are covered by the
    fetch_attrs test below; misses interpolate garbage u/v in JAX)."""
    _, ts, o, d = soup
    got = ttrav.intersect_scene(ts, tvec(o), tvec(d), method="bvh", fuse_attr=True)
    stale = np.asarray(jax_fused["attrs_stale"])
    assert stale.mean() < 0.1
    hit = np.isfinite(np.asarray(jax_fused["t"])) & ~stale
    want = np.asarray(jax_fused["attrs"])[:15]
    np.testing.assert_allclose(want[:, hit], got["attrs"].numpy()[:15, hit], **PALLAS_TOL)


def test_fetch_attrs_matches_jax_kernel_and_gather(soup, jax_fused):
    """K2's plain version against the JAX attribute kernel (interpret mode)
    and the JAX integrator's non-fused row gather."""
    js, ts, o, d = soup
    tri, u, v = jax_fused["tri"], jax_fused["u"], jax_fused["v"]
    hit = np.asarray(tri) >= 0
    got = tc.fetch_attrs(ts.triangles.attr_rows, torch.as_tensor(np.array(tri)),
                         torch.as_tensor(np.array(u)), torch.as_tensor(np.array(v)))
    got = tc.attrs_to_dict(got)
    want_k = jtp.fetch_attrs(js.ptables, tri, u, v)
    want_g = jint._gather_hit_geometry(
        js, jvec(o), jvec(d), {k: jax_fused[k] for k in ("t", "tri", "u", "v")}, "brute")
    for want in (want_k, want_g):
        for k in ("normal", "ng", "tangent", "bitangent"):
            np.testing.assert_allclose(np3(want[k])[hit], np3(got[k])[hit], err_msg=k, **TOL)
        for k in ("uv_u", "uv_v"):
            np.testing.assert_allclose(np.asarray(want[k])[hit], got[k].numpy()[hit], **TOL)
        np.testing.assert_array_equal(np.asarray(want["mat_id"])[hit], got["mat_id"].numpy()[hit])


def test_active_and_t_max(soup):
    """Inactive lanes and hits at or beyond t_max come back as misses
    (t = +inf, tri = -1, u = v = 0); the rest are unchanged."""
    _, ts, o, d = soup
    full = tc.bvh_traverse(tvec(o), tvec(d), ts.triangles, ts.bvh)
    active = torch.arange(1024) % 3 != 0
    t_max = torch.where(torch.arange(1024) % 2 == 0, full["t"], torch.tensor(float("inf")))
    part = tc.bvh_traverse(tvec(o), tvec(d), ts.triangles, ts.bvh, active=active, t_max=t_max)
    keep = active & (torch.arange(1024) % 2 == 1)
    for k in ("t", "u", "v", "tri"):
        np.testing.assert_array_equal(part[k][keep].numpy(), full[k][keep].numpy())
    gone = ~keep
    assert torch.isinf(part["t"][gone]).all() and (part["tri"][gone] == -1).all()
    assert (part["u"][gone] == 0).all() and (part["v"][gone] == 0).all()
    assert torch.isinf(part["dropped_min"]).all()


def test_launch_counters_stay_zero_on_cpu(soup):
    _, ts, o, d = soup
    tc.reset_launch_counts()
    hit = ttrav.intersect_scene(ts, tvec(o), tvec(d), method="bvh", fuse_attr=True)
    tc.fetch_attrs(ts.triangles.attr_rows, hit["tri"], hit["u"], hit["v"])
    st = tint._initial_state(tvec(o), tvec(d))
    tint.bounce_step(ts, st, torch.rand(3, 1024), method="bvh")
    assert tc.launch_counts() == {"bvh_traverse": 0, "fetch_attrs": 0}


def test_wrapper_rejects_other_devices(soup):
    _, ts, o, d = soup
    meta = tvec(o)
    meta = type(meta)(*(t.to("meta") for t in (meta.x, meta.y, meta.z)))
    with pytest.raises(ValueError):
        tc.bvh_traverse(meta, meta, ts.triangles, ts.bvh)
