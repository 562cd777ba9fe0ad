"""The port's batch API (render_batch_indexed, render_batches_grouped,
render_batches_grouped_acc, render(k_group=, accumulate=)) and its
traversal method names, against the JAX package.

Same scene arrays (carried across with scene_from_numpy), same seeds, the
same threefry streams. Tolerance: images bit-identical, else PSNR >= 45 dB
(the cross-backend bound of test_golden.py:75); rays and batch counts
exact.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_c_tpu.render import renderer as jren
from raytracing_c_tpu_torch.ops import traverse as ttr
from raytracing_c_tpu_torch.render import renderer as tren
from raytracing_c_tpu_torch.utils import rng as trng

from helpers import random_mesh, simple_scene
from torch_port_helpers import port_scene, psnr, quad_sphere_scene

#: the soup's batch tables: 40x24 in batches of 100 pixels, 9 full and a
#: padded tenth (60 pixels and 40 of padding)
W, H, BP = 40, 24, 100
N_BATCHES = -(-W * H // BP)
SOUP_KW = dict(width=W, height=H, spp=2, max_bounces=3, batch_px=BP, compact=True)
#: the JAX CLI's --method names (raytracing_c_tpu/cli.py)
JAX_CLI_METHODS = ("auto", "pallas", "pallas_fused", "pallas_fast", "topk", "topk_fast", "dfs",
                   "brute")


@pytest.fixture(scope="module")
def scenes():
    js = simple_scene(random_mesh(900, np.random.default_rng(3)), bg=(0.7, 0.8, 1.0))
    jq = quad_sphere_scene()
    return {"soup": (js, port_scene(js)), "quad_sphere": (jq, port_scene(jq))}


@pytest.fixture(scope="module")
def tables():
    pad = N_BATCHES * BP - W * H
    jxs, jys = jren._pixel_tables_device(W, H, pad)
    txs, tys, _ = tren._pixel_tables_device(W, H, pad, torch.device("cpu"))
    return (jxs, jys), (txs, tys)


def _same_image(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (got == want).all() or psnr(got, want) >= 45.0


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("b", [0, N_BATCHES - 1])
def test_render_batch_indexed_matches_jax(scenes, tables, b, as_tensor):
    """Batch 0 and the padded last batch, the index a python int or a 0-d
    tensor on the scene's device."""
    js, ts = scenes["soup"]
    (jxs, jys), (txs, tys) = tables
    jrgb, jrays = jren.render_batch_indexed(js, jxs, jys, jax.random.PRNGKey(11), jnp.uint32(b),
                                            method="topk", **SOUP_KW)
    tb = torch.tensor(b) if as_tensor else b
    trgb, trays = tren.render_batch_indexed(ts, txs, tys, trng.prng_key(11), tb,
                                            method="topk", **SOUP_KW)
    _same_image(trgb.numpy(), np.asarray(jrgb))
    assert int(trays) == float(jrays)


def test_render_batches_grouped_clamps_like_jax(scenes, tables):
    """A group of 4 from the second-to-last batch runs past the end: its
    indices clamp to the last batch, which comes back three times."""
    js, ts = scenes["soup"]
    (jxs, jys), (txs, tys) = tables
    b0 = N_BATCHES - 2
    jrgb, jrays = jren.render_batches_grouped(js, jxs, jys, jax.random.PRNGKey(11),
                                              jnp.uint32(b0), k_group=4, method="topk",
                                              **SOUP_KW)
    trgb, trays = tren.render_batches_grouped(ts, txs, tys, trng.prng_key(11), b0, k_group=4,
                                              method="topk", **SOUP_KW)
    assert trgb.shape == (4, BP, 3) and trgb.dtype == torch.uint8
    assert trays.shape == (4,) and trays.dtype == torch.float32
    _same_image(trgb.numpy(), np.asarray(jrgb))
    np.testing.assert_array_equal(trays.numpy(), np.asarray(jrays))
    for j in (2, 3):
        assert torch.equal(trgb[j], trgb[1]) and trays[j] == trays[1]


def test_render_batches_grouped_acc_writes_in_place(scenes, tables):
    """The group's rows and ray counts land in the given tensors, which
    come back; every other row and count is untouched."""
    ts = scenes["soup"][1]
    _, (txs, tys) = tables
    kw = dict(k_group=3, method="bvh", **SOUP_KW)
    acc = torch.full((12 * BP, 3), 7, dtype=torch.uint8)
    rays_acc = torch.full((12,), -1.0)
    b0 = 4
    got_acc, got_rays = tren.render_batches_grouped_acc(ts, txs, tys, trng.prng_key(2), b0, acc,
                                                        rays_acc, **kw)
    assert got_acc is acc and got_rays is rays_acc
    rgb, rays = tren.render_batches_grouped(ts, txs, tys, trng.prng_key(2), b0, **kw)
    lo, hi = b0 * BP, (b0 + 3) * BP
    assert torch.equal(acc[lo:hi], rgb.reshape(-1, 3))
    assert (acc[:lo] == 7).all() and (acc[hi:] == 7).all()
    assert torch.equal(rays_acc[b0:b0 + 3], rays)
    assert (rays_acc[:b0] == -1).all() and (rays_acc[b0 + 3:] == -1).all()


@pytest.mark.parametrize("limit", [None, 5])
@pytest.mark.parametrize("accumulate", [True, False])
@pytest.mark.parametrize("k_group", [1, 3, 4])
def test_render_groups_match_jax(scenes, k_group, accumulate, limit):
    """render() over the JAX package's batch loop: 16x16 in 8 batches of
    32 pixels on the quad + sphere scene, seed 0. With limit_batches=5 the
    accumulating loop renders the whole last group into the image (253
    lit pixels at k_group=4 against 157 without accumulate) and counts
    the rays of 5 batches; the port does the same."""
    jq, tq = scenes["quad_sphere"]
    kw = dict(spp=1, max_bounces=2, seed=0, batch_pixels=32, limit_batches=limit,
              k_group=k_group, accumulate=accumulate)
    jimg, jst = jren.render(jq, 16, 16, **kw)
    timg, tst = tren.render(tq, 16, 16, **kw)
    _same_image(timg, jimg)
    assert (tst.rays_traced, tst.batches) == (jst.rays_traced, jst.batches)
    if limit is not None and k_group == 4:
        assert int((timg.sum(-1) > 0).sum()) == (253 if accumulate else 157)


def test_accumulate_matches_drain(scenes):
    """Counterpart of test_golden.py::test_accumulate_matches_drain on the
    soup: the accumulator and the per-batch frame writes assemble the same
    image from 5 batches (a group of 4 and a clamped tail group), with the
    same rays; progress fires per group and per batch."""
    ts = scenes["soup"][1]
    kw = dict(spp=2, max_bounces=2, seed=7, batch_pixels=200)
    calls = {True: [], False: []}
    img_acc, st_acc = tren.render(ts, W, H, accumulate=True,
                                  progress=lambda *a: calls[True].append(a), **kw)
    img_drn, st_drn = tren.render(ts, W, H, accumulate=False,
                                  progress=lambda *a: calls[False].append(a), **kw)
    assert st_acc.batches == st_drn.batches == 5
    assert (img_acc == img_drn).all() and img_acc.std() > 0
    assert st_acc.rays_traced == st_drn.rays_traced
    assert calls[True] == [(4, 5), (5, 5)]
    assert calls[False] == [(b, 5) for b in range(1, 6)]


@pytest.mark.parametrize("name", ["render", "render_batch", "render_batch_sharded",
                                  "render_batch_indexed", "render_batches_grouped",
                                  "render_batches_grouped_acc"])
def test_signatures_hold_jax_parameters(name):
    """Every parameter of the JAX function is a parameter of the port's,
    by name and kind; render's to_host is the port's only extra."""
    jp = inspect.signature(getattr(jren, name)).parameters
    tp = inspect.signature(getattr(tren, name)).parameters
    assert set(tp) - set(jp) == ({"to_host"} if name == "render" else set())
    assert set(jp) <= set(tp)
    assert all(tp[n].kind == p.kind for n, p in jp.items())


def test_render_stats_fields():
    assert ([f.name for f in dataclasses.fields(tren.RenderStats)]
            == [f.name for f in dataclasses.fields(jren.RenderStats)])
    st = tren.RenderStats()
    assert st.compile_ms == 0.0 and st.extra == {} and st.extra is not tren.RenderStats().extra


@pytest.mark.parametrize("method", JAX_CLI_METHODS)
def test_jax_method_names(scenes, method):
    """Every name of the JAX CLI goes through the port's render() and
    render_batch(). auto, topk, dfs and brute are held against the JAX
    package's render with the same name; every name mapped to K1 equals
    the port's "bvh" byte for byte."""
    jq, tq = scenes["quad_sphere"]
    kw = dict(spp=1, max_bounces=2, seed=4, batch_pixels=32)
    timg, tst = tren.render(tq, 16, 16, method=method, **kw)
    port = ttr.port_method(method, tq)
    want = tren.render(tq, 16, 16, method=port, **kw)[0]
    assert (timg == want).all()
    if method in ("auto", "topk", "dfs", "brute"):
        jimg, jst = jren.render(jq, 16, 16, method=method, **kw)
        _same_image(timg, jimg)
        assert tst.rays_traced == jst.rays_traced
    px = torch.arange(64, dtype=torch.int32) % 16
    py = torch.arange(64, dtype=torch.int32) // 16
    bkw = dict(width=16, height=16, spp=1, max_bounces=2, compact=True)
    rgb, rays = tren.render_batch(tq, px, py, trng.prng_key(4), method=method, **bkw)
    rgb_p, rays_p = tren.render_batch(tq, px, py, trng.prng_key(4), method=port, **bkw)
    assert torch.equal(rgb, rgb_p) and int(rays) == int(rays_p)


def test_unknown_method_raises(scenes):
    tq = scenes["quad_sphere"][1]
    with pytest.raises(ValueError, match="unknown traversal method 'nope'"):
        tren.render(tq, 8, 8, spp=1, max_bounces=1, method="nope")
    with pytest.raises(ValueError, match="unknown traversal method 'nope'"):
        tren.render_batch(tq, torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
                          trng.prng_key(0), width=8, height=8, spp=1, max_bounces=1,
                          method="nope")
