"""The port's threefry (raytracing_c_tpu_torch/utils/rng.py) against
jax.random itself: every stream the renderer draws must be bit-equal
(tolerance: none, the words are compared exactly)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_c_tpu_torch.utils import rng


def _key_words(k):
    return np.asarray(jax.random.key_data(k) if jnp.issubdtype(k.dtype, jax.dtypes.prng_key)
                      else k).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 5, 2**32 - 1])
def test_prng_key_fold_in_split(seed):
    jk = jax.random.PRNGKey(seed)
    tk = rng.prng_key(seed)
    np.testing.assert_array_equal(_key_words(jk), tk.numpy())
    for data in (0, 1, 7, 123456, 2**32 - 1):
        np.testing.assert_array_equal(
            _key_words(jax.random.fold_in(jk, data)), rng.fold_in(tk, data).numpy()
        )
    np.testing.assert_array_equal(_key_words(jax.random.split(jk)), rng.split(tk).numpy())
    np.testing.assert_array_equal(
        _key_words(jax.random.split(jk, 5)), rng.split(tk, 5).numpy()
    )


@pytest.mark.parametrize("shape", [(1,), (7,), (2, 333), (3, 4, 129)])
def test_uniform_bits_equal(shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(9), 3)
    tk = rng.fold_in(rng.prng_key(9), 3)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, shape, jnp.float32)),
        rng.uniform(tk, shape).numpy(),
    )


@pytest.mark.parametrize("b", [0, 5, 127])
def test_batch_jitter_stream(b):
    """renderer._draw_uniforms: split(fold_in(PRNGKey(seed), b)) -> jitter
    (2, R) and the dense per-bounce draw (bounces, 4, R); with nee also the
    light-sample draw (bounces, 3, R) from fold_in(kb, 7919), which leaves
    the other two unchanged."""
    from raytracing_c_tpu.render.renderer import _draw_uniforms as jax_draw

    from raytracing_c_tpu_torch.render.renderer import _draw_uniforms

    r, bounces = 96, 3
    kb = jax.random.fold_in(jax.random.PRNGKey(11), jnp.uint32(b))
    tkb = rng.fold_in(rng.prng_key(11), b)
    for nee in (False, True):
        j_jit, j_uni, j_nee = jax_draw(kb, r, bounces, nee=nee)
        t_jit, t_uni, t_nee = _draw_uniforms(tkb, r, bounces, nee=nee)
        np.testing.assert_array_equal(np.asarray(j_jit), t_jit.numpy())
        np.testing.assert_array_equal(np.asarray(j_uni), t_uni.numpy())
        if nee:
            np.testing.assert_array_equal(np.asarray(j_nee), t_nee.numpy())
        else:
            assert j_nee is None and t_nee is None
    assert _draw_uniforms(tkb, r, bounces, nee=True, skip_mat=True)[1:] == (None, None)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 1.0), (0.25, 3.5),
                                   (float(np.nextafter(np.float32(-1), np.float32(0))), 1.0)])
def test_uniform_with_bounds_bits_equal(lo, hi):
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    jk = jax.random.fold_in(jax.random.PRNGKey(21), 8)
    tk = rng.fold_in(rng.prng_key(21), 8)
    want = np.asarray(jax.random.uniform(jk, (3, 1000), jnp.float32, lo, hi))
    np.testing.assert_array_equal(want, rng.uniform(tk, (3, 1000), lo, hi).numpy())


def test_erfinv_matches_xla():
    """The float32 erfinv against jax.lax.erf_inv on a dense grid of
    (-1, 1), the tails and +-1. Tolerance: 3 float32 ulps (rtol 3.6e-7)
    plus atol 1e-37. Measured: 2,226 of 200,506 values differ, by at most
    2 ulps (torch's log1p rounds differently from XLA's); +-inf equal."""
    x = np.concatenate([np.linspace(-1, 1, 200001, dtype=np.float32),
                        1 - np.logspace(-7.2, -1, 500).astype(np.float32),
                        np.float32([1.0, -1.0, 0.0, 1e-30, -1e-30])])
    x = np.clip(x, -1, 1).astype(np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = rng.erfinv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=3.6e-7, atol=1e-37)


@pytest.mark.parametrize("shape", [(5,), (3, 4097)])
def test_normal_matches_jax(shape):
    """jax.random.normal(key, shape, float32): sqrt(2) erfinv of a uniform
    on [nextafter(-1, 0), 1). Tolerance as test_erfinv_matches_xla;
    measured: 112 of 12,291 differ, by at most 2.4e-7."""
    jk = jax.random.fold_in(jax.random.PRNGKey(4), 99)
    want = np.asarray(jax.random.normal(jk, shape, jnp.float32))
    got = rng.normal(rng.fold_in(rng.prng_key(4), 99), shape).numpy()
    np.testing.assert_allclose(got, want, rtol=3.6e-7, atol=1e-37)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("nu", [3, 4, 7])
def test_slot_keyed_bounce_stream(nu):
    """integrator.trace_bucketed's uniform(fold_in(fold_in(kb1, slot), i),
    (nu,)); nu = 3 must be the prefix of the nee-width draw nu = 7."""
    kb1 = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(4), 2), 1)
    tk = rng.fold_in(rng.fold_in(rng.prng_key(4), 2), 1)
    slots = np.arange(0, 5000, 7, dtype=np.int32)
    for bounce in (0, 1, 7):
        def draw(s):
            k = jax.random.fold_in(jax.random.fold_in(kb1, s), bounce)
            return jax.random.uniform(k, (nu,), jnp.float32)

        want = np.asarray(jax.vmap(draw, out_axes=1)(jnp.asarray(slots)))
        got = rng.uniform(rng.fold_in(rng.fold_in(tk, torch.from_numpy(slots)), bounce), (nu,)).T
        np.testing.assert_array_equal(want, got.numpy())
        if nu == 7:
            got3 = rng.uniform(rng.fold_in(rng.fold_in(tk, torch.from_numpy(slots)), bounce), (3,)).T
            np.testing.assert_array_equal(want[:3], got3.numpy())


#: slots at the ends of the uint32 range and between (the slot is folded in
#: as a uint32 word)
EDGE_SLOTS = np.array([0, 1, 2, 1000, 2**31 - 2, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1],
                      dtype=np.int64)


@pytest.mark.parametrize("bounce", [0, 1, 7])
@pytest.mark.parametrize("nu", [3, 4, 7])
def test_bounce_uniforms_matches_jax(nu, bounce):
    """rng.bounce_uniforms, the compacted tracer's draw a bounce, on the CPU
    (its plain composition) against jax.random's
    uniform(fold_in(fold_in(kb1, slot), bounce), (nu,)), vmapped over the
    slots: (nu, n), bit for bit, the slots 0, 2^31 - 1 and 2^32 - 1
    among them."""
    kb1 = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(77), 5), 1)
    tk = rng.fold_in(rng.fold_in(rng.prng_key(77), 5), 1)
    slots = np.concatenate([EDGE_SLOTS, np.arange(3, 4000, 13)])

    def draw(s):
        k = jax.random.fold_in(jax.random.fold_in(kb1, s), bounce)
        return jax.random.uniform(k, (nu,), jnp.float32)

    want = np.asarray(jax.vmap(draw, out_axes=1)(jnp.asarray(slots.astype(np.uint32))))
    got = rng.bounce_uniforms(tk, torch.from_numpy(slots), bounce, nu)
    assert got.shape == (nu, slots.size) and got.dtype == torch.float32
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("bounce", [0, 1, 7])
def test_bounce_uniforms_prefix(bounce):
    """nu = 3 (and 4) are the first rows of the NEE width nu = 7, so K4
    reads the same material draws with and without NEE."""
    tk = rng.fold_in(rng.prng_key(3), 9)
    slots = torch.from_numpy(np.concatenate([EDGE_SLOTS, np.arange(10, 3000, 7)]))
    got7 = rng.bounce_uniforms(tk, slots, bounce, 7)
    for nu in (3, 4):
        assert torch.equal(rng.bounce_uniforms(tk, slots, bounce, nu), got7[:nu])


def test_cpu_draws_never_reach_k5(monkeypatch):
    """Every draw on CPU tensors takes the plain int64 version: each public
    draw and a render through the compacted tracer with NEE (so every
    width is drawn) leave K5's launch counts at 0 and never load its
    library."""
    import chip_smoke
    from raytracing_c_tpu_torch.models import scene as ps
    from raytracing_c_tpu_torch.ops import cuda_build, rng_cuda
    from raytracing_c_tpu_torch.render.renderer import render

    def refuse():
        raise AssertionError("a CPU draw reached K5's library")

    monkeypatch.setattr(rng_cuda, "_library", refuse)
    cuda_build.reset_launch_counts()
    key = rng.prng_key(5)
    rng.split(rng.fold_in(key, torch.tensor(3)))
    rng.normal(key, (2, 9))
    rng.random_bits(key, (4,))
    rng.bounce_uniforms(key, torch.arange(6), 2, 7)
    scene = chip_smoke.procedural_scene(ps, np, torch, "cpu", n=8, tex=16)
    _, stats = render(scene, 8, 6, spp=2, max_bounces=3, seed=1, nee=True)
    assert stats.rays_traced > 0
    counts = cuda_build.launch_counts()
    assert {k: counts[k] for k in ("rng_fold_in", "rng_split", "rng_bits",
                                   "rng_bounce_uniforms")} == \
        {"rng_fold_in": 0, "rng_split": 0, "rng_bits": 0, "rng_bounce_uniforms": 0}


def test_k5_bounds():
    """utils/bounds.py's counts for K5: the bounce draw at 262,144 lanes and
    nu = 3 is operation-bound (5 blocks a lane), a few microseconds; the
    dense batch draw of 8 x 4 x 262,144 words is operation-bound too."""
    from raytracing_c_tpu_torch.utils import bounds

    work = bounds.k5_bounce_work(262_144, 3)
    assert work["bytes"] == 16 + 262_144 * 20
    assert work["ops"] == 262_144 * (5 * bounds.THREEFRY_OPS + 3 * bounds.UNIFORM_WORD_OPS)
    b = bounds.bound(work)
    assert b["bound_by"] == "operations" and 0.001 < b["bound_ms"] < 0.01
    assert bounds.bound(bounds.k5_uniform_work(8 * 4 * 262_144))["bound_by"] == "operations"
    assert bounds.k5_key_work(2) == {"bytes": 48, "ops": 2.0 * bounds.THREEFRY_OPS}
    assert bounds.bound(bounds.k5_bounce_work(0, 7))["bound_ms"] < 1e-5
