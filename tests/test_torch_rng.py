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
    (2, R) and the dense per-bounce draw (bounces, 4, R)."""
    from raytracing_c_tpu.render.renderer import _draw_uniforms as jax_draw

    from raytracing_c_tpu_torch.render.renderer import _draw_uniforms

    r, bounces = 96, 3
    kb = jax.random.fold_in(jax.random.PRNGKey(11), jnp.uint32(b))
    j_jit, j_uni, _ = jax_draw(kb, r, bounces, nee=False)
    t_jit, t_uni = _draw_uniforms(rng.fold_in(rng.prng_key(11), b), r, bounces)
    np.testing.assert_array_equal(np.asarray(j_jit), t_jit.numpy())
    np.testing.assert_array_equal(np.asarray(j_uni), t_uni.numpy())


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
