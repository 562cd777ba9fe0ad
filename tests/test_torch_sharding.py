"""The port's multi-device rendering (raytracing_c_tpu_torch/parallel/,
render(mesh=), render_batch_sharded) against the JAX package's device mesh.

The JAX side runs `raytracing_c_tpu.parallel.mesh.make_mesh` over the
first n of conftest's 8 virtual CPU devices; the port side runs n gloo
ranks on the CPU through `parallel/launch.py:run_ranks`, every case of
one world size in one start of the ranks (tests/torch_ranks.py, which
imports no jax). Scene: random_mesh(200) carried across with port_scene
and handed to the ranks as a scene cache. Tolerance: none. Images, ray
counts and blocks are exact: the port's threefry is jax.random's, so the
dense images, the NEE images and the per-shard compacted images all
equal JAX's bit for bit, and the dense ones also equal the port's
single-process render.
"""

import hashlib
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracing_c_tpu.parallel import mesh as jmesh
from raytracing_c_tpu.render import renderer as jren
from raytracing_c_tpu_torch.models.serialization import save_scene_cache
from raytracing_c_tpu_torch.parallel import launch
from raytracing_c_tpu_torch.parallel.mesh import make_mesh
from raytracing_c_tpu_torch.render import renderer as tren
from raytracing_c_tpu_torch.utils import rng as trng

import torch_ranks
from helpers import random_mesh, simple_scene
from torch_port_helpers import port_scene

WORLDS = (2, 8)
W, H = 16, 12
#: rounds down to 56 pixels a batch for 8 ranks and stays 60 for 2: four
#: batches, the last one padded
BATCH_PIXELS = 60
BASE = dict(spp=2, max_bounces=2, seed=5, batch_pixels=BATCH_PIXELS)
CASES = {"dense": dict(compact=False), "compact": dict(compact=True),
         "nee": dict(compact=False, nee=True)}
ROWS = 48


def _batch_px(n):
    return max(n, (BATCH_PIXELS // n) * n)


def _batch_case(n):
    """render_batch_sharded's case: the first batch of the compacted render,
    so JAX reuses that render's compiled program."""
    xs, ys, _ = tren._pixel_tables(W, H, 0)
    p = _batch_px(n)
    return dict(px=xs[:p], py=ys[:p], seed=3,
                kw=dict(width=W, height=H, spp=2, max_bounces=2, compact=True))


def _port_runs(scene_path):
    out = {}
    for n in WORLDS:
        renders = [dict(width=W, height=H, **BASE, **CASES[c]) for c in CASES]
        out[n] = launch.run_ranks(torch_ranks.sharding_cases, n, "gloo", ["cpu"] * n,
                                  scene_path, renders, _batch_case(n), ROWS)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages on every case: the port's ranks start in a thread while
    JAX compiles and renders."""
    js = simple_scene(random_mesh(200, np.random.default_rng(7)))
    ts = port_scene(js)
    path = str(tmp_path_factory.mktemp("sharding") / "scene.npz")
    save_scene_cache(path, ts)
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_runs, path)
        jax_out = {}
        for n in WORLDS:
            m = jmesh.make_mesh(jax.devices()[:n])
            renders = {c: jren.render(js, W, H, mesh=m, method="brute", **BASE, **CASES[c])
                       for c in CASES}
            case = _batch_case(n)
            rgb, rays = jren.render_batch_sharded(
                jmesh.shard_scene(js, m), jmesh.shard_rays(jnp.asarray(case["px"]), m),
                jmesh.shard_rays(jnp.asarray(case["py"]), m), jax.random.PRNGKey(case["seed"]),
                mesh=m, method="brute", **case["kw"])
            x = jmesh.shard_rays(jnp.arange(ROWS), m)
            idx = x.sharding.devices_indices_map(x.shape)
            blocks = [np.asarray(x)[idx[d]] for d in m.devices.flat]
            jax_out[n] = dict(renders=renders, batch=(np.asarray(rgb), float(rays)),
                              blocks=blocks)
        # the single-process render at the mesh's batch size (the batch
        # index keys the draws)
        single = {(n, c): tren.render(ts, W, H, **{**BASE, "batch_pixels": _batch_px(n)},
                                      **CASES[c]) for n in WORLDS for c in ("dense", "nee")}
        return dict(port=port.result(), jax=jax_out, single=single, scene=ts)


def _check_render(runs, n, case):
    img, rays, batches, digests = runs["port"][n]["renders"][list(CASES).index(case)]
    jimg, jst = runs["jax"][n]["renders"][case]
    assert img.shape == (H, W, 3) and img.std() > 0
    np.testing.assert_array_equal(img, jimg)
    assert rays == jst.rays_traced and batches == jst.batches == 4
    assert digests == [hashlib.sha256(img.tobytes()).hexdigest()] * n  # every rank's image
    return img, rays


@pytest.mark.parametrize("n", WORLDS)
def test_mesh_render_dense_matches_jax_and_single_process(runs, n):
    img, rays = _check_render(runs, n, "dense")
    simg, sst = runs["single"][n, "dense"]
    np.testing.assert_array_equal(img, simg)
    assert rays == sst.rays_traced


@pytest.mark.parametrize("n", WORLDS)
def test_mesh_render_compacted_matches_jax(runs, n):
    """Each rank's compacted trace keys its draws by local slot under
    fold_in(fold_in(kb, 1), rank), as each JAX shard does: exact."""
    _check_render(runs, n, "compact")


@pytest.mark.parametrize("n", WORLDS)
def test_mesh_render_nee_matches_jax_and_single_process(runs, n):
    img, rays = _check_render(runs, n, "nee")
    simg, sst = runs["single"][n, "nee"]
    np.testing.assert_array_equal(img, simg)
    assert rays == sst.rays_traced > runs["single"][n, "dense"][1].rays_traced  # shadow rays


@pytest.mark.parametrize("n", WORLDS)
def test_render_batch_sharded_matches_jax_per_shard(runs, n):
    """Rank k's rgb block is the k-th block of JAX's output; the rays are
    summed over the ranks."""
    jrgb, jrays = runs["jax"][n]["batch"]
    per = _batch_px(n) // n
    for k, (rgb, rays) in enumerate(runs["port"][n]["batch"]):
        np.testing.assert_array_equal(rgb, jrgb[k * per:(k + 1) * per])
        assert rays == jrays


@pytest.mark.parametrize("n", WORLDS)
def test_replicate_scene_gives_every_rank_rank_0s_scene(runs, n):
    assert runs["port"][n]["digests"] == [torch_ranks.scene_digest(runs["scene"])] * n


@pytest.mark.parametrize("n", WORLDS)
def test_shard_rays_gives_jaxs_blocks(runs, n):
    for k, (block, block2) in enumerate(runs["port"][n]["blocks"]):
        np.testing.assert_array_equal(block, runs["jax"][n]["blocks"][k])
        np.testing.assert_array_equal(block2, np.stack([block, -block]))


def test_render_batch_matches_jax():
    """The flat single-process batch (dense): rgb and rays exact."""
    js = simple_scene(random_mesh(200, np.random.default_rng(7)))
    ts = port_scene(js)
    px = np.arange(64, dtype=np.int32) % 16
    py = np.arange(64, dtype=np.int32) // 16
    kw = dict(width=16, height=16, spp=2, max_bounces=3)
    jrgb, jrays = jren.render_batch(js, jnp.asarray(px), jnp.asarray(py), jax.random.PRNGKey(3),
                                    method="brute", **kw)
    trgb, trays = tren.render_batch(ts, torch.from_numpy(px), torch.from_numpy(py),
                                    trng.prng_key(3), **kw)
    assert trgb.shape == (64, 3) and trgb.dtype == torch.uint8
    np.testing.assert_array_equal(trgb.numpy(), np.asarray(jrgb))
    assert int(trays) == float(jrays)


def test_a_rank_that_raises_fails_run_ranks():
    """Rank 1 raises while rank 0 waits in a barrier: the call raises with
    rank 1's error and returns nothing."""
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        launch.run_ranks(torch_ranks.raise_on_rank_1, 2, "gloo", ["cpu", "cpu"])


def test_make_mesh_has_no_fallback():
    """NCCL on the CPU is refused, and the default device (cuda:LOCAL_RANK)
    raises where there is no card, before any process group exists."""
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        make_mesh("nccl", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs CUDA"):
            make_mesh()
