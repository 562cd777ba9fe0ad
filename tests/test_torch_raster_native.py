"""The lightmap bake's native rasterizer (native/raster.c, through
render/lightmap.py:_rasterize) against its plain numpy version
(`_rasterize_plain`): every record byte for byte and in order, and the
four counts, on the padded soup, on both UV sources, on UVs that stress
the box, the cast, the skip and the overwrite order, and on positions
whose float32 rounding the order of the float64 arithmetic decides. Also the
loader's argument checks and the `rasterize` span's `kernel` note."""

import numpy as np
import pytest

from raytracing_c_tpu_torch.models import scene as ps
from raytracing_c_tpu_torch.native import raster_native
from raytracing_c_tpu_torch.render import lightmap as tlm
from raytracing_c_tpu_torch.utils import spans

from helpers import random_mesh, simple_scene
from torch_port_helpers import port_scene


def _scene(mesh):
    """mesh on the CPU under a small seeded env map, one grey material."""
    env = np.random.default_rng(3).integers(0, 256, (8, 16, 3), dtype=np.uint8)
    return ps.build_scene(mesh, ps.MaterialTable.default(1), ps.TextureAtlas.pack([env]),
                          ps.Background.equirect(1), ps.Camera.default(), device="cpu")


def _soup(n, seed, lightmap_uvs=None):
    """n random triangles; lightmap_uvs (n, 3, 2), or None for none."""
    j = random_mesh(n, np.random.default_rng(seed))
    return ps.HostMesh(j.positions, j.normals, j.uvs, j.mat_id,
                       lightmap_uvs=None if lightmap_uvs is None
                       else np.asarray(lightmap_uvs, np.float32))


def _with_uvs(uvs):
    """A soup of len(uvs) triangles whose lightmap UV set is `uvs`."""
    return _scene(_soup(len(uvs), 11, uvs))


def _padded_soup():
    return port_scene(simple_scene(random_mesh(100, np.random.default_rng(5)),
                                   bg=(0.9, 0.8, 0.7)))


def _lightmap_set():
    return _scene(_soup(100, 9, np.random.default_rng(10).uniform(0, 1, (100, 3, 2))))


def _texture_set():
    m = _soup(100, 9, np.random.default_rng(10).uniform(0, 1, (100, 3, 2)))
    return _scene(ps.HostMesh(m.positions, m.normals, m.uvs, m.mat_id))


def _outside():
    """UVs beyond [0, 1] and below 0: trunc goes toward zero, so a box
    from -0.7 starts at texel 0 and one from -1.3 at -1 (clamped)."""
    rnd = np.random.default_rng(12)
    uvs = rnd.uniform(-1.5, 2.5, (60, 3, 2))
    uvs[:10] = rnd.uniform(-0.2, 0.05, (10, 3, 2))  # just below zero
    uvs[10:20] = rnd.uniform(-3.0, -1.0, (10, 3, 2))  # wholly below zero: empty boxes
    uvs[20:30] = rnd.uniform(1.0, 4.0, (10, 3, 2))  # wholly beyond 1
    return _with_uvs(uvs)


def _clipped():
    """A triangle over each edge and each corner of the atlas, and one
    over the whole of it."""
    tris = [[(-0.3, 0.3), (0.2, 0.4), (0.1, 0.7)],  # left
            [(0.8, 0.3), (1.4, 0.5), (0.9, 0.6)],  # right
            [(0.3, -0.4), (0.7, 0.1), (0.4, 0.2)],  # bottom
            [(0.3, 0.8), (0.6, 1.5), (0.5, 0.9)],  # top
            [(-0.2, -0.2), (0.3, 0.05), (0.05, 0.3)],  # the four corners
            [(1.2, -0.2), (0.7, 0.05), (0.95, 0.3)],
            [(-0.2, 1.2), (0.3, 0.95), (0.05, 0.7)],
            [(1.2, 1.2), (0.7, 0.95), (0.95, 0.7)],
            [(-1.0, -1.0), (3.0, -1.0), (-1.0, 3.0)]]
    return _with_uvs(np.array(tris))


def _degenerate():
    """Zero-area, collinear, NaN and infinite UVs among sound triangles:
    the first three kinds are skipped before any cast."""
    rnd = np.random.default_rng(13)
    uvs = rnd.uniform(0, 1, (40, 3, 2))
    uvs[0] = 0.5  # one point
    uvs[1] = [(0.1, 0.1), (0.5, 0.5), (0.9, 0.9)]  # collinear
    uvs[2] = [(0.1, 0.1), (0.1, 0.1), (0.9, 0.2)]  # two vertices shared
    uvs[3, 1, 0] = np.nan
    uvs[4, :, 1] = np.nan
    uvs[5, 2] = (np.inf, 0.5)
    uvs[6, 0] = (-np.inf, -np.inf)
    uvs[7, 0, 0] = 1e30  # beyond int64 once scaled
    uvs[8, 1] = (-1e30, 0.3)
    uvs[9] = [(0.2, 0.2), (0.2 + 1e-12, 0.2), (0.2, 0.2 + 1e-12)]  # |denom| < 1e-20
    return _with_uvs(uvs)


def _overlapping():
    """Large triangles over one another, so most texels are written by
    several slots and the last write decides."""
    rnd = np.random.default_rng(14)
    return _with_uvs(0.5 + rnd.uniform(-0.45, 0.45, (30, 3, 2)))


def _nothing_written():
    """A triangle inside one texel, between the texel points (its box is
    one candidate), and zero-area ones: no record."""
    uvs = np.zeros((6, 3, 2))
    uvs[0] = [(0.1 / 24, 0.1 / 16), (0.9 / 24, 0.1 / 16), (0.1 / 24, 0.9 / 16)]
    return _with_uvs(uvs)


def _random_small(n=3000):
    """n triangles of up to a few texels each, anywhere in a 512^2 atlas."""
    rnd = np.random.default_rng(15)
    centre = rnd.uniform(0, 1, (n, 1, 2))
    return _with_uvs(centre + rnd.normal(0, 3.0 / 512, (n, 3, 2)))


def _ties(n=600):
    """Weights of 1/2 at a row or column of texels against weights in
    thirds to fourteenths, and the vertex of that weight one float32 ulp
    from the others along x: the exact position there is a float32
    rounding tie, so the order of the float64 arithmetic decides it."""
    rnd = np.random.default_rng(16)
    tie = rnd.integers(1, 3, n)  # the vertex whose weight is 1/2 somewhere
    k = np.where(tie == 1, rnd.integers(3, 10, n), rnd.choice([6, 10, 12, 14], n))
    shape = np.zeros((n, 3, 2))
    shape[:, 1, 0] = 2.0  # w1 = x / 2
    shape[:, 2, 1] = k  # w2 = y / k
    uv = (rnd.integers(0, 48, (n, 1, 2)) + shape) / 64.0
    p0 = rnd.uniform(1.0, 2.0, (n, 3)).astype(np.float32)
    pos = np.stack([p0, p0, p0], axis=1)
    pos[np.arange(n), tie, 0] = np.nextafter(p0[:, 0], np.float32(3.0))
    flip = rnd.random(n) < 0.5  # the other winding: a negative denominator
    uv[flip], pos[flip] = uv[flip][:, ::-1], pos[flip][:, ::-1]
    return _scene(ps.HostMesh(pos, pos.copy(), np.zeros((n, 3, 2), np.float32),
                              np.zeros(n, np.int32), lightmap_uvs=uv.astype(np.float32)))


CASES = {
    "padded_soup_24x16": (_padded_soup, 24, 16),
    "padded_soup_16x16": (_padded_soup, 16, 16),
    "padded_soup_7x5": (_padded_soup, 7, 5),
    "lightmap_uv_set": (_lightmap_set, 24, 16),
    "texture_uvs": (_texture_set, 24, 16),
    "outside_and_negative": (_outside, 24, 16),
    "clipped_at_every_edge": (_clipped, 20, 13),
    "degenerate_and_nan": (_degenerate, 24, 16),
    "overlapping": (_overlapping, 32, 32),
    "nothing_written": (_nothing_written, 24, 16),
    "random_3000_at_512": (_random_small, 512, 512),
    "float32_ties": (_ties, 64, 64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_native_rasterize_equals_plain(case):
    make, w, h = CASES[case]
    scene = make()
    got = tlm._rasterize(scene, w, h)
    with np.errstate(invalid="ignore", over="ignore"):  # the plain casts of NaN and inf
        want = tlm._rasterize_plain(scene, w, h)
    for field in ("index", "position", "normal", "slot"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field
    counts = ("triangles", "candidates", "covered", "overwritten")
    assert [getattr(got, c) for c in counts] == [getattr(want, c) for c in counts]
    if case == "nothing_written":
        assert len(got) == 0 and got.candidates == 1
    elif case == "overlapping":
        assert got.overwritten > got.covered // 2
    elif case == "random_3000_at_512":
        assert len(got) > 10_000 and got.triangles == 3000


def _arrays(n=4):
    rnd = np.random.default_rng(0)
    f = lambda *s: rnd.uniform(0, 1, s).astype(np.float32)  # noqa: E731
    return dict(uv=f(n, 3, 2), v0=f(n, 3), e1=f(n, 3), e2=f(n, 3), n0=f(n, 3), n1=f(n, 3),
                n2=f(n, 3), slots=np.arange(n, dtype=np.int64))


@pytest.mark.parametrize("field,bad", [
    ("uv", lambda a: a.astype(np.float64)),  # dtype
    ("uv", lambda a: a.reshape(-1, 6)),  # shape
    ("v0", lambda a: np.asfortranarray(a)),  # contiguity
    ("n2", lambda a: a[:-1]),  # length
    ("slots", lambda a: a.astype(np.int32)),
    ("e1", lambda a: np.ascontiguousarray(a[:, :2])),
])
def test_native_rasterize_rejects_other_arrays(field, bad):
    args = _arrays()
    args[field] = bad(args[field])
    with pytest.raises(ValueError, match="raster"):
        raster_native().rasterize(width=8, height=8, **args)


def test_native_rasterize_rejects_an_empty_atlas():
    with pytest.raises(ValueError, match="raster"):
        raster_native().rasterize(width=0, height=8, **_arrays())


def test_rasterize_span_notes_the_native_kernel():
    scene = _lightmap_set()
    spans.enable()
    try:
        texels = tlm.rasterize(scene, 24, 16)
        recs = spans.collect()
    finally:
        spans.disable()
    ras = [r for r in recs if r["name"] == "rasterize"]
    assert len(ras) == 1
    assert ras[0]["attrs"] == dict(kernel="native", candidates=texels.candidates,
                                   texels=texels.covered, overwritten=texels.overwritten)
