"""The port's BVH inspector (raytracing_c_tpu_torch/tools/bvh_viz.py)
against the JAX package's (tools/bvh_viz.py), on the CPU.

The same mesh is built by each package (both splitters). Tolerance: the
OBJ dump byte-identical, the snapshot's pixels identical, the line
rasterizer's pixels identical to PIL.ImageDraw.line's, and the printed
lines equal. The overlay's wireframe pixels are equal and the whole image
is at least 45 dB from the JAX tool's (the cross-backend bound of
test_golden.py:75): XLA fuses the JAX package's ray-triangle test on the
CPU and rounds it apart from the port's, so the renders under the
wireframes are not byte-equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

import chip_smoke
from raytracing_c_tpu.models import bvh as jbvh
from raytracing_c_tpu_torch.io.image_io import load_image_rgb_u8
from raytracing_c_tpu_torch.models import scene as ps
from raytracing_c_tpu_torch.models import serialization
from raytracing_c_tpu_torch.tools import bvh_viz as tviz

from helpers import random_mesh, simple_scene
from torch_port_helpers import port_mesh, psnr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import bvh_viz as jviz  # noqa: E402  (the JAX package's tool)


def _scenes(mesh, sah, monkeypatch):
    """(JAX scene, port scene) of one mesh, each built by its own package
    with the given splitter."""
    monkeypatch.setattr(jbvh, "SAH_DEFAULT", sah)
    js = simple_scene(mesh)
    ts = ps.build_scene(port_mesh(mesh), ps.MaterialTable.default(1), ps.TextureAtlas.empty(),
                        ps.Background.constant((0.5, 0.6, 0.7)), ps.Camera.default(),
                        device="cpu", sah=sah)
    return js, ts


@pytest.mark.parametrize("sah", [False, True], ids=["midpoint", "sah"])
@pytest.mark.parametrize("n,depth", [(200, 2), (2000, 3)])
def test_dump_obj_bytes_equal_jax(tmp_path, monkeypatch, n, depth, sah):
    js, ts = _scenes(random_mesh(n, np.random.default_rng(n)), sah, monkeypatch)
    assert ts.bvh.depth == js.bvh.depth == depth
    for a, b in zip(ts.bvh.child_boxes_np(), js.bvh.child_boxes_np()):
        np.testing.assert_array_equal(a, b)
    stats_t = tviz.dump_bvh_obj(ts, str(tmp_path / "t.obj"))
    stats_j = jviz.dump_bvh_obj(js, str(tmp_path / "j.obj"))
    assert stats_t == stats_j
    assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()


def test_bvh_dump_obj(tmp_path, rng, monkeypatch):
    """test_tools.py:test_bvh_dump_obj on the port's scene."""
    _, scene = _scenes(random_mesh(200, rng), False, monkeypatch)
    out = str(tmp_path / "bvh.obj")
    stats = tviz.dump_bvh_obj(scene, out)
    assert os.path.exists(out)
    assert set(stats) == set(range(scene.bvh.depth))
    assert 0 < stats[0] <= 8
    text = open(out).read()
    assert "o level_0" in text and "l " in text and "v " in text
    n_boxes = sum(stats.values())
    assert text.count("\nv ") == n_boxes * 8
    assert text.count("\nl ") == n_boxes * 12


def test_snapshot_pixels_equal_jax(tmp_path, rng, monkeypatch, capsys):
    js, ts = _scenes(random_mesh(200, rng), False, monkeypatch)
    jviz.interactive(js, snapshot=str(tmp_path / "j.png"))
    said_j = capsys.readouterr().out.replace("j.png", "x.png")
    tviz.interactive(ts, snapshot=str(tmp_path / "t.png"))
    said_t = capsys.readouterr().out.replace("t.png", "x.png")
    a = load_image_rgb_u8(str(tmp_path / "t.png"))
    b = np.asarray(Image.open(tmp_path / "j.png"))
    assert a.shape == b.shape == (512, 512, 3)
    np.testing.assert_array_equal(a, b)
    assert (a > 0).mean() > 0.001
    assert said_t == said_j


def test_line_pixels_equal_pillow():
    """~200 seeded float segments, drawn one at a time, with endpoints off
    the image on every side, negative endpoints, single points, and
    horizontal, vertical and diagonal lines."""
    rng = np.random.default_rng(7)
    w, h = 48, 40
    segs = rng.uniform(-60.0, 110.0, (200, 4))
    segs[:40] = rng.uniform(0.0, 40.0, (40, 4))  # inside the image
    segs[40:60, 2:] = segs[40:60, :2] + rng.uniform(-1.5, 1.5, (20, 2))  # short
    segs[60:70, 3] = segs[60:70, 1]  # horizontal
    segs[70:80, 2] = segs[70:80, 0]  # vertical
    segs[80:90, 2:] = segs[80:90, :2] + rng.uniform(-30, 30, (10, 1))  # diagonal
    segs[90:100] = -rng.uniform(0.1, 20.0, (10, 4))  # negative, near the corner
    for s in segs:
        im = Image.new("L", (w, h))
        ImageDraw.Draw(im).line(tuple(float(v) for v in s), fill=255)
        got = np.zeros((h, w), bool)
        got[tviz._line_pixels(s[None], w, h)] = True
        np.testing.assert_array_equal(got, np.asarray(im) > 0, err_msg=str(s))
    # all at once equals the union of the single segments
    im = Image.new("L", (w, h))
    draw = ImageDraw.Draw(im)
    for s in segs:
        draw.line(tuple(float(v) for v in s), fill=255)
    got = np.zeros((h, w), bool)
    got[tviz._line_pixels(segs, w, h)] = True
    np.testing.assert_array_equal(got, np.asarray(im) > 0)


def test_overlay_levels_match_jax(tmp_path, rng, monkeypatch, capsys):
    size = 64
    js, ts = _scenes(random_mesh(200, rng), False, monkeypatch)
    jviz.overlay_levels(js, str(tmp_path / "j"), size)
    said_j = capsys.readouterr().out.replace(str(tmp_path / "j"), "x")
    tviz.overlay_levels(ts, str(tmp_path / "t"), size)
    said_t = capsys.readouterr().out.replace(str(tmp_path / "t"), "x")
    assert said_t == said_j
    assert said_t.splitlines() == [f"x_level{d}.png: {n} boxes" for d, n in
                                   tviz.dump_bvh_obj(ts, str(tmp_path / "t.obj")).items()]
    drawn = 0
    for d, (segs, _) in enumerate(tviz._overlay_segments(ts, size)):
        a = load_image_rgb_u8(str(tmp_path / f"t_level{d}.png"))
        b = np.asarray(Image.open(tmp_path / f"j_level{d}.png"))
        assert a.shape == b.shape == (size, size, 3)
        mask = np.zeros((size, size), bool)
        mask[tviz._line_pixels(segs, size, size)] = True
        color = tviz.LEVEL_COLORS[d]
        assert (a[mask] == color).all() and (b[mask] == color).all()
        assert (a == b).all() or psnr(a, b) >= 45.0
        drawn += int(mask.sum())
    assert drawn > size


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("bvh_viz_models")
    glb = str(d / "standin.glb")
    chip_smoke.write_glb(glb, n=6, tex=32)
    npz = str(d / "standin.npz")
    serialization.save_scene_cache(npz, tviz._load(glb, "cpu"))
    return {"glb": glb, "npz": npz}


@pytest.mark.parametrize("form", ["dump", "overlay", "snapshot"])
@pytest.mark.parametrize("model", ["glb", "npz"])
def test_main_prints_jax_tool_lines(models, tmp_path, monkeypatch, capsys, model, form):
    """main(argv, device="cpu") in each argv form prints the JAX tool's
    lines and writes what it writes."""
    monkeypatch.setattr(jviz, "_ensure_backend", lambda: None)  # JAX is on the CPU here
    argv = {"dump": ["out.obj"], "overlay": ["--overlay", "ov", "32"],
            "snapshot": ["--interactive", "--snapshot", "snap.png"]}[form]
    said = {}
    for name, run in (("jax", jviz.main), ("port", lambda a: tviz.main(a, device="cpu"))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        run([models[model], *argv])
        said[name] = capsys.readouterr().out
    assert said["port"] == said["jax"] and said["port"]
    j, t = tmp_path / "jax", tmp_path / "port"
    if form == "dump":
        assert said["port"].startswith("wrote out.obj: depth=")
        assert (t / "out.obj").read_bytes() == (j / "out.obj").read_bytes()
    elif form == "snapshot":
        np.testing.assert_array_equal(load_image_rgb_u8(str(t / "snap.png")),
                                      np.asarray(Image.open(j / "snap.png")))
    else:
        for line in said["port"].splitlines():
            png = line.split(":")[0]
            a, b = load_image_rgb_u8(str(t / png)), np.asarray(Image.open(j / png))
            assert a.shape == (32, 32, 3) and ((a == b).all() or psnr(a, b) >= 45.0)


def test_main_runs_on_the_gpu_unless_asked(models):
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU machine's refusal; a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tviz.main([models["npz"], "out.obj"])


def test_tool_imports_no_jax_or_pillow(tmp_path):
    """Importing the port's tool and running its three forms loads neither
    jax, the JAX package nor Pillow."""
    obj = tmp_path / "quad.obj"
    obj.write_text("v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nf 1 2 3 4\n")
    code = (
        "import sys\n"
        "from raytracing_c_tpu_torch.tools import bvh_viz\n"
        f"bvh_viz.main([{str(obj)!r}, 'out.obj'], device='cpu')\n"
        f"bvh_viz.main([{str(obj)!r}, '--overlay', 'ov', '16'], device='cpu')\n"
        f"bvh_viz.main([{str(obj)!r}, '--interactive', '--snapshot', 's.png'], device='cpu')\n"
        "bad = [m for m in sys.modules if m in ('jax', 'PIL', 'raytracing_c_tpu')"
        " or m.startswith(('jax.', 'PIL.', 'raytracing_c_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("wrote out.obj: depth=1, level 0: 1 boxes")
    assert lines[-1] == "ok"


def test_phase12_on_cpu(capsys):
    """chip_smoke.phase12_bvh_viz on a small stand-in on the CPU: the dump
    equals the CPU build's and the node rows' counts, every overlay level
    equals a direct render outside its wireframe, the snapshot is lit; the
    two failures are that no kernel launched (the CPU runs the plain
    versions) and that `python -m` refuses to run without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU machine's refusal; a GPU is present")
    scene = chip_smoke.procedural_scene(ps, np, torch, "cpu", n=10, tex=16)
    zero = {"bvh_traverse": 0, "bvh_traverse_wide": 0, "fetch_attrs": 0, "denoise_u8": 0}
    failures = []
    launches = chip_smoke.phase12_bvh_viz(np, torch, ps, scene, lambda: None,
                                          lambda: dict(zero), failures, n=10, size=64)
    assert launches == zero
    assert failures == ["phase 12 launches", "phase 12 python -m"]
    said = capsys.readouterr().out
    assert said.count(" ok\n") == 2 + scene.bvh.depth  # the dump, each level, the snapshot
    assert "needs CUDA" in said
