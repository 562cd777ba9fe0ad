"""The port's 16-spp parity references (tests/goldens_torch16/) and the
gate that holds the port to them (chip_smoke.py phase 11), on the CPU.

The references are files rendered by the JAX package
(tools/make_torch_parity_refs.py), so no JAX runs here. Checked:
(a) chip_smoke's writers, run with the manifest's parameters, reproduce
every scene file's sha256; (b) every reference decodes through the port's
codec to the manifest's shape, and the recorded floor equals PSNR(ref,
alt) recomputed; (c) the gate's own functions on the CPU hold every case
to its JAX reference at the gate's bound (PSNR >= 45 dB), glb_normals and
glb_env with at least 99% of their pixels byte-equal, and phase11_parity
reads the manifest, checks the scene and reports each case.

Not bit for bit: XLA fuses the JAX package's Moller-Trumbore on the CPU
and rounds its t, u and v differently from the same ops run one at a time,
which the port equals bit for bit. At 128x128 and 16 spp a few hits tie
or cross a u8 step apart: 2 of glb_normals' 16,384 pixels (92 dB), 35 of
glb_env's (67 dB).
"""

import json
import os

import numpy as np
import pytest

import chip_smoke
from raytracing_c_tpu_torch.io.image_io import load_image_rgb_u8

with open(os.path.join(chip_smoke.PARITY_DIR, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


def _load(name):
    path = os.path.join(chip_smoke.PARITY_DIR, name)
    return np.load(path) if name.endswith(".npy") else load_image_rgb_u8(path)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("parity_scene")
    return str(d), chip_smoke.write_parity_scene(str(d))


def test_scene_files_hash_to_manifest(scene_dir):
    _, sha = scene_dir
    assert MANIFEST["scene"]["writers"] == chip_smoke.PARITY_SCENE
    assert sha == MANIFEST["scene"]["sha256"]
    assert {"standin.glb", "standin.obj", "standin.mtl", "env.png"} <= set(sha)


def test_manifest_holds_every_case():
    assert list(MANIFEST["cases"]) == list(chip_smoke.PARITY_CASES)
    assert MANIFEST["seeds"] == list(chip_smoke.PARITY_SEEDS) == [42, 43]
    assert MANIFEST["bound_db"] == chip_smoke.PSNR_MIN == 45.0


@pytest.mark.parametrize("case", list(chip_smoke.PARITY_CASES))
def test_reference_decodes_to_manifest(case):
    meta = MANIFEST["cases"][case]
    spec = chip_smoke.PARITY_CASES[case]
    assert {k: meta[k] for k in spec} == spec
    names = [chip_smoke.parity_file(case, s) for s in chip_smoke.PARITY_SEEDS]
    assert meta["files"] == names
    ref, alt = (_load(n) for n in names)
    assert list(ref.shape) == list(alt.shape) == meta["shape"]
    assert str(ref.dtype) == str(alt.dtype) == meta["dtype"]
    assert np.isfinite(ref.astype(np.float64)).all() and ref.std() > 0
    floor = chip_smoke.parity_psnr(np, alt, ref)
    assert floor == pytest.approx(meta["floor_db"], abs=1e-3)
    # another seed's render fails the gate: a wrong RNG stream would too
    assert floor < chip_smoke.PSNR_MIN
    assert len(meta["jax_wall_s"]) == 2 and min(meta["jax_wall_s"]) > 0
    # the camera launch holds 128 x 128 x 16 = 262,144 rays (K1's one-thread
    # kernel runs bounce 0 on the card)
    kw = spec.get("kwargs", {})
    if spec["entry"] == "cli":
        argv = spec["argv"]
        w, h, spp = (int(argv[argv.index(f) + 1]) for f in ("-W", "-H", "-S"))
        assert w * h * spp >= 131_072 and spp == 16
    elif spec["entry"] == "render":
        assert kw["width"] * kw["height"] * kw["spp"] >= 131_072 and kw["spp"] == 16
    else:
        assert kw["samples"] == 16


#: cases whose CPU render must also be byte-equal to the reference in this
#: share of pixels
BYTE_EQUAL_MIN = {"glb_normals": 0.99, "glb_env": 0.99}


@pytest.mark.parametrize("case", list(chip_smoke.PARITY_CASES))
def test_gate_on_cpu_holds_jax_reference(case, scene_dir, tmp_path):
    d, _ = scene_dir
    got = chip_smoke.run_parity_case(case, d, chip_smoke.PARITY_SEEDS[0], str(tmp_path),
                                     device="cpu")
    ref = _load(chip_smoke.parity_file(case, chip_smoke.PARITY_SEEDS[0]))
    assert got.shape == ref.shape and got.dtype == ref.dtype and got.std() > 0
    assert chip_smoke.parity_psnr(np, got, ref) >= chip_smoke.PSNR_MIN
    if case in BYTE_EQUAL_MIN:
        assert (got == ref).all(-1).mean() >= BYTE_EQUAL_MIN[case]


def test_phase11_on_cpu_reports_each_case(monkeypatch):
    """phase11_parity itself, cut to glb_normals (rendered twice): the
    scene hashes as the manifest's, the case passes the gate and renders
    the same bytes twice, and the one failure is that no kernel launched
    (the CPU runs the plain versions)."""
    monkeypatch.setattr(chip_smoke, "PARITY_CASES",
                        {"glb_normals": chip_smoke.PARITY_CASES["glb_normals"]})
    monkeypatch.setattr(chip_smoke, "PARITY_TWICE", ("glb_normals",))
    failures = []
    zero = {"bvh_traverse": 0, "bvh_traverse_wide": 0, "fetch_attrs": 0, "denoise_u8": 0}
    rec, launches = chip_smoke.phase11_parity(np, lambda: None, lambda: dict(zero), failures,
                                              device="cpu")
    assert failures == ["phase 11 launches"] and launches == zero
    got = rec["cases"]["glb_normals"]
    assert got["psnr_db"] >= chip_smoke.PSNR_MIN and got["byte_equal"] >= 0.99
    assert got["twice_identical"] and got["ok"]
    assert got["floor_db"] == MANIFEST["cases"]["glb_normals"]["floor_db"]
