"""The port's command-line renderer (cli.py) against the JAX package's.

parse_args must give the same config for every argv (exact). main() on the
CPU renders chip_smoke.py's stand-in as an OBJ (>64 triangles, so the BVH
path) with the env map at 32x32, 2 spp, 3 bounces; its output file must
equal the JAX CLI's (--method topk) or be >= 45 dB from it (the
cross-backend bound of test_golden.py:75; -D may differ by 1 u8 where
XLA sums the luminances in another order).
"""

import io

import numpy as np
import pytest

import chip_smoke
from raytracing_c_tpu import cli as jcli
from raytracing_c_tpu.utils.progress import ProgressBar as JaxProgressBar
from raytracing_c_tpu_torch import cli as tcli
from raytracing_c_tpu_torch.io.image_io import load_image_rgb_u8
from raytracing_c_tpu_torch.utils.progress import ProgressBar

from torch_port_helpers import psnr

ARGVS = [
    ["-W", "640", "-H", "480", "-S", "4", "-T", "3", "-B", "2", "model.obj", "-O", "out.qoi",
     "-V", "-D"],
    ["m.glb"],
    [],
    ["-W"],
    ["a.obj", "b.obj"],
    ["-X", "1", "a.obj"],
    ["--seed", "7", "--no-bg", "--brute-force", "a.obj", "--batch-pixels", "4096",
     "--tonemap", "aces"],
    ["--nearest", "a.obj"],
    ["--load-scene", "cache.npz"],
    ["--method", "topk", "a.obj"],
    ["--method", "bogus", "a.obj"],
    ["--tonemap", "filmic", "a.obj"],
    ["--bg", "sky.png", "--rr", "--nee", "--debug-normals", "--profile", "p", "a.gltf"],
    ["--save-scene", "s.npz", "a.obj", "--seed"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "empty")
def test_parse_args_matches_jax(argv):
    assert tcli.parse_args(list(argv)) == jcli.parse_args(list(argv))


@pytest.mark.parametrize("flag,method", [
    ([], "auto"), (["--brute-force"], "brute"), (["--method", "auto"], "auto"),
    (["--method", "brute"], "brute"), (["--method", "pallas_fused"], "bvh"),
    (["--method", "topk"], "bvh"), (["--method", "dfs"], "bvh"),
    (["--brute-force", "--method", "pallas"], "bvh"),
])
def test_method_names_map_to_the_port(flag, method):
    assert tcli.render_method(tcli.parse_args([*flag, "a.obj"])) == method


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    chip_smoke.write_obj_mtl(str(d), n=6, tex=32)
    chip_smoke.write_env_map(str(d / "background.png"), 64, 32)
    return d


@pytest.mark.parametrize("denoise", [False, True])
def test_main_matches_jax_cli(model_dir, monkeypatch, denoise):
    monkeypatch.chdir(model_dir)
    args = ["-W", "32", "-H", "32", "-S", "2", "-B", "3", *(["-D"] if denoise else [])]
    assert jcli.main([*args, "--method", "topk", "-O", "jax.png", "standin.obj"]) == 0
    assert tcli.main([*args, "-O", "port.png", "standin.obj"], device="cpu") == 0
    want, got = load_image_rgb_u8("jax.png"), load_image_rgb_u8("port.png")
    assert got.shape == (32, 32, 3) and got.std() > 5.0
    assert (got == want).all() or psnr(got, want) >= 45.0
    assert len(np.unique(got[:4].reshape(-1, 3), axis=0)) > 1  # the env map's sky


def test_main_nee_matches_jax_cli(model_dir, monkeypatch, capsys):
    """--nee with the env map: the port's image equals the JAX CLI's or is
    >= 45 dB from it, and -V reports the env table's build."""
    monkeypatch.chdir(model_dir)
    args = ["-W", "32", "-H", "24", "-S", "2", "-B", "3", "--nee"]
    assert jcli.main([*args, "--method", "topk", "-O", "jax_nee.png", "standin.obj"]) == 0
    capsys.readouterr()
    assert tcli.main([*args, "-V", "-O", "port_nee.png", "standin.obj"], device="cpu") == 0
    assert "Env light table built in" in capsys.readouterr().out
    want, got = load_image_rgb_u8("jax_nee.png"), load_image_rgb_u8("port_nee.png")
    assert got.shape == (24, 32, 3) and got.std() > 5.0
    assert (got == want).all() or psnr(got, want) >= 45.0


def test_main_save_then_load_scene(model_dir, monkeypatch, capsys):
    """--save-scene writes the scene after --debug-normals (the JAX CLI's
    order), so --load-scene of that cache renders what the direct run did;
    the JAX CLI loads the port's cache and renders the same image."""
    monkeypatch.chdir(model_dir)
    args = ["-W", "24", "-H", "16", "-S", "1", "-B", "2"]
    assert tcli.main([*args, "--debug-normals", "-V", "--save-scene", "dbg.npz", "-O",
                      "direct.png", "standin.obj"], device="cpu") == 0
    assert "scene cache written to dbg.npz" in capsys.readouterr().out
    assert tcli.main([*args, "--load-scene", "dbg.npz", "-O", "cached.png"], device="cpu") == 0
    assert jcli.main([*args, "--method", "topk", "--load-scene", "dbg.npz", "-O",
                      "jax_cached.png"]) == 0
    direct = load_image_rgb_u8("direct.png")
    np.testing.assert_array_equal(load_image_rgb_u8("cached.png"), direct)
    jax_img = load_image_rgb_u8("jax_cached.png")
    assert (jax_img == direct).all() or psnr(jax_img, direct) >= 45.0
    assert direct.std() > 5.0


def test_main_writes_qoi_and_ppm(model_dir, monkeypatch):
    monkeypatch.chdir(model_dir)
    args = ["-W", "16", "-H", "8", "-S", "1", "-B", "2", "--no-bg", "standin.obj"]
    assert tcli.main([*args, "-O", "a.png"], device="cpu") == 0
    assert tcli.main([*args, "-O", "a.ppm"], device="cpu") == 0
    assert tcli.main([*args, "-O", "a.qoi"], device="cpu") == 0
    png = load_image_rgb_u8("a.png")
    ppm = np.frombuffer((model_dir / "a.ppm").read_bytes()[-png.size:], np.uint8)
    np.testing.assert_array_equal(ppm.reshape(png.shape), png)
    from raytracing_c_tpu_torch.io.image_io import qoi_decode

    np.testing.assert_array_equal(qoi_decode((model_dir / "a.qoi").read_bytes()), png)


@pytest.mark.parametrize("flags", [["--nee"], ["--save-scene", "s.npz"],
                                   ["--load-scene", "s.npz"]])
def test_not_ported_flags_exit_1(model_dir, monkeypatch, capsys, flags):
    """The three flags that once exited 1 ("not ported yet") now run and
    exit 0 (--load-scene reads a cache written first by --save-scene)."""
    monkeypatch.chdir(model_dir)
    args = ["-W", "8", "-H", "8", "-S", "1", "-B", "2", "-O", "f.png"]
    if flags[0] == "--load-scene":
        assert tcli.main([*args, "--save-scene", "s.npz", "standin.obj"], device="cpu") == 0
    assert tcli.main([*args, *flags, "standin.obj"], device="cpu") == 0
    assert "not ported" not in capsys.readouterr().err
    assert load_image_rgb_u8("f.png").shape == (8, 8, 3)


def test_missing_env_map_exits_1(tmp_path, model_dir, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert tcli.main(["-W", "8", "-H", "8", str(model_dir / "standin.obj")], device="cpu") == 1
    assert "Failed to load texture: 'background.png'" in capsys.readouterr().err


def test_usage_error_exits_1(capsys):
    assert tcli.main(["-W"], device="cpu") == 1
    assert "-W <width>" in capsys.readouterr().err


def test_profile_writes_chrome_trace(model_dir, monkeypatch):
    monkeypatch.chdir(model_dir)
    assert tcli.main(["-W", "8", "-H", "8", "-S", "1", "-B", "1", "--no-bg", "--profile",
                      "prof", "-O", "p.png", "standin.obj"], device="cpu") == 0
    assert (model_dir / "prof" / "trace.json").stat().st_size > 0


def test_progress_bar_matches_jax():
    a, b = io.StringIO(), io.StringIO()
    port, ref = ProgressBar(interval_s=0.0, stream=a), JaxProgressBar(interval_s=0.0, stream=b)
    for done in (1, 2, 5):
        port(done, 5)
        ref(done, 5)
    port.finish()
    ref.finish()
    assert a.getvalue() == b.getvalue()
