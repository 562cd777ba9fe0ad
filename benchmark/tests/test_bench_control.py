"""The output check fails what it must: the control (the reference in
bfloat16 in the program's place) and the faults a render can have, each
planted underneath the timed path of a whole run.

CPU tests run each cell at a small size. The `cuda` test runs the control
at each cell's own size on three seeds and prints its readings, beside
those of a sound variant, the reference computed in float64 in the
program's place, which has to pass:

    python -m pytest --noconftest -p no:cacheprovider -s -m cuda \
        benchmark/tests/test_bench_control.py
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from bench_helpers import CELLS, small_run
from harness import runner

CONTROL_SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


def _fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_small(cell):
    run = small_run(cell, 5)
    run.entry.make_inputs(run)
    run.frames = [{"seed": runner.frame_seed(run.seed, 0)}]
    assert _fails(runner.check_outputs(run, torch.bfloat16), run.spec["limits"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_variant_passes_small(cell):
    """The reference in float64 in the program's place rounds otherwise
    and is sound: it passes."""
    run = small_run(cell, 5)
    run.entry.make_inputs(run)
    run.frames = [{"seed": runner.frame_seed(run.seed, 0)}]
    assert not _fails(runner.check_outputs(run, torch.float64), run.spec["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in CONTROL_SEEDS:
        t0 = time.perf_counter()
        run = runner.Run(cell, seed, 0.0, False, "cuda:0", t0)
        run.entry.make_inputs(run)
        run.frames = [{"seed": runner.frame_seed(seed, 0)}]
        numbers = runner.check_outputs(run, torch.bfloat16)
        t1 = time.perf_counter()
        print(f"control {cell} seed {seed}: {numbers} ({t1 - t0:.1f} s)", flush=True)
        variant = runner.check_outputs(run, torch.float64)
        print(f"float64 variant {cell} seed {seed}: {variant} "
              f"({time.perf_counter() - t1:.1f} s)", flush=True)
        assert _fails(numbers, run.spec["limits"])
        assert not _fails(variant, run.spec["limits"])


def _state_unchanged(mp, run):
    """Every bounce returns the state it was given."""
    from raytracing_c_tpu_torch.render import integrator

    mp.setattr(integrator, "bounce_step", lambda scene, st, *a, **k: st)


def _half_samples(mp, run):
    """Half of each pixel's samples left out, the mean over the rest: the
    second half of its samples replaced by the first."""
    from raytracing_c_tpu_torch.render import integrator

    spp = run.entry.frame_params(run)["spp"]
    original = integrator.trace_bucketed

    def traced(*a, **k):
        rad, rays = original(*a, **k)
        for c in (rad.x, rad.y, rad.z):
            s = c.view(-1, spp)
            s[:, spp // 2:] = s[:, :spp // 2]
        return rad, rays

    mp.setattr(integrator, "trace_bucketed", traced)


def _answer_altered(mp, run):
    """One pixel of each 32x32 tile altered in the frame the entry hands
    back: by render()'s u8 encode (the first pixel of each batch as well),
    or in the image the CLI writes."""
    from raytracing_c_tpu_torch.io import image_io
    from raytracing_c_tpu_torch.utils import color

    encode = color.encode_u8
    write = image_io.write_image

    def encoded(rgb):
        out = encode(rgb)
        out[::1024] ^= 0x80
        return out

    def written(path, img, **k):
        img = np.array(img)
        img[16::32, 16::32] ^= 0x80
        return write(path, img, **k)

    mp.setattr(color, "encode_u8", encoded)
    mp.setattr(image_io, "write_image", written)


FAULTS = {"state_unchanged": _state_unchanged, "half_samples": _half_samples,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_under_the_timed_path_makes_the_run_incorrect(cell, fault, monkeypatch):
    """The whole run (set-up, window, check), without the harness's look
    for a card, with the fault planted after set-up: correct is false."""
    run = small_run(cell, 9)
    out = runner.run_cell(run, hooks={"after_setup": lambda r: FAULTS[fault](monkeypatch, r)})
    assert out["correct"] is False, out["checks"]
