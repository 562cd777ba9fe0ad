"""The plain reference against the program's CPU path, and K1's yardstick
on hand-checked rays. Run: python -m pytest benchmark/tests -p no:cacheprovider
"""

from __future__ import annotations

import numpy as np
import pytest

from bench_helpers import CELLS, small_run
from harness import png, runner
from roofline import bounds
from roofline.k1 import K1Tree, launch_work


@pytest.mark.parametrize("nee", [False, True])
def test_reference_equals_the_program_on_a_small_render_frame(nee):
    """render(): the whole 32x32 frame (one batch) of the window, dense
    and with NEE, equal to the reference byte for byte."""
    run = small_run(CELLS[0], 2**31 + 11, nee=nee)
    out = runner.run_cell(run)
    assert out["correct"] and out["checks"]["max_abs_u8"]["value"] == 0.0
    assert run.frames[0]["rays"] > 32 * 32 * 2
    assert np.asarray(run.frames[0]["img"]).mean() > 10


def test_reference_equals_the_program_through_the_cli():
    """cli.main with -D --nee on the stand-in GLB: the PNG it wrote,
    decoded, equal to the reference's loader, render and median filter."""
    run = small_run(CELLS[1], 7)
    out = runner.run_cell(run)
    assert out["correct"] and out["checks"]["max_abs_u8"]["value"] == 0.0
    assert {"wall_ms", "rays", "load_ms", "env_table_ms", "write_ms"} <= set(run.frames[0])


def test_png_codec_round_trip():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (37, 29, 3), dtype=np.uint8)
    img[10:20] = 7  # rows where Sub, Up, Average and Paeth compete
    assert np.array_equal(png.decode(png.encode(img)), img)


def _tree(tris):
    return K1Tree(np.asarray(tris, np.float32))


TRI = [[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]]


def test_k1_yardstick_on_hand_checked_rays():
    """One triangle in z = 0 (a depth-1 tree: the root's one occupied child
    is a leaf block with one occupied slot)."""
    tree = _tree([TRI])
    down = np.float32([0, 0, -1])
    # hits: one box test, one full triangle test
    assert tree.walk_ops([0, 0, 1], down, False) == bounds.BOX_TEST_OPS + bounds.TRI_TEST_OPS
    # misses the box: the root's one box test only
    assert tree.walk_ops([5, 5, 1], down, False) == bounds.BOX_TEST_OPS
    # enters the box, leaves the triangle test at u
    assert tree.walk_ops([-0.99, 0.99, 1], down, False) == \
        bounds.BOX_TEST_OPS + bounds.TRI_U_FAIL_OPS


def test_k1_any_hit_stops_at_the_first_occluder():
    """Two stacked triangles in one leaf block: the nearest-hit walk tests
    both, the any-hit walk stops at the first slot that occludes."""
    below = [[p[0], p[1], -0.5] for p in TRI]
    tree = _tree([TRI, below])
    o, d = [0, 0, 1], np.float32([0, 0, -1])
    assert tree.walk_ops(o, d, False) == bounds.BOX_TEST_OPS + 2 * bounds.TRI_TEST_OPS
    assert tree.walk_ops(o, d, True) == bounds.BOX_TEST_OPS + bounds.TRI_TEST_OPS
    nbytes, ops = launch_work(tree, 1000, np.float32([o]), np.float32([d]), True, False)
    assert ops == 1000 * (bounds.RAY_SETUP_OPS + bounds.BOX_TEST_OPS + bounds.TRI_TEST_OPS)
    assert nbytes == 1000 * 4 * 13 + 4 * (1 * 6 + 2 * 9)
