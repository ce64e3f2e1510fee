"""Smoke-run every shipped example script end-to-end on tiny clips.

The examples are the README's migration story — they must keep working.
Each runs IN-PROCESS via runpy (inheriting the suite's pinned 8-device
CPU mesh; a subprocess would race the contended real chip) with argv
pointed at a tiny generated .y4m.
"""

import os
import runpy
import sys

import numpy as np
import pytest

from sangnom_jax import Clip
from sangnom_jax.io import read_y4m, write_y4m

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples")


def _tiny_clip(n=4, w=64, h=48):
    rng = np.random.default_rng(7)
    planes = [
        rng.integers(0, 256, (n, h, w)).astype(np.uint8),
        rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8),
        rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8),
    ]
    return Clip.from_numpy(planes, "YUV420P8")


@pytest.fixture
def tiny_y4m(tmp_path):
    src = str(tmp_path / "in.y4m")
    write_y4m(src, _tiny_clip())
    return src


def _run(script, argv):
    old = sys.argv
    sys.argv = [script] + argv
    try:
        runpy.run_path(os.path.join(EXAMPLES, script), run_name="__main__")
    finally:
        sys.argv = old


@pytest.mark.parametrize(
    "script,height_mul,frames_mul",
    [
        ("deinterlace_file.py", 1, 1),
        ("antialias_2x.py", 2, 1),
        ("bob_double_rate.py", 1, 2),
        ("reference_compat.py", 1, 1),
        ("avisynth_host.py", 2, 1),
    ],
)
def test_file_examples(tiny_y4m, tmp_path, script, height_mul, frames_mul):
    dst = str(tmp_path / "out.y4m")
    _run(script, [tiny_y4m, dst])
    src = read_y4m(tiny_y4m)
    out = read_y4m(dst)
    assert out.width == src.width
    assert out.height == src.height * height_mul
    assert out.num_frames == src.num_frames * frames_mul


def test_sharded_batch_example():
    _run("sharded_batch.py", [])
