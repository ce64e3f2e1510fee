"""Three-way parity: native C++ oracle vs scalar spec vs jnp backend.

The oracle is an independent native implementation; agreement of all three
is the framework's correctness anchor (the reference's own oracle was its
dual C/SSE2 backend pair, SURVEY.md §4).
"""

import numpy as np
import pytest

from sangnom_jax import Clip, get_format, sangnom2
from sangnom_jax.oracle import sangnom2_frame_oracle

from conftest import make_planes
from scalar_model import sangnom2_frame_scalar

CONFIGS = [
    # the five BASELINE.json parity configs, scaled down
    dict(fmt="GRAY8", w=64, h=32, kw=dict(order=1)),
    dict(fmt="YUV420P8", w=48, h=24, kw=dict(order=2)),
    dict(fmt="YUV420P8", w=32, h=16, kw=dict(order=1, dh=True, aa=48, aac=0)),
    dict(fmt="YUV422P10", w=40, h=20, kw=dict(order=0)),
    dict(fmt="GRAY16", w=40, h=16, kw=dict(order=1, aa=128, aac=64)),
    dict(fmt="YUV444PS", w=40, h=16, kw=dict(order=2, aa=48, aac=48)),
    # border geometry
    dict(fmt="GRAY8", w=31, h=8, kw=dict(order=1)),
    dict(fmt="GRAY8", w=32, h=8, kw=dict(order=2)),  # stride == w: taps clamp
    dict(fmt="GRAY8", w=5, h=8, kw=dict(order=1)),
    # 4:1:1 (AviSynth YV411): quarter-width chroma against the luma-derived
    # stride — the widest stale-padding region of any format
    dict(fmt="YUV411P8", w=48, h=16, kw=dict(order=1, aa=48, aac=48)),
    dict(fmt="YV411", w=32, h=8, kw=dict(order=2, dh=True)),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"{c['fmt']}-{c['kw']}")
def test_oracle_vs_scalar_spec(rng, cfg):
    fmt = get_format(cfg["fmt"])
    planes = make_planes(rng, cfg["w"], cfg["h"], fmt)
    a = sangnom2_frame_oracle(planes, fmt, **cfg["kw"])
    b = sangnom2_frame_scalar(planes, fmt, **cfg["kw"])
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"plane {i}")


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"{c['fmt']}-{c['kw']}")
def test_oracle_vs_jnp_backend(rng, cfg):
    fmt = get_format(cfg["fmt"])
    planes = make_planes(rng, cfg["w"], cfg["h"], fmt)
    clip = Clip.from_numpy([p[None] for p in planes], fmt)
    got = sangnom2(clip, opt=0, **cfg["kw"])
    want = sangnom2_frame_oracle(planes, fmt, frame_parity=clip.get_parity(0), **cfg["kw"])
    for i, w_plane in enumerate(want):
        g = np.asarray(got.planes[i])[0]
        if fmt.is_float:
            # float contract: <=1 ulp (BASELINE.md); in practice exact
            np.testing.assert_allclose(g, w_plane, rtol=0, atol=0, err_msg=f"plane {i}")
        else:
            np.testing.assert_array_equal(g, w_plane, err_msg=f"plane {i}")


def test_oracle_vs_jnp_large_frame(rng):
    """A bigger (quarter-720p) frame to exercise non-toy geometry fast —
    scalar spec would be too slow here, the native oracle is not."""
    fmt = get_format("YUV420P8")
    planes = make_planes(rng, 320, 180, fmt)
    clip = Clip.from_numpy([p[None] for p in planes], fmt)
    got = sangnom2(clip, opt=0, order=2)
    want = sangnom2_frame_oracle(planes, fmt, order=2)
    for i, w_plane in enumerate(want):
        np.testing.assert_array_equal(np.asarray(got.planes[i])[0], w_plane)
