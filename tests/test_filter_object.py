"""Filter-object API + degenerate-geometry edge cases."""

import numpy as np
import pytest

from sangnom_jax import Clip, SangNom2Filter, get_format, sangnom2
from sangnom_jax.api import SangNomError

from conftest import make_planes


def test_filter_object_matches_function(rng):
    fmt = get_format("YUV420P8")
    planes = [p[None] for p in make_planes(rng, 32, 16, fmt)]
    clip = Clip.from_numpy(planes, fmt)
    f = SangNom2Filter(order=2, aa=96, aac=32)
    a = f(clip)
    b = sangnom2(clip, order=2, aa=96, aac=32)
    for i in range(3):
        np.testing.assert_array_equal(np.asarray(a.planes[i]), np.asarray(b.planes[i]))


def test_filter_object_validates_at_construction():
    """Parameter validation fires at ctor time, like the reference factory
    (reference src/SangNom2.cpp:399-435)."""
    with pytest.raises(SangNomError, match=r"order must be between 0\.\.2\."):
        SangNom2Filter(order=3)
    with pytest.raises(SangNomError, match=r"opt must be between -1\.\.2\."):
        SangNom2Filter(opt=2)
    assert "order=1" in repr(SangNom2Filter())
    assert SangNom2Filter.MT_CONTRACT.startswith("pure-functional")


def test_filter_object_reusable_across_clips(rng):
    f = SangNom2Filter(dh=True)
    for fmt_name in ("GRAY8", "YUV444P16"):
        fmt = get_format(fmt_name)
        clip = Clip.from_numpy([p[None] for p in make_planes(rng, 16, 8, fmt)], fmt)
        assert f(clip).height == 16


def test_empty_clip_passthrough(rng):
    clip = Clip.from_numpy([np.zeros((0, 8, 16), np.uint8)], "GRAY8")
    out = sangnom2(clip)
    assert np.asarray(out.planes[0]).shape == (0, 8, 16)
    out = sangnom2(clip, dh=True)
    assert np.asarray(out.planes[0]).shape == (0, 16, 16)


@pytest.mark.parametrize("opt", [0, 1])
def test_h2_no_interior_lines(rng, opt):
    """h=2: zero interpolatable interior rows; output = kept + duplicated
    boundary, on both backends."""
    p = rng.integers(0, 256, (1, 2, 16)).astype(np.uint8)
    clip = Clip.from_numpy([p], "GRAY8")
    out = np.asarray(sangnom2(clip, order=2, opt=opt).planes[0])[0]
    np.testing.assert_array_equal(out[1], p[0][1])
    np.testing.assert_array_equal(out[0], p[0][1])  # dup of kept bottom line
