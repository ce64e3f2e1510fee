"""Bit-exactness of the jnp reference backend vs the executable scalar spec.

Covers the BASELINE.json config matrix on small frames: all orders, dh
on/off, plane masks, all three dtype families, odd/tiny widths (border code),
aa/aac extremes.  Integer formats must match bit-exactly; float within 1 ulp.
"""

import numpy as np
import pytest

from sangnom_jax import Clip, get_format, sangnom2

from conftest import make_planes
from scalar_model import sangnom2_frame_scalar


def _run_both(fmt_name, w, h, rng, **kw):
    fmt = get_format(fmt_name)
    planes = make_planes(rng, w, h, fmt)
    clip = Clip.from_numpy([p[None] for p in planes], fmt, tff=kw.pop("tff", True))
    got = sangnom2(clip, **kw)
    want = sangnom2_frame_scalar(
        planes, fmt, frame_parity=clip.get_parity(0),
        **{k: v for k, v in kw.items() if k != "opt"},
    )
    return got, want, fmt


def _assert_match(got, want, fmt):
    for i, w_plane in enumerate(want):
        g = np.asarray(got.planes[i])[0]
        if fmt.is_float:
            np.testing.assert_allclose(g, w_plane, rtol=0, atol=0, err_msg=f"plane {i}")
        else:
            np.testing.assert_array_equal(g, w_plane, err_msg=f"plane {i}")


# -- config 1: keep-top-field 8-bit Y (BASELINE.json configs[0]) ------------
def test_gray8_order1(rng):
    got, want, fmt = _run_both("GRAY8", 24, 12, rng, order=1)
    _assert_match(got, want, fmt)


# -- config 2: keep-bottom on YUV420 8-bit, luma+chroma ----------------------
def test_yuv420p8_order2(rng):
    got, want, fmt = _run_both("YUV420P8", 24, 16, rng, order=2)
    _assert_match(got, want, fmt)


# -- config 3: dh height-doubling, aa=48 aac=0 -------------------------------
@pytest.mark.parametrize("order", [0, 1, 2])
def test_dh_all_orders(rng, order):
    got, want, fmt = _run_both("YUV420P8", 16, 8, rng, order=order, dh=True, aa=48, aac=0)
    _assert_match(got, want, fmt)


# -- config 4: order=0 bob, 10-bit 4:2:2 --------------------------------------
@pytest.mark.parametrize("tff", [True, False])
def test_yuv422p10_order0(rng, tff):
    got, want, fmt = _run_both("YUV422P10", 20, 12, rng, order=0, tff=tff)
    _assert_match(got, want, fmt)


# -- config 5: 16-bit and float with depth-scaled aa --------------------------
@pytest.mark.parametrize("fmt_name", ["GRAY16", "YUV444P16"])
def test_16bit(rng, fmt_name):
    got, want, fmt = _run_both(fmt_name, 24, 10, rng, order=1, aa=96, aac=32)
    _assert_match(got, want, fmt)


@pytest.mark.parametrize("fmt_name", ["GRAYS", "YUV420PS"])
def test_float(rng, fmt_name):
    got, want, fmt = _run_both(fmt_name, 24, 8, rng, order=2, aa=48, aac=16)
    _assert_match(got, want, fmt)


# -- border / geometry edge cases --------------------------------------------
@pytest.mark.parametrize("w", [1, 2, 3, 7, 15, 31, 32, 33, 64])
def test_widths_exercise_borders(rng, w):
    """w<7 exercises the clamp paths; w=32/64 makes stride==w so the
    horizontal smoothing taps CLAMP at the edge instead of reading zero
    padding (reference loadPixel vs bufferStride, src/SangNom2.cpp:141-150)."""
    got, want, fmt = _run_both("GRAY8", w, 8, rng, order=1)
    _assert_match(got, want, fmt)


@pytest.mark.parametrize("h", [2, 4, 6])
def test_tiny_heights(rng, h):
    got, want, fmt = _run_both("GRAY8", 16, h, rng, order=2)
    _assert_match(got, want, fmt)


@pytest.mark.parametrize("aa,aac", [(0, 0), (128, 128), (1, 127)])
def test_aa_extremes(rng, aa, aac):
    got, want, fmt = _run_both("YUV444P8", 16, 8, rng, order=1, aa=aa, aac=aac)
    _assert_match(got, want, fmt)


def test_plane_masks(rng):
    got, want, fmt = _run_both("YUV444P8", 16, 8, rng, order=1, luma=False, chroma=True)
    _assert_match(got, want, fmt)
    got, want, fmt = _run_both("YUV444P8", 16, 8, rng, order=1, luma=True, chroma=False)
    _assert_match(got, want, fmt)


def test_alpha_passthrough(rng):
    got, want, fmt = _run_both("YUVA444P8", 16, 8, rng, order=1)
    _assert_match(got, want, fmt)


@pytest.mark.parametrize("bits", [10, 12, 14])
def test_intermediate_depths(rng, bits):
    """10/12/14-bit ride uint16 storage; wrap happens at the STORAGE width
    (reference casts to T = uint16_t, src/SangNom2.cpp:317)."""
    got, want, fmt = _run_both(f"GRAY{bits}", 16, 8, rng, order=1)
    _assert_match(got, want, fmt)
