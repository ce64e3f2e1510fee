"""Unit tests for the precompute math (geometry + threshold scaling).

These pin the constructor-derived quantities the output observably depends on
(reference src/SangNom2.cpp:275-310).
"""

import numpy as np
import pytest

from sangnom_jax.core.formats import get_format
from sangnom_jax.core.geometry import (
    aaf_as_pixel,
    buffer_height,
    buffer_stride_elems,
    scaled_aa_thresholds,
)


@pytest.mark.parametrize(
    "w,expect",
    [(1, 32), (31, 32), (32, 32), (33, 64), (640, 640), (1920, 1920), (1921, 1952)],
)
def test_stride_rounds_to_32_pixels(w, expect):
    # reference src/SangNom2.cpp:287: ceil32(width) regardless of depth
    for cs in (1, 2, 4):
        assert buffer_stride_elems(w, cs) == expect


def test_buffer_height_after_dh():
    # (height+1)>>1 computed AFTER dh doubling (reference src/SangNom2.cpp:284-288)
    assert buffer_height(480) == 240
    assert buffer_height(1080) == 540


def test_aa_scaling_8bit_exact():
    fmt = get_format("YUV420P8")
    # 48 * 21 / 16 = 63.0 exactly (reference src/SangNom2.cpp:280-282)
    assert scaled_aa_thresholds(48, 0, fmt) == [63.0, 0.0, 0.0]
    # 50 * 21 / 16 = 65.625 -> truncated to 65 when passed as the pixel type
    aafs = scaled_aa_thresholds(50, 50, fmt)
    assert aafs[0] == pytest.approx(65.625)
    assert aaf_as_pixel(aafs[0], fmt) == 65


@pytest.mark.parametrize("bits,scale", [(10, 4), (12, 16), (16, 256)])
def test_aa_scaling_highbit(bits, scale):
    fmt = get_format(f"GRAY{bits}")
    assert scaled_aa_thresholds(48, 0, fmt)[0] == 63.0 * scale


def test_aa_scaling_float():
    fmt = get_format("GRAYS")
    got = scaled_aa_thresholds(48, 0, fmt)[0]
    assert got == pytest.approx(63.0 / 256.0)
    assert isinstance(aaf_as_pixel(got, fmt), np.float32)


def test_aa_per_plane_layout():
    # aaf = [aa, aac, aac] (reference src/SangNom2.cpp:280)
    fmt = get_format("YUV444P8")
    assert scaled_aa_thresholds(128, 64, fmt) == [168.0, 84.0, 84.0]
    # GRAY gets only the luma entry
    assert len(scaled_aa_thresholds(128, 64, get_format("GRAY8"))) == 1


def test_formats_registry_geometry():
    f = get_format("YUV420P10")
    assert f.component_size == 2 and f.dtype == np.uint16 and f.is_420
    assert f.plane_dims(1920, 1080, 1) == (960, 540)
    f = get_format("YUV422P8")
    assert f.plane_dims(1920, 1080, 2) == (960, 1080) and not f.is_420
    f = get_format("YUVA444P16")
    assert f.num_planes == 4 and f.has_alpha()
    assert get_format("GRAYS").is_float and get_format("GRAYS").component_size == 4
    with pytest.raises(KeyError):
        get_format("NV12")
