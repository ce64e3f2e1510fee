"""Structural property tests (SURVEY.md §4c).

These assert GetFrame's observable contracts independently of the kernel
numerics: kept-field copy-through, boundary-line duplication, order-0
per-frame parity flips, dh layout, and plane-mask passthrough
(reference src/SangNom2.cpp:332-397).
"""

import numpy as np
import pytest

from sangnom_jax import Clip, get_format, sangnom2

from conftest import make_planes


def _one(rng, fmt_name="GRAY8", w=32, h=16, n=1, **clip_kw):
    fmt = get_format(fmt_name)
    frames = [make_planes(rng, w, h, fmt) for _ in range(n)]
    planes = [np.stack([f[i] for f in frames]) for i in range(fmt.num_planes)]
    return Clip.from_numpy(planes, fmt, **clip_kw), planes


@pytest.mark.parametrize("order,offset", [(1, 0), (2, 1)])
def test_kept_field_verbatim(rng, order, offset):
    """The kept field is BitBlt'd unmodified (reference src/SangNom2.cpp:376)."""
    clip, planes = _one(rng)
    out = np.asarray(sangnom2(clip, order=order).planes[0])[0]
    np.testing.assert_array_equal(out[offset::2], planes[0][0][offset::2])


def test_boundary_line_duplication(rng):
    """offset=0: last line := line above; offset=1: first line := line below
    (reference src/SangNom2.cpp:379-391)."""
    clip, _ = _one(rng, h=16)
    top = np.asarray(sangnom2(clip, order=1).planes[0])[0]
    np.testing.assert_array_equal(top[-1], top[-2])
    bot = np.asarray(sangnom2(clip, order=2).planes[0])[0]
    np.testing.assert_array_equal(bot[0], bot[1])


def test_order0_follows_per_frame_parity(rng):
    """order=0 consults GetParity(n) per frame (reference src/SangNom2.cpp:
    338): a TFF frame behaves like order=1, a BFF frame like order=2."""
    parity = np.array([True, False])
    clip, planes = _one(rng, n=2, parity=parity)
    out = sangnom2(clip, order=0)
    f0 = np.asarray(out.planes[0])[0]
    f1 = np.asarray(out.planes[0])[1]

    single0 = Clip.from_numpy([planes[0][:1]], clip.format)
    single1 = Clip.from_numpy([planes[0][1:]], clip.format)
    np.testing.assert_array_equal(f0, np.asarray(sangnom2(single0, order=1).planes[0])[0])
    np.testing.assert_array_equal(f1, np.asarray(sangnom2(single1, order=2).planes[0])[0])


def test_dh_places_source_rows_by_offset(rng):
    """dh: every source row lands at dst row offset+2k
    (reference src/SangNom2.cpp:361-366)."""
    clip, planes = _one(rng, h=8)
    for order, offset in ((1, 0), (2, 1)):
        out = np.asarray(sangnom2(clip, order=order, dh=True).planes[0])[0]
        np.testing.assert_array_equal(out[offset::2], planes[0][0])


def test_plane_mask_passthrough_is_identity(rng):
    clip, planes = _one(rng, "YUV444P8")
    out = sangnom2(clip, luma=False, chroma=False)
    for i in range(3):
        np.testing.assert_array_equal(np.asarray(out.planes[i]), planes[i])


def test_dh_ignores_plane_masks(rng):
    """dh=True forces processing of all planes (SURVEY.md §2 quirk 7)."""
    clip, _ = _one(rng, "YUV444P8", h=8)
    a = sangnom2(clip, dh=True, luma=False, chroma=False)
    b = sangnom2(clip, dh=True, luma=True, chroma=True)
    for i in range(3):
        np.testing.assert_array_equal(np.asarray(a.planes[i]), np.asarray(b.planes[i]))


def test_aa128_acts_like_unbounded_threshold(rng):
    """With minBuf always <= aaf at aa=128 (max), the threshold fallback
    only triggers via the buf[4] tie — output must still be deterministic
    and equal across backends."""
    clip, _ = _one(rng)
    a = sangnom2(clip, aa=128, opt=0)
    b = sangnom2(clip, aa=128, opt=1)
    np.testing.assert_array_equal(np.asarray(a.planes[0]), np.asarray(b.planes[0]))


def test_output_dtype_and_shape_contract(rng):
    for fmt_name in ("GRAY8", "YUV422P10", "GRAY16", "YUV444PS"):
        clip, _ = _one(rng, fmt_name)
        out = sangnom2(clip)
        for i in range(out.num_planes):
            assert out.planes[i].dtype == clip.planes[i].dtype
            assert out.planes[i].shape == clip.planes[i].shape
        out = sangnom2(clip, dh=True)
        for i in range(out.num_planes):
            assert out.planes[i].shape[1] == clip.planes[i].shape[1] * 2


def test_props_and_parity_carry_over(rng):
    clip, _ = _one(rng, props={"note": "x"}, tff=False)
    out = sangnom2(clip)
    assert out.props == {"note": "x"}
    assert out.tff is False
