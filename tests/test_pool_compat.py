"""Pool-compat mode: bit-exact emulation of the reference's shared buffer
pool (reference src/SangNom2.cpp:303-310 allocates ONE luma-geometry pool in
the constructor; src/SangNom2.cpp:265-272 reuses it for every plane pass).

Three independent implementations of the carry semantics are cross-checked:
the Python scalar spec (tests/scalar_model.py), the native C++ oracle
(sangnom_jax/oracle), and the jnp backend (sangnom_jax/ops/pool_carry.py) —
plus pinned tests that localize exactly WHERE the carry semantics diverge
from the default zero-defined contract (docs/PARITY.md deviation 1/5).
"""

import numpy as np
import pytest

from sangnom_jax.core.clip import Clip
from sangnom_jax.core.formats import get_format
from sangnom_jax.oracle import sangnom2_clip_oracle
from conftest import make_planes
from scalar_model import sangnom2_clip_scalar, sangnom2_frame_scalar


def _frames(rng, fmt, w, h, n):
    return [make_planes(rng, w, h, fmt) for _ in range(n)]


def _run_jnp(frames, fmt, **kw):
    """Whole clip through the public API with pool_compat=True."""
    from sangnom_jax import sangnom2

    planes = [
        np.stack([f[i] for f in frames]) for i in range(len(frames[0]))
    ]
    clip = Clip.from_numpy(planes, fmt)
    out = sangnom2(clip, pool_compat=True, **kw)
    return [
        [np.asarray(out.planes[i][n]) for i in range(len(planes))]
        for n in range(len(frames))
    ]


def _assert_clips_equal(a, b, cast_dtype=None):
    for n, (fa, fb) in enumerate(zip(a, b)):
        for i, (pa, pb) in enumerate(zip(fa, fb)):
            pb = np.asarray(pb, dtype=cast_dtype or pa.dtype)
            np.testing.assert_array_equal(
                pa, pb, err_msg=f"frame {n} plane {i}"
            )


CONFIGS = [
    # fmt, w, h, order, aa, aac, dh, luma, chroma
    ("YUV420P8", 48, 16, 1, 48, 48, False, True, True),
    ("YUV420P8", 64, 16, 2, 48, 128, False, True, True),
    ("YUV420P8", 48, 8, 0, 28, 64, True, True, True),
    ("YUV420P16", 48, 16, 1, 48, 48, False, True, True),
    ("YUV422P8", 48, 16, 1, 48, 48, False, True, True),
    ("YUV444P8", 48, 16, 1, 48, 48, False, True, True),
    ("YUV420PS", 48, 16, 1, 48, 48, False, True, True),
    ("GRAY8", 48, 16, 1, 48, 0, False, True, True),
    # luma=False: the pool carries V residue ACROSS FRAMES into next U
    ("YUV420P8", 64, 16, 1, 48, 48, False, False, True),
    ("YUV420P8", 64, 16, 1, 48, 0, False, True, False),
    # 4:1:1: quarter-width chroma -> the widest stale-column region
    ("YUV411P8", 64, 16, 1, 48, 48, False, True, True),
]


@pytest.mark.parametrize(
    "fname,w,h,order,aa,aac,dh,luma,chroma", CONFIGS
)
def test_threeway_pool_parity(rng, fname, w, h, order, aa, aac, dh, luma,
                              chroma):
    """scalar spec == native oracle == jnp backend, pool-compat mode,
    multi-frame (the carry across planes AND frames must agree)."""
    fmt = get_format(fname)
    frames = _frames(rng, fmt, w, h, 3)
    parities = [True, False, True]
    kw = dict(order=order, aa=aa, aac=aac, dh=dh, luma=luma, chroma=chroma)
    want = sangnom2_clip_scalar(
        frames, fmt, parities=parities, pool_compat=True, **kw
    )
    got_oracle = sangnom2_clip_oracle(
        frames, fmt, parities=parities, pool_compat=True, **kw
    )
    _assert_clips_equal(got_oracle, want, cast_dtype=frames[0][0].dtype)

    # jnp path goes through the public API; parity array drives order=0
    planes = [np.stack([f[i] for f in frames]) for i in range(len(frames[0]))]
    clip = Clip.from_numpy(planes, fmt, parity=np.asarray(parities))
    from sangnom_jax import sangnom2

    out = sangnom2(clip, pool_compat=True, **kw)
    got_jnp = [
        [np.asarray(out.planes[i][n]) for i in range(len(planes))]
        for n in range(len(frames))
    ]
    _assert_clips_equal(got_jnp, want, cast_dtype=frames[0][0].dtype)

    # four-way: opt=1 runs the same scan in pool_compat mode (the mode has
    # no kernel of its own) — pinned against the same scalar spec
    out_p = sangnom2(clip, pool_compat=True, opt=1, **kw)
    got_pallas = [
        [np.asarray(out_p.planes[i][n]) for i in range(len(planes))]
        for n in range(len(frames))
    ]
    _assert_clips_equal(got_pallas, want, cast_dtype=frames[0][0].dtype)


def test_divergence_localized_to_stale_regions(rng):
    """Zero contract vs pool-compat on a 4:2:0 frame: luma identical (its
    prepare covers the whole pool at aligned widths), and chroma diffs are
    confined to the stale-influence cone — interpolated row b only differs
    at cols >= w_c - 3*b (3-col creep/row through the 7-tap hbox), except
    the LAST interpolated row, which reads the stale row h_c/2 outright
    (VERDICT round-1 Missing #2; reference src/SangNom2.cpp:126-159)."""
    fmt = get_format("YUV420P8")
    w, h = 64, 16  # aligned luma width: no pad-column carry into luma
    frames = _frames(rng, fmt, w, h, 1)
    kw = dict(order=1, aa=48, aac=48)
    zero = sangnom2_frame_scalar(frames[0], fmt, **kw)
    pool = sangnom2_clip_scalar(frames[0:1], fmt, pool_compat=True, **kw)[0]

    np.testing.assert_array_equal(
        np.asarray(zero[0], np.uint8), np.asarray(pool[0], np.uint8),
        err_msg="luma must be carry-invariant at aligned widths",
    )
    w_c, buf_c = w // 2, h // 2 // 2  # chroma width 32, bufH 4
    saw_stale_row_diff = False
    for i in (1, 2):
        a = np.asarray(zero[i], np.uint8)
        b = np.asarray(pool[i], np.uint8)
        diffs = np.argwhere(a != b)
        assert len(diffs), "stale pool must be observable on 4:2:0 chroma"
        for r, c in diffs:
            assert r % 2 == 1, "kept rows must never differ"
            bidx = (r + 1) // 2  # interpolated row r comes from buffer row b
            if bidx == buf_c - 1:
                saw_stale_row_diff = True
                continue  # last interpolated row: stale ROW read, any col
            assert c >= w_c - 3 * bidx, (
                f"plane {i} row {r} col {c}: outside the 3-col/row creep cone"
            )
    assert saw_stale_row_diff, "the stale-row read must hit the last row"


def test_cross_frame_carry_without_luma(rng):
    """luma=False: frame n's U pass inherits frame n-1's V residue — two
    IDENTICAL input frames produce different chroma outputs (the reference's
    pool is never reinitialized between GetFrame calls)."""
    fmt = get_format("YUV420P8")
    f = _frames(rng, fmt, 64, 16, 1)[0]
    frames = [f, [p.copy() for p in f]]
    kw = dict(order=1, aa=48, aac=48, luma=False, chroma=True)
    out = sangnom2_clip_scalar(frames, fmt, pool_compat=True, **kw)
    u0, u1 = np.asarray(out[0][1], np.uint8), np.asarray(out[1][1], np.uint8)
    assert not np.array_equal(u0, u1), (
        "identical frames must diverge through the carried pool"
    )
    # and the jnp backend reproduces exactly that history
    got = _run_jnp(frames, fmt, **kw)
    _assert_clips_equal(got, out, cast_dtype=np.uint8)


def test_pool_equals_zero_when_prepare_covers_pool(rng):
    """4:4:4 at an aligned width: every plane's prepare covers the whole
    pool, so carry == zero-defined bit-for-bit (first frame) — and stays
    equal across frames (no stale cell survives a pass)."""
    fmt = get_format("YUV444P8")
    frames = _frames(rng, fmt, 64, 16, 2)
    kw = dict(order=1, aa=48, aac=48)
    pool = sangnom2_clip_scalar(frames, fmt, pool_compat=True, **kw)
    for n, f in enumerate(frames):
        zero = sangnom2_frame_scalar(f, fmt, **kw)
        _assert_clips_equal([zero], [pool[n]], cast_dtype=np.uint8)


def test_unaligned_width_luma_carry(rng):
    """W % 32 != 0: the pad columns [w, stride) are smoothed by every pass
    but never re-prepared, so even LUMA picks up cross-frame carry — frame 2
    of identical input differs from frame 1 near the right edge."""
    fmt = get_format("GRAY8")
    f = _frames(rng, fmt, 60, 16, 1)[0]  # stride 64, 4 pad cols
    frames = [f, [p.copy() for p in f]]
    out = sangnom2_clip_scalar(frames, fmt, order=1, aa=48, pool_compat=True)
    y0, y1 = np.asarray(out[0][0], np.uint8), np.asarray(out[1][0], np.uint8)
    assert not np.array_equal(y0, y1)
    diffs = np.argwhere(y0 != y1)
    # creep bound: interpolated row b reaches at most 3*b cols inward of the
    # stride (=64), i.e. col >= 60 - 3*b + (64-60) ... conservatively w-3*b
    for r, c in diffs:
        b = (r + 1) // 2
        assert c >= 60 - 3 * b
    # oracle agrees with the scalar spec on the carried history
    got = sangnom2_clip_oracle(frames, fmt, order=1, aa=48, pool_compat=True)
    _assert_clips_equal(got, out, cast_dtype=np.uint8)
