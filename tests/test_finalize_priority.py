"""Adversarial tests for the finalize priority select (VERDICT_r3 #5).

The reference's select is an if-chain whose ORDER is semantics ("the order
of following code is important", reference src/SangNom2.cpp:212-213): on
exact ties with the 9-way min, the FIRST matching branch wins, in the order
buf4/threshold, buf5, buf3, buf6, buf2, buf7, buf1, buf8, buf0
(src/SangNom2.cpp:214-249).  Both jnp realizations (reverse-order masked
overwrites) must reproduce that chain exactly:

  * the complete tie-subset truth table: every one of the 511 nonempty
    subsets of {0..8} tied at the min, under three aa-threshold regimes,
    against a directly-evaluated if-chain — any reordering of a single
    `where` in either implementation flips at least one subset;
  * constructed full-pipeline inputs that force EACH of the 9 directions
    through the real prepare->smooth->finalize stack with a closed-form
    expected output (shear-matched rows for the 7 ADIFF branches, exact
    linear-ramp predictor identities for SG_FORWARD/SG_REVERSE).
"""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest

from sangnom_jax import Clip, get_format, sangnom2
from sangnom_jax.ops.pallas_kernel import _finalize
from sangnom_jax.ops.primitives import KernelSpec
from sangnom_jax.ops.reference import finalize_select_from_taps

from scalar_model import sangnom2_frame_scalar

# Distinct per-direction average operands: direction i's average is unique,
# so a select that picks the wrong branch is always observable.
#       cm3 cm2 cm1 c0  cp1 cp2 cp3   nm3 nm2 nm1 n0  np1 np2 np3
TAPS = (0, 4, 8, 12, 16, 20, 24, 26, 22, 18, 14, 10, 6, 2)
PREDS = (28, 30, 32, 34)  # fwd1, fwd2, bwd1, bwd2

# avg operands per buffer index (reference src/SangNom2.cpp:214-249)
_AVG_OPERANDS = {
    0: (TAPS[0], TAPS[13]),   # M3P3: cm3, np3
    1: (TAPS[1], TAPS[12]),   # M2P2
    2: (TAPS[2], TAPS[11]),   # M1P1
    3: (PREDS[0], PREDS[1]),  # SG_FORWARD
    4: (TAPS[3], TAPS[10]),   # vertical: c0, n0
    5: (PREDS[2], PREDS[3]),  # SG_REVERSE
    6: (TAPS[4], TAPS[9]),    # P1M1
    7: (TAPS[5], TAPS[8]),    # P2M2
    8: (TAPS[6], TAPS[7]),    # P3M3
}

MN, OTHER = 5, 10  # tied-at-min value vs non-min value

SPECS = [
    pytest.param(KernelSpec(is_float=False, mask=0xFF), id="u8_c"),
    pytest.param(KernelSpec(is_float=False, mask=0xFF, sse2=True),
                 id="u8_sse2"),
    pytest.param(KernelSpec(is_float=False, mask=0xFFFF), id="u16_c"),
    pytest.param(KernelSpec(is_float=True, mask=0), id="f32"),
]


def _avg(a, b, spec):
    if spec.is_float:
        return np.float32((a + b) * np.float32(0.5))
    return ((a + b + 1) >> 1) & spec.mask


def _expected(tie_set, aaf, spec):
    """The C if-chain, evaluated directly (src/SangNom2.cpp:212-249)."""
    if 4 in tie_set or MN > aaf:
        idx = 4
    else:
        for idx in (5, 3, 6, 2, 7, 1, 8, 0):
            if idx in tie_set:
                break
    a, b = _AVG_OPERANDS[idx]
    return _avg(a, b, spec)


@pytest.mark.parametrize("spec", SPECS)
def test_priority_truth_table_all_tie_subsets(spec):
    """All 511 nonempty tie subsets x 3 threshold regimes, three
    implementations (array-bufs select, tuple-bufs select, Pallas-kernel
    select).  Reordering any single masked overwrite fails this test."""
    dt = np.float32 if spec.is_float else np.int32
    subsets = [frozenset(s)
               for r in range(1, 10)
               for s in itertools.combinations(range(9), r)]
    n = len(subsets)
    assert n == 511
    bufs = np.full((9, n), OTHER, dt)
    for j, s in enumerate(subsets):
        for i in s:
            bufs[i, j] = MN
    taps = tuple(jnp.full((n,), v, dt) for v in TAPS)
    preds = tuple(jnp.full((n,), v, dt) for v in PREDS)
    bufs_j = jnp.asarray(bufs)

    # aaf regimes: no trip (mn < aaf), forced trip (mn > aaf), and the
    # equality boundary (mn == aaf: "mn > aaf" is FALSE -> no trip)
    for aaf in (100, 3, MN):
        aaf_t = np.float32(aaf) if spec.is_float else aaf
        want = np.array([_expected(s, aaf, spec) for s in subsets], dt)

        got_arr = finalize_select_from_taps(taps, preds, bufs_j, aaf_t, spec)
        np.testing.assert_array_equal(np.asarray(got_arr), want,
                                      err_msg=f"array bufs, aaf={aaf}")

        got_tup = finalize_select_from_taps(
            taps, preds, tuple(bufs_j[i] for i in range(9)), aaf_t, spec)
        np.testing.assert_array_equal(np.asarray(got_tup), want,
                                      err_msg=f"tuple bufs, aaf={aaf}")

        v = list(taps) + list(preds)
        got_pl = _finalize(v, bufs_j, aaf_t, spec)
        np.testing.assert_array_equal(np.asarray(got_pl), want,
                                      err_msg=f"pallas _finalize, aaf={aaf}")


# ---------------------------------------------------------------------------
# Full-pipeline constructed inputs: one per direction.
# ---------------------------------------------------------------------------

W, H = 128, 12  # 6 kept rows (order=1), 5 interpolated rows
MARGIN = 32     # clamped-edge contamination (9) + smoothing creep (3/row)


def _run_both_backends(planes, fmt, **kw):
    clip = Clip.from_numpy([p[None] for p in planes], fmt)
    out0 = [np.asarray(p)[0] for p in sangnom2(clip, opt=0, **kw).planes]
    out1 = [np.asarray(p)[0] for p in sangnom2(clip, opt=1, **kw).planes]
    for a, b in zip(out0, out1):
        np.testing.assert_array_equal(a, b, err_msg="opt=1 != opt=0")
    want = sangnom2_frame_scalar(planes, fmt, **kw)
    for a, b in zip(out0, want):
        np.testing.assert_array_equal(a, b, err_msg="backend != scalar spec")
    return out0


@pytest.mark.parametrize("t", [3, 2, 1, 0, -1, -2, -3],
                         ids=["M3P3", "M2P2", "M1P1", "P0M0",
                              "P1M1", "P2M2", "P3M3"])
def test_pipeline_shear_direction(t):
    """Kept rows successively shifted by s=-2t columns: the ADIFF map at
    shear t (buffer 3-t for t>0, 3+|t|+... — spatial index 3-t mapped over
    the enum: t=3->buf0 .. t=0->buf4 .. t=-3->buf8) is EXACTLY zero in the
    interior while every other map is nonzero (injective row values), so
    the select must output that direction's average = curr[x-t]."""
    fmt = get_format("GRAY8")
    s = -2 * t
    rows = np.zeros((H, W), np.uint8)

    def f(u):
        return (3 * u + 7) % 251

    x = np.arange(W)
    for r in range(H // 2):
        rows[2 * r] = f(x + s * r).astype(np.uint8)  # kept field (order=1)
    out = _run_both_backends([rows], fmt, order=1, aa=48)[0]

    # kept field verbatim
    np.testing.assert_array_equal(out[0::2], rows[0::2])
    # interior of each interpolated row: the matched direction's average
    sl = slice(MARGIN, W - MARGIN)
    for r in range(1, H // 2):  # interp row between kept r-1 and r
        curr = f(x + s * (r - 1))
        want = curr[sl.start - t : sl.stop - t] % 256
        np.testing.assert_array_equal(
            out[2 * (r - 1) + 1][sl], want.astype(np.uint8),
            err_msg=f"shear t={t}, interp row {r - 1}",
        )


@pytest.mark.parametrize("numerics", ["c", "sse2"])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_pipeline_sg_direction_u16(which, numerics):
    """Linear ramps with slope d=4 and per-row offset -/+5 make the two
    3-tap predictors agree EXACTLY ((8a-20)>>3 == (8(a-5)+20)>>3 = a-3 for
    SG_FORWARD; a+2 for SG_REVERSE) while every ADIFF map is the nonzero
    constant |delta - 8t| (odd, never 0) — the select must output the
    predictor average through the full pipeline."""
    fmt = get_format("GRAY16")
    delta = -5 if which == "fwd" else 5
    base = 600
    x = np.arange(W)
    rows = np.zeros((H, W), np.uint16)
    for r in range(H // 2):
        rows[2 * r] = (base + delta * r + 4 * x).astype(np.uint16)
    out = _run_both_backends([rows], fmt, order=1, aa=48,
                             numerics=numerics)[0]

    sl = slice(MARGIN, W - MARGIN)
    shift = -3 if which == "fwd" else 2  # (8a -/+ 20)>>3 = a-3 / a+2
    for r in range(1, H // 2):
        a = base + delta * (r - 1) + 4 * x[sl]
        np.testing.assert_array_equal(
            out[2 * (r - 1) + 1][sl], (a + shift).astype(np.uint16),
            err_msg=f"SG_{which} interp row {r - 1}",
        )


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_pipeline_sg_direction_float(which):
    """Float twin of the SG construction: slope 8, per-row offset -/+10 ->
    predictors (8a - 5*8)/8 = a-5 (fwd) / a+5 (bwd), exactly representable;
    every ADIFF map is |delta - 8t| = |±10 - 8t| ≠ 0."""
    fmt = get_format("GRAYS")
    delta = np.float32(-10 if which == "fwd" else 10)
    base = np.float32(600)
    x = np.arange(W, dtype=np.float32)
    rows = np.zeros((H, W), np.float32)
    for r in range(H // 2):
        rows[2 * r] = base + delta * np.float32(r) + np.float32(8) * x
    out = _run_both_backends([rows], fmt, order=1, aa=48)[0]

    sl = slice(MARGIN, W - MARGIN)
    shift = np.float32(-5 if which == "fwd" else 5)
    for r in range(1, H // 2):
        a = base + delta * np.float32(r - 1) + np.float32(8) * x[sl]
        np.testing.assert_array_equal(
            out[2 * (r - 1) + 1][sl], a + shift,
            err_msg=f"SG_{which} float interp row {r - 1}",
        )
