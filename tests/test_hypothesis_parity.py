"""Property-based parity: hypothesis-generated frames/params, jnp backend vs
the Python scalar spec.

Complements the seeded sweep with adversarial shrinking: hypothesis hunts the
parameter lattice for divergence and reports a minimal counterexample.
"""

import numpy as np
from hypothesis import given, settings, strategies as st

from sangnom_jax import Clip, get_format, sangnom2

from scalar_model import sangnom2_frame_scalar

FMTS = ["GRAY8", "GRAY12", "GRAY16", "GRAYS", "YUV420P8", "YUV444P10"]


@st.composite
def cases(draw):
    fmt = get_format(draw(st.sampled_from(FMTS)))
    w = draw(st.integers(2, 20)) * 2
    h = draw(st.integers(1, 6)) * 4
    seed = draw(st.integers(0, 2**31 - 1))
    order = draw(st.integers(0, 2))
    aa = draw(st.sampled_from([0, 1, 48, 127, 128]))
    aac = draw(st.sampled_from([0, 48, 128]))
    dh = draw(st.booleans())
    tff = draw(st.booleans())
    return fmt, w, h, seed, order, aa, aac, dh, tff


@settings(max_examples=25, deadline=None)
@given(cases())
def test_backend_matches_spec(case):
    fmt, w, h, seed, order, aa, aac, dh, tff = case
    rng = np.random.default_rng(seed)
    planes = []
    for i in range(fmt.num_planes):
        pw, ph = fmt.plane_dims(w, h, i)
        if fmt.is_float:
            planes.append((rng.random((ph, pw), np.float32) * 2 - 0.5).astype(np.float32))
        else:
            top = (1 << (8 * fmt.component_size)) - 1
            planes.append(rng.integers(0, top + 1, (ph, pw)).astype(fmt.dtype))
    clip = Clip.from_numpy([p[None] for p in planes], fmt, tff=tff)
    got = sangnom2(clip, order=order, aa=aa, aac=aac, dh=dh, opt=0)
    want = sangnom2_frame_scalar(
        planes, fmt, order=order, aa=aa, aac=aac, dh=dh, frame_parity=tff
    )
    for i, wp in enumerate(want):
        np.testing.assert_array_equal(np.asarray(got.planes[i])[0], wp)


@st.composite
def tie_cases(draw):
    """Adversarially tie-dense inputs: pixels drawn from a tiny alphabet so
    error maps collide at the 9-way min constantly — every comparison in
    the finalize priority chain (reference src/SangNom2.cpp:212-249)
    resolves real ties, and the wrap/saturate extremes of both numerics
    contracts are exercised via alphabets containing 0 and the storage max."""
    fmt = get_format(draw(st.sampled_from(FMTS)))
    w = draw(st.integers(2, 12)) * 2
    h = draw(st.integers(1, 4)) * 4
    seed = draw(st.integers(0, 2**31 - 1))
    order = draw(st.integers(0, 2))
    aa = draw(st.sampled_from([0, 1, 48, 128]))
    dh = draw(st.booleans())
    tff = draw(st.booleans())
    luma = draw(st.booleans())
    chroma = draw(st.booleans())
    numerics = draw(st.sampled_from(["c", "sse2"]))
    n_sym = draw(st.integers(2, 4))
    return fmt, w, h, seed, order, aa, dh, tff, luma, chroma, numerics, n_sym


@settings(max_examples=30, deadline=None)
@given(tie_cases())
def test_tie_dense_matches_spec(case):
    (fmt, w, h, seed, order, aa, dh, tff, luma, chroma, numerics,
     n_sym) = case
    rng = np.random.default_rng(seed)
    if fmt.is_float:
        alphabet = np.asarray([0.0, 0.25, 1.0, 255.0], np.float32)[:n_sym]
    else:
        top = (1 << (8 * fmt.component_size)) - 1
        alphabet = np.asarray([0, 1, top, top // 2], fmt.dtype)[:n_sym]
    planes = []
    for i in range(fmt.num_planes):
        pw, ph = fmt.plane_dims(w, h, i)
        planes.append(rng.choice(alphabet, size=(ph, pw)).astype(fmt.dtype))
    clip = Clip.from_numpy([p[None] for p in planes], fmt, tff=tff)
    kw = dict(order=order, aa=aa, dh=dh, luma=luma, chroma=chroma,
              numerics=numerics)
    want = sangnom2_frame_scalar(planes, fmt, frame_parity=tff, **kw)
    got0 = sangnom2(clip, opt=0, **kw)
    got1 = sangnom2(clip, opt=1, **kw)  # interpret-mode Pallas on CPU
    for i, wp in enumerate(want):
        np.testing.assert_array_equal(np.asarray(got0.planes[i])[0], wp)
        np.testing.assert_array_equal(np.asarray(got1.planes[i])[0], wp)
