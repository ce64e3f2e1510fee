"""numerics="sse2": the reference's second numeric contract.

The reference ships two genuinely diverging integer paths (C vs SSE2:
saturate-vs-wrap writebacks, logical-vs-arithmetic predictor shift —
SURVEY.md §2 quirk 3).  The framework's default contract is the C path;
``numerics="sse2"`` selects the other one on every backend.

Ground truth here is the REFERENCE'S OWN SSE2 CODE, compiled in place from
/root/reference by tools/sse2_baseline (libref_sse2.so) — the strongest
possible check, skipped if the reference tree/toolchain is unavailable.
"""

import ctypes
import subprocess
from pathlib import Path

import numpy as np
import pytest

from sangnom_jax import Clip, get_format, sangnom2
from sangnom_jax.core.geometry import (
    buffer_height,
    buffer_stride_elems,
    scaled_aa_thresholds,
)
from conftest import make_planes

TOOL_DIR = Path(__file__).parent.parent / "tools" / "sse2_baseline"
REF_SRC = Path("/root/reference/src/SangNom2_SSE2.cpp")


def _load_ref_lib():
    if not REF_SRC.exists():
        pytest.skip("reference tree not available")
    lib_path = TOOL_DIR / "libref_sse2.so"
    try:
        subprocess.run(["make", "-s", "libref_sse2.so"], cwd=TOOL_DIR,
                       check=True, capture_output=True, timeout=300)
    except Exception as e:  # no toolchain
        pytest.skip(f"cannot build libref_sse2.so: {e}")
    lib = ctypes.CDLL(str(lib_path))
    for name, ptr in (("ref_sse2_deint_u8", ctypes.c_uint8),
                      ("ref_sse2_deint_u16", ctypes.c_uint16),
                      ("ref_sse2_deint_f32", ctypes.c_float)):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.POINTER(ptr), ctypes.POINTER(ptr),
                       ctypes.c_long, ctypes.c_long, ctypes.c_long,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float,
                       ctypes.c_long, ctypes.c_long]
    return lib


def _ref_sse2_frame(lib, planes, fmt, order, aa, aac, dh):
    """All planes of one frame through the genuine reference SSE2 path
    (zero pool per plane — the framework's pool contract)."""
    from sangnom_jax.ops.sangnom import field_offset_py

    offset = field_offset_py(order, True)
    aafs = scaled_aa_thresholds(aa, aac, fmt)
    stride = buffer_stride_elems(planes[0].shape[1], fmt.component_size)
    buf_h = buffer_height(planes[0].shape[0] * (2 if dh else 1))
    entry = {1: "ref_sse2_deint_u8", 2: "ref_sse2_deint_u16",
             4: "ref_sse2_deint_f32"}[fmt.component_size]
    ptr_t = {1: ctypes.c_uint8, 2: ctypes.c_uint16,
             4: ctypes.c_float}[fmt.component_size]
    if fmt.is_float:
        entry, ptr_t = "ref_sse2_deint_f32", ctypes.c_float
    out = []
    for i, p in enumerate(planes):
        h, w = p.shape
        # the reference's SSE2 LEFT blocks do aligned row loads: row
        # starts must be 16B aligned -> pad rows to a 16-elem stride
        row = -(-w // 16) * 16
        src = np.zeros((h, row), p.dtype)
        src[:, :w] = p
        dst = np.zeros(((2 * h if dh else h), row), p.dtype)
        getattr(lib, entry)(
            src.ctypes.data_as(ctypes.POINTER(ptr_t)),
            dst.ctypes.data_as(ctypes.POINTER(ptr_t)),
            w, h, row, offset, int(dh), ctypes.c_float(aafs[i]),
            stride, buf_h,
        )
        out.append(dst[:, :w])
    return out


CONFIGS = [
    ("GRAY8", 64, 16, dict(order=1, aa=48)),
    ("GRAY8", 48, 32, dict(order=2, aa=0)),
    ("GRAY8", 64, 16, dict(order=1, aa=128, dh=True)),
    ("YUV420P8", 64, 16, dict(order=1, aa=48, aac=128)),
    ("GRAY16", 64, 16, dict(order=1, aa=128)),
    ("YUV422P10", 64, 16, dict(order=2, aa=48, aac=48)),
    ("GRAYS", 64, 16, dict(order=1, aa=48)),
]


@pytest.mark.parametrize("fname,w,h,kw", CONFIGS, ids=lambda v: str(v))
def test_sse2_numerics_matches_real_reference(rng, fname, w, h, kw):
    """jnp backend AND the Python scalar spec with numerics='sse2' == the
    reference's own compiled SSE2 pipeline, bit for bit (full-range random
    input: the divergent saturate/logical-shift paths fire constantly)."""
    from scalar_model import sangnom2_frame_scalar

    lib = _load_ref_lib()
    fmt = get_format(fname)
    planes = make_planes(rng, w, h, fmt)
    kw = dict(kw)
    dh = kw.pop("dh", False)
    want = _ref_sse2_frame(lib, planes, fmt, kw.get("order", 1),
                           kw.get("aa", 48), kw.get("aac", 0), dh)
    clip = Clip.from_numpy([p[None] for p in planes], fmt)
    got = sangnom2(clip, opt=0, dh=dh, numerics="sse2", **kw)
    spec_out = sangnom2_frame_scalar(planes, fmt, dh=dh, numerics="sse2",
                                     **kw)
    for i in range(fmt.num_planes):
        np.testing.assert_array_equal(
            np.asarray(got.planes[i])[0], want[i], err_msg=f"jnp plane {i}"
        )
        np.testing.assert_array_equal(
            np.asarray(spec_out[i], dtype=want[i].dtype), want[i],
            err_msg=f"scalar-spec plane {i}",
        )


def test_sse2_numerics_pallas_matches_jnp(rng):
    """The fused Pallas kernel implements the sse2 contract identically."""
    fmt = get_format("YUV420P8")
    planes = make_planes(rng, 64, 16, fmt)
    clip = Clip.from_numpy([p[None] for p in planes], fmt)
    a = sangnom2(clip, opt=0, order=1, aa=48, aac=96, numerics="sse2")
    b = sangnom2(clip, opt=1, order=1, aa=48, aac=96, numerics="sse2")
    for i in range(3):
        np.testing.assert_array_equal(
            np.asarray(a.planes[i]), np.asarray(b.planes[i])
        )


def test_sse2_numerics_diverges_from_c(rng):
    """The two contracts genuinely differ on full-range input (if they
    didn't, the mode would be untestable dead weight)."""
    fmt = get_format("GRAY8")
    planes = make_planes(rng, 64, 32, fmt)
    clip = Clip.from_numpy([p[None] for p in planes], fmt)
    a = np.asarray(sangnom2(clip, opt=0, order=1, numerics="c").planes[0])
    b = np.asarray(sangnom2(clip, opt=0, order=1, numerics="sse2").planes[0])
    assert not np.array_equal(a, b)


def test_sse2_numerics_float_identical_to_c(rng):
    """The reference's float SSE2 path is bit-identical to its C path
    (same op order); numerics='sse2' must therefore be a no-op for float."""
    fmt = get_format("GRAYS")
    planes = make_planes(rng, 64, 16, fmt)
    clip = Clip.from_numpy([p[None] for p in planes], fmt)
    a = np.asarray(sangnom2(clip, opt=0, order=1, numerics="c").planes[0])
    b = np.asarray(sangnom2(clip, opt=0, order=1, numerics="sse2").planes[0])
    np.testing.assert_array_equal(a, b)


def test_pool_carry_sse2_matches_real_reference(rng):
    """The FULL live-reference emulation: pool_compat=True composed with
    numerics='sse2' must match the reference's own SSE2 code run with its
    actual shared-pool reuse (caller-threaded pool through Y->U->V of every
    frame) — bit for bit, on 4:2:0 where the stale carry is observable."""
    lib = _load_ref_lib()
    fn = lib.ref_sse2_deint_u8_pool
    fn.restype = None
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint8)] * 2 + [
        ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    fmt = get_format("YUV420P8")
    W, H, N = 64, 16, 3
    frames = [make_planes(rng, W, H, fmt) for _ in range(N)]
    aa, aac, order = 48, 96, 1
    aafs = scaled_aa_thresholds(aa, aac, fmt)
    stride = buffer_stride_elems(W, 1)
    buf_h = buffer_height(H)
    pool = np.zeros(9 * (buf_h + 1) * stride, np.uint8)

    want = []
    for f in frames:
        fout = []
        for i, p in enumerate(f):
            h, w = p.shape
            src = np.ascontiguousarray(p)
            dst = np.zeros((h, w), np.uint8)
            fn(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
               dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
               w, h, w, 0 if order == 1 else 1, 0,
               ctypes.c_float(aafs[i]), stride, buf_h,
               pool.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            fout.append(dst)
        want.append(fout)

    planes = [np.stack([f[i] for f in frames]) for i in range(3)]
    got = sangnom2(Clip.from_numpy(planes, fmt), order=order, aa=aa, aac=aac,
                   pool_compat=True, numerics="sse2")
    for n in range(N):
        for i in range(3):
            np.testing.assert_array_equal(
                np.asarray(got.planes[i][n]), want[n][i],
                err_msg=f"frame {n} plane {i}",
            )


def test_numerics_validation(rng):
    from sangnom_jax.api import SangNom2Filter, SangNomError

    fmt = get_format("GRAY8")
    clip = Clip.from_numpy([np.zeros((1, 8, 16), np.uint8)], fmt)
    with pytest.raises(SangNomError, match="numerics"):
        sangnom2(clip, numerics="avx")
    with pytest.raises(SangNomError, match="numerics"):
        SangNom2Filter(numerics="avx")


def test_filter_object_threads_numerics(rng):
    """The filter-object surface must express the full composed contract."""
    from sangnom_jax.api import SangNom2Filter

    fmt = get_format("GRAY8")
    planes = make_planes(rng, 32, 16, fmt)
    clip = Clip.from_numpy([p[None] for p in planes], fmt)
    f = SangNom2Filter(order=1, aa=48, numerics="sse2", pool_compat=True)
    assert "sse2" in repr(f)
    want = sangnom2(clip, order=1, aa=48, numerics="sse2", pool_compat=True)
    got = f(clip)
    np.testing.assert_array_equal(
        np.asarray(got.planes[0]), np.asarray(want.planes[0])
    )
    # and the sse2 contract actually applied (differs from default)
    base = sangnom2(clip, order=1, aa=48)
    assert not np.array_equal(
        np.asarray(got.planes[0]), np.asarray(base.planes[0])
    )
