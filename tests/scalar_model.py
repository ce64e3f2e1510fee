"""Executable scalar specification of the SangNom algorithm.

A deliberately slow, loop-by-loop Python transliteration of the semantics the
framework must honor (derived from reference src/SangNom2.cpp:25-273,
332-397).  Used as the parity oracle for tiny frames; the native C++ oracle
(sangnom_jax/oracle) covers large frames fast.

Default contract (both axes selectable, mirroring the framework API):
  * buffer cells outside the prepared plane region are ZERO (the reference
    reuses one shared pool across passes, reference src/SangNom2.cpp:79 vs
    129-133, 265-272, 305-306) — ``pool=`` carries the shared pool instead.
  * numerics follow the C path: integer wrap-on-cast, arithmetic >>3
    (reference src/SangNom2.cpp:63-64, 152) — ``numerics="sse2"`` /
    ``sse2=True`` selects the reference SSE2 path's saturating /
    logical-shift contract instead.
"""

from __future__ import annotations

import numpy as np

from sangnom_jax.core.formats import VideoFormat
from sangnom_jax.core.geometry import (
    aaf_as_pixel,
    buffer_stride_elems,
    scaled_aa_thresholds,
)

F32 = np.float32


def _clamp_load(row, x, off, n):
    """Edge-clamped gather (reference loadPixel, src/SangNom2.cpp:25-34)."""
    p = x + off
    if 0 <= p < n:
        return row[p]
    if p >= 0:
        return row[n - 1]
    return row[0]


def _calc_int(p1, p2, p3, mask):
    """(4*p1 + 5*p2 - p3) >> 3, arithmetic shift, wrapped to the pixel type
    (reference calculateSangNom, src/SangNom2.cpp:60-65)."""
    s = 4 * p1 + 5 * p2 - p3
    return (s >> 3) & mask  # python >> on ints is arithmetic (floor)


def _calc_int_sse2(p1, p2, p3, mask):
    """The reference SSE2 path's divergent predictor: LOGICAL >>3 within
    the SIMD lane (i16 lanes for u8, i32 for u16), then saturate-pack
    (reference src/SangNom2_SSE2.cpp:451-482, 485-518)."""
    s = 4 * p1 + 5 * p2 - p3
    lane = 0xFFFF if mask == 0xFF else 0xFFFFFFFF
    return min((s & lane) >> 3, mask)


def _calc_f32(p1, p2, p3):
    s = p1 * F32(4) + p2 * F32(5) - p3
    return s * F32(0.125)  # reference src/SangNom2.cpp:67-72


def _avg_int(a, b, mask):
    return ((a + b + 1) >> 1) & mask  # reference src/SangNom2.cpp:48-52


def _avg_f32(a, b):
    return (a + b) * F32(0.5)  # reference src/SangNom2.cpp:54-58


def make_pool_scalar(stride: int, pool_rows: int, is_float: bool):
    """Fresh shared pool state for pool-compat mode: 9 x (pool_rows+1) x S,
    all zero (the reference's malloc'd pool is fresh zero pages in practice;
    its never-written cells — row 0, row bufferHeight — stay zero forever,
    reference src/SangNom2.cpp:79 vs 129-133, 305-306)."""
    zero = F32(0) if is_float else 0
    return [[[zero] * stride for _ in range(pool_rows + 1)] for _ in range(9)]


def interpolate_field_scalar(kept: np.ndarray, aaf, is_float: bool, mask: int,
                             stride: int, pool=None,
                             sse2: bool = False) -> np.ndarray:
    """Interpolate the bufH-1 interior missing lines between kept lines.

    kept: [bufH, w] python-int-convertible (or float32) kept-field lines.
    Returns [bufH-1, w] in the same value domain.

    ``pool``: optional carried shared-pool state (pool-compat mode) of shape
    9 x (P+1) x S with P the LUMA bufferHeight — mutated in place, exactly
    like the reference's cross-plane buffer reuse (src/SangNom2.cpp:265-272:
    prepare writes rows 1..h/2-1 for THIS plane but processBuffers always
    smooths rows 1..bufferHeight-1 over the full stride).  When None, a
    plane-local zero pool is used (the framework's default zero contract).
    """
    bufH, w = kept.shape
    S = stride
    if pool is None and bufH < 2:
        return np.zeros((0, w), dtype=kept.dtype)

    if is_float:
        k = kept.astype(np.float32)
        zero = F32(0)
    else:
        k = kept.astype(object)  # python ints, exact
        zero = 0

    if is_float:
        calc = _calc_f32
    elif sse2:
        calc = lambda a, b, c: _calc_int_sse2(a, b, c, mask)  # noqa: E731
    else:
        calc = lambda a, b, c: _calc_int(a, b, c, mask)  # noqa: E731
    avg = _avg_f32 if is_float else (lambda a, b: _avg_int(a, b, mask))

    # ---- stage 1: prepare the 9 raw error maps, rows 1..bufH-1 -----------
    # Map index IS spatial priority order (reference enum Buffers,
    # src/SangNom2.h:8-20): 0=M3P3 1=M2P2 2=M1P1 3=SG_FWD 4=P0M0 5=SG_REV
    # 6=P1M1 7=P2M2 8=P3M3.  (reference prepareBuffers_c,
    # src/SangNom2.cpp:74-124.)
    raw = pool if pool is not None else make_pool_scalar(S, bufH, is_float)
    for b in range(1, bufH):
        c, n = k[b - 1], k[b]
        for x in range(w):
            cm3 = _clamp_load(c, x, -3, w); cm2 = _clamp_load(c, x, -2, w)
            cm1 = _clamp_load(c, x, -1, w); c0 = c[x]
            cp1 = _clamp_load(c, x, 1, w); cp2 = _clamp_load(c, x, 2, w)
            cp3 = _clamp_load(c, x, 3, w)
            nm3 = _clamp_load(n, x, -3, w); nm2 = _clamp_load(n, x, -2, w)
            nm1 = _clamp_load(n, x, -1, w); n0 = n[x]
            np1 = _clamp_load(n, x, 1, w); np2 = _clamp_load(n, x, 2, w)
            np3 = _clamp_load(n, x, 3, w)
            fwd1 = calc(cm1, c0, cp1)
            fwd2 = calc(np1, n0, nm1)
            bwd1 = calc(cp1, c0, cm1)
            bwd2 = calc(nm1, n0, np1)
            raw[0][b][x] = abs(cm3 - np3)
            raw[1][b][x] = abs(cm2 - np2)
            raw[2][b][x] = abs(cm1 - np1)
            raw[3][b][x] = abs(fwd1 - fwd2)
            raw[4][b][x] = abs(c0 - n0)
            raw[5][b][x] = abs(bwd1 - bwd2)
            raw[6][b][x] = abs(cp1 - nm1)
            raw[7][b][x] = abs(cp2 - nm2)
            raw[8][b][x] = abs(cp3 - nm3)

    # ---- stage 2: recursive 3x7 box smoothing, IN PLACE over rows --------
    # Row b's vertical 3-sum reads row b-1 AFTER it was smoothed — a scan,
    # not a convolution (reference processBuffers_c, src/SangNom2.cpp:126-159;
    # the three cursors stride together at 155-157).  Horizontal taps clamp
    # at the PADDED stride S, not at w (loop bound src/SangNom2.cpp:136,141).
    # In pool-compat mode the smoothed height is the POOL's (luma-derived),
    # not the plane's (reference src/SangNom2.cpp:270 passes bufferHeight).
    smooth_rows = len(raw[0]) - 1
    for i in range(9):
        m = raw[i]
        for b in range(1, smooth_rows):
            line = [m[b - 1][x] + m[b][x] + m[b + 1][x] for x in range(S)]
            for x in range(S):
                h = (
                    _clamp_load(line, x, -3, S) + _clamp_load(line, x, -2, S)
                    + _clamp_load(line, x, -1, S) + line[x]
                    + _clamp_load(line, x, 1, S) + _clamp_load(line, x, 2, S)
                    + _clamp_load(line, x, 3, S)
                )
                if is_float:
                    m[b][x] = h / F32(16)
                elif sse2:
                    # SSE2 writeback saturates where C wraps (reference
                    # src/SangNom2_SSE2.cpp:749-765, 798-811)
                    m[b][x] = min(h >> 4, mask)
                else:
                    m[b][x] = (h >> 4) & mask  # nonneg: /16 == >>4; wrap to T

    # ---- stage 3: finalize — min-error priority select --------------------
    # (reference finalizePlane_c, src/SangNom2.cpp:161-257.)
    out = np.zeros((bufH - 1, w), dtype=kept.dtype)
    for b in range(1, bufH):
        c, n = k[b - 1], k[b]
        for x in range(w):
            cm3 = _clamp_load(c, x, -3, w); cm2 = _clamp_load(c, x, -2, w)
            cm1 = _clamp_load(c, x, -1, w); c0 = c[x]
            cp1 = _clamp_load(c, x, 1, w); cp2 = _clamp_load(c, x, 2, w)
            cp3 = _clamp_load(c, x, 3, w)
            nm3 = _clamp_load(n, x, -3, w); nm2 = _clamp_load(n, x, -2, w)
            nm1 = _clamp_load(n, x, -1, w); n0 = n[x]
            np1 = _clamp_load(n, x, 1, w); np2 = _clamp_load(n, x, 2, w)
            np3 = _clamp_load(n, x, 3, w)
            fwd1 = calc(cm1, c0, cp1)
            fwd2 = calc(np1, n0, nm1)
            bwd1 = calc(cp1, c0, cm1)
            bwd2 = calc(nm1, n0, np1)
            buf = [raw[i][b][x] for i in range(9)]
            mn = min(buf)
            # Fixed priority order (reference src/SangNom2.cpp:212-249:
            # "the order of following code is important").
            if buf[4] == mn or mn > aaf:
                v = avg(c0, n0)
            elif buf[5] == mn:
                v = avg(bwd1, bwd2)
            elif buf[3] == mn:
                v = avg(fwd1, fwd2)
            elif buf[6] == mn:
                v = avg(cp1, nm1)
            elif buf[2] == mn:
                v = avg(cm1, np1)
            elif buf[7] == mn:
                v = avg(cp2, nm2)
            elif buf[1] == mn:
                v = avg(cm2, np2)
            elif buf[8] == mn:
                v = avg(cp3, nm3)
            else:  # buf[0] == mn
                v = avg(cm3, np3)
            out[b - 1, x] = v
    return out


def deinterlace_plane_scalar(src: np.ndarray, offset: int, dh: bool,
                             aaf, fmt: VideoFormat, stride: int,
                             pool=None, sse2: bool = False) -> np.ndarray:
    """Full per-plane pipeline: field selection, boundary duplication,
    interpolation, assembly (reference GetFrame, src/SangNom2.cpp:332-397)."""
    h_src, w = src.shape
    h_out = h_src * 2 if dh else h_src
    kept = src if dh else src[offset::2]
    bufH = h_out // 2
    assert kept.shape[0] == bufH

    is_float = fmt.is_float
    mask = (1 << (8 * fmt.component_size)) - 1 if not is_float else 0
    interp = interpolate_field_scalar(kept, aaf, is_float, mask, stride, pool,
                                      sse2)

    out = np.zeros((h_out, w), dtype=src.dtype)
    out[offset::2] = kept
    if offset == 0:
        # bottom line can't be interpolated: duplicate the line above
        # (reference src/SangNom2.cpp:381-385)
        missing = np.concatenate([interp, kept[-1:]], axis=0)
        out[1::2] = missing
    else:
        # top line can't be interpolated: duplicate the line below
        # (reference src/SangNom2.cpp:386-391)
        missing = np.concatenate([kept[:1], interp], axis=0)
        out[0::2] = missing
    return out


def field_offset(order: int, frame_parity: bool) -> int:
    """order=0: per-frame parity; order=1: keep top; order=2: keep bottom
    (reference src/SangNom2.cpp:336-341)."""
    if order == 0:
        return 0 if frame_parity else 1
    return 0 if order == 1 else 1


def sangnom2_frame_scalar(
    planes: list[np.ndarray],
    fmt: VideoFormat,
    order: int = 1,
    aa: int = 48,
    aac: int = 0,
    dh: bool = False,
    luma: bool = True,
    chroma: bool = True,
    frame_parity: bool = True,
    pool=None,
    numerics: str = "c",
) -> list[np.ndarray]:
    """One frame through the full filter, all planes.

    ``pool``: carried shared-pool state for pool-compat mode (mutated in
    place and reusable for the next frame); None = zero contract."""
    offset = field_offset(order, frame_parity)
    aafs = scaled_aa_thresholds(aa, aac, fmt)
    stride = buffer_stride_elems(planes[0].shape[1], fmt.component_size)
    process = [luma, chroma, chroma]
    out = []
    for i, p in enumerate(planes):
        if i >= 3:
            # alpha plane: passthrough, line-doubled under dh (deviation:
            # the reference leaves dst alpha uninitialized,
            # src/SangNom2.cpp:347 caps at 3 planes)
            out.append(np.repeat(p, 2, axis=0) if dh else p.copy())
            continue
        if not dh and not process[i]:
            # unprocessed plane: verbatim copy (reference src/SangNom2.cpp:
            # 369-374); dh=True forces processing of every plane (361-366)
            out.append(p.copy())
            continue
        aaf = aaf_as_pixel(aafs[i], fmt)
        out.append(
            deinterlace_plane_scalar(p, offset, dh, aaf, fmt, stride, pool,
                                     sse2=(numerics == "sse2"))
        )
    return out


def sangnom2_clip_scalar(
    frames: list[list[np.ndarray]],
    fmt: VideoFormat,
    order: int = 1,
    aa: int = 48,
    aac: int = 0,
    dh: bool = False,
    luma: bool = True,
    chroma: bool = True,
    parities: list[bool] | None = None,
    pool_compat: bool = False,
    numerics: str = "c",
) -> list[list[np.ndarray]]:
    """A whole clip, optionally with the reference's shared-pool semantics:
    ONE pool (luma geometry) threaded through every processed plane of every
    frame in order (reference src/SangNom2.cpp:303-310 allocates it once in
    the constructor; GetFrame never reinitializes it)."""
    pool = None
    if pool_compat:
        h0, w0 = frames[0][0].shape
        stride = buffer_stride_elems(w0, fmt.component_size)
        pool_rows = (h0 * 2 if dh else h0) // 2
        pool = make_pool_scalar(stride, pool_rows, fmt.is_float)
    out = []
    for n, planes in enumerate(frames):
        par = parities[n] if parities is not None else True
        out.append(
            sangnom2_frame_scalar(
                planes, fmt, order, aa, aac, dh, luma, chroma,
                frame_parity=par, pool=pool, numerics=numerics,
            )
        )
    return out
