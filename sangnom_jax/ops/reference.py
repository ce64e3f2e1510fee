"""Bit-exact jnp kernel — the numerics ground truth (opt=0 backend).

A pure-functional XLA implementation of the reference's C kernel path
(reference src/SangNom2.cpp:74-273), dtype-parameterized exactly as the
reference's template instantiations (u8->i16, u16->i32, f32->f32; here all
integer work rides int32 lanes, which reproduces the narrower accumulators
exactly since they never overflow).

Stage structure (reference sangnom_c, src/SangNom2.cpp:259-273):
  1. prepare  — 9 directional error maps between adjacent kept lines,
     fully vectorized (shifted-slice arithmetic, no gather loops).
  2. smooth   — the 3x7 box filter.  CRITICAL: the reference smooths IN
     PLACE, so each row's vertical 3-sum reads the already-smoothed row
     above (src/SangNom2.cpp:129-131, 155-157).  That makes it a true scan
     over rows, realized here as `lax.scan` carrying the previous smoothed
     row; a plain convolution is NOT bit-exact.
  3. finalize — 9-way min + fixed-priority select, realized as reverse-order
     masked overwrites (ties must break by the C if-chain's priority,
     src/SangNom2.cpp:212-249 — argmin breaks ties differently).

Zero-defined contract (deviation from the reference's uninitialized reads,
SURVEY.md §2 quirks 1-2): buffer rows 0 and bufH and padding columns
[w, stride) are zero.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from sangnom_jax.ops.primitives import (
    KernelSpec,
    abs_diff,
    avg_pair,
    calc_sangnom,
    neighborhood,
    smooth_writeback,
)


def pair_taps(curr, nxt, spec: KernelSpec):
    """(taps, preds) of a kept-line pair: the 14 edge-clamped neighborhood
    taps and 4 directional predictors (reference src/SangNom2.cpp:87-106).
    The single tap source for the unsharded backends; the width-sharded
    backend derives the same values from halo-extended slices instead and
    feeds them to the shared map/finalize stages below."""
    cm3, cm2, cm1, c0, cp1, cp2, cp3 = neighborhood(curr, 3)
    nm3, nm2, nm1, n0, np1, np2, np3 = neighborhood(nxt, 3)
    fwd1 = calc_sangnom(cm1, c0, cp1, spec)
    fwd2 = calc_sangnom(np1, n0, nm1, spec)
    bwd1 = calc_sangnom(cp1, c0, cm1, spec)
    bwd2 = calc_sangnom(nm1, n0, np1, spec)
    taps = (cm3, cm2, cm1, c0, cp1, cp2, cp3,
            nm3, nm2, nm1, n0, np1, np2, np3)
    return taps, (fwd1, fwd2, bwd1, bwd2)


def error_maps_list(taps, preds) -> list:
    """The 9 raw directional error maps from pair taps/predictors, as a
    LIST in spatial priority order (reference enum Buffers,
    src/SangNom2.h:8-20; stores at src/SangNom2.cpp:103-117) — callers that
    need a different stacking axis (the time-major pool backend) use this
    form to avoid a materialized transpose."""
    (cm3, cm2, cm1, c0, cp1, cp2, cp3,
     nm3, nm2, nm1, n0, np1, np2, np3) = taps
    fwd1, fwd2, bwd1, bwd2 = preds
    return [
        abs_diff(cm3, np3),  # 0 ADIFF_M3_P3
        abs_diff(cm2, np2),  # 1 ADIFF_M2_P2
        abs_diff(cm1, np1),  # 2 ADIFF_M1_P1
        abs_diff(fwd1, fwd2),  # 3 SG_FORWARD
        abs_diff(c0, n0),  # 4 ADIFF_P0_M0
        abs_diff(bwd1, bwd2),  # 5 SG_REVERSE
        abs_diff(cp1, nm1),  # 6 ADIFF_P1_M1
        abs_diff(cp2, nm2),  # 7 ADIFF_P2_M2
        abs_diff(cp3, nm3),  # 8 ADIFF_P3_M3
    ]


def error_maps_from_taps(taps, preds) -> jnp.ndarray:
    """The 9 raw directional error maps from pair taps/predictors.

    Returns [9, ...] indexed in spatial priority order."""
    return jnp.stack(error_maps_list(taps, preds))


def _error_maps(curr, nxt, spec: KernelSpec) -> jnp.ndarray:
    """The 9 raw directional error maps for each kept-line pair.

    curr/nxt: [..., R, w] accumulator-dtype rows.  Returns [9, ..., R, w]."""
    return error_maps_from_taps(*pair_taps(curr, nxt, spec))


def _hbox7(line: jnp.ndarray) -> jnp.ndarray:
    """7-tap horizontal box sum with taps edge-clamped at the padded stride
    (reference src/SangNom2.cpp:141-152: loadPixel against bufferStride)."""
    t = neighborhood(line, 3)
    # same left-to-right association as the C expression (float exactness)
    s = t[0]
    for k in range(1, 7):
        s = s + t[k]
    return s


def smooth_scan(
    raw: jnp.ndarray,
    spec: KernelSpec,
    init: jnp.ndarray | None = None,
    hbox_fn=None,
    row_axis: int = 1,
) -> jnp.ndarray:
    """The recursive 3x7 smoothing over buffer rows 1..bufH-1.

    raw: raw error maps with the buffer-row dimension at ``row_axis``
    ([9, bufH+1, S] by default); rows 0 and bufH are the pool's boundary
    rows — zero under the zero-defined contract; carried pool content in
    pool-compat mode, which passes ``init`` = pool row 0.
    ``hbox_fn``: the horizontal 7-tap box sum (defaults to the local
    stride-clamped `_hbox7`; the width-sharded backend passes a
    halo-exchanging variant so the recursion itself is shared).
    Returns smoothed rows, time-major: [bufH-1, 9, ...].
    """
    bufH = raw.shape[row_axis] - 1
    if hbox_fn is None:
        hbox_fn = _hbox7
    rows = jnp.moveaxis(raw, row_axis, 1)  # [9, bufH+1, ...]

    def step(prev_sm, xs):
        rb, rb1 = xs  # raw row b, raw row b+1 — each [9, ...]
        line = prev_sm + rb + rb1  # vertical 3-sum; row b-1 already smoothed
        sm = smooth_writeback(hbox_fn(line), spec)
        return sm, sm

    xs = (
        jnp.moveaxis(rows[:, 1:bufH], 1, 0),  # raw rows 1..bufH-1
        jnp.moveaxis(rows[:, 2 : bufH + 1], 1, 0),  # raw rows 2..bufH
    )
    if init is None:  # smoothed "row 0" seed
        init = jnp.zeros(rows.shape[:1] + rows.shape[2:], rows.dtype)
    _, sm = jax.lax.scan(step, init, xs)
    return sm


def finalize_select_from_taps(taps, preds, bufs, aaf, spec: KernelSpec):
    """Stage 3: 9-way min + fixed-priority select over smoothed error maps.

    taps/preds: as returned by `pair_taps` (or the sharded halo variant);
    bufs: [9, ...] smoothed maps. Returns accumulator-dtype results.

    Realized as reverse-priority masked overwrites: the LAST write wins, so
    writes run from the lowest-priority direction (buf0) up to the
    vertical/threshold case — the same trick the reference's SIMD path uses
    (reference src/SangNom2_SSE2.cpp:1032-1058, "write output in reverse
    order"), exactly matching the C if-chain priority
    (src/SangNom2.cpp:212-249).  Shared by the unsharded, width-sharded and
    pool-compat backends so the numerics exist exactly once.
    """
    (cm3, cm2, cm1, c0, cp1, cp2, cp3,
     nm3, nm2, nm1, n0, np1, np2, np3) = taps
    fwd1, fwd2, bwd1, bwd2 = preds

    if isinstance(bufs, (list, tuple)):
        # sequence form (the time-major pool backend): the 9-way min as a
        # chained jnp.minimum — exact for integers regardless of
        # association (the float pool path passes a stacked array instead,
        # keeping jnp.min's reduction)
        import functools

        mn = functools.reduce(jnp.minimum, bufs)
    else:
        mn = jnp.min(bufs, axis=0)

    res = avg_pair(cm3, np3, spec)  # buf0 ADIFF_M3_P3 (lowest priority)
    for idx, val in (
        (8, avg_pair(cp3, nm3, spec)),  # ADIFF_P3_M3
        (1, avg_pair(cm2, np2, spec)),  # ADIFF_M2_P2
        (7, avg_pair(cp2, nm2, spec)),  # ADIFF_P2_M2
        (2, avg_pair(cm1, np1, spec)),  # ADIFF_M1_P1
        (6, avg_pair(cp1, nm1, spec)),  # ADIFF_P1_M1
        (3, avg_pair(fwd1, fwd2, spec)),  # SG_FORWARD
        (5, avg_pair(bwd1, bwd2, spec)),  # SG_REVERSE
    ):
        res = jnp.where(bufs[idx] == mn, val, res)
    # highest priority: vertical if it ties the min OR the min exceeds aaf
    # (reference src/SangNom2.cpp:214-217)
    aaf_c = jnp.asarray(aaf, c0.dtype)
    return jnp.where((bufs[4] == mn) | (mn > aaf_c), avg_pair(c0, n0, spec), res)


def finalize_select(curr, nxt, bufs, aaf, spec: KernelSpec) -> jnp.ndarray:
    """`finalize_select_from_taps` with taps recomputed from the kept-line
    pair (the reference recomputes them too, src/SangNom2.cpp:176-195)."""
    taps, preds = pair_taps(curr, nxt, spec)
    return finalize_select_from_taps(taps, preds, bufs, aaf, spec)


def interpolate_field(
    kept: jnp.ndarray, aaf, spec: KernelSpec, stride: int
) -> jnp.ndarray:
    """Interpolate the interior missing lines from the kept field.

    kept: [bufH, w] in the storage dtype (u8/u16/f32); widened internally.
    aaf: pre-scaled threshold as the kernel sees it (int or float32).
    stride: padded buffer stride in elements (luma-derived, SURVEY.md §2 q6).
    Returns [bufH-1, w] interpolated lines back in the storage dtype.
    """
    out_dtype = kept.dtype
    kept = kept.astype(spec.acc_dtype)
    bufH, w = kept.shape
    if bufH < 2:
        return jnp.zeros((0, w), out_dtype)

    curr, nxt = kept[:-1], kept[1:]  # kept pairs for buffer rows 1..bufH-1

    # Smoothing width: the zero-defined padding decays to EXACT zero within
    # `decay_hops` rows for integer formats (see core.geometry.width_tiers
    # — same proof, same +6 clamp parking; the fused kernel's bound is
    # oracle-verified), so the scan needn't run the full luma-derived
    # stride.  Float keeps the stride (no exact decay).
    S_sm = stride
    if not spec.is_float:
        from sangnom_jax.core.geometry import decay_hops

        S_sm = min(stride, w + 3 * decay_hops(spec.mask) + 6)

    # stage 1: prepare (reference src/SangNom2.cpp:74-124)
    raw = _error_maps(curr, nxt, spec)  # [9, bufH-1, w]
    raw = jnp.pad(raw, ((0, 0), (1, 1), (0, S_sm - w)))  # zero-defined pool

    # stage 2: smooth (reference src/SangNom2.cpp:126-159)
    sm = smooth_scan(raw, spec)  # [bufH-1, 9, S]
    bufs = jnp.moveaxis(sm[..., :w], 1, 0)  # [9, bufH-1, w]

    # stage 3: finalize (reference src/SangNom2.cpp:161-257)
    res = finalize_select(curr, nxt, bufs, aaf, spec)
    return res.astype(out_dtype)


def _device_bytes() -> int:
    """Memory of this process's first device: what the allocator reports,
    or the host's physical memory for a backend that reports none (the
    CPU)."""
    stats = jax.local_devices()[0].memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def scan_batch(bufH: int, S: int) -> int:
    """Frames per scan invocation.  One scan over the whole batch is the
    fastest form (on an H100, 54 ms for the 120-frame 1080p true bob
    against 238 ms in chunks of 8), so the chunk is bounded only by
    memory: about six [9, bufH, S] int32 arrays live per frame (raw maps,
    the scan's two row views, the smoothed rows and their transpose),
    kept within half of the device's memory."""
    per_frame = 6 * 9 * (bufH + 1) * S * 4
    return max(1, (_device_bytes() // 2) // per_frame)


def interpolate_field_batch(
    kept: jnp.ndarray, aaf, spec: KernelSpec, stride: int,
    plane_width: int | None = None,
) -> jnp.ndarray:
    """Batched-over-frames variant: [N, bufH, w] -> [N, bufH-1, w].

    ``plane_width`` exists for interface parity with the sharded backend;
    on the unsharded path the array width IS the plane width.

    The frame batch is the framework's analogue of the reference's
    MT_MULTI_INSTANCE frame parallelism (reference src/SangNom2.h:63-66) —
    embarrassingly parallel, batched via vmap.
    """
    N, bufH, w = kept.shape
    run = jax.vmap(lambda k: interpolate_field(k, aaf, spec, stride))
    g = scan_batch(bufH, stride)
    if N <= g:
        return run(kept)
    pad = (-N) % g
    kp = jnp.pad(kept, ((0, pad), (0, 0), (0, 0)))
    out = jax.lax.map(run, kp.reshape(-1, g, bufH, w))
    return out.reshape(-1, max(bufH - 1, 0), w)[:N]
