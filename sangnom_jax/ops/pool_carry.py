"""Pool-compat backend: bit-exact emulation of the reference's SHARED buffer
pool (``pool_compat=True``).

The reference allocates ONE 9-buffer pool sized by the LUMA geometry
(stride = ceil32(luma width), bufferHeight = luma h_out/2; reference
src/SangNom2.cpp:287-288, 303-310) and reuses it for every plane of every
frame without reinitialization.  Each plane pass then

  * prepares only rows 1..h_p/2-1, cols 0..w_p-1 (src/SangNom2.cpp:75-124),
  * but SMOOTHS the full pool — all rows 1..bufferHeight-1 over the full
    stride (src/SangNom2.cpp:268-270: ``processBuffers_c(...bufferHeight)``),
  * and finalizes from rows 1..h_p/2-1, cols 0..w_p-1 (src/SangNom2.cpp:272).

For subsampled chroma the prepared region is strictly smaller than the
smoothed region, so the smoothing pass reads back the PREVIOUS pass's
smoothed data in the stale rows (rows >= h_c/2: the previous plane's maps)
and the stale columns (cols >= w_c: the previous plane's maps, whose
influence creeps 3 columns inward per smoothed row through the 7-tap
horizontal box).  That contamination is deterministic — the pool's only
never-written cells (row 0 and row bufferHeight, src/SangNom2.cpp:79 vs
129-133) are zero pages from the allocator in practice — so a live
reference build is reproducible bit-for-bit by threading the pool as
explicit state: planes in Y->U->V order within a frame, frames in clip
order (a `lax.scan`; frame parallelism is fundamentally unavailable in this
mode whenever the pool state survives a frame boundary, e.g. luma=False or
unaligned widths).

The default ``pool_compat=False`` path (ops/reference.py, the row-scan
kernel, and the sharded backends) instead zero-defines every out-of-plane pool cell
— deviation 1 in docs/PARITY.md — which is frame-parallel and identical to
this mode for the first processed plane of the first frame.

Numerics (maps, smoothing, priority select) are imported from
ops/reference.py — this module adds only the pool state threading, and
runs the XLA scan for every ``opt``.
"""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp

from sangnom_jax.core.formats import VideoFormat
from sangnom_jax.core.geometry import (
    aaf_as_pixel,
    buffer_height,
    buffer_stride_elems,
    scaled_aa_thresholds,
)
from sangnom_jax.ops.primitives import KernelSpec
from sangnom_jax.ops.reference import _error_maps, finalize_select, smooth_scan

Offset = Union[int, jax.Array]


def init_pool(luma_width: int, luma_h_out: int, fmt: VideoFormat) -> jnp.ndarray:
    """Fresh pool state: [9, bufferHeight+1, stride], all zero (the
    reference's pool is malloc'd fresh pages — zero in practice — and its
    never-written cells stay zero forever)."""
    spec = KernelSpec.from_format(fmt)
    stride = buffer_stride_elems(luma_width, fmt.component_size)
    buf_h = buffer_height(luma_h_out)
    return jnp.zeros((9, buf_h + 1, stride), spec.acc_dtype)


def interp_field_pool(
    kept: jnp.ndarray, pool: jnp.ndarray, aaf, spec: KernelSpec
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """One plane pass against the shared pool.

    kept: [bufH_p, w] storage-dtype kept field (bufH_p = h_p_out/2).
    pool: [9, P+1, S] accumulator-dtype carried pool (P = luma bufferHeight).
    Returns (interpolated rows [bufH_p-1, w] in the storage dtype, new pool).
    """
    out_dtype = kept.dtype
    kept = kept.astype(spec.acc_dtype)
    bufH_p, w = kept.shape
    P = pool.shape[1] - 1

    curr, nxt = kept[:-1], kept[1:]

    # prepare: overwrite rows 1..bufH_p-1, cols 0..w-1 ONLY — stale cells
    # elsewhere keep the previous pass's smoothed data
    if bufH_p >= 2:
        raw = _error_maps(curr, nxt, spec)  # [9, bufH_p-1, w]
        pool = jax.lax.dynamic_update_slice(pool, raw, (0, 1, 0))

    # smooth: the FULL pool, rows 1..P-1 over the full stride, in place;
    # the row-0 seed is the pool's (never-written, zero) row 0
    sm = smooth_scan(pool, spec, init=pool[:, 0])  # [P-1, 9, S]
    pool = pool.at[:, 1:P].set(jnp.moveaxis(sm, 0, 1))

    if bufH_p < 2:
        return jnp.zeros((0, w), out_dtype), pool

    # finalize: read back rows 1..bufH_p-1, cols 0..w-1
    bufs = pool[:, 1:bufH_p, :w]
    res = finalize_select(curr, nxt, bufs, aaf, spec)
    return res.astype(out_dtype), pool


def _gather_kept(p: jnp.ndarray, offset: Offset, dh: bool) -> jnp.ndarray:
    """Kept-field rows of one frame's plane ([h, w] -> [bufH_p, w])."""
    if dh:
        return p
    if isinstance(offset, int):
        return p[offset::2]
    rows = offset + 2 * jnp.arange(p.shape[0] // 2)
    return jnp.take(p, rows, axis=0)


def _assemble(kept: jnp.ndarray, interp: jnp.ndarray, offset: Offset):
    """Weave kept + missing lines with boundary duplication
    (reference src/SangNom2.cpp:376-391), single frame."""
    bufH_p, w = kept.shape

    def weave(top, bottom):
        return jnp.stack([top, bottom], axis=1).reshape(2 * bufH_p, w)

    out0 = weave(kept, jnp.concatenate([interp, kept[-1:]], axis=0))
    out1 = weave(jnp.concatenate([kept[:1], interp], axis=0), kept)
    if isinstance(offset, int):
        return out0 if offset == 0 else out1
    return jnp.where(offset == 0, out0, out1)


def sangnom2_pool_impl(
    planes,
    parity,
    fmt: VideoFormat,
    order: int,
    aa: int,
    aac: int,
    dh: bool,
    luma: bool,
    chroma: bool,
    pool0: jnp.ndarray | None = None,
    numerics: str = "c",
):
    """Whole-clip transform with the shared-pool bug-compat semantics.

    planes: tuple of [N, h_i, w_i] arrays; frames are processed sequentially
    (lax.scan) threading the pool, planes in index order within each frame —
    exactly the reference's pass order.  Returns (out_planes, final_pool) so
    streaming callers (CLI --window) can carry the pool across chunks.
    ``numerics="sse2"`` composes the SSE2 numeric contract with the pool
    carry — a live reference build on its vectorized path.

    """
    from sangnom_jax.ops.sangnom import field_offsets  # cycle-free at runtime

    spec = KernelSpec.from_format(fmt, sse2=(numerics == "sse2"))
    N, h0, w0 = planes[0].shape
    h_out0 = 2 * h0 if dh else h0
    if pool0 is None:
        pool0 = init_pool(w0, h_out0, fmt)
    aafs = scaled_aa_thresholds(aa, aac, fmt)
    process = [luma, chroma, chroma]
    offsets = field_offsets(order, parity)
    static_off = isinstance(offsets, int)

    def frame_step(pool, xs):
        fplanes = xs[:-1]
        off = offsets if static_off else xs[-1]
        outs = []
        for i, p in enumerate(fplanes):
            if i >= 3:
                # alpha: passthrough (the reference never feeds it through
                # the pool, src/SangNom2.cpp:347)
                outs.append(jnp.repeat(p, 2, axis=0) if dh else p)
                continue
            if not dh and not process[i]:
                outs.append(p)  # skipped plane: pool untouched
                continue
            kept = _gather_kept(p, off, dh)
            aaf = aaf_as_pixel(aafs[i], fmt)
            interp, pool = interp_field_pool(kept, pool, aaf, spec)
            outs.append(_assemble(kept, interp, off))
        return pool, tuple(outs)

    xs = tuple(planes) + (
        (jnp.zeros((N,), jnp.int32),) if static_off else (offsets,)
    )
    final_pool, outs = jax.lax.scan(frame_step, pool0, xs)
    return outs, final_pool
