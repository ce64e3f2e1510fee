"""Row-scan Pallas kernel for NVIDIA Hopper (Triton route) — the opt=1 backend.

Fuses the reference's three raster passes (prepare -> 9x smooth -> finalize,
reference src/SangNom2.cpp:259-273) into one kernel, so the 9 error maps
never round-trip through device memory as whole planes.

One program owns one (frame, plane) pair; the grid spreads over frames.
The in-place vertical smoothing recursion (SURVEY.md §2 quirk 1; reference
src/SangNom2.cpp:129-131, 155-157) is a `lax.fori_loop` over buffer rows
inside the program.  Its dependency cone widens 3 columns per row, so a
program holds the full padded row (1920 -> 2048 columns, 3840 -> 4096).

Per row b (buffer rows 1..bufH-1), for each map m in finalize priority
order:

    raw[b+1]_m  = |a_m - b_m| of kept pair (b, b+1)     zero past the end
    line_m      = carry_m + raw[b+1]_m                  carry = sm[b-1] + raw[b]
    sm[b]_m     = hbox7_clamped(line_m) / 16            via the line scratch
    carry_m    <- sm[b]_m + raw[b+1]_m
    select     <- streaming argmin over sm[b]_m with pair (b-1, b) operands

Triton has no lane rotate, so the 7-tap box reads shifted, clamped columns
back from a per-program line scratch (a second output, L1/L2-resident)
after a block barrier.  Raw maps and pixel taps are recomputed from the
kept rows instead of being carried (the reference recomputes too,
src/SangNom2.cpp:176-195).  The finalize select streams over the maps in
priority order and takes a map only when it is strictly smaller than the
running minimum — the first map reaching the minimum wins, exactly the C
if-chain (src/SangNom2.cpp:212-249).

The kernel reads kept rows straight from the source plane (a dh field, a
frame's kept field at row stride 2, or an interlaced frame's field for the
bob pipeline) and writes the complete woven plane, so no field split or
interleave pass runs in XLA.

Clamp geometry matches the reference: pixel taps clamp at the plane width
w (loadPixel, src/SangNom2.cpp:25-34), smoothing taps at the buffer stride
(src/SangNom2.cpp:141-150), tightened to the creep/decay bound of
`core.geometry.width_tiers`.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from sangnom_jax.core.geometry import width_tiers
from sangnom_jax.ops.primitives import (
    KernelSpec,
    abs_diff,
    avg_pair,
    calc_sangnom,
    smooth_writeback,
)

# Finalize order: vertical first, then the C if-chain (src/SangNom2.cpp:
# 214-249).  Spatial map index -> curr tap shift k of its ADIFF pair
# (the next row's tap is at -k); maps 3 and 5 are the predictor pairs.
_PRIORITY = (4, 5, 3, 6, 2, 7, 1, 8, 0)
_SHEAR = {0: -3, 1: -2, 2: -1, 4: 0, 6: 1, 7: 2, 8: 3}


class KernelUnavailable(RuntimeError):
    """The row-scan kernel was asked for where it cannot compile."""


def interpret_mode() -> bool:
    """Whether the kernel runs in the Pallas interpreter.  Decided here
    only: compiled on a GPU; interpreted on the CPU backend when
    ``SANGNOM_INTERPRET=1`` asks for it (the test suite does); refused
    anywhere else."""
    backend = jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu" and os.environ.get("SANGNOM_INTERPRET", "") == "1":
        return True
    raise KernelUnavailable(
        f"the opt=1 kernel needs a GPU backend (default backend is "
        f"{backend!r}; SANGNOM_INTERPRET=1 runs it interpreted on the CPU)"
    )


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _num_warps(Wb: int) -> int:
    return max(4, min(16, Wb // 256))


def pair_operands(m: int, tap_c, tap_n, spec: KernelSpec):
    """(a, b) of map m for a kept pair: |a - b| is the raw error map and
    avg(a, b) the interpolation along that direction (reference
    src/SangNom2.cpp:87-117, 214-249).  ``tap_c(k)`` / ``tap_n(k)`` give
    the clamped taps of the current / next kept row at shift k."""
    if m == 3:
        return (calc_sangnom(tap_c(-1), tap_c(0), tap_c(1), spec),
                calc_sangnom(tap_n(1), tap_n(0), tap_n(-1), spec))
    if m == 5:
        return (calc_sangnom(tap_c(1), tap_c(0), tap_c(-1), spec),
                calc_sangnom(tap_n(-1), tap_n(0), tap_n(1), spec))
    k = _SHEAR[m]
    return tap_c(k), tap_n(-k)


def select_step(state, sm_m, ops_m):
    """One step of the streaming priority select: ``state`` is None before
    the first (vertical) map, else (running min, a, b).  A later map wins
    only when strictly smaller, so the earliest map in `_PRIORITY` that
    reaches the minimum is kept."""
    a_m, b_m = ops_m
    if state is None:
        return sm_m, a_m, b_m
    mn, a, b = state
    hit = sm_m < mn
    return (jnp.where(hit, sm_m, mn), jnp.where(hit, a_m, a),
            jnp.where(hit, b_m, b))


def select_finish(state, vert_ops, aaf, spec: KernelSpec):
    """The threshold override (min above aaf -> vertical,
    src/SangNom2.cpp:214-217) and the directional average."""
    mn, a, b = state
    over = mn > jnp.asarray(aaf, mn.dtype)
    return avg_pair(jnp.where(over, vert_ops[0], a),
                    jnp.where(over, vert_ops[1], b), spec)


def _finalize(v, sm, aaf, spec: KernelSpec):
    """The kernel's select outside the kernel, on the reference layout:
    ``v`` = 14 taps (curr -3..+3, next -3..+3) + 4 predictors (fwd1, fwd2,
    bwd1, bwd2), ``sm`` = the 9 smoothed maps in spatial order."""
    taps_c = dict(zip(range(-3, 4), v[0:7]))
    taps_n = dict(zip(range(-3, 4), v[7:14]))
    preds = {3: (v[14], v[15]), 5: (v[16], v[17])}
    state = None
    for m in _PRIORITY:
        ops = preds.get(m) or (taps_c[_SHEAR[m]], taps_n[-_SHEAR[m]])
        state = select_step(state, sm[m], ops)
    return select_finish(state, (taps_c[0], taps_n[0]), aaf, spec)


def _kernel(*refs, spec, aaf, w, S_clamp, Wb, bufH, src_rows, per_frame,
            static_off, tff, interpret):
    if per_frame:
        src_ref, off_ref, out_ref, line_ref, carry_ref = refs
    else:
        (src_ref, out_ref, line_ref, carry_ref), off_ref = refs, None
    acc = spec.acc_dtype
    i = pl.program_id(0)
    col = jnp.arange(Wb, dtype=jnp.int32)
    off = off_ref[i] if per_frame else static_off

    # kept row r of this program's frame: src[fi, r0 + rs * r]
    if src_rows == "interlaced":
        fi, r0, rs = i // 2, (i % 2) ^ (0 if tff else 1), 2
    elif src_rows == "field":
        fi, r0, rs = i, off, 2
    else:
        fi, r0, rs = i, 0, 1

    def kept_row(r):
        return src_ref[fi, r0 + rs * r, jnp.minimum(col, w - 1)]

    def taps_of(r):
        cache = {}

        def tap(k):
            if k not in cache:
                idx = jnp.clip(col + k, 0, w - 1)
                cache[k] = src_ref[fi, r0 + rs * r, idx].astype(acc)
            return cache[k]
        return tap

    in_plane = col < w
    zero = jnp.zeros((), acc)

    def put(row, val):
        plgpu.store(out_ref.at[i, row, pl.ds(0, Wb)],
                    val.astype(out_ref.dtype), mask=in_plane)

    barrier = (lambda: None) if interpret else plgpu.debug_barrier
    wb_idx = [jnp.clip(col + k, 0, S_clamp - 1) for k in range(-3, 4)]

    # carry <- sm[0] + raw[1] = raw[1] (buffer row 0 is zero-defined)
    tc, tn = taps_of(0), taps_of(1)
    for m in range(9):
        a, b = pair_operands(m, tc, tn, spec)
        carry_ref[i, m, :] = jnp.where(in_plane, abs_diff(a, b), zero)
    put(off, kept_row(0))
    # the scratch rows are written and read back by different threads:
    # every later access of a row is ordered behind a barrier like this one
    barrier()

    def body(bi, _):
        nxt = jnp.minimum(bi + 1, bufH - 1)
        live = (bi + 1 < bufH) & in_plane  # raw[bufH] is zero-defined
        prev_c, prev_n = taps_of(bi - 1), taps_of(bi)  # finalize pair
        cur_c, cur_n = prev_n, taps_of(nxt)  # raw[b+1] pair
        state = None
        for m in _PRIORITY:
            a, b = pair_operands(m, cur_c, cur_n, spec)
            raw = jnp.where(live, abs_diff(a, b), zero)
            line_ref[i, m, :] = carry_ref[i, m, :] + raw
            barrier()
            # reference association: left-to-right over the 7 taps
            h = line_ref[i, m, wb_idx[0]]
            for idx in wb_idx[1:]:
                h = h + line_ref[i, m, idx]
            sm = smooth_writeback(h, spec)
            carry_ref[i, m, :] = sm + raw
            state = select_step(state, sm,
                                pair_operands(m, prev_c, prev_n, spec))
        res = select_finish(state, (prev_c(0), prev_n(0)), aaf, spec)
        put(2 * bi - 1 + off, res)
        put(2 * bi + off, kept_row(bi))

    jax.lax.fori_loop(1, bufH, body, None)
    # the one uninterpolatable line duplicates its kept neighbour
    # (reference src/SangNom2.cpp:379-391; offset 0: the bottom line,
    # offset 1: the top line)
    put((1 - off) * (2 * bufH - 1), kept_row((1 - off) * (bufH - 1)))


def interpolate_field_batch(
    kept: jnp.ndarray, aaf, spec: KernelSpec, stride: int,
    plane_width: int | None = None,
) -> jnp.ndarray:
    """[N, bufH, w] kept field (storage dtype) -> [N, bufH-1, w]
    interpolated lines: the backend interface `ops.sangnom` dispatches
    through (``plane_width`` is for interface parity with the
    width-sharded backend).  The dispatch takes the woven form,
    `deinterlace_field_batch_fused`, whenever bufH >= 2; this one picks
    the interpolated rows out of it."""
    N, bufH, w = kept.shape
    if bufH < 2:
        return jnp.zeros((N, 0, w), kept.dtype)
    return deinterlace_field_batch_fused(kept, 0, aaf, spec, stride)[:, 1:-1:2]


def deinterlace_field_batch_fused(
    src: jnp.ndarray, offset, aaf, spec: KernelSpec, stride: int,
    dh: bool = True, interlaced_tff: bool | None = None,
) -> jnp.ndarray:
    """The complete deinterlaced plane [N, 2*bufH, w], kept and
    interpolated rows interleaved per ``offset`` (a static int or a
    per-frame [N] array) with the boundary line duplicated.

    ``src`` is the dh field [N, bufH, w] (``dh=True``), the full frames
    [N, 2*bufH, w] whose kept field the kernel reads at row stride 2
    (``dh=False``), or — ``interlaced_tff`` not None — interlaced frames
    [N/2, 2*bufH, w] of which output frame 2j+b takes field b of frame j
    in dominance order (the bob pipeline)."""
    if interlaced_tff is not None:
        n_in, H, w = src.shape
        N, bufH, src_rows = 2 * n_in, H // 2, "interlaced"
    elif dh:
        N, bufH, w = src.shape
        src_rows = "kept"
    else:
        N, H, w = src.shape
        bufH, src_rows = H // 2, "field"
    # columns at or beyond the smoothing clamp are never read back, and
    # the clamp covers the plane (S_clamp >= w)
    _, _, S_clamp = width_tiers(w, bufH, stride, spec)
    Wb = _pow2(S_clamp)
    per_frame = not isinstance(offset, int)
    interpret = interpret_mode()
    kernel = functools.partial(
        _kernel, spec=spec, aaf=aaf, w=w, S_clamp=S_clamp, Wb=Wb, bufH=bufH,
        src_rows=src_rows, per_frame=per_frame,
        static_off=0 if per_frame else offset, tff=interlaced_tff,
        interpret=interpret,
    )
    scratch = jax.ShapeDtypeStruct((N, 9, Wb), spec.acc_dtype)
    operands = (src, jnp.asarray(offset, jnp.int32)) if per_frame else (src,)
    out, _, _ = pl.pallas_call(
        kernel,
        grid=(N,),
        out_shape=(jax.ShapeDtypeStruct((N, 2 * bufH, w), src.dtype),
                   scratch, scratch),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_num_warps(Wb),
                                             num_stages=1),
        interpret=interpret,
        name="sangnom_row_scan",
    )(*operands)
    return out


# consumed by ops.sangnom.deinterlace_plane_batch for unsharded dispatches
interpolate_field_batch.fused_weave = deinterlace_field_batch_fused
