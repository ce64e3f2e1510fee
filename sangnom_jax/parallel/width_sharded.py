"""Width-sharded interpolation: spatial (context-parallel-style) scaling
with a per-step halo exchange between devices.

The smoothing recursion propagates horizontal influence 3 columns per row
(sm[b][x] depends on sm[b-1][x±3], reference src/SangNom2.cpp:129-152), so a
width shard cannot precompute a fixed halo: it exchanges a 3-column halo of
the in-flight line with its neighbors at EVERY scan step via `lax.ppermute`
— the structural analogue of ring/context-parallel halo exchange (SURVEY.md
§5 "Long-context / sequence parallelism").

Stride semantics: the caller pads every plane to the luma-derived buffer
stride S with EDGE REPLICATION before sharding (sangnom_jax.parallel.
sharding), so (a) pixel taps that would clamp at the true plane width w read
the replicated edge pixel — exactly loadPixel's clamp (reference
src/SangNom2.cpp:25-34); (b) the smoothing clamp at S falls on the global
array edge, realized by edge-replicated halos on the boundary shards; and
(c) the zero-defined raw-map padding columns [w, S) (SURVEY.md §2 quirk 2)
are recreated by masking raw maps against the GLOBAL column index — this is
what makes horizontally subsampled chroma (w < S) bit-exact, including its
observable zero-padding creep.

NUMERICS LIVE IN ops/reference.py: this module only contributes the tap
source (halo-extended slices instead of clamped shifts) and the
halo-exchanging hbox; maps, the smoothing recursion, and the priority
select are the shared `error_maps_from_taps` / `smooth_scan` /
`finalize_select_from_taps`, so the two backends cannot drift.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sangnom_jax.ops.primitives import KernelSpec, calc_sangnom
from sangnom_jax.ops.reference import (
    error_maps_from_taps,
    finalize_select_from_taps,
    smooth_scan,
)


def _exchange_halo(x: jnp.ndarray, radius: int, axis_name: str) -> jnp.ndarray:
    """[..., W_loc] -> [..., W_loc + 2*radius]: neighbors' edge columns via
    ppermute; global boundaries get edge-replication (clamp semantics,
    reference loadPixel src/SangNom2.cpp:25-34)."""
    n = jax.lax.axis_size(axis_name)
    if n == 1:
        left = jnp.broadcast_to(x[..., :1], x.shape[:-1] + (radius,))
        right = jnp.broadcast_to(x[..., -1:], x.shape[:-1] + (radius,))
        return jnp.concatenate([left, x, right], axis=-1)
    idx = jax.lax.axis_index(axis_name)
    # halo from the left neighbor: its rightmost columns travel i -> i+1
    left_halo = jax.lax.ppermute(
        x[..., -radius:], axis_name, [(i, i + 1) for i in range(n - 1)]
    )
    right_halo = jax.lax.ppermute(
        x[..., :radius], axis_name, [(i + 1, i) for i in range(n - 1)]
    )
    edge_l = jnp.broadcast_to(x[..., :1], x.shape[:-1] + (radius,))
    edge_r = jnp.broadcast_to(x[..., -1:], x.shape[:-1] + (radius,))
    left_halo = jnp.where(idx == 0, edge_l, left_halo)
    right_halo = jnp.where(idx == n - 1, edge_r, right_halo)
    return jnp.concatenate([left_halo, x, right_halo], axis=-1)


def _taps7_ext(ext: jnp.ndarray, w_loc: int) -> list[jnp.ndarray]:
    """Plain shifted slices of a halo-extended array (radius 3)."""
    return [ext[..., 3 + k : 3 + k + w_loc] for k in range(-3, 4)]


def _pair_taps_halo(curr_ext, nxt_ext, w_loc, spec):
    """The sharded tap source: same (taps, preds) contract as
    ops.reference.pair_taps, derived from halo-extended rows."""
    cm3, cm2, cm1, c0, cp1, cp2, cp3 = _taps7_ext(curr_ext, w_loc)
    nm3, nm2, nm1, n0, np1, np2, np3 = _taps7_ext(nxt_ext, w_loc)
    fwd1 = calc_sangnom(cm1, c0, cp1, spec)
    fwd2 = calc_sangnom(np1, n0, nm1, spec)
    bwd1 = calc_sangnom(cp1, c0, cm1, spec)
    bwd2 = calc_sangnom(nm1, n0, np1, spec)
    taps = (cm3, cm2, cm1, c0, cp1, cp2, cp3, nm3, nm2, nm1, n0, np1, np2, np3)
    return taps, (fwd1, fwd2, bwd1, bwd2)


def interpolate_field_width_sharded(
    kept: jnp.ndarray, aaf, spec: KernelSpec, axis_name: str,
    plane_width: int | None = None,
) -> jnp.ndarray:
    """Shard-local kept field [N, bufH, W_loc] -> [N, bufH-1, W_loc].

    Must run inside `shard_map` with the width axis mapped to ``axis_name``;
    the global (unsharded) width is the buffer stride S, edge-replicated
    beyond ``plane_width`` (see module docstring).  Takes and returns the
    storage dtype; bit-exact to the unsharded backends.
    """
    out_dtype = kept.dtype
    N, bufH, w_loc = kept.shape
    kept = kept.astype(spec.acc_dtype)
    if bufH < 2:
        return jnp.zeros((N, 0, w_loc), out_dtype)

    keptx = _exchange_halo(kept, 3, axis_name)  # one exchange for pixel taps
    taps, preds = _pair_taps_halo(keptx[:, :-1], keptx[:, 1:], w_loc, spec)

    raw = error_maps_from_taps(taps, preds)  # [9, N, bufH-1, W_loc]
    if plane_width is not None:
        # zero-defined raw padding beyond the TRUE plane width (global cols)
        gcol = (
            jax.lax.axis_index(axis_name) * w_loc
            + jax.lax.broadcasted_iota(jnp.int32, (1, 1, 1, w_loc), 3)
        )
        raw = jnp.where(gcol < plane_width, raw, jnp.zeros((), raw.dtype))
    raw = jnp.pad(raw, ((0, 0), (0, 0), (1, 1), (0, 0)))  # zero rows 0, bufH

    def hbox_halo(line):
        # per-step 3-column halo exchange: the collective on the
        # recursion's critical path
        linex = _exchange_halo(line, 3, axis_name)
        t = _taps7_ext(linex, w_loc)
        h = t[0]
        for tp in t[1:]:
            h = h + tp
        return h

    sm = smooth_scan(raw, spec, hbox_fn=hbox_halo, row_axis=2)
    bufs = jnp.moveaxis(sm, 0, 2)  # [9, N, bufH-1, W_loc]

    res = finalize_select_from_taps(taps, preds, bufs, aaf, spec)
    return res.astype(out_dtype)
