"""Scratch-buffer geometry and threshold precompute.

Replicates the reference constructor's derived quantities exactly, because
they are observable in the output (reference src/SangNom2.cpp:275-310):

- The 9 directional-error buffers are allocated with a stride rounded up to a
  32-byte alignment (reference src/SangNom2.cpp:16, 287).  The horizontal
  7-tap smoothing pass runs over — and clamps its taps at — that *padded*
  stride, not the plane width (reference src/SangNom2.cpp:136-152 iterate
  ``x in [0, bufferStride)``), so the padding columns are observable in the
  last <=3 output columns.  The reference leaves them uninitialized; this
  framework's contract defines them (and buffer rows 0 and H/2, likewise
  never written — reference src/SangNom2.cpp:79 vs 129-133) as ZERO.
- Buffer geometry is computed once from the LUMA plane and reused for chroma
  (reference src/SangNom2.cpp:287-288), so chroma error maps see zero padding
  out to the luma-derived stride.
- The `aa`/`aac` thresholds are pre-scaled by 21/16 (the smoothing stage sums
  21 taps but divides by 16) and by bit depth (reference src/SangNom2.cpp:
  280-282), then truncated to the pixel type when passed to the kernel
  (reference src/SangNom2.cpp:272 passes float ``aaf`` as ``const T``).
"""

from __future__ import annotations

import numpy as np

from sangnom_jax.core.formats import VideoFormat

# Scratch alignment in bytes (reference src/SangNom2.cpp:16).
ALIGNMENT_BYTES = 32


def buffer_stride_elems(luma_width: int, component_size: int) -> int:
    """Error-buffer stride in *elements*.

    The reference computes ``bufferStride = ceil32(width) * ComponentSize``
    in bytes (reference src/SangNom2.cpp:287) — note it rounds the width in
    pixels up to 32 first, so the element stride is ceil32(width) for every
    component size.
    """
    del component_size  # stride is 32-pixel aligned regardless of depth
    return -(-luma_width // 32) * 32


def buffer_height(output_height: int) -> int:
    """Number of kept-field lines: ``(height + 1) >> 1`` computed AFTER any
    `dh` height doubling (reference src/SangNom2.cpp:284-288)."""
    return (output_height + 1) >> 1


def scaled_aa_thresholds(aa: int, aac: int, fmt: VideoFormat) -> list[float]:
    """Per-plane anti-aliasing thresholds, float32-exact.

    Reference src/SangNom2.cpp:280-282: ``aaf[i] = aa_i * 21.0f / 16.0f``
    times ``1 << (bits - 8)`` for integer formats, divided by 256 for float.
    The arithmetic is single-precision in the reference; replicate with
    np.float32 so truncation edge cases match bit-for-bit.
    """
    aa_per_plane = [aa, aac, aac]
    out: list[float] = []
    for i in range(min(fmt.num_planes, 3)):
        v = np.float32(aa_per_plane[i]) * np.float32(21.0) / np.float32(16.0)
        if fmt.component_size < 4:
            v = v * np.float32(1 << (fmt.bits - 8))
        else:
            v = v / np.float32(256.0)
        out.append(float(v))
    return out


def aaf_as_pixel(aaf: float, fmt: VideoFormat):
    """The threshold as the kernel sees it: the reference passes the float
    ``aaf`` as ``const T`` (reference src/SangNom2.cpp:272), i.e. truncated
    toward zero for integer pixel types."""
    if fmt.is_float:
        return np.float32(aaf)
    return int(aaf)  # float->unsigned conversion truncates toward zero


# --- smoothing-width bounds ------------------------------------------------
# These are GEOMETRY facts (consequences of the zero-defined padding
# contract above), not kernel-implementation details: every backend — the
# jnp parity target (ops/reference), the Pallas kernel, the sharded paths
# (parallel/sharding) and the cost model — must agree on them bit-for-bit,
# so they live here and nothing imports a perf module for them.

# Trace-time switch for the geometric-decay smoothing bound below; exists
# so perf A/B harnesses can compile both variants in one process.
DECAY_BOUND = True


def round_up(x: int, m: int) -> int:
    """x rounded up to a multiple of m."""
    return -(-x // m) * m


def decay_hops(mask: int) -> int:
    """Rows until a zero-raw padding column provably decays to exactly 0.

    In the zero-defined padding (columns >= w) the raw maps are zero, so a
    padding column's smoothing recursion degenerates to
    ``sm[b][c] = hbox7(sm[b-1])[c] / 16`` — every tap of which is itself a
    padding value once c >= w+3.  With m_k bounding all rows' values at
    columns >= w + 3k, induction gives m_k = floor(7 * m_(k-1) / 16)
    (truncating integer division; the SSE2-numerics saturating writeback
    only lowers values), starting from m_0 = the storage-type max (the
    wrap/saturate writeback bounds every stored value by it).  m_k hits
    exactly 0 after 7 hops for u8, 14 for u16 — so all padding columns
    >= w + 3*hops are zero on every row, for any plane height.
    """
    m, k = mask, 0
    while m:
        m = (7 * m) >> 4
        k += 1
    return k


def creep_bound(w: int, bufH: int, spec=None) -> int:
    """Rightmost column (exclusive) the smoothing recursion can observably
    reach: w + 3 cols/row of recursion creep (+3 hbox taps), tightened by
    the integer decay bound (+6: the last computed columns clamp onto a
    provably-zero column).  Bit-exactness-critical — `width_tiers` and the
    sharded pre-padding (parallel/sharding._sharded_pad_width) MUST use
    the same bound, so both call this one helper.

    ``spec`` is duck-typed (needs ``.is_float`` and ``.mask`` — an
    ops.primitives.KernelSpec in practice; core stays import-free of ops).
    """
    creep = w + 3 * bufH + 3
    if DECAY_BOUND and spec is not None and not spec.is_float:
        creep = min(creep, w + 3 * decay_hops(spec.mask) + 6)
    return creep


def width_tiers(w: int, bufH: int, S: int, spec=None) -> tuple[int, int, int]:
    """(W_act, W_sm, S_clamp) — all 128-lane aligned, capped at S_pad.

    - ACTIVE width: pixel taps reach w+2 and output columns >= w are
      discarded, so the prepare/finalize stages only need ~w columns.
    - SMOOTHING width: the zero-padding creep is observable out to
      w + 3*bufH columns (3 columns/row through the recursion) — but for
      INTEGER formats the creep magnitude decays geometrically and hits
      exactly zero within `decay_hops` rows, so columns beyond
      w + 3*hops are zero forever and the smoothing pass stops there
      (+6: the last computed columns clamp their right taps onto a
      provably-zero column, making the early clamp invisible).  Float
      never decays to exact zero, so it keeps the full creep bound.
    For subsampled chroma (whose stride is LUMA-derived, SURVEY.md §2
    quirk 6: e.g. w=960, S=1920 at 1080p 4:2:0) this cuts the smoothing
    width 1792 -> 1024 while staying bit-exact (verified vs the full-
    stride native oracle by the parity suites).
    """
    S_pad = max(round_up(S, 128), 128)
    W_act = min(S_pad, max(round_up(w + 3, 128), 128))
    W_sm = min(S_pad, max(round_up(creep_bound(w, bufH, spec), 128), W_act))
    return W_act, W_sm, min(S, W_sm)
