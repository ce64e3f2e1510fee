"""Vectorized math primitives shared by the jnp-reference and Pallas kernels.

Each helper replicates one scalar primitive of the reference's C path
(the parity target, reference src/SangNom2.cpp:25-72) as a whole-array op:

  - `neighborhood`    <-> loadPixel edge-clamped gather (src/SangNom2.cpp:25-34)
  - `calc_sangnom`    <-> calculateSangNom (4a+5b-c)>>3 w/ wrap (60-72)
  - `avg_pair`        <-> avg round-half-up / float half (48-58)

Integer work is carried in int32 lanes; the C paths' narrower accumulators
(i16 for 8-bit) never overflow i16, so i32 reproduces them exactly.
Wrap-on-cast-to-pixel-type is an `& mask`.
"""

from __future__ import annotations

import dataclasses
import enum

import jax.numpy as jnp

from sangnom_jax.core.formats import VideoFormat


class Buffers(enum.IntEnum):
    """The nine directional error maps.

    Values are *spatial priority indices* 0..8 — the SangNom predictor maps
    interleave between the shear-difference maps (FWD=3, REV=5), and the
    finalize stage's tie-breaking priority is a fixed function of this
    spatial order (reference enum Buffers, src/SangNom2.h:8-20; load order
    src/SangNom2.cpp:197-206).
    """

    ADIFF_M3_P3 = 0  # |curr[x-3] - next[x+3]|
    ADIFF_M2_P2 = 1
    ADIFF_M1_P1 = 2
    SG_FORWARD = 3   # forward predictor disagreement
    ADIFF_P0_M0 = 4  # vertical
    SG_REVERSE = 5   # reverse predictor disagreement
    ADIFF_P1_M1 = 6
    ADIFF_P2_M2 = 7
    ADIFF_P3_M3 = 8


TOTAL_BUFFERS = len(Buffers)

# Finalize checks in this order; the FIRST hit wins (reference
# src/SangNom2.cpp:212-249 "the order of following code is important").
# ADIFF_P0_M0 is special-cased first together with the aa threshold.
SELECT_PRIORITY = (
    Buffers.SG_REVERSE,
    Buffers.SG_FORWARD,
    Buffers.ADIFF_P1_M1,
    Buffers.ADIFF_M1_P1,
    Buffers.ADIFF_P2_M2,
    Buffers.ADIFF_M2_P2,
    Buffers.ADIFF_P3_M3,
    Buffers.ADIFF_M3_P3,
)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Static per-dtype kernel configuration (the analogue of the reference's
    <T, IType> template instantiations, src/SangNom2.cpp:316-327).

    ``sse2``: select the reference's SECOND numerics contract — its SSE2
    path genuinely diverges from its C path at integer extremes (SURVEY.md
    §2 quirk 3).  Exactly two primitives differ (everything else —
    abs-diffs, averages, min/priority select, thresholds — is provably
    identical between the reference's paths):
      * the predictor shifts LOGICALLY within its SIMD lane and
        saturate-packs (reference src/SangNom2_SSE2.cpp:478-481 srli_epi16 +
        packus_epi16; :513-517 srli_epi32 + packus_epi32) where C shifts
        arithmetically and wraps (src/SangNom2.cpp:60-65);
      * the smoothing writeback saturate-packs (src/SangNom2_SSE2.cpp:
        749-761, 807-811) where C wraps (src/SangNom2.cpp:152).
    Float is bit-identical between the reference's two paths, so ``sse2``
    is a no-op for float formats."""

    is_float: bool
    mask: int  # wrap mask for the storage type; unused for float
    sse2: bool = False

    @property
    def acc_dtype(self):
        """Accumulator: int32 lanes for integer formats (reproduces the
        reference's narrower i16-for-u8 accumulator exactly — no
        intermediate exceeds it, src/SangNom2.cpp:316), float32 for float."""
        return jnp.float32 if self.is_float else jnp.int32

    @classmethod
    def from_format(cls, fmt: VideoFormat, sse2: bool = False) -> "KernelSpec":
        if fmt.is_float:
            return cls(is_float=True, mask=0, sse2=sse2)
        return cls(
            is_float=False, mask=(1 << (8 * fmt.component_size)) - 1,
            sse2=sse2,
        )


def neighborhood(a: jnp.ndarray, radius: int = 3) -> list[jnp.ndarray]:
    """[a shifted by -radius .. +radius], edge-clamped; one pad, many slices."""
    w = a.shape[-1]
    pad = [(0, 0)] * (a.ndim - 1) + [(radius, radius)]
    ap = jnp.pad(a, pad, mode="edge")
    return [ap[..., radius + k : radius + k + w] for k in range(-radius, radius + 1)]


def calc_sangnom(p1, p2, p3, spec: KernelSpec):
    """3-tap predictor (4*p1 + 5*p2 - p3)/8.

    C numerics: arithmetic >>3, wrap to the pixel type (reference
    src/SangNom2.cpp:60-72).  SSE2 numerics: LOGICAL >>3 within the SIMD
    lane (i16 for 8-bit, i32 for 16-bit) then saturate-pack to the pixel
    type (reference src/SangNom2_SSE2.cpp:451-482 srli_epi16+packus_epi16,
    :485-518 srli_epi32+packus_epi32)."""
    if spec.is_float:
        # 5*p2 as p2*4 + p2: the same rounded value, but with every multiply
        # on the path by a power of two, a compiler that contracts a multiply
        # and an add into one FMA (GPU code generators do) cannot change the
        # result
        return (p1 * 4 + (p2 * 4 + p2) - p3) * jnp.float32(0.125)
    s = p1 * 4 + p2 * 5 - p3
    if not spec.sse2:
        return jnp.right_shift(s, 3) & spec.mask  # arithmetic >>3, wrap to T
    if spec.mask == 0xFF:
        # u8 rides i16 lanes: logical shift of the 16-bit pattern, u8 sat
        s = jnp.right_shift(s & 0xFFFF, 3)
        return jnp.minimum(s, 255)
    # u16 rides i32 lanes: logical shift of the 32-bit pattern, u16 sat.
    # logical >>3 == arithmetic >>3 with the sign-extended bits masked off
    # (keeps every lane a signed int32)
    s = jnp.right_shift(s, 3) & 0x1FFFFFFF
    return jnp.minimum(s, 65535)


def smooth_writeback(h, spec: KernelSpec):
    """Smoothing-stage writeback of the (non-negative) 21-tap box sum.

    C numerics: /16 then wrap to the pixel type (reference
    src/SangNom2.cpp:152).  SSE2 numerics: >>4 then saturate-pack
    (reference src/SangNom2_SSE2.cpp:749-765, 798-811).  Float: *1/16."""
    if spec.is_float:
        return h * jnp.float32(1.0 / 16.0)
    if spec.sse2:
        return jnp.minimum(jnp.right_shift(h, 4), spec.mask)
    return jnp.right_shift(h, 4) & spec.mask


def avg_pair(a, b, spec: KernelSpec):
    """Directional average: integer round-half-up (matches (a+b+1)>>1),
    float exact half (reference src/SangNom2.cpp:48-58)."""
    if spec.is_float:
        return (a + b) * jnp.float32(0.5)
    return jnp.right_shift(a + b + 1, 1) & spec.mask


def abs_diff(a, b):
    """|a - b| in the accumulator domain (reference src/SangNom2.cpp:36-46)."""
    return jnp.abs(a - b)
