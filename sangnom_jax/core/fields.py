"""Field-geometry clip utilities: SeparateFields / DoubleWeave / bob.

The reference's double-rate mode requires the host to prepare the clip:
"user must call std.SeparateFields().std.DoubleWeave() before use" for
order=0 (reference src/SangNom2.cpp:18-23).  A standalone framework provides
those host utilities itself, with AviSynth's field semantics:

- `separate_fields`: each interlaced frame -> two half-height field frames,
  ordered by the clip's field dominance (tff); per-field parity recorded.
- `double_weave`: frame n = weave of fields (n, n+1) — same frame count,
  double height, parity from the leading field.
- `bob`: the whole double-rate deinterlace pipeline:
  separate_fields -> double_weave -> SangNom2(order=0).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from sangnom_jax import aot
from sangnom_jax.core.clip import Clip


def _split_plane(p: jnp.ndarray, tff: bool) -> jnp.ndarray:
    """[N, H, W] -> [2N, H/2, W] field frames in dominance order.

    Written as reshape/transpose (row index 2r+b factors as [r, b]) rather
    than strided slices + stack: one transpose XLA can fuse with a
    downstream relayout, instead of two gathers and a concatenate."""
    n, h, w = p.shape
    rb = p.reshape(n, h // 2, 2, w)
    if not tff:
        rb = rb[:, :, ::-1]
    return rb.transpose(0, 2, 1, 3).reshape(2 * n, h // 2, w)


@partial(jax.jit, static_argnames=("tff",))
def _split_planes_jit(planes, tff: bool):
    """All planes split in ONE compiled dispatch (not one eager dispatch
    per plane op)."""
    return tuple(_split_plane(p, tff) for p in planes)


def separate_fields(clip: Clip, tff: bool | None = None) -> Clip:
    """[N, H, W] frames -> [2N, H/2, W] field frames.

    Field order follows ``tff`` (default: the clip's flag): tff=True emits
    (top, bottom) per frame, and the emitted parity array marks each top
    field True.
    """
    if clip.height % 2:
        raise ValueError("separate_fields: height must be even.")
    tff = clip.tff if tff is None else tff

    n = clip.num_frames
    # HOST-side parity metadata: order=0's static split reads it with
    # np.asarray every call — a device-resident parity array would force a
    # blocking device->host fetch mid-pipeline (a needless sync)
    parity = np.tile(np.array([tff, not tff]), n)
    return Clip(
        list(_split_planes_jit(clip.planes, tff)),
        clip.format,
        parity=parity,
        tff=tff,
        props={**clip.props, "field_based": True},
    )


def weave(clip: Clip) -> Clip:
    """Inverse of separate_fields: field pairs (2k, 2k+1) -> [N/2, 2h, W]."""
    if clip.num_frames % 2:
        raise ValueError("weave: field count must be even.")
    parity = clip.parity_array()

    def join(p: jnp.ndarray) -> jnp.ndarray:
        m, h, w = p.shape
        pairs = p.reshape(m // 2, 2, h, w)
        return _weave_pair(pairs[:, 0], pairs[:, 1], parity[0::2])

    props = {k: v for k, v in clip.props.items() if k != "field_based"}
    return Clip([join(p) for p in clip.planes], clip.format,
                tff=clip.get_parity(0), props=props)


def _weave_pair(first, second, first_is_top):
    """Interleave two field batches by the first field's parity."""
    m, h, w = first.shape
    top_first = jnp.stack([first, second], axis=2).reshape(m, 2 * h, w)
    bot_first = jnp.stack([second, first], axis=2).reshape(m, 2 * h, w)
    return jnp.where(first_is_top[:, None, None], top_first, bot_first)


def double_weave(clip: Clip) -> Clip:
    """Field frames -> same-count full-height frames: frame n weaves fields
    (n, n+1); the last frame weaves (N-1, N-1) degenerately like AviSynth's
    final duplicated pairing."""
    parity = clip.parity_array()

    def dw(p: jnp.ndarray) -> jnp.ndarray:
        nxt = jnp.concatenate([p[1:], p[-1:]], axis=0)
        return _weave_pair(p, nxt, parity)

    return Clip(
        [dw(p) for p in clip.planes],
        clip.format,
        parity=clip.parity,
        tff=clip.tff,
        props=clip.props,
    )


def bob(clip: Clip, aa: int = 48, aac: int = 0, luma: bool = True,
        chroma: bool = True, opt: int = -1, tff: bool | None = None,
        pool_compat: bool = False, numerics: str = "c") -> Clip:
    """Double-rate deinterlace: SeparateFields -> DoubleWeave ->
    SangNom2(order=0) (the reference's documented double-rate recipe,
    src/SangNom2.cpp:18-23).  Returns 2N full-height frames.

    Fused fast path (round 3): the filter reads ONLY the kept field of
    each woven frame — and DoubleWeave places field n at exactly frame n's
    kept-field parity — so ``SangNom2(order=0)`` on the woven clip is
    value-identical to ``SangNom2(order=0, dh=True)`` on the field frames
    directly.  The fused form skips materializing the DoubleWeave
    intermediate and the filter's kept-field re-extraction (two full-frame
    copies per output frame).  It requires every plane to be processed:
    with a plane mask off (or an alpha plane, which the filter copies from
    the woven frame verbatim), the unprocessed planes need the discarded
    field's data, so those cases — and pool_compat, whose pool state is
    keyed to the woven frame sequence — keep the explicit pipeline.
    """
    from sangnom_jax.api import _validate, _validate_numerics, sangnom2

    tff_r = clip.tff if tff is None else tff
    # chroma only gates the fused path when chroma planes exist: on a
    # single-plane (GRAY) clip the mask is vacuous and the fused form
    # stays value-identical
    fused = (luma and (chroma or clip.format.num_planes == 1)
             and not pool_compat
             and clip.format.num_planes <= 3 and clip.height % 2 == 0)
    if fused:
        # validate against the WOVEN geometry (identical to the explicit
        # pipeline's: the woven height IS the input height), then run
        # SeparateFields + the filter as ONE compiled dispatch — the
        # per-frame parity alternation is a compile-time constant here
        _validate("SangNom2", clip, 0, aa, aac, opt)
        _validate_numerics("SangNom2", numerics)
        planes = None
        if aot.is_configured():
            call = aot.lookup(
                "bob", clip.format.name, aot.plane_shapes(clip.planes),
                aot.bob_statics(aa, aac, tff_r, opt, numerics))
            if call is not None:
                planes = call(tuple(clip.planes))
        if planes is None:
            planes = _bob_jit(
                clip.planes, clip.format, aa, aac, tff_r, opt, numerics
            )
        return Clip(
            list(planes), clip.format,
            parity=np.tile(np.array([tff_r, not tff_r]), clip.num_frames),
            tff=tff_r, props={**clip.props, "field_based": True},
        )
    fields = separate_fields(clip, tff=tff)
    woven = double_weave(fields)
    return sangnom2(woven, order=0, aa=aa, aac=aac, luma=luma,
                    chroma=chroma, opt=opt, pool_compat=pool_compat,
                    numerics=numerics)


def bob_impl(planes, fmt, aa: int, aac: int, tff: bool, opt: int,
             numerics: str):
    """SeparateFields -> order=0 dh filter as one traceable program.  The
    alternating parity is baked in as a constant, so the per-frame-offset
    in-kernel weave sees it as plain operand data; the planes stay
    INTERLACED into the impl (``interlaced_tff``), letting the Pallas
    weave path absorb the field split into its chunk relayout (a
    materialized split measured ~11% of true bob at 1080p).  Shared by
    the jit wrapper below and the AOT export (sangnom_jax.aot), so the
    exported artifact IS the jit program."""
    from sangnom_jax.ops.sangnom import sangnom2_impl

    n2 = 2 * planes[0].shape[0]
    parity = jnp.asarray(np.tile(np.array([tff, not tff]), n2 // 2))
    return sangnom2_impl(
        tuple(planes), parity, fmt, order=0, aa=aa, aac=aac, dh=True,
        luma=True, chroma=True, opt=opt, numerics=numerics,
        interlaced_tff=tff,
    )


@partial(jax.jit, static_argnames=("fmt", "aa", "aac", "tff", "opt",
                                   "numerics"))
def _bob_jit(planes, fmt, aa: int, aac: int, tff: bool, opt: int,
             numerics: str):
    return bob_impl(planes, fmt, aa, aac, tff, opt, numerics)
