"""Frame orchestration: field selection, plane dispatch, assembly, batching.

The functional equivalent of the reference's `GetFrame` (reference
src/SangNom2.cpp:332-397): pick the kept field per `order`, copy it through,
interpolate the missing lines, duplicate the one uninterpolatable boundary
line, honor the `luma`/`chroma` plane masks and `dh` height doubling — but as
a pure clip -> clip transform, `vmap`-batched over frames so a whole clip is
one compiled XLA program.

Backend dispatch (the analogue of the reference's CPUID/opt member-fn-pointer
selection, src/SangNom2.cpp:312-329):
  opt = -1  auto: the row-scan kernel on a GPU, jnp reference elsewhere
  opt =  0  jnp reference path (the parity target, like the reference's C)
  opt =  1  the row-scan kernel (ops/pallas_kernel.py; like the reference's
            SSE2, but bit-exact to opt=0 by construction — the reference's
            two paths genuinely diverge at numeric extremes, SURVEY.md §2
            quirk 3)
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Union

import jax
import jax.numpy as jnp
import numpy as np

from sangnom_jax.core.clip import Clip
from sangnom_jax.core.formats import VideoFormat
from sangnom_jax.core.geometry import (
    aaf_as_pixel,
    buffer_stride_elems,
    scaled_aa_thresholds,
)
from sangnom_jax.ops import reference as ref_backend
from sangnom_jax.ops.primitives import KernelSpec
from sangnom_jax.utils.logging import log_dispatch
from sangnom_jax.utils.profiling import stage_scope

Offset = Union[int, jax.Array]

def _pick_backend(opt: int) -> Callable:
    """Returns the batched interpolation kernel for the requested backend:
    the row-scan kernel on a GPU (and wherever opt=1 asks for it), the
    plain XLA path otherwise."""
    if opt == 0:
        return ref_backend.interpolate_field_batch
    if opt == 1 or jax.default_backend() == "gpu":
        from sangnom_jax.ops import pallas_kernel

        return pallas_kernel.interpolate_field_batch
    return ref_backend.interpolate_field_batch


def deinterlace_plane_batch(
    src: jnp.ndarray,
    offsets: Offset,
    dh: bool,
    aaf,
    spec: KernelSpec,
    stride: int,
    interp_fn: Callable,
    plane_width: int | None = None,
    interlaced_tff: bool | None = None,
) -> jnp.ndarray:
    """One plane, all frames: [N, h_src, w] -> [N, h_out, w].

    Mirrors the per-plane body of GetFrame (reference src/SangNom2.cpp:
    361-393): kept-field copy, boundary-line duplication, in-place kernel —
    realized as functional gathers + one interleave, batched over frames.
    `offsets` is a static int (orders 1/2) or a per-frame [N] array
    (order 0: parity-dependent, reference src/SangNom2.cpp:338).

    ``interlaced_tff`` non-None (requires dh): ``src`` is an interlaced
    [N/2, h, w] plane whose per-frame FIELDS are the dh sources (the bob
    pipeline).  A backend with a ``fused_weave`` (the row-scan kernel)
    reads the kept rows straight from ``src`` and writes the woven plane;
    the others get the kept field split out here and an XLA weave.
    """
    if interlaced_tff is not None:
        assert dh
        h_src = src.shape[1] // 2
    else:
        h_src = src.shape[1]
    h_out = 2 * h_src if dh else h_src
    bufH = h_out // 2

    # plane_width is only set inside the width-sharded shard_map, where the
    # local array is stride-padded and the weave runs outside the shard
    fused_weave = getattr(interp_fn, "fused_weave", None)
    if fused_weave is not None and bufH >= 2 and plane_width is None:
        with stage_scope("interpolate+weave"):
            return fused_weave(src, offsets, aaf, spec, stride, dh=dh,
                               interlaced_tff=interlaced_tff)
    if interlaced_tff is not None:
        from sangnom_jax.core.fields import _split_plane

        src = _split_plane(src, interlaced_tff)
    if dh:
        kept = src  # dh: the whole source is the kept field
        # (reference src/SangNom2.cpp:361-366)
    elif isinstance(offsets, int):
        kept = src[:, offsets::2]
    else:
        # per-frame offsets: select between the two strided row views
        kept = jnp.where(
            (offsets == 0)[:, None, None], src[:, 0::2], src[:, 1::2]
        )

    # backends take and return the storage dtype (widening happens inside);
    # plane_width is only meaningful inside shard_map, where the local array
    # width is stride-padded and the true width must come from outside
    with stage_scope("interpolate"):
        interp = interp_fn(kept, aaf, spec, stride, plane_width=plane_width)
    return weave_assemble(kept, interp, offsets)


def weave_assemble(
    kept: jnp.ndarray, interp: jnp.ndarray, offsets: Offset
) -> jnp.ndarray:
    """XLA-side weave: interleave kept [N, bufH, w] and interpolated
    [N, bufH-1, w] rows per ``offsets``, with the boundary missing line
    duplicated (reference src/SangNom2.cpp:379-391): offset==0 -> bottom
    missing line := last kept line; offset==1 -> top missing line := first
    kept line.  Shared by the single-device non-weave path and the sharded
    small-shard fallback."""
    N, bufH, w = kept.shape
    h_out = 2 * bufH

    def weave(top: jnp.ndarray, bottom: jnp.ndarray) -> jnp.ndarray:
        return jnp.stack([top, bottom], axis=2).reshape(N, h_out, w)

    if isinstance(offsets, int):
        if offsets == 0:
            return weave(kept, jnp.concatenate([interp, kept[:, -1:]], axis=1))
        return weave(jnp.concatenate([kept[:, :1], interp], axis=1), kept)
    # traced per-frame offsets: select the HALF-HEIGHT weave inputs per
    # frame and interleave once — value-identical to building both woven
    # planes and selecting, at ~25% less assembly traffic (one full-height
    # interleave copy instead of two)
    is0 = (offsets == 0)[:, None, None]
    top = jnp.where(is0, kept, jnp.concatenate([kept[:, :1], interp], axis=1))
    bottom = jnp.where(
        is0, jnp.concatenate([interp, kept[:, -1:]], axis=1), kept
    )
    return weave(top, bottom)


def field_offsets(order: int, parity: jax.Array) -> Offset:
    """Per-frame kept-field offset (reference src/SangNom2.cpp:336-341):
    order=0 consults per-frame parity (GetParity), 1 keeps top, 2 bottom.
    The single source of the order->offset mapping for every caller."""
    if order == 1:
        return 0
    if order == 2:
        return 1
    return jnp.where(parity, 0, 1)  # [N] traced offsets


def field_offset_py(order: int, frame_parity: bool) -> int:
    """Host-side scalar variant of `field_offsets` for numpy-path callers
    (the native-oracle wrapper)."""
    if order == 0:
        return 0 if frame_parity else 1
    return 0 if order == 1 else 1


def sangnom2_impl(
    planes,
    parity,
    fmt: VideoFormat,
    order: int,
    aa: int,
    aac: int,
    dh: bool,
    luma: bool,
    chroma: bool,
    opt: int,
    interp_fn: Callable | None = None,
    plane_widths: tuple | None = None,
    stride: int | None = None,
    numerics: str = "c",
    interlaced_tff: bool | None = None,
):
    """The un-jitted whole-frame-batch transform over raw plane arrays.

    Shared by the single-device jit wrapper below and the sharded wrappers in
    sangnom_jax.parallel (which call it inside `shard_map` with a
    halo-exchanging `interp_fn`, the GLOBAL `plane_widths` — local arrays are
    stride-padded there — and the precomputed global `stride`).

    ``numerics``: "c" (default, the parity target) or "sse2" — the
    reference's second numeric contract (its SSE2 path diverges from its C
    path at integer extremes; see ops.primitives.KernelSpec)."""
    if interp_fn is None:
        interp_fn = _pick_backend(opt)
    spec = KernelSpec.from_format(fmt, sse2=(numerics == "sse2"))
    log_dispatch(
        fmt=fmt.name,
        backend=getattr(interp_fn, "__module__", str(interp_fn)),
        acc_dtype=spec.acc_dtype.__name__ if hasattr(spec.acc_dtype, "__name__") else spec.acc_dtype,
        order=order, aa=aa, aac=aac, dh=dh, luma=luma, chroma=chroma, opt=opt,
        frames=planes[0].shape[0], height=planes[0].shape[1],
        width=planes[0].shape[2],
    )
    aafs = scaled_aa_thresholds(aa, aac, fmt)
    if stride is None:
        stride = buffer_stride_elems(planes[0].shape[2], fmt.component_size)
    process = [luma, chroma, chroma]
    offsets = field_offsets(order, parity)

    def run_plane(p, aaf, pw):
        return deinterlace_plane_batch(
            p, offsets, dh=dh, aaf=aaf, spec=spec, stride=stride,
            interp_fn=interp_fn, plane_width=pw,
            interlaced_tff=interlaced_tff,
        )

    def width_of(i):
        return None if plane_widths is None else plane_widths[i]

    out: dict[int, jnp.ndarray] = {}
    chroma_planes = [
        i for i in (1, 2)
        if i < len(planes) and (dh or process[i])
    ]
    if len(chroma_planes) == 2 and planes[1].shape == planes[2].shape:
        # U and V share geometry, threshold, and offsets — fuse them into
        # one batched kernel invocation (halves chroma dispatches)
        uv = jnp.concatenate([planes[1], planes[2]], axis=0)
        offs2 = offsets if isinstance(offsets, int) else jnp.tile(offsets, 2)
        # output frame count per plane: doubled when src is interlaced
        # field-pair frames (the bob pipeline)
        n = planes[1].shape[0] * (1 if interlaced_tff is None else 2)
        res = deinterlace_plane_batch(
            uv, offs2, dh=dh, aaf=aaf_as_pixel(aafs[1], fmt), spec=spec,
            stride=stride, interp_fn=interp_fn, plane_width=width_of(1),
            interlaced_tff=interlaced_tff,
        )
        out[1], out[2] = res[:n], res[n:]

    for i, p in enumerate(planes):
        if i in out:
            continue
        if i >= 3:
            # Alpha plane: passthrough; under dh, line-double by repetition.
            # (Deviation: the reference caps at 3 planes and leaves dst
            # alpha uninitialized, src/SangNom2.cpp:347.)
            out[i] = jnp.repeat(p, 2, axis=1) if dh else p
            continue
        if not dh and not process[i]:
            # Unprocessed plane: verbatim copy (reference src/SangNom2.cpp:
            # 369-374).  dh=True forces processing of every plane (361-366,
            # SURVEY.md §2 quirk 7), so no skip in that case.
            out[i] = p
            continue
        out[i] = run_plane(p, aaf_as_pixel(aafs[i], fmt), width_of(i))
    return tuple(out[i] for i in range(len(planes)))


@partial(jax.jit, static_argnames=("order", "aa", "aac", "dh", "luma", "chroma", "opt", "fmt", "numerics"))
def _sangnom2_jit(planes, parity, fmt: VideoFormat, order, aa, aac, dh, luma, chroma, opt, numerics):
    return sangnom2_impl(
        planes, parity, fmt, order, aa, aac, dh, luma, chroma, opt,
        numerics=numerics,
    )


@partial(jax.jit, static_argnames=("order", "aa", "aac", "dh", "luma", "chroma", "fmt", "numerics"))
def _sangnom2_pool_jit(planes, parity, fmt: VideoFormat, order, aa, aac, dh, luma, chroma, numerics):
    from sangnom_jax.ops.pool_carry import sangnom2_pool_impl

    outs, _ = sangnom2_pool_impl(
        planes, parity, fmt, order, aa, aac, dh, luma, chroma,
        numerics=numerics,
    )
    return outs


def sangnom2_op(
    clip: Clip,
    order: int = 1,
    aa: int = 48,
    aac: int = 0,
    dh: bool = False,
    luma: bool = True,
    chroma: bool = True,
    opt: int = -1,
    pool_compat: bool = False,
    numerics: str = "c",
) -> Clip:
    """The validated, jit-compiled filter op. Parameters are pre-validated by
    the API layer (sangnom_jax.api).

    ``pool_compat=True`` selects the shared-buffer-pool bug-compat backend
    (ops/pool_carry.py): bit-exact to a live reference build's cross-plane
    stale-pool semantics, at the cost of sequential frame processing — the
    pool is genuine cross-frame state.  The mode runs the XLA scan for
    every ``opt``.

    ``numerics="sse2"`` selects the reference's SSE2 numeric contract
    (composable with ``pool_compat`` — together they reproduce a live
    reference build running its vectorized path)."""
    if order == 0:
        # HOST-side parity resolution (AviSynth's GetParity is a host call
        # too).  Creating a device parity array here and fetching it back
        # in the static split would be a blocking device round trip per
        # call — the parity stays host-side; clips whose parity lives on
        # device (or is a tracer) fall through to the traced path.
        parity = _host_parity(clip)
    else:
        parity = jnp.zeros((clip.num_frames,), jnp.bool_)
    if pool_compat:
        if order == 0:
            parity = (clip.parity_array() if parity is None
                      else jnp.asarray(parity))
        planes = _sangnom2_pool_jit(
            clip.planes, parity, clip.format, order, aa, aac, dh, luma,
            chroma, numerics,
        )
    else:
        planes = _maybe_aot(clip, parity, order, aa, aac, dh, luma, chroma,
                            opt, numerics)
        if planes is None and order == 0:
            planes = _order0_static_split(
                clip, parity, aa, aac, dh, luma, chroma, opt, numerics
            )
        elif planes is None:
            planes = _sangnom2_jit(
                clip.planes, parity, clip.format, order, aa, aac, dh, luma,
                chroma, opt, numerics,
            )
    return clip.with_planes(planes)


def _maybe_aot(clip, parity, order, aa, aac, dh, luma, chroma, opt,
               numerics):
    """Serve this dispatch from a prewarmed jax.export artifact if one is
    configured and matches (sangnom_jax.aot) — same program body as the
    jit path, so the output bits are identical; order=0 runs the
    traced-parity program (bit-identical to the eager static split by the
    backend contract).  Returns None on any miss."""
    from sangnom_jax import aot

    if not aot.is_configured():
        return None
    if parity is None:  # non-addressable parity (tracer): keep jit path
        return None  # (checked BEFORE lookup so STATS never counts a hit
        #              for a dispatch that actually ran the jit path)
    call = aot.lookup(
        "filter", clip.format.name, aot.plane_shapes(clip.planes),
        aot.filter_statics(order, aa, aac, dh, luma, chroma, opt, numerics))
    if call is None:
        return None
    return call(tuple(clip.planes), jnp.asarray(parity))


def _host_parity(clip: Clip):
    """Per-frame parity as a host numpy array, or None if it is a tracer /
    non-addressable device value (then the caller keeps the traced path).
    Never triggers a device computation; a concrete device-resident parity
    is fetched once (tiny), which Clip constructors avoid creating."""
    if clip.parity is None:
        return np.full((clip.num_frames,), clip.tff, dtype=bool)
    try:
        return np.asarray(clip.parity).astype(bool)
    except Exception:
        return None


def sangnom2_pool_stream(
    clip: Clip,
    pool_state,
    order: int = 1,
    aa: int = 48,
    aac: int = 0,
    dh: bool = False,
    luma: bool = True,
    chroma: bool = True,
    numerics: str = "c",
    opt: int = -1,
):
    """One chunk of a pool-compat stream: like ``sangnom2(pool_compat=True)``
    but taking and returning the pool state, so a windowed caller (the CLI's
    ``--window``) produces output byte-identical to whole-clip processing —
    the pool is genuine cross-frame state and must survive chunk boundaries.
    ``pool_state=None`` starts a fresh stream.  Returns (out_clip, pool).
    ``opt`` picks the pool smoothing backend (see sangnom2_pool_impl)."""
    from sangnom_jax.api import _validate
    from sangnom_jax.ops.pool_carry import init_pool

    _validate("SangNom2", clip, order, aa, aac, opt)
    parity = clip.parity_array() if order == 0 else jnp.zeros(
        (clip.num_frames,), jnp.bool_)
    if pool_state is None:
        h_out = 2 * clip.height if dh else clip.height
        pool_state = init_pool(clip.width, h_out, clip.format)
    planes, pool_state = _sangnom2_pool_stream_jit(
        clip.planes, parity, pool_state, clip.format, order, aa, aac, dh,
        luma, chroma, numerics,
    )
    return clip.with_planes(planes), pool_state


@partial(jax.jit, static_argnames=("order", "aa", "aac", "dh", "luma", "chroma", "fmt", "numerics"))
def _sangnom2_pool_stream_jit(planes, parity, pool0, fmt, order, aa, aac,
                              dh, luma, chroma, numerics):
    from sangnom_jax.ops.pool_carry import sangnom2_pool_impl

    return sangnom2_pool_impl(
        planes, parity, fmt, order, aa, aac, dh, luma, chroma, pool0=pool0,
        numerics=numerics,
    )


def _order0_static_split(clip, parity, aa, aac, dh, luma, chroma, opt,
                         numerics):
    """order=0 with host-concrete parity: resolve the per-frame offsets NOW
    and dispatch static-offset kernels instead of the traced-offset path.

    At this level the parity array is a concrete value (AviSynth's
    GetParity is a host call too, reference src/SangNom2.cpp:338), so a
    UNIFORM batch collapses to order 1/2 outright (static offsets).  A
    mixed batch (e.g. bob's alternation) stays on the traced path, where
    the row-scan kernel reads the per-frame offsets as data.
    """
    fmt = clip.format
    if parity is None:
        # parity is a tracer / device value (op invoked under an outer
        # jit): keep the traced-offset path, which handles per-frame
        # offsets in-graph
        return _sangnom2_jit(
            clip.planes, clip.parity_array(), fmt, 0, aa, aac, dh, luma,
            chroma, opt, numerics,
        )
    offs = np.where(parity, 0, 1)

    def run(planes, order_s):
        par = jnp.zeros((planes[0].shape[0],), jnp.bool_)
        return _sangnom2_jit(
            planes, par, fmt, order_s, aa, aac, dh, luma, chroma, opt,
            numerics,
        )

    if (offs == offs[0]).all():
        return run(clip.planes, 1 if offs[0] == 0 else 2)

    # Mixed parity: per-frame offsets ride the traced path — the HOST
    # numpy parity uploads with the arguments (no device round trip), and
    # the kernel's per-frame-offset weave consumes the offsets as data.
    return _sangnom2_jit(
        clip.planes, jnp.asarray(parity), fmt, 0, aa, aac, dh, luma,
        chroma, opt, numerics,
    )
