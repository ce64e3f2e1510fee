"""Mesh construction and the sharded filter entry point.

`sangnom2_sharded` is the multi-chip analogue of the host's frame-MT in the
reference (MT_MULTI_INSTANCE, reference src/SangNom2.h:63-66): frames shard
over the ``data`` mesh axis with zero communication, and optionally each
plane's width shards over the ``space`` axis with ppermute halo exchange
(sangnom_jax.parallel.width_sharded).  Everything runs inside one
`shard_map`-wrapped jit, so XLA issues the collectives.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from sangnom_jax.core.clip import Clip
from sangnom_jax.ops.sangnom import sangnom2_impl
from sangnom_jax.parallel.width_sharded import interpolate_field_width_sharded


def default_mesh(
    data: Optional[int] = None, space: int = 1, devices=None
) -> Mesh:
    """A ('data', 'space') mesh over the available devices.

    data defaults to len(devices) // space.  'data' shards frames
    (embarrassingly parallel); 'space' shards plane width (halo exchange).
    """
    devices = jax.devices() if devices is None else devices
    if data is None:
        data = len(devices) // space
    n = data * space
    if n > len(devices):
        raise ValueError(
            f"mesh {data}x{space} needs {n} devices, have {len(devices)}"
        )
    import numpy as np

    return Mesh(np.asarray(devices[:n]).reshape(data, space), ("data", "space"))


def _sharded_pad_width(
    w_i: int, h_i: int, stride: int, n_space: int, fmt, dh: bool
) -> int:
    """Padded width for one plane under width sharding: the least multiple
    of ``n_space`` that provably preserves the full-stride semantics.

    The reference smooths every plane over the LUMA-derived buffer stride
    (SURVEY.md §2 quirk 6), so subsampled chroma carries up to 2x padding.
    The single-chip kernels already cut that via the observable-creep /
    integer-decay bounds (core.geometry.width_tiers: clamping the hbox
    at S_clamp >= the bound is invisible in the trimmed output, verified
    against the full-stride native oracle); this applies the SAME bounds to
    the globally padded array the shards divide, instead of always padding
    to the full stride — at 1080p 4:2:0 this halves the sharded chroma
    compute and every chroma halo exchange."""
    from sangnom_jax.core.geometry import creep_bound
    from sangnom_jax.ops.primitives import KernelSpec

    spec = KernelSpec.from_format(fmt)
    bufH = h_i if dh else h_i // 2
    creep = creep_bound(w_i, bufH, spec)
    s_eff = min(stride, -(-creep // n_space) * n_space)
    # keep shards at least as wide as the full-stride case would allow the
    # fused kernel (or, for narrow strides, no narrower than stride/n)
    return max(s_eff, min(stride, n_space * 9))


def _validate_width_sharding(stride: int, n_space: int) -> None:
    """Every plane is padded to the luma-derived buffer stride before
    sharding, so the only requirements are on the stride itself."""
    if stride % n_space:
        raise ValueError(
            f"buffer stride {stride} does not divide across "
            f"{n_space} 'space' shards"
        )
    if stride // n_space < 3:
        # halo exchange reaches only the adjacent shard; every tap spans
        # <= 3 columns, so each shard must own at least 3
        raise ValueError(
            f"local width {stride // n_space} < 3: too many 'space' "
            f"shards for stride {stride}"
        )


@partial(
    jax.jit,
    static_argnames=(
        "mesh", "fmt", "order", "aa", "aac", "dh", "luma", "chroma", "opt",
        "numerics", "data_axis", "space_axis", "plane_widths", "stride",
    ),
)
def _sharded_jit(planes, parity, *, mesh, fmt, order, aa, aac, dh, luma,
                 chroma, opt, numerics, data_axis, space_axis, plane_widths,
                 stride):
    """The cached compiled sharded program.

    Everything configuration-like is a STATIC argument so repeat calls with
    the same mesh/params hit the jit cache — building the shard_map closure
    fresh and jitting it per call retraced AND recompiled the whole sharded
    program every invocation."""
    if space_axis:
        interp_fn = (
            lambda kept, aaf, spec, stride_, plane_width=None:  # noqa: E731
            interpolate_field_width_sharded(
                kept, aaf, spec, space_axis, plane_width
            )
        )
        plane_spec = P(data_axis, None, space_axis)
        impl_kw = dict(interp_fn=interp_fn, plane_widths=plane_widths,
                       stride=stride)
    else:
        plane_spec = P(data_axis, None, None)
        impl_kw = dict(interp_fn=None)  # per-shard default backend

    def local(planes_loc, parity_loc):
        return sangnom2_impl(
            planes_loc, parity_loc, fmt, order, aa, aac, dh, luma, chroma,
            opt, numerics=numerics, **impl_kw,
        )

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(tuple(plane_spec for _ in planes), P(data_axis)),
        out_specs=tuple(plane_spec for _ in planes),
        check_vma=False,
    )(planes, parity)


def sangnom2_sharded(
    clip: Clip,
    mesh: Mesh,
    order: int = 1,
    aa: int = 48,
    aac: int = 0,
    threads: int = 0,
    dh: bool = False,
    luma: bool = True,
    chroma: bool = True,
    opt: int = -1,
    data_axis: str = "data",
    space_axis: Optional[str] = None,
    numerics: str = "c",
    pool_compat: bool = False,
) -> Clip:
    """SangNom2 over a device mesh.

    Frames shard over ``data_axis`` (padded to divide evenly, then trimmed).
    If ``space_axis`` is given, plane widths additionally shard over it and
    the smoothing recursion exchanges 3-column halos per row via ppermute
    (the XLA scan; data-only meshes run the per-shard backend ``opt``
    picks).  ``numerics`` selects the reference numerics contract exactly as on the
    single-device surface ("c" | "sse2"); every sharded backend honors it
    through the shared primitives.

    ``pool_compat`` is NOT supported under sharding and raises: the pool
    is cross-frame state (frames must run sequentially, so the data axis
    is meaningless there), and width-sharding the sequential pool scan is
    rejected on value — full analysis in docs/MULTICHIP.md
    ("pool_compat × sharding").  Use the single-device surface
    (``sangnom2(pool_compat=True)``) for the emulation mode.
    """
    from sangnom_jax.api import (SangNomError, _validate,  # surface parity
                                 _validate_numerics)
    from sangnom_jax.core.geometry import buffer_stride_elems

    _validate("SangNom2", clip, order, aa, aac, opt)
    _validate_numerics("SangNom2", numerics)
    if pool_compat:
        raise SangNomError(
            "SangNom2: pool_compat is not supported under sharding (the "
            "pool is sequential cross-frame state; see docs/MULTICHIP.md) "
            "— use the single-device sangnom2(pool_compat=True)."
        )
    del threads

    n_data = mesh.shape[data_axis]
    n_space = mesh.shape[space_axis] if space_axis else 1
    fmt = clip.format
    stride = buffer_stride_elems(clip.width, fmt.component_size)
    if space_axis:
        _validate_width_sharding(stride, n_space)

    N = clip.num_frames
    pad = (-N) % n_data
    widths = tuple(p.shape[2] for p in clip.planes)
    planes = []
    for p in clip.planes:
        if pad:
            p = jnp.pad(p, ((0, pad), (0, 0), (0, 0)))
        if space_axis and p.shape[2] < stride:
            # pad the plane toward the buffer stride with EDGE REPLICATION:
            # pixel taps that clamp at the true width then read the
            # replicated edge pixel (loadPixel semantics), while the
            # zero-defined raw-map padding is re-created inside the sharded
            # kernel by a global-column mask (see parallel.width_sharded).
            # The padded width stops at the creep/decay bound rather than
            # the full stride (_sharded_pad_width) — bit-exact, and it
            # halves 4:2:0 chroma compute + halo traffic.
            s_eff = _sharded_pad_width(
                p.shape[2], p.shape[1], stride, n_space, fmt, dh
            )
            if p.shape[2] < s_eff:
                p = jnp.pad(p, ((0, 0), (0, 0), (0, s_eff - p.shape[2])),
                            mode="edge")
        planes.append(p)
    planes = tuple(planes)
    parity = jnp.pad(clip.parity_array(), (0, pad)) if pad else clip.parity_array()

    out_planes = _sharded_jit(
        planes, parity, mesh=mesh, fmt=fmt, order=order, aa=aa, aac=aac,
        dh=dh, luma=luma, chroma=chroma, opt=opt, numerics=numerics,
        data_axis=data_axis, space_axis=space_axis, plane_widths=widths if space_axis else None,
        stride=stride if space_axis else None,
    )
    out_planes = tuple(p[:N, :, :w] for p, w in zip(out_planes, widths))
    return clip.with_planes(out_planes)
