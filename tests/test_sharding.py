"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Data-parallel frame sharding and width sharding with per-step ppermute halo
exchange must both be bit-exact vs the single-device jnp reference.
"""

import jax
import numpy as np
import pytest

from sangnom_jax import Clip, get_format, sangnom2
from sangnom_jax.parallel import default_mesh, sangnom2_sharded

from conftest import make_planes


def _clip(rng, fmt_name, w, h, n, parity=None):
    fmt = get_format(fmt_name)
    frames = [make_planes(rng, w, h, fmt) for _ in range(n)]
    planes = [np.stack([f[i] for f in frames]) for i in range(fmt.num_planes)]
    return Clip.from_numpy(planes, fmt, parity=parity)


def _assert_clips_equal(a, b):
    for i in range(a.num_planes):
        np.testing.assert_array_equal(
            np.asarray(a.planes[i]), np.asarray(b.planes[i]), err_msg=f"plane {i}"
        )


def test_mesh_construction():
    mesh = default_mesh(data=4, space=2)
    assert mesh.shape == {"data": 4, "space": 2}
    with pytest.raises(ValueError, match="needs 16 devices"):
        default_mesh(data=8, space=2)


def test_data_parallel_frames(rng):
    clip = _clip(rng, "YUV420P8", 32, 16, n=8)
    mesh = default_mesh(data=8)
    want = sangnom2(clip, opt=0, order=1)
    got = sangnom2_sharded(clip, mesh, order=1, opt=0)
    _assert_clips_equal(got, want)


def test_data_parallel_uneven_batch(rng):
    """N=5 frames over 4 shards: internal padding + trim."""
    clip = _clip(rng, "GRAY8", 32, 16, n=5)
    mesh = default_mesh(data=4, space=2)
    want = sangnom2(clip, opt=0, order=2)
    got = sangnom2_sharded(clip, mesh, order=2, opt=0)
    _assert_clips_equal(got, want)


def test_data_parallel_order0_parity(rng):
    parity = np.array([True, False, False, True])
    clip = _clip(rng, "GRAY8", 32, 16, n=4, parity=parity)
    mesh = default_mesh(data=4)
    want = sangnom2(clip, opt=0, order=0)
    got = sangnom2_sharded(clip, mesh, order=0, opt=0)
    _assert_clips_equal(got, want)


@pytest.mark.parametrize("n_space", [2, 4, 8])
def test_width_sharded(rng, n_space):
    """Width sharding with per-step halo exchange: bit-exact vs unsharded."""
    clip = _clip(rng, "GRAY8", 64, 16, n=2)
    mesh = default_mesh(data=1, space=n_space)
    want = sangnom2(clip, opt=0, order=1)
    got = sangnom2_sharded(clip, mesh, order=1, space_axis="space")
    _assert_clips_equal(got, want)


def test_width_sharded_2d_mesh(rng):
    """Frames AND width sharded simultaneously (data=2 x space=4)."""
    clip = _clip(rng, "YUV444P8", 64, 16, n=4)
    mesh = default_mesh(data=2, space=4)
    want = sangnom2(clip, opt=0, order=2, aa=96)
    got = sangnom2_sharded(clip, mesh, order=2, aa=96, space_axis="space")
    _assert_clips_equal(got, want)


def test_width_sharded_chroma_subsampling(rng):
    """YUV420: chroma width (W/2) must also divide across shards."""
    clip = _clip(rng, "YUV420P8", 64, 16, n=2)
    mesh = default_mesh(data=2, space=2)
    want = sangnom2(clip, opt=0, order=1, dh=True)
    got = sangnom2_sharded(clip, mesh, order=1, dh=True, space_axis="space")
    _assert_clips_equal(got, want)


@pytest.mark.parametrize("opt", [0, 1])
def test_width_sharded_smooth_backends(rng, opt):
    """Width sharding runs the per-row-exchange scan whatever ``opt`` says
    — bit-exact to the unsharded reference on a mixed data x space mesh
    with subsampled chroma and order=0 traced offsets."""
    parity = np.array([True, False, True])
    clip = _clip(rng, "YUV420P8", 64, 16, n=3, parity=parity)
    mesh = default_mesh(data=2, space=4)
    want = sangnom2(clip, opt=0, order=0, aa=48, aac=48)
    got = sangnom2_sharded(
        clip, mesh, order=0, aa=48, aac=48, space_axis="space", opt=opt
    )
    _assert_clips_equal(got, want)


def test_width_sharded_fully_fused_order0_dh(rng):
    """The width-sharded scan with opt=1 on the true-bob shape: order=0
    mixed parity + dh + subsampled chroma, 2x4 mesh."""
    parity = np.array([True, False, True, False])
    clip = _clip(rng, "YUV420P8", 64, 16, n=4, parity=parity)
    mesh = default_mesh(data=2, space=4)
    want = sangnom2(clip, opt=0, order=0, dh=True, aa=48, aac=48)
    got = sangnom2_sharded(
        clip, mesh, order=0, dh=True, aa=48, aac=48, space_axis="space",
        opt=1,
    )
    _assert_clips_equal(got, want)


def test_width_sharded_fully_fused_u16_and_float(rng):
    """u16 and float (the halo hbox keeps the reference's left-to-right
    association) through the width-sharded scan with opt=1."""
    mesh = default_mesh(data=1, space=4)
    for fmt_name, kw in [("GRAY16", dict(order=1, aa=128, aac=64)),
                         ("GRAYS", dict(order=2))]:
        clip = _clip(rng, fmt_name, 64, 16, n=2)
        want = sangnom2(clip, opt=0, **kw)
        got = sangnom2_sharded(clip, mesh, space_axis="space", opt=1, **kw)
        _assert_clips_equal(got, want)


def test_width_sharded_sse2_numerics(rng):
    """The reference's SSE2 numerics contract through the sharded surface
    (the shared primitives carry it into the sharded scan) — bit-exact vs the unsharded sse2 path at the integer
    extremes where the contracts genuinely diverge."""
    clip = _clip(rng, "YUV420P8", 64, 16, n=2)
    mesh = default_mesh(data=2, space=4)
    for opt in (0, 1):
        want = sangnom2(clip, opt=0, order=1, aa=0, numerics="sse2")
        got = sangnom2_sharded(clip, mesh, order=1, aa=0,
                               space_axis="space", opt=opt, numerics="sse2")
        _assert_clips_equal(got, want)
    with pytest.raises(Exception, match="numerics"):
        sangnom2_sharded(clip, mesh, numerics="bogus")


def test_width_sharded_fused_thin_shards(rng):
    """8-way sharding of a 64-col stride leaves 8-col shards, still wider
    than the 3-column halo: bit-exact."""
    clip = _clip(rng, "GRAY8", 64, 16, n=2)
    mesh = default_mesh(data=1, space=8)
    want = sangnom2(clip, opt=0, order=1)
    got = sangnom2_sharded(clip, mesh, order=1, space_axis="space", opt=1)
    _assert_clips_equal(got, want)


def test_width_sharded_float(rng):
    clip = _clip(rng, "GRAYS", 64, 16, n=2)
    mesh = default_mesh(data=1, space=4)
    want = sangnom2(clip, opt=0, order=1)
    got = sangnom2_sharded(clip, mesh, order=1, space_axis="space")
    _assert_clips_equal(got, want)


def test_width_sharded_chroma_aac(rng):
    """Regression: subsampled chroma smooths against the LUMA stride with
    zero-defined padding (SURVEY.md §2 quirk 6); with aac > 0 the
    directional select actually runs on chroma, exposing any stride-
    semantics divergence in the sharded path."""
    clip = _clip(rng, "YUV420P8", 64, 16, n=2)
    mesh = default_mesh(data=2, space=4)
    want = sangnom2(clip, opt=0, order=1, aa=48, aac=48)
    got = sangnom2_sharded(clip, mesh, order=1, aa=48, aac=48,
                           space_axis="space")
    _assert_clips_equal(got, want)
    # 4:2:2 too (taller chroma, different padding-creep extent)
    clip = _clip(rng, "YUV422P10", 64, 16, n=2)
    want = sangnom2(clip, opt=0, order=2, aa=96, aac=96)
    got = sangnom2_sharded(clip, mesh, order=2, aa=96, aac=96,
                           space_axis="space")
    _assert_clips_equal(got, want)


def test_width_sharded_non_mod32_width(rng):
    """Arbitrary widths: planes are edge-padded to the buffer stride before
    sharding, so W need not divide anything."""
    clip = _clip(rng, "GRAY8", 40, 16, n=2)  # stride 64, w 40
    mesh = default_mesh(data=1, space=4)
    want = sangnom2(clip, opt=0, order=1, aa=32)
    got = sangnom2_sharded(clip, mesh, order=1, aa=32, space_axis="space")
    _assert_clips_equal(got, want)


def test_width_sharding_validation(rng):
    clip = _clip(rng, "GRAY8", 32, 16, n=2)  # stride 32
    # stride must divide across the space axis
    mesh3 = default_mesh(data=2, space=3)
    with pytest.raises(ValueError, match="does not divide"):
        sangnom2_sharded(clip, mesh3, space_axis="space")


def test_sharded_validates_params(rng):
    clip = _clip(rng, "GRAY8", 32, 16, n=2)
    mesh = default_mesh(data=2)
    with pytest.raises(Exception, match=r"order must be between 0\.\.2\."):
        sangnom2_sharded(clip, mesh, order=9)


def test_width_sharded_order0_dh(rng):
    """Traced per-frame offsets + dh + width sharding together."""
    parity = np.array([True, False, True])
    clip = _clip(rng, "YUV420P8", 64, 8, n=3, parity=parity)
    mesh = default_mesh(data=1, space=4)
    want = sangnom2(clip, opt=0, order=0, dh=True, aac=32)
    got = sangnom2_sharded(clip, mesh, order=0, dh=True, aac=32,
                           space_axis="space")
    _assert_clips_equal(got, want)


def test_width_sharded_float_chroma_aac(rng):
    clip = _clip(rng, "YUV422PS", 64, 16, n=2)
    mesh = default_mesh(data=2, space=4)
    want = sangnom2(clip, opt=0, order=1, aa=96, aac=96)
    got = sangnom2_sharded(clip, mesh, order=1, aa=96, aac=96,
                           space_axis="space")
    _assert_clips_equal(got, want)


def test_width_sharded_alpha_passthrough(rng):
    clip = _clip(rng, "YUVA444P8", 64, 16, n=2)
    mesh = default_mesh(data=1, space=8)
    want = sangnom2(clip, opt=0, order=2)
    got = sangnom2_sharded(clip, mesh, order=2, space_axis="space")
    _assert_clips_equal(got, want)


def test_sharded_repeat_calls_hit_jit_cache(rng):
    """Repeat calls with the same mesh/config must not retrace: a per-call
    closure jit retraced AND recompiled the whole sharded program every
    invocation."""
    from sangnom_jax.parallel.sharding import _sharded_jit

    clip = _clip(rng, "YUV420P8", 32, 16, n=4)
    mesh = default_mesh(data=2, space=2)
    kw = dict(order=1, dh=True, space_axis="space")
    first = sangnom2_sharded(clip, mesh, **kw)
    size = _sharded_jit._cache_size()
    again = sangnom2_sharded(clip, mesh, **kw)
    assert _sharded_jit._cache_size() == size, "second call retraced"
    _assert_clips_equal(again, first)


def test_width_sharded_411_deep_stride_cut(rng):
    """YUV411P8: the deepest chroma subsampling (w/4), where the creep/
    decay-bound padded width (_sharded_pad_width) cuts the sharded chroma
    array hardest below the luma stride — and a u16 case, whose decay
    bound is wider (14 hops).  Both must stay bit-exact vs unsharded."""
    mesh = default_mesh(data=1, space=4)
    for fmt_name, kw in [("YUV411P8", dict(order=1, dh=True, aac=48)),
                         ("YUV422P16", dict(order=2, aa=128))]:
        clip = _clip(rng, fmt_name, 128, 16, n=2)
        for opt in (0, 1):
            want = sangnom2(clip, opt=0, **kw)
            got = sangnom2_sharded(clip, mesh, space_axis="space", opt=opt,
                                   **kw)
            _assert_clips_equal(got, want)


def _lowered_collectives(clip, mesh, *, opt, n_space, order=1, dh=False):
    """collective_permute site count in the UNCOMPILED StableHLO of the
    cached sharded program (S._sharded_jit) — the designed communication
    structure, before backend passes."""
    import jax.numpy as jnp

    import sangnom_jax.parallel.sharding as S
    from sangnom_jax.core.geometry import buffer_stride_elems

    fmt = clip.format
    stride = buffer_stride_elems(clip.width, fmt.component_size)
    widths = tuple(p.shape[2] for p in clip.planes)
    planes = []
    for p in clip.planes:
        if p.shape[2] < stride:
            s_eff = S._sharded_pad_width(
                p.shape[2], p.shape[1], stride, n_space, fmt, dh
            )
            if p.shape[2] < s_eff:
                p = jnp.pad(p, ((0, 0), (0, 0), (0, s_eff - p.shape[2])),
                            mode="edge")
        planes.append(p)
    lowered = S._sharded_jit.lower(
        tuple(planes), clip.parity_array(), mesh=mesh, fmt=fmt, order=order,
        aa=48, aac=0, dh=dh, luma=True, chroma=True, opt=opt, numerics="c",
        data_axis="data", space_axis="space", plane_widths=widths,
        stride=stride,
    )
    return lowered.as_text().count("stablehlo.collective_permute")


def test_sharded_halo_exchange_count_invariants(rng):
    """Pin the sharded communication STRUCTURE (docs/MULTICHIP.md): the
    per-row halo exchanges ride the scan state, so the number of
    collective sites is independent of plane height, and every processed
    plane trace has them."""
    mesh = default_mesh(data=2, space=2)
    for opt in (0, 1):
        short = _lowered_collectives(_clip(rng, "YUV420P8", 64, 32, n=4),
                                     mesh, opt=opt, n_space=2)
        tall = _lowered_collectives(_clip(rng, "YUV420P8", 64, 96, n=4),
                                    mesh, opt=opt, n_space=2)
        assert short > 0
        assert tall == short, (
            f"opt={opt}: halo-exchange sites scale with height "
            f"({short} -> {tall}); exchanges must ride the scan"
        )


@pytest.mark.parametrize("kw,parity", [
    (dict(order=1, dh=True), None),
    (dict(order=0), np.array([True, False, False, True])),
])
def test_data_parallel_runs_kernel_per_shard(rng, kw, parity):
    """Frame sharding with opt=1 runs the row-scan kernel inside each
    shard (interpreted here), bit-exact to the unsharded jnp path."""
    clip = _clip(rng, "YUV420P8", 32, 16, n=4, parity=parity)
    mesh = default_mesh(data=4)
    want = sangnom2(clip, opt=0, **kw)
    got = sangnom2_sharded(clip, mesh, opt=1, **kw)
    _assert_clips_equal(got, want)


def test_pool_compat_sharded_rejected(rng):
    """pool_compat x sharding is an EXPLICIT fail-fast rejection, not a
    silent hole (VERDICT_r4 #4; analysis in docs/MULTICHIP.md) — the pool
    is sequential cross-frame state."""
    from sangnom_jax.api import SangNomError

    clip = _clip(rng, "YUV420P8", 32, 16, n=4)
    mesh = default_mesh(data=4, space=2)
    with pytest.raises(SangNomError, match="pool_compat is not supported "
                       "under sharding"):
        sangnom2_sharded(clip, mesh, order=1, pool_compat=True)
