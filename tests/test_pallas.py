"""The row-scan kernel (opt=1) against the jnp reference backend (opt=0)
and the scalar spec: bit-exact parity.

On the CPU the kernel runs in the Pallas interpreter (same program, no
Triton compile).  What the GPU compiler says is checked here only as far
as lowering goes (the kernel is lowered for CUDA on this host); compiled
runs on the card are the `chip` tests and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sangnom_jax import Clip, get_format, sangnom2
from sangnom_jax.ops import pallas_kernel as pk

from conftest import make_planes
from scalar_model import sangnom2_frame_scalar


def _clip(fmt_name, w, h, rng, n=1, parity=None):
    fmt = get_format(fmt_name)
    frames = [make_planes(rng, w, h, fmt) for _ in range(n)]
    planes = [np.stack([f[i] for f in frames]) for i in range(fmt.num_planes)]
    return Clip.from_numpy(planes, fmt, parity=parity), frames


def _run(fmt_name, w, h, rng, n=1, **kw):
    clip, _ = _clip(fmt_name, w, h, rng, n, parity=kw.pop("parity", None))
    a = sangnom2(clip, opt=0, **kw)  # jnp reference
    b = sangnom2(clip, opt=1, **kw)  # row-scan kernel
    for i in range(clip.format.num_planes):
        np.testing.assert_array_equal(
            np.asarray(a.planes[i]), np.asarray(b.planes[i]), err_msg=f"plane {i}"
        )


PARITY_CASES = [
    ("GRAY8", 64, 32, dict(order=1)),
    ("YUV420P8", 48, 24, dict(order=2)),
    ("YUV420P8", 32, 16, dict(order=1, dh=True)),
    ("YUV422P10", 40, 20, dict(order=2)),
    ("GRAY16", 40, 16, dict(order=1, aa=128, aac=64)),
    ("YUV444PS", 40, 16, dict(order=2, aa=48, aac=48)),
    ("GRAY8", 31, 8, dict(order=1)),
    ("GRAY8", 32, 8, dict(order=2)),  # stride == w: taps clamp at edge
    ("GRAY8", 5, 8, dict(order=1)),
    ("GRAY8", 130, 10, dict(order=1)),  # stride 160: block width 256
    ("YUV411P8", 48, 16, dict(order=1, aa=48, aac=48)),  # 4:1:1 chroma
]


@pytest.mark.parametrize("fmt_name,w,h,kw", PARITY_CASES, ids=lambda v: str(v))
def test_pallas_matches_reference(rng, fmt_name, w, h, kw):
    _run(fmt_name, w, h, rng, **kw)


@pytest.mark.parametrize("fmt_name,w,h,kw", PARITY_CASES, ids=lambda v: str(v))
def test_pallas_matches_scalar_spec(rng, fmt_name, w, h, kw):
    """The kernel against the independent scalar model of the reference's
    C path, frame by frame."""
    clip, frames = _clip(fmt_name, w, h, rng, n=2)
    got = sangnom2(clip, opt=1, **kw)
    for n, f in enumerate(frames):
        want = sangnom2_frame_scalar(f, clip.format, **kw)
        for i, wp in enumerate(want):
            np.testing.assert_array_equal(
                np.asarray(got.planes[i])[n], np.asarray(wp),
                err_msg=f"frame {n} plane {i}")


def test_pallas_batched_frames(rng):
    _run("GRAY8", 48, 16, rng, n=5, order=1)


def test_pallas_order0_mixed_parity(rng):
    parity = np.array([True, False, True, False])
    _run("GRAY8", 32, 16, rng, n=4, order=0, parity=parity)


def test_pallas_order0_mixed_parity_dh(rng):
    """True-bob shape: dh height doubling with alternating per-frame
    parity — the kernel's per-frame-offset weave against the jnp
    reference, including subsampled chroma."""
    parity = np.array([True, False, True, False, True])
    _run("YUV420P8", 48, 16, rng, n=5, order=0, dh=True, parity=parity)


def test_pallas_order0_nonuniform_groups(rng):
    """Non-alternating mixed parity (arbitrary pattern) through the
    per-frame-offset weave."""
    parity = np.array([False, False, True, False])
    _run("GRAY8", 40, 12, rng, n=4, order=0, dh=True, parity=parity)


def test_pallas_aa_zero(rng):
    _run("GRAY8", 32, 16, rng, aa=0, aac=0)


def test_pallas_sse2_numerics(rng):
    _run("GRAY8", 40, 16, rng, order=1, numerics="sse2")
    _run("YUV420P16", 48, 16, rng, order=2, numerics="sse2")


def test_pallas_reduced_width_tiers(rng):
    """Subsampled chroma with a large luma stride: the kernel clamps its
    smoothing at the creep/decay bound below the stride (w=640, bufH=42
    against stride 1280 -> clamp 896), bit-exact to the full-stride
    reference."""
    from sangnom_jax.core.geometry import width_tiers

    W_act, W_sm, _ = width_tiers(640, 42, 1280)
    assert W_act < W_sm < 1280, (W_act, W_sm)  # guard the test's own premise
    _run("YUV420P8", 1280, 168, rng, order=1, aa=48, aac=48)


@pytest.mark.parametrize("fmt_name", ["YUV420P8", "GRAY16", "GRAYS"])
@pytest.mark.parametrize("tff", [True, False])
def test_pallas_bob_reads_interlaced_source(rng, fmt_name, tff):
    """bob() hands the kernel the interlaced frames and it reads each
    field in place (row stride 2, dominance-ordered): equal to the
    explicit SeparateFields -> DoubleWeave -> SangNom2(order=0) pipeline
    on the jnp backend."""
    from sangnom_jax import bob
    from sangnom_jax.core.fields import double_weave, separate_fields

    fmt = get_format(fmt_name)
    frames = [make_planes(rng, 40, 16, fmt) for _ in range(3)]
    planes = [np.stack([f[i] for f in frames]) for i in range(fmt.num_planes)]
    clip = Clip.from_numpy(planes, fmt, tff=tff)
    got = bob(clip, opt=1, aa=40, aac=20)
    want = sangnom2(double_weave(separate_fields(clip)), order=0, opt=0,
                    aa=40, aac=20)
    for i in range(fmt.num_planes):
        np.testing.assert_array_equal(np.asarray(got.planes[i]),
                                      np.asarray(want.planes[i]))


def test_pallas_interp_rows_without_weave(rng):
    """`interpolate_field_batch` (the interpolated rows only, the form
    callers without a fused weave use) matches the jnp backend row for
    row."""
    from sangnom_jax.ops import reference
    from sangnom_jax.ops.primitives import KernelSpec

    kept = jnp.asarray(rng.integers(0, 256, (3, 9, 50)).astype(np.uint8))
    spec = KernelSpec(is_float=False, mask=0xFF)
    a = reference.interpolate_field_batch(kept, 62, spec, 64)
    b = pk.interpolate_field_batch(kept, 62, spec, 64)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("w,S,bufH,is_float,Wb", [
    (1920, 1920, 540, False, 2048),   # 1080p luma
    (960, 1920, 270, False, 1024),    # 4:2:0 chroma: clamp at the decay bound
    (960, 1920, 270, True, 2048),     # float chroma keeps the full stride
    (3840, 3840, 1080, False, 4096),  # 4K luma
    (5, 32, 4, False, 32),
])
def test_kernel_block_width(w, S, bufH, is_float, Wb):
    """One program holds the padded row: a power of two covering the
    smoothing width (1920 -> 2048, 3840 -> 4096)."""
    from sangnom_jax.core.geometry import width_tiers
    from sangnom_jax.ops.primitives import KernelSpec

    spec = KernelSpec(is_float=is_float, mask=0 if is_float else 0xFF)
    _, _, S_clamp = width_tiers(w, bufH, S, spec)
    assert w <= S_clamp <= Wb
    assert pk._pow2(S_clamp) == Wb
    assert 4 <= pk._num_warps(Wb) <= 16


# --- lowering for the GPU, here -------------------------------------------

def _lower_cuda(monkeypatch, fn, *args):
    monkeypatch.setattr(pk, "interpret_mode", lambda: False)
    low = jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))
    return low.as_text()


def _u(shape, dt=jnp.uint8):
    return jax.ShapeDtypeStruct(shape, dt)


@pytest.mark.parametrize("fmt_name,w,h,n,kind", [
    ("YUV420P8", 1920, 1080, 4, "bob"),
    ("YUV420P8", 1920, 540, 4, "dh"),
    ("GRAY16", 1920, 1080, 2, "order1"),
    ("YUV444PS", 1920, 540, 2, "dh"),
    ("YUV420P10", 3840, 2160, 2, "bob"),
    ("GRAY8", 3840, 2160, 2, "order1"),
])
def test_kernel_lowers_for_cuda(monkeypatch, fmt_name, w, h, n, kind):
    """The whole program, kernel included, lowers for CUDA at 1080p and 4K
    widths: the Triton custom call is emitted and nothing on the path
    falls back to the interpreter."""
    from sangnom_jax.core.fields import bob_impl
    from sangnom_jax.ops.sangnom import sangnom2_impl

    fmt = get_format(fmt_name)
    shapes = tuple(_u((n,) + tuple(reversed(fmt.plane_dims(w, h, i))),
                      jnp.dtype(fmt.dtype)) for i in range(fmt.num_planes))
    if kind == "bob":
        fn = functools.partial(bob_impl, fmt=fmt, aa=48, aac=0, tff=True,
                               opt=1, numerics="c")
        text = _lower_cuda(monkeypatch, lambda p: fn(p), shapes)
    else:
        order, dh = (1, True) if kind == "dh" else (1, False)
        text = _lower_cuda(
            monkeypatch,
            lambda p, par: sangnom2_impl(p, par, fmt, order, 48, 0, dh,
                                         True, True, 1),
            shapes, _u((n,), jnp.bool_))
    assert "__gpu$xla.gpu.triton" in text
    assert "sangnom_row_scan" in text


# --- where the kernel runs, per platform -----------------------------------

@pytest.mark.parametrize("backend,env,want", [
    ("gpu", None, False),
    ("gpu", "1", False),
    ("cpu", "1", True),
    ("cpu", None, "raise"),
    ("rocm", "1", "raise"),
])
def test_interpret_mode_choice(monkeypatch, backend, env, want):
    """Compiled on a GPU, interpreted on the CPU only when asked for,
    refused elsewhere: the one place the choice is made."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if env is None:
        monkeypatch.delenv("SANGNOM_INTERPRET", raising=False)
    else:
        monkeypatch.setenv("SANGNOM_INTERPRET", env)
    if want == "raise":
        with pytest.raises(pk.KernelUnavailable):
            pk.interpret_mode()
    else:
        assert pk.interpret_mode() is want


@pytest.mark.parametrize("backend,env,ok", [
    ("gpu", None, True),
    ("cpu", "1", True),
    ("cpu", None, False),
    ("rocm", None, False),
])
def test_opt1_gate_per_platform(monkeypatch, backend, env, ok):
    from sangnom_jax.api import _opt1_backend_ok

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if env is None:
        monkeypatch.delenv("SANGNOM_INTERPRET", raising=False)
    else:
        monkeypatch.setenv("SANGNOM_INTERPRET", env)
    assert _opt1_backend_ok() is ok


@pytest.mark.parametrize("backend,opt,kernel", [
    ("gpu", -1, True),
    ("cpu", -1, False),
    ("gpu", 0, False),
    ("cpu", 1, True),
])
def test_pick_backend_per_platform(monkeypatch, backend, opt, kernel):
    """Auto picks the kernel on a GPU and the plain XLA path elsewhere."""
    from sangnom_jax.ops import reference
    from sangnom_jax.ops.sangnom import _pick_backend

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    fn = _pick_backend(opt)
    want = pk.interpolate_field_batch if kernel else \
        reference.interpolate_field_batch
    assert fn is want


# --- on the card -------------------------------------------------------------

@pytest.mark.chip
@pytest.mark.parametrize("fmt_name,w,h,n,kw", [
    ("YUV420P8", 1920, 1080, 4, dict(order=1)),
    ("GRAY16", 1920, 540, 2, dict(order=2, dh=True)),
    ("YUV420P10", 3840, 2160, 1, dict(order=0)),
    ("YUV444PS", 1920, 1080, 1, dict(order=1, aa=48, aac=48)),
])
def test_chip_kernel_matches_plain_path(chip, rng, fmt_name, w, h, n, kw):
    """Compiled kernel against the plain XLA path on the card, at full
    width, float included."""
    assert pk.interpret_mode() is False
    _run(fmt_name, w, h, rng, n=n, **kw)


@pytest.mark.chip
def test_chip_plain_path_batch_from_device_memory(chip):
    """The plain path runs the 120-frame 1080p batch as one scan on an
    80 GB card."""
    from sangnom_jax.ops.reference import scan_batch

    assert scan_batch(540, 1920) >= 120
