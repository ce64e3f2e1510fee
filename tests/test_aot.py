"""AOT program export/load (sangnom_jax.aot + the CLI prewarm verb,
VERDICT_r4 #2).

The exported artifact is the same traced program as the jit path, so
every test pins BYTE IDENTITY between an AOT-served dispatch and the
normal path, plus the hit/miss accounting that proves the artifact was
actually used (not silently fallen back from).
"""

import io

import numpy as np
import pytest

from sangnom_jax import Clip, aot, bob, get_format, sangnom2
from sangnom_jax.io import read_y4m, write_y4m


@pytest.fixture
def _aot_off():
    yield
    aot.configure(None)


def _clip(rng, n=4, w=64, h=32, fmt_name="YUV420P8", parity=None):
    fmt = get_format(fmt_name)
    planes = []
    for i in range(fmt.num_planes):
        pw, ph = fmt.plane_dims(w, h, i)
        planes.append(rng.integers(0, 256, (n, ph, pw)).astype(fmt.dtype))
    return Clip.from_numpy(planes, fmt, parity=parity), planes


def test_filter_program_roundtrip(rng, tmp_path, _aot_off):
    """save_program -> configure -> sangnom2 serves from the artifact and
    matches the jit path bit-for-bit."""
    clip, _ = _clip(rng)
    fmt = clip.format
    kw = dict(order=1, aa=48, aac=0, dh=True, luma=True, chroma=True,
              opt=0, numerics="c")
    want = sangnom2(clip, order=1, dh=True, opt=0)

    path = aot.save_program(tmp_path, "filter", fmt,
                            aot.plane_shapes(clip.planes),
                            aot.filter_statics(**kw))
    assert path.exists() and path.stat().st_size > 0

    aot.configure(tmp_path)
    got = sangnom2(clip, order=1, dh=True, opt=0)
    assert aot.STATS["hits"] == 1, aot.STATS
    for a, b in zip(got.planes, want.planes):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_filter_order0_traced_parity_matches_static_split(rng, tmp_path,
                                                          _aot_off):
    """order=0 mixed parity: the AOT program runs the traced-parity path;
    it must match the eager static split bit-for-bit (the backend
    contract)."""
    parity = np.arange(5) % 2 == 0
    clip, _ = _clip(rng, n=5, parity=parity)
    kw = dict(order=0, aa=48, aac=0, dh=True, luma=True, chroma=True,
              opt=0, numerics="c")
    want = sangnom2(clip, order=0, dh=True, opt=0)

    aot.save_program(tmp_path, "filter", clip.format,
                     aot.plane_shapes(clip.planes), aot.filter_statics(**kw))
    aot.configure(tmp_path)
    got = sangnom2(clip, order=0, dh=True, opt=0)
    assert aot.STATS["hits"] == 1
    for a, b in zip(got.planes, want.planes):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_bob_program_roundtrip(rng, tmp_path, _aot_off):
    clip, _ = _clip(rng, n=3)
    want = bob(clip, opt=0)
    aot.save_program(tmp_path, "bob", clip.format,
                     aot.plane_shapes(clip.planes),
                     aot.bob_statics(48, 0, True, 0, "c"))
    aot.configure(tmp_path)
    got = bob(clip, opt=0)
    assert aot.STATS["hits"] == 1
    assert got.num_frames == 2 * clip.num_frames
    for a, b in zip(got.planes, want.planes):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_miss_falls_back(rng, tmp_path, _aot_off):
    """Unmatched geometry/params fall back to jit with a recorded miss."""
    clip, _ = _clip(rng)
    aot.configure(tmp_path)  # empty dir: everything misses
    want_off = None
    got = sangnom2(clip, order=2, opt=0)
    assert aot.STATS["hits"] == 0 and aot.STATS["misses"] >= 1
    aot.configure(None)
    want_off = sangnom2(clip, order=2, opt=0)
    for a, b in zip(got.planes, want_off.planes):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_corrupt_artifact_is_a_miss(rng, tmp_path, _aot_off, capsys):
    clip, _ = _clip(rng)
    kw = dict(order=1, aa=48, aac=0, dh=False, luma=True, chroma=True,
              opt=0, numerics="c")
    key = aot.program_key("filter", clip.format.name,
                          aot.plane_shapes(clip.planes),
                          aot.filter_statics(**kw))
    (tmp_path / f"{key}.jaxexport").write_bytes(b"not a program")
    aot.configure(tmp_path)
    got = sangnom2(clip, order=1, opt=0)
    assert aot.STATS["misses"] >= 1 and aot.STATS["hits"] == 0
    aot.configure(None)
    want = sangnom2(clip, order=1, opt=0)
    for a, b in zip(got.planes, want.planes):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_key_distinguishes_params_and_shapes(rng):
    clip, _ = _clip(rng)
    sh = aot.plane_shapes(clip.planes)
    base = aot.filter_statics(1, 48, 0, False, True, True, 0, "c")
    k0 = aot.program_key("filter", "YUV420P8", sh, base)
    assert k0 != aot.program_key("filter", "YUV420P8", sh,
                                 dict(base, aa=49))
    assert k0 != aot.program_key("bob", "YUV420P8", sh, base)
    sh2 = tuple((tuple(s[:-1]) + (s[-1] + 2,), d) for s, d in sh)
    assert k0 != aot.program_key("filter", "YUV420P8", sh2, base)


# --- CLI integration ---------------------------------------------------------

def _write_y4m_file(rng, path, n=5, w=64, h=32):
    fmt = get_format("YUV420P8")
    planes = [rng.integers(0, 256, (n, h, w)).astype(np.uint8),
              rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8),
              rng.integers(0, 256, (n, h // 2, w // 2)).astype(np.uint8)]
    clip = Clip.from_numpy(planes, fmt)
    buf = io.BytesIO()
    write_y4m(buf, clip, fps=(25, 1))
    path.write_bytes(buf.getvalue())


def test_cli_prewarm_and_aot_run(rng, tmp_path, _aot_off, capsys):
    """prewarm verb -> main CLI --aot: byte-identical output to the plain
    run, and the stderr note confirms artifact hits."""
    from sangnom_jax.cli import main

    src = tmp_path / "in.y4m"
    _write_y4m_file(rng, src, n=5)
    adir = tmp_path / "aot"

    rc = main(["prewarm", "--aot", str(adir), "--format", "YUV420P8",
               "--size", "64x32", "--window", "2", "--order", "1", "--dh",
               "--opt", "0"])
    assert rc == 0
    arts = list(adir.glob("*.jaxexport"))
    assert len(arts) == 1 and arts[0].name.startswith("filter-YUV420P8-")

    out_plain = tmp_path / "plain.y4m"
    out_aot = tmp_path / "aot.y4m"
    assert main([str(src), str(out_plain), "--order", "1", "--dh", "--opt",
                 "0", "--window", "2", "--no-overlap-write"]) == 0
    capsys.readouterr()
    assert main([str(src), str(out_aot), "--order", "1", "--dh", "--opt",
                 "0", "--window", "2", "--no-overlap-write", "--aot",
                 str(adir)]) == 0
    err = capsys.readouterr().err
    # 5 frames in windows of 2 -> two full windows hit, the trailing
    # 1-frame window misses (documented fallback)
    assert "aot: 2 dispatch(es) served from artifacts" in err, err
    assert out_plain.read_bytes() == out_aot.read_bytes()
    got = read_y4m(io.BytesIO(out_aot.read_bytes()))
    assert got.height == 64


def test_cli_prewarm_bob_windowed(rng, tmp_path, _aot_off, capsys):
    from sangnom_jax.cli import main

    src = tmp_path / "in.y4m"
    _write_y4m_file(rng, src, n=5)
    adir = tmp_path / "aot"
    rc = main(["prewarm", "--aot", str(adir), "--format", "YUV420P8",
               "--size", "64x32", "--window", "2", "--bob", "--opt", "0"])
    assert rc == 0
    assert len(list(adir.glob("bob-*.jaxexport"))) == 2  # N and N+1 feeds

    out_plain = tmp_path / "plain.y4m"
    out_aot = tmp_path / "aot.y4m"
    assert main([str(src), str(out_plain), "--bob", "--opt", "0",
                 "--window", "2", "--no-overlap-write"]) == 0
    capsys.readouterr()
    assert main([str(src), str(out_aot), "--bob", "--opt", "0",
                 "--window", "2", "--no-overlap-write", "--aot",
                 str(adir)]) == 0
    err = capsys.readouterr().err
    assert "served from artifacts" in err
    assert out_plain.read_bytes() == out_aot.read_bytes()


def test_cli_prewarm_validation_errors(tmp_path, capsys):
    from sangnom_jax.cli import main

    rc = main(["prewarm", "--aot", str(tmp_path), "--format", "YUV420P8",
               "--size", "64x30", "--frames", "2"])  # 420 height not mod4
    assert rc == 2
    assert "height must be mod4" in capsys.readouterr().err
    rc = main(["prewarm", "--aot", str(tmp_path), "--format", "YUV420P8",
               "--size", "64x32", "--frames", "2", "--order", "7"])
    assert rc == 2
    assert "order must be between 0..2." in capsys.readouterr().err


@pytest.mark.parametrize("kind", ["filter", "bob"])
def test_export_for_cuda_with_kernel(monkeypatch, kind):
    """The GPU program, row-scan kernel included, exports for CUDA from
    this host: the Triton custom call is allowed explicitly and the
    artifact deserializes with the kernel inside."""
    from sangnom_jax.ops import pallas_kernel as pk

    monkeypatch.setattr(pk, "interpret_mode", lambda: False)
    fmt = get_format("YUV420P8")
    n, h = (2, 1080) if kind == "bob" else (4, 540)
    shapes = tuple(((n,) + tuple(reversed(fmt.plane_dims(1920, h, i))),
                    "uint8") for i in range(3))
    statics = (aot.bob_statics(48, 0, True, 1, "c") if kind == "bob" else
               aot.filter_statics(1, 48, 0, True, True, True, 1, "c"))
    blob = aot.export_program(kind, fmt, shapes, statics,
                              platforms=("cuda",))
    exp = aot.deserialize(blob)
    assert exp.platforms == ("cuda",)
    assert aot.TRITON_CUSTOM_CALL in exp.mlir_module()


def test_key_includes_jax_version(monkeypatch):
    """A custom call carries no compatibility guarantee across JAX
    versions, so an artifact of another JAX is a miss, not a load."""
    import jax

    shapes = (((2, 16, 32), "uint8"),)
    statics = aot.filter_statics(1, 48, 0, False, True, True, 1, "c")
    k1 = aot.program_key("filter", "GRAY8", shapes, statics)
    monkeypatch.setattr(jax, "__version__", "0.0.0-other")
    assert aot.program_key("filter", "GRAY8", shapes, statics) != k1
