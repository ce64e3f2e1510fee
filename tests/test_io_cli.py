"""y4m round-trip and CLI host tests."""

import io
import subprocess
import sys

import numpy as np
import pytest

from sangnom_jax import Clip, get_format, sangnom2
from sangnom_jax.io import read_y4m, write_y4m

from conftest import make_planes


def _roundtrip(fmt_name, w, h, n, rng):
    fmt = get_format(fmt_name)
    frames = [make_planes(rng, w, h, fmt) for _ in range(n)]
    planes = [np.stack([f[i] for f in frames]) for i in range(fmt.num_planes)]
    if fmt_name.startswith("GRAY") or "P1" in fmt_name or fmt_name.endswith("P8"):
        pass
    clip = Clip.from_numpy(planes, fmt)
    buf = io.BytesIO()
    write_y4m(buf, clip)
    buf.seek(0)
    back = read_y4m(buf)
    assert back.format.name == fmt.name
    for i in range(fmt.num_planes):
        np.testing.assert_array_equal(np.asarray(back.planes[i]), np.asarray(clip.planes[i]))


@pytest.mark.parametrize(
    "fmt_name", ["GRAY8", "YUV420P8", "YUV422P10", "YUV444P16", "YUV411P8"]
)
def test_y4m_roundtrip(rng, fmt_name):
    _roundtrip(fmt_name, 32, 16, 3, rng)


def test_y4m_rejects_float(rng):
    fmt = get_format("GRAYS")
    clip = Clip.from_numpy([np.zeros((1, 8, 16), np.float32)], fmt)
    with pytest.raises(ValueError, match="no y4m colorspace"):
        write_y4m(io.BytesIO(), clip)


def test_y4m_rejects_garbage():
    with pytest.raises(ValueError, match="not a YUV4MPEG2"):
        read_y4m(io.BytesIO(b"RIFF....WEBP"))


def test_y4m_interlace_flag_sets_parity(rng):
    fmt = get_format("GRAY8")
    clip = Clip.from_numpy([np.zeros((1, 8, 16), np.uint8)], fmt)
    buf = io.BytesIO()
    write_y4m(buf, clip, interlace="b")
    buf.seek(0)
    assert read_y4m(buf).tff is False


def test_cli_end_to_end(rng, tmp_path):
    """Drive the CLI host exactly as a user would, stdin/stdout included."""
    fmt = get_format("YUV420P8")
    planes = [np.stack([p]) for p in make_planes(rng, 32, 16, fmt)]
    clip = Clip.from_numpy(planes, fmt)
    src = tmp_path / "in.y4m"
    dst = tmp_path / "out.y4m"
    write_y4m(str(src), clip)

    res = subprocess.run(
        [sys.executable, "-m", "sangnom_jax", str(src), str(dst),
         "--order", "2", "--aa", "48"],
        capture_output=True, text=True, timeout=600,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    assert res.returncode == 0, res.stderr
    out = read_y4m(str(dst))
    want = sangnom2(clip, order=2, aa=48, opt=0)
    for i in range(3):
        np.testing.assert_array_equal(
            np.asarray(out.planes[i]), np.asarray(want.planes[i])
        )
    assert "frames 32x16" in res.stderr


def test_cli_cache_dir_populates_and_output_identical(rng, tmp_path):
    """--cache-dir enables the persistent XLA compilation cache: the first
    run populates it, the second run (fresh process, cold jit caches) must
    produce byte-identical output while loading compiled programs from it."""
    fmt = get_format("YUV420P8")
    planes = [np.stack([p]) for p in make_planes(rng, 32, 16, fmt)]
    clip = Clip.from_numpy(planes, fmt)
    src = tmp_path / "in.y4m"
    write_y4m(str(src), clip)
    cache = tmp_path / "xla_cache"

    def run(dst):
        res = subprocess.run(
            [sys.executable, "-m", "sangnom_jax", str(src), str(dst),
             "--order", "1", "--dh", "--cache-dir", str(cache)],
            capture_output=True, text=True, timeout=600,
            env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
        )
        assert res.returncode == 0, res.stderr

    run(tmp_path / "out1.y4m")
    entries = list(cache.iterdir())
    assert entries, "cache dir not populated"
    run(tmp_path / "out2.y4m")
    assert (tmp_path / "out1.y4m").read_bytes() == \
        (tmp_path / "out2.y4m").read_bytes()


@pytest.mark.parametrize("arg,env,backend,want", [
    (None, None, "gpu", "DEFAULT"),      # .jax_cache/ at the checkout root
    (None, None, "cpu", None),           # no default off the accelerator
    (None, "/x/env", "gpu", "/x/env"),   # JAX's own variable wins
    (None, "/x/env", "cpu", "/x/env"),
    ("/x/arg", "/x/env", "gpu", "/x/arg"),  # an explicit dir wins over all
    ("", "/x/env", "gpu", None),         # '' disables
])
def test_cache_dir_resolution(monkeypatch, arg, env, backend, want):
    from sangnom_jax.cli import DEFAULT_CACHE_DIR, resolve_cache_dir

    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    if want == "DEFAULT":
        want = str(DEFAULT_CACHE_DIR)
    assert resolve_cache_dir(arg, backend) == want


def test_default_cache_dir_is_fixed_in_checkout():
    """The default path is a fixed directory at the checkout root (listed
    in .gitignore): never a temp name, a pid or a time, which would never
    hit again."""
    from pathlib import Path

    from sangnom_jax.cli import DEFAULT_CACHE_DIR

    root = Path(__file__).resolve().parent.parent
    assert DEFAULT_CACHE_DIR == root / ".jax_cache"
    assert ".jax_cache/" in (root / ".gitignore").read_text().splitlines()


def test_cli_cache_default_policy(rng, tmp_path):
    """Precedence through the CLI process: $JAX_COMPILATION_CACHE_DIR is
    used as it stands (the CLI sets no other directory); --cache-dir ''
    disables even over it; output bytes never depend on the cache."""
    import os

    fmt = get_format("GRAY8")
    src = tmp_path / "in.y4m"
    write_y4m(str(src), Clip.from_numpy([np.zeros((1, 8, 16), np.uint8)],
                                        fmt))
    cache = tmp_path / "env_cache"
    cache.mkdir()
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "JAX_COMPILATION_CACHE_DIR": str(cache)}

    res = subprocess.run(
        [sys.executable, "-m", "sangnom_jax", str(src),
         str(tmp_path / "o1.y4m"), "--opt", "0"],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert res.returncode == 0, res.stderr
    assert list(cache.iterdir()), "env-var cache not populated"

    cache2 = tmp_path / "env_cache2"
    cache2.mkdir()
    env["JAX_COMPILATION_CACHE_DIR"] = str(cache2)
    res = subprocess.run(
        [sys.executable, "-m", "sangnom_jax", str(src),
         str(tmp_path / "o2.y4m"), "--opt", "0", "--cache-dir", ""],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert res.returncode == 0, res.stderr
    assert not list(cache2.iterdir()), "'' did not override the env var"
    assert (tmp_path / "o1.y4m").read_bytes() == \
        (tmp_path / "o2.y4m").read_bytes()


# -- raw planar I/O -----------------------------------------------------------
@pytest.mark.parametrize("fmt_name", ["GRAYS", "YUVA444P16", "YUV420P8"])
def test_raw_roundtrip(rng, fmt_name):
    from sangnom_jax.io import read_raw, write_raw

    fmt = get_format(fmt_name)
    frames = [make_planes(rng, 16, 8, fmt) for _ in range(2)]
    planes = [np.stack([f[i] for f in frames]) for i in range(fmt.num_planes)]
    clip = Clip.from_numpy(planes, fmt)
    buf = io.BytesIO()
    write_raw(buf, clip)
    buf.seek(0)
    back = read_raw(buf, fmt, 16, 8)
    for i in range(fmt.num_planes):
        np.testing.assert_array_equal(np.asarray(back.planes[i]), planes[i])


def test_raw_truncated_rejected(rng):
    from sangnom_jax.io import frame_size_bytes, read_raw

    fmt = get_format("GRAY8")
    n = frame_size_bytes(fmt, 16, 8)
    with pytest.raises(ValueError, match="truncated"):
        read_raw(io.BytesIO(b"\0" * (n + 3)), fmt, 16, 8)


def test_y4m_preserves_framerate_and_aspect(rng):
    fmt = get_format("GRAY8")
    clip = Clip.from_numpy([np.zeros((1, 8, 16), np.uint8)], fmt,
                           props={"y4m_fps": (30000, 1001), "y4m_aspect": "4:3"})
    buf = io.BytesIO()
    write_y4m(buf, clip)  # defaults to the clip's stream framerate
    head = bytes(buf.getbuffer()[:64])
    assert b"F30000:1001" in head and b"A4:3" in head
    buf.seek(0)
    back = read_y4m(buf)
    assert back.props["y4m_fps"] == (30000, 1001)
    assert back.props["y4m_aspect"] == "4:3"


def test_cli_bff_flag_changes_order0(rng, tmp_path):
    """--bff must affect order=0 on the plain path, not only --bob."""
    fmt = get_format("GRAY8")
    plane = make_planes(rng, 16, 8, fmt)[0][None]
    src = tmp_path / "in.y4m"
    write_y4m(str(src), Clip.from_numpy([plane], fmt))
    import os
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    outs = {}
    for flag in ("--tff", "--bff"):
        dst = tmp_path / f"out{flag}.y4m"
        res = subprocess.run(
            [sys.executable, "-m", "sangnom_jax", str(src), str(dst),
             "--order", "0", flag, "--opt", "0"],
            capture_output=True, text=True, timeout=600, env=env,
        )
        assert res.returncode == 0, res.stderr
        outs[flag] = np.asarray(read_y4m(str(dst)).planes[0])
    assert not np.array_equal(outs["--tff"], outs["--bff"])


def test_cli_output_write_error_clean(rng, tmp_path):
    """An unwritable output path must produce the same clean 'error: ...' /
    exit-2 contract as input errors (not a raw traceback)."""
    import os
    fmt = get_format("GRAY8")
    src = tmp_path / "in.y4m"
    write_y4m(str(src), Clip.from_numpy([np.zeros((1, 8, 16), np.uint8)], fmt))
    res = subprocess.run(
        [sys.executable, "-m", "sangnom_jax", str(src),
         str(tmp_path / "no_such_dir" / "o.y4m")],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert res.returncode == 2
    assert res.stderr.strip().startswith("error:")
    assert "Traceback" not in res.stderr


def test_cli_passthrough_preserves_interlace_tag(rng, tmp_path):
    """--no-luma --no-chroma without --dh touches no plane; the input's
    interlace tag must round-trip instead of being restamped progressive.
    A processing run still stamps 'p'."""
    import os
    fmt = get_format("YUV420P8")
    src = tmp_path / "in.y4m"
    planes = [np.zeros((1, 8, 16), np.uint8), np.zeros((1, 4, 8), np.uint8),
              np.zeros((1, 4, 8), np.uint8)]
    write_y4m(str(src), Clip.from_numpy(planes, fmt), interlace="t")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    for extra, want in ((["--no-luma", "--no-chroma"], "t"), ([], "p")):
        dst = tmp_path / f"out_{want}.y4m"
        res = subprocess.run(
            [sys.executable, "-m", "sangnom_jax", str(src), str(dst)] + extra,
            capture_output=True, text=True, timeout=600, env=env,
        )
        assert res.returncode == 0, res.stderr
        header = dst.read_bytes().split(b"\n", 1)[0].decode()
        assert f"I{want}" in header, (extra, header)


def test_cli_pool_compat_windowed_matches_whole_clip(rng, tmp_path):
    """--pool-compat threads the shared pool across --window chunks, so
    windowed output is byte-identical to whole-clip output (the pool is
    genuine cross-frame state); --numerics sse2 composes."""
    import os
    fmt = get_format("YUV420P8")
    frames = 5
    planes = [
        np.stack([rng.integers(0, 256, (16, 32)).astype(np.uint8)
                  for _ in range(frames)]),
        np.stack([rng.integers(0, 256, (8, 16)).astype(np.uint8)
                  for _ in range(frames)]),
        np.stack([rng.integers(0, 256, (8, 16)).astype(np.uint8)
                  for _ in range(frames)]),
    ]
    src = tmp_path / "in.y4m"
    write_y4m(str(src), Clip.from_numpy(planes, fmt))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    flags = ["--pool-compat", "--numerics", "sse2", "--aac", "48"]
    whole, windowed = tmp_path / "whole.y4m", tmp_path / "win.y4m"
    for dst, extra in ((whole, []), (windowed, ["--window", "2"])):
        res = subprocess.run(
            [sys.executable, "-m", "sangnom_jax", str(src), str(dst)]
            + flags + extra,
            capture_output=True, text=True, timeout=600, env=env,
        )
        assert res.returncode == 0, res.stderr
    assert whole.read_bytes() == windowed.read_bytes()


def test_cli_pool_compat_windowed_legacy_matches_whole_clip(rng, tmp_path):
    """The legacy surface has no dh/luma/chroma parameters; the windowed
    pool-compat path must mirror sangnom()'s fixed defaults (NOT the CLI's
    --dh/--no-chroma flags) so --window stays byte-identical."""
    import os
    fmt = get_format("YUV420P8")
    planes = [
        np.stack([rng.integers(0, 256, (16, 32)).astype(np.uint8)
                  for _ in range(4)]),
        np.stack([rng.integers(0, 256, (8, 16)).astype(np.uint8)
                  for _ in range(4)]),
        np.stack([rng.integers(0, 256, (8, 16)).astype(np.uint8)
                  for _ in range(4)]),
    ]
    src = tmp_path / "in.y4m"
    write_y4m(str(src), Clip.from_numpy(planes, fmt))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    # --dh/--no-chroma must be ignored by --legacy in BOTH modes
    flags = ["--legacy", "--order", "2", "--pool-compat", "--dh",
             "--no-chroma"]
    whole, windowed = tmp_path / "whole.y4m", tmp_path / "win.y4m"
    for dst, extra in ((whole, []), (windowed, ["--window", "2"])):
        res = subprocess.run(
            [sys.executable, "-m", "sangnom_jax", str(src), str(dst)]
            + flags + extra,
            capture_output=True, text=True, timeout=600, env=env,
        )
        assert res.returncode == 0, res.stderr
    assert whole.read_bytes() == windowed.read_bytes()


def test_cli_pool_compat_windowed_validates_opt(rng, tmp_path):
    """An out-of-range --opt must be rejected identically with and without
    --window in pool-compat mode."""
    import os
    fmt = get_format("GRAY8")
    src = tmp_path / "in.y4m"
    write_y4m(str(src), Clip.from_numpy([np.zeros((2, 8, 16), np.uint8)],
                                        fmt))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    for extra in ([], ["--window", "1"]):
        res = subprocess.run(
            [sys.executable, "-m", "sangnom_jax", str(src),
             str(tmp_path / "o.y4m"), "--pool-compat", "--opt", "9"] + extra,
            capture_output=True, text=True, timeout=600, env=env,
        )
        assert res.returncode == 2, (extra, res.stderr)
        assert "opt must be between -1..2." in res.stderr


def test_cli_gray_no_luma_passthrough_preserves_interlace(rng, tmp_path):
    """GRAY with --no-luma touches no plane (the chroma flag is moot on a
    clip with no chroma planes): the interlace tag must round-trip."""
    import os
    fmt = get_format("GRAY8")
    src = tmp_path / "in.y4m"
    write_y4m(str(src), Clip.from_numpy([np.zeros((1, 8, 16), np.uint8)],
                                        fmt), interlace="b")
    dst = tmp_path / "out.y4m"
    res = subprocess.run(
        [sys.executable, "-m", "sangnom_jax", str(src), str(dst),
         "--no-luma"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert res.returncode == 0, res.stderr
    assert "Ib" in dst.read_bytes().split(b"\n", 1)[0].decode()


def test_cli_pool_compat_bob_window_rejected(rng, tmp_path):
    import os
    fmt = get_format("YUV420P8")
    src = tmp_path / "in.y4m"
    write_y4m(str(src), Clip.from_numpy(
        [np.zeros((2, 16, 32), np.uint8), np.zeros((2, 8, 16), np.uint8),
         np.zeros((2, 8, 16), np.uint8)], fmt))
    res = subprocess.run(
        [sys.executable, "-m", "sangnom_jax", str(src),
         str(tmp_path / "o.y4m"), "--bob", "--pool-compat", "--window", "2"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert res.returncode == 2
    assert "error:" in res.stderr


def test_cli_explicit_fps_is_output_rate_under_bob(rng, tmp_path):
    """--fps names the OUTPUT framerate (its documented meaning): an
    explicit --fps must NOT be doubled by --bob; only the input-derived
    default doubles.  Both whole-clip and windowed writers."""
    import os
    fmt = get_format("GRAY8")
    src = tmp_path / "in.y4m"
    write_y4m(str(src), Clip.from_numpy(
        [np.zeros((2, 16, 32), np.uint8)], fmt), fps=(25, 1))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    for name, extra, want in [
        ("e.y4m", ["--fps", "60000:1001"], b"F60000:1001"),
        ("d.y4m", [], b"F50:1"),  # input 25:1 doubled
        ("w.y4m", ["--fps", "60000:1001", "--window", "2"], b"F60000:1001"),
    ]:
        out = tmp_path / name
        res = subprocess.run(
            [sys.executable, "-m", "sangnom_jax", str(src), str(out),
             "--bob"] + extra,
            capture_output=True, text=True, timeout=600, env=env,
        )
        assert res.returncode == 0, res.stderr
        header = out.read_bytes().split(b"\n", 1)[0]
        assert want in header, (name, header)


def test_cli_legacy_bob_rejected(rng, tmp_path):
    """--legacy --bob would silently run the SangNom2 surface; the CLI
    rejects the combination (while --dh/--aac stay IGNORED under
    --legacy per the legacy surface's parameter set, pinned above)."""
    import os
    fmt = get_format("GRAY8")
    src = tmp_path / "in.y4m"
    write_y4m(str(src), Clip.from_numpy([np.zeros((2, 8, 16), np.uint8)],
                                        fmt))
    res = subprocess.run(
        [sys.executable, "-m", "sangnom_jax", str(src),
         str(tmp_path / "o.y4m"), "--legacy", "--bob"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert res.returncode == 2
    assert "--legacy cannot be combined with --bob" in res.stderr


def test_cli_bad_fps_clean_error(rng, tmp_path):
    import os
    fmt = get_format("GRAY8")
    src = tmp_path / "in.y4m"
    write_y4m(str(src), Clip.from_numpy([np.zeros((1, 8, 16), np.uint8)], fmt))
    res = subprocess.run(
        [sys.executable, "-m", "sangnom_jax", str(src), str(tmp_path / "o.y4m"),
         "--fps", "25"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert res.returncode == 2
    assert res.stderr.strip().startswith("error:")


# -- streaming / windowed mode ------------------------------------------------
def test_iter_y4m_windows(rng):
    from sangnom_jax.io import iter_y4m

    fmt = get_format("GRAY8")
    planes = [np.stack([make_planes(rng, 16, 8, fmt)[0] for _ in range(7)])]
    clip = Clip.from_numpy(planes, fmt)
    buf = io.BytesIO()
    write_y4m(buf, clip, fps=(30, 1))
    buf.seek(0)
    sizes = []
    got = []
    for w in iter_y4m(buf, window=3):
        sizes.append(w.num_frames)
        assert w.props["y4m_fps"] == (30, 1)
        got.append(np.asarray(w.planes[0]))
    assert sizes == [3, 3, 1]
    np.testing.assert_array_equal(np.concatenate(got), planes[0])


@pytest.mark.parametrize("mode", [[], ["--bob"]])
def test_cli_windowed_matches_whole_clip(rng, tmp_path, mode):
    """--window output must be byte-identical to whole-clip processing,
    including the bob pipeline's cross-window field pairing."""
    import os

    fmt = get_format("YUV420P8")
    frames = [make_planes(rng, 32, 16, fmt) for _ in range(7)]
    planes = [np.stack([f[i] for f in frames]) for i in range(3)]
    src = tmp_path / "in.y4m"
    write_y4m(str(src), Clip.from_numpy(planes, fmt), fps=(30, 1))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}

    outs = {}
    for tag, extra in (("whole", []), ("win", ["--window", "3"]),
                       ("winov", ["--window", "3", "--overlap-write"])):
        dst = tmp_path / f"{tag}.y4m"
        res = subprocess.run(
            [sys.executable, "-m", "sangnom_jax", str(src), str(dst),
             "--opt", "0", *mode, *extra],
            capture_output=True, text=True, timeout=600, env=env,
        )
        assert res.returncode == 0, res.stderr
        outs[tag] = dst.read_bytes()
    assert outs["whole"] == outs["win"] == outs["winov"]


def test_cli_overlap_write_errors(rng, tmp_path):
    """Writer-thread failures surface as the clean exit-2 contract, and
    --overlap-write without --window is rejected up front."""
    import os

    fmt = get_format("GRAY8")
    src = tmp_path / "in.y4m"
    write_y4m(str(src), Clip.from_numpy([np.zeros((3, 8, 16), np.uint8)], fmt))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run(
        [sys.executable, "-m", "sangnom_jax", str(src),
         str(tmp_path / "no_such_dir" / "o.y4m"), "--opt", "0",
         "--window", "1", "--overlap-write"],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert res.returncode == 2
    assert res.stderr.strip().startswith("error:")
    assert "Traceback" not in res.stderr

    res = subprocess.run(
        [sys.executable, "-m", "sangnom_jax", str(src),
         str(tmp_path / "o.y4m"), "--overlap-write"],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert res.returncode == 2
    assert "--overlap-write requires --window" in res.stderr


def test_cli_overlap_reader_thread_errors(rng, tmp_path):
    """A malformed stream parsed on the READER thread (the --overlap-write
    prefetch stage, round 4) must surface as the clean exit-2 contract on
    the main thread, not a hang or a traceback."""
    import os

    fmt = get_format("GRAY8")
    src = tmp_path / "in.y4m"
    write_y4m(str(src), Clip.from_numpy([np.zeros((3, 8, 16), np.uint8)],
                                        fmt))
    data = src.read_bytes()
    src.write_bytes(data[: len(data) - 40])  # truncate mid-frame
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run(
        [sys.executable, "-m", "sangnom_jax", str(src),
         str(tmp_path / "o.y4m"), "--opt", "0", "--window", "1",
         "--overlap-write"],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert res.returncode == 2
    assert "truncated" in res.stderr
    assert "Traceback" not in res.stderr


def test_y4m_chroma_siting_tag_roundtrip(rng):
    """420mpeg2 siting tag survives read -> filter -> write."""
    fmt = get_format("YUV420P8")
    planes = make_planes(rng, 16, 8, fmt)
    buf = io.BytesIO()
    clip = Clip.from_numpy([p[None] for p in planes], fmt)
    write_y4m(buf, clip)
    raw = buf.getvalue().replace(b"C420\n", b"C420mpeg2\n")
    back = read_y4m(io.BytesIO(raw))
    assert back.props["y4m_colorspace"] == "420mpeg2"
    out = sangnom2(back, order=1)
    buf2 = io.BytesIO()
    write_y4m(buf2, out)
    assert b"C420mpeg2" in bytes(buf2.getbuffer()[:64])


# -- chunked reader internals (io.common.read_frames_chunked) -----------------
def _make_y4m_bytes(rng, n_frames):
    fmt = get_format("YUV420P8")
    planes = [
        rng.integers(0, 256, (n_frames, 16 >> s, 32 >> s), dtype=np.uint8)
        for s in (0, 1, 1)
    ]
    clip = Clip.from_numpy(planes, fmt)
    buf = io.BytesIO()
    write_y4m(buf, clip)
    return buf.getvalue(), planes


@pytest.mark.parametrize("n_frames", [7, 6])  # 6 == EOF exactly at a
def test_y4m_multichunk_read(rng, monkeypatch, n_frames):  # chunk boundary
    """Force the multi-chunk concatenate path (and the EOF-at-exact-chunk-
    boundary case) by shrinking the chunk byte budget to 3 frames."""
    from sangnom_jax.io import common

    data, planes = _make_y4m_bytes(rng, n_frames)
    frame_bytes = 32 * 16 * 3 // 2
    monkeypatch.setattr(common, "CHUNK_BYTES", 3 * frame_bytes)
    back = read_y4m(io.BytesIO(data))
    for i in range(3):
        np.testing.assert_array_equal(np.asarray(back.planes[i]), planes[i])


def test_y4m_multichunk_truncated(rng, monkeypatch):
    from sangnom_jax.io import common

    data, _ = _make_y4m_bytes(rng, 5)
    frame_bytes = 32 * 16 * 3 // 2
    monkeypatch.setattr(common, "CHUNK_BYTES", 2 * frame_bytes)
    with pytest.raises(ValueError, match="truncated y4m frame"):
        read_y4m(io.BytesIO(data[:-10]))


class _ReadOnlyDribble:
    """File-like with NO readinto and bounded short read()s — the
    readinto_full fallback path (loops until filled; None at exhaustion
    exercises the non-blocking-EOF contract)."""

    def __init__(self, data, max_read=7):
        self._fh = io.BytesIO(data)
        self._max = max_read

    def readline(self):
        return self._fh.readline()

    def read(self, n=-1):
        out = self._fh.read(min(n, self._max) if n >= 0 else self._max)
        return out if out else None

    def close(self):
        self._fh.close()


def test_y4m_read_fallback_short_reads(rng):
    data, planes = _make_y4m_bytes(rng, 3)
    back = read_y4m(_ReadOnlyDribble(data))
    for i in range(3):
        np.testing.assert_array_equal(np.asarray(back.planes[i]), planes[i])


def test_raw_multichunk_read(rng, monkeypatch):
    from sangnom_jax.io import common, read_raw, write_raw

    fmt = get_format("GRAY8")
    planes = [rng.integers(0, 256, (9, 8, 16), dtype=np.uint8)]
    clip = Clip.from_numpy(planes, fmt)
    buf = io.BytesIO()
    write_raw(buf, clip)
    monkeypatch.setattr(common, "CHUNK_BYTES", 2 * 8 * 16)
    back = read_raw(io.BytesIO(buf.getvalue()), fmt, 16, 8)
    np.testing.assert_array_equal(np.asarray(back.planes[0]), planes[0])
