"""AviSynth script-text evaluation (hosts/avs_script.py): the exact lines
a reference user writes, run against the protocol host."""

import numpy as np
import pytest

from conftest import make_planes
from sangnom_jax import Clip, get_format, sangnom2
from sangnom_jax.core.fields import bob
from sangnom_jax.hosts.avisynth import (ArraySource, AvisynthError,
                                        ScriptEnvironment,
                                        avisynth_plugin_init)
from sangnom_jax.hosts.avs_script import eval_script


def _env():
    env = ScriptEnvironment()
    avisynth_plugin_init(env)
    return env


def _src(rng, n=4, fmt_name="YUV420P8", w=32, h=16):
    fmt = get_format(fmt_name)
    frames = [make_planes(rng, w, h, fmt) for _ in range(n)]
    planes = [np.stack([fr[i] for fr in frames])
              for i in range(fmt.num_planes)]
    return ArraySource(planes, fmt_name), planes


def _collect(clip, env):
    vi = clip.get_video_info()
    frames = [clip.get_frame(n, env) for n in range(vi.num_frames)]
    return [np.stack([fr.planes[i] for fr in frames])
            for i in range(vi.num_components())]


def test_verbatim_double_rate_recipe_matches_bob(rng):
    """The reference's documented recipe as literal script text
    (src/SangNom2.cpp:18-23), including a comment and a continuation."""
    env = _env()
    src, planes = _src(rng, n=3)
    script = """
    # classic double-rate bob
    AssumeTFF()
    SeparateFields()
    DoubleWeave()
    SangNom2(order=0, \\
             aa=48)
    """
    out = eval_script(env, script, last=src)
    got = _collect(out, env)
    ref = bob(Clip.from_numpy(planes, "YUV420P8"), tff=True)
    for g, r in zip(got, ref.planes):
        np.testing.assert_array_equal(g, np.asarray(r))


def test_oop_chaining_variables_and_return(rng):
    env = _env()
    src, planes = _src(rng, n=3)
    script = """
    x = clip.AssumeBFF().SeparateFields()
    y = x.Weave()
    return y.SangNom2(order=1, dh=true)
    """
    out = eval_script(env, script, variables={"CLIP": src})
    got = _collect(out, env)
    ref = sangnom2(Clip.from_numpy(planes, "YUV420P8"), order=1, dh=True)
    for g, r in zip(got, ref.planes):
        np.testing.assert_array_equal(g, np.asarray(r))


def test_case_insensitive_and_bool_words(rng):
    env = _env()
    src, planes = _src(rng, n=2, fmt_name="GRAY8")
    out = eval_script(env, "SANGNOM2(ORDER=2, DH=yes)", last=src)
    got = _collect(out, env)
    ref = sangnom2(Clip.from_numpy(planes, "GRAY8"), order=2, dh=True)
    np.testing.assert_array_equal(got[0], np.asarray(ref.planes[0]))


def test_implicit_last_updates_through_statements(rng):
    env = _env()
    src, _ = _src(rng, n=4)
    ev_out = eval_script(env, "SeparateFields()\nSelectEven()", last=src)
    assert ev_out.get_video_info().num_frames == 4  # 8 fields -> evens
    assert ev_out.get_video_info().height == 8


def test_script_errors_are_line_numbered(rng):
    env = _env()
    src, _ = _src(rng)
    with pytest.raises(AvisynthError, match="line 2: there is no function"):
        eval_script(env, "AssumeTFF()\nBogus()", last=src)
    with pytest.raises(AvisynthError, match="line 1.*order must be"):
        eval_script(env, "SangNom2(order=9)", last=src)
    with pytest.raises(AvisynthError, match="'last' is not set"):
        eval_script(env, "SangNom2()")
    with pytest.raises(AvisynthError, match="outside the supported"):
        eval_script(env, "x = 1 + 2", last=src)
    with pytest.raises(AvisynthError, match="positional argument after"):
        eval_script(env, "SangNom2(order=1, 48)", last=src)


def test_string_and_numeric_literals(rng):
    env = _env()
    src, planes = _src(rng, n=2)
    out = eval_script(env, 'SangNom2(aa=0, numerics="sse2")', last=src)
    got = _collect(out, env)
    ref = sangnom2(Clip.from_numpy(planes, "YUV420P8"), aa=0,
                   numerics="sse2")
    for g, r in zip(got, ref.planes):
        np.testing.assert_array_equal(g, np.asarray(r))


def test_cli_script_verb_runs_recipe(rng, tmp_path):
    """sangnom-jax script RECIPE in.y4m out.y4m == core bob, fps doubled."""
    from sangnom_jax.cli import main
    from sangnom_jax.io import read_y4m, write_y4m

    fmt = get_format("YUV420P8")
    frames = [make_planes(rng, 32, 16, fmt) for _ in range(3)]
    planes = [np.stack([fr[i] for fr in frames]) for i in range(3)]
    src_path = str(tmp_path / "in.y4m")
    write_y4m(src_path, Clip.from_numpy(planes, fmt), fps=(30, 1))
    recipe = tmp_path / "bob.avs"
    recipe.write_text(
        "AssumeTFF()\nSeparateFields()\nDoubleWeave()\nSangNom2(order=0)\n")
    out_path = str(tmp_path / "out.y4m")
    assert main(["script", str(recipe), src_path, out_path]) == 0
    got = read_y4m(out_path)
    assert got.num_frames == 6 and got.height == 16
    assert got.props.get("y4m_fps") == (60, 1)  # frame-count-scaled
    ref = bob(Clip.from_numpy(planes, fmt), tff=True)
    for g, r in zip(got.planes, ref.planes):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    # error surface: a non-clip result fails loudly
    bad = tmp_path / "bad.avs"
    bad.write_text("x = 3\nreturn x\n")
    assert main(["script", str(bad), src_path, out_path]) == 2


def test_negative_literal_and_minus_guard(rng):
    env = _env()
    src, planes = _src(rng, n=2, fmt_name="GRAY8")
    out = eval_script(env, "SangNom2(opt=-1, order=1)", last=src)
    got = _collect(out, env)
    ref = sangnom2(Clip.from_numpy(planes, "GRAY8"), opt=-1, order=1)
    np.testing.assert_array_equal(got[0], np.asarray(ref.planes[0]))
    with pytest.raises(AvisynthError, match="numeric sign"):
        eval_script(env, "SangNom2(order=-true)", last=src)
