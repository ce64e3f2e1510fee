"""Drive the AviSynth-model host adapter (hosts/avisynth.py) — the
reference plugin's own host contract: signature-string registration,
AVSValue binding, Create_ factory validation through env.throw_error,
GetFrame/GetParity frame serving, and the SetCacheHints MT contract
(reference src/SangNom2.cpp:399-484, src/SangNom2.h:61-66).

No mock layer is needed here: the module itself ships the protocol
(`ScriptEnvironment`, `ArraySource`), so the tests ARE the host."""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from conftest import make_planes
from sangnom_jax import Clip, get_format, sangnom, sangnom2
from sangnom_jax.hosts.avisynth import (
    CACHE_GET_MTMODE, CPUF_GPU, MT_MULTI_INSTANCE, MT_SERIALIZED,
    SIG_SANGNOM, SIG_SANGNOM2, ArraySource, AvisynthError,
    ScriptEnvironment, avisynth_plugin_init, bind_args, parse_signature,
)


def _env():
    env = ScriptEnvironment()
    assert avisynth_plugin_init(env) == "SangNom2"
    return env


def _stacked(rng, w=32, h=16, n=6, fmt_name="YUV420P8"):
    fmt = get_format(fmt_name)
    frames = [make_planes(rng, w, h, fmt) for _ in range(n)]
    return [np.stack([fr[i] for fr in frames]) for i in range(fmt.num_planes)]


def _collect(flt, env, order=None):
    vi = flt.get_video_info()
    order = range(vi.num_frames) if order is None else order
    outs = {n: flt.get_frame(n, env) for n in order}
    return [np.stack([outs[n].planes[i] for n in range(vi.num_frames)])
            for i in range(len(outs[0].planes))]


# --- registration + binding ------------------------------------------------

def test_signature_strings_match_reference_verbatim():
    # the AddFunction strings at reference src/SangNom2.cpp:481-482
    assert SIG_SANGNOM2 == \
        "c[order]i[aa]i[aac]i[threads]i[dh]b[luma]b[chroma]b[opt]i"
    assert SIG_SANGNOM == "c[order]i[aa]i[opt]i"
    env = _env()
    assert env.function_signature("SangNom2").startswith(SIG_SANGNOM2)
    assert env.function_signature("sangnom").startswith(SIG_SANGNOM)


def test_parse_signature():
    assert parse_signature("c[order]i[dh]b") == [
        (None, "c"), ("order", "i"), ("dh", "b")]
    with pytest.raises(AvisynthError):
        parse_signature("c[x]q")


def test_bind_positional_named_and_errors(rng):
    src = ArraySource(_stacked(rng), "YUV420P8")
    sig = SIG_SANGNOM2
    args = bind_args(sig, (src, 2, 100), {"DH": True, "Opt": 0})
    assert args[1].as_int(1) == 2 and args[2].as_int(48) == 100
    assert args[5].as_bool(False) is True  # case-insensitive names
    assert args[8].as_int(-1) == 0
    assert args[3].as_int(0) == 0 and not args[3].defined()
    with pytest.raises(AvisynthError, match="unknown named"):
        bind_args(sig, (src,), {"bogus": 1})
    with pytest.raises(AvisynthError, match="twice"):
        bind_args(sig, (src, 1), {"order": 1})
    with pytest.raises(AvisynthError, match="expects type"):
        bind_args(sig, (src, "one"), {})
    with pytest.raises(AvisynthError, match="expects type"):
        bind_args(sig, (src,), {"dh": 1})  # b is strictly bool
    with pytest.raises(AvisynthError, match="too many"):
        bind_args(SIG_SANGNOM, (src, 1, 48, 0, 99), {})
    # numpy scalars bind like script ints/bools (array-driven hosts)
    np_args = bind_args(sig, (src, np.int64(2)), {"dh": np.True_})
    assert np_args[1].as_int(1) == 2 and np_args[5].as_bool(False) is True
    # args array OOB raises (documented-surface stance on the reference's
    # legacy OOB reads, docs/PARITY.md deviation 2)
    with pytest.raises(AvisynthError, match="out of range"):
        bind_args(SIG_SANGNOM, (src,), {})[7]


# --- factory validation through the host error channel ---------------------

def test_factory_validation_error_strings(rng):
    env = _env()
    good = ArraySource(_stacked(rng), "YUV420P8")
    for kw, msg in [
        (dict(order=3), "SangNom2: order must be between 0..2."),
        (dict(aa=129), "SangNom2: aa must be between 0..128."),
        (dict(aac=-1), "SangNom2: aac must be between 0..128."),
        (dict(opt=5), "SangNom2: opt must be between -1..2."),
        (dict(numerics="fast"), "numerics must be 'c' or 'sse2'"),
    ]:
        with pytest.raises(AvisynthError, match=msg.replace(".", r"\.")):
            env.invoke("SangNom2", good, **kw)
    odd = ArraySource([p[:, :15] if i == 0 else p[:, :7]
                       for i, p in enumerate(_stacked(rng, h=16))],
                      "YUV420P8")
    # geometry checks ride the clip's VideoInfo (height even / mod4 for 420)
    with pytest.raises(AvisynthError, match="height must be"):
        env.invoke("SangNom2", odd)
    packed = ArraySource(_stacked(rng, fmt_name="GRAY8"), get_format("YUY2"))
    with pytest.raises(AvisynthError, match="planar"):
        env.invoke("SangNom2", packed)
    with pytest.raises(AvisynthError, match="SangNom: order must be"):
        env.invoke("SangNom", good, order=-1)


def test_opt1_gate_rides_env_cpu_flags(rng):
    src = ArraySource(_stacked(rng), "YUV420P8")
    bare = ScriptEnvironment(cpu_flags=0)
    avisynth_plugin_init(bare)
    with pytest.raises(AvisynthError, match="opt=1 requires"):
        bare.invoke("SangNom2", src, opt=1)
    flagged = ScriptEnvironment(cpu_flags=CPUF_GPU)
    avisynth_plugin_init(flagged)
    flt = flagged.invoke("SangNom2", src, opt=1)
    assert flt.get_video_info().height == 16


# --- frame serving parity with the core API --------------------------------

@pytest.mark.parametrize("fmt_name,order,dh,aa", [
    ("YUV420P8", 1, False, 48),
    ("YUV420P8", 2, True, 48),
    ("GRAY16", 0, False, 128),
    ("YUV444PS", 1, True, 0),
])
def test_adapter_matches_direct_filter(rng, fmt_name, order, dh, aa):
    planes = _stacked(rng, n=6, fmt_name=fmt_name)
    env = _env()
    src = ArraySource(planes, fmt_name)
    flt = env.invoke("SangNom2", src, order=order, dh=dh, aa=aa, batch=4)
    vi = flt.get_video_info()
    assert vi.height == (32 if dh else 16) and vi.num_frames == 6
    got = _collect(flt, env)
    ref = sangnom2(Clip.from_numpy(planes, fmt_name), order=order, dh=dh,
                   aa=aa)
    for g, r in zip(got, ref.planes):
        np.testing.assert_array_equal(g, np.asarray(r))


def test_order0_consults_child_parity(rng):
    planes = _stacked(rng, n=6, fmt_name="GRAY8")
    parity = np.array([True, False, True, True, False, False])
    env = _env()
    flt = env.invoke("SangNom2", ArraySource(planes, "GRAY8", parity=parity),
                     order=0, batch=3)
    got = _collect(flt, env)
    ref = sangnom2(Clip.from_numpy(planes, "GRAY8", parity=parity), order=0)
    np.testing.assert_array_equal(got[0], np.asarray(ref.planes[0]))
    # GetParity delegates to the child (GenericVideoFilter default)
    assert [flt.get_parity(k) for k in range(6)] == list(map(bool, parity))


def test_legacy_sangnom_documented_remap(rng):
    planes = _stacked(rng, n=5, fmt_name="YUV420P8")
    env = _env()
    for order in (0, 1, 2):
        flt = env.invoke("SangNom", ArraySource(planes, "YUV420P8"),
                         order=order, aa=32, batch=4)
        assert flt.get_video_info().height == 16  # legacy has no dh
        got = _collect(flt, env)
        ref = sangnom(Clip.from_numpy(planes, "YUV420P8"), order=order,
                      aa=32)
        for g, r in zip(got, ref.planes):
            np.testing.assert_array_equal(g, np.asarray(r))
    with pytest.raises(AvisynthError, match="unknown named"):
        env.invoke("SangNom", ArraySource(planes, "YUV420P8"), dh=True)


def test_props_propagation_and_field_rewrite(rng):
    planes = _stacked(rng, n=3, fmt_name="GRAY8")
    props_fn = lambda n: {"_Matrix": 1, "_Field": 1, "_FieldBased": 2,
                          "n": n}  # noqa: E731
    env = _env()
    flt = env.invoke("SangNom2", ArraySource(planes, "GRAY8",
                                             props_fn=props_fn), batch=2)
    fr = flt.get_frame(1, env)
    assert fr.props["_Matrix"] == 1 and fr.props["n"] == 1
    assert fr.props["_FieldBased"] == 0 and "_Field" not in fr.props


def test_set_cache_hints_mt_contract(rng):
    planes = _stacked(rng, n=2, fmt_name="GRAY8")
    env = _env()
    flt = env.invoke("SangNom2", ArraySource(planes, "GRAY8"))
    # the reference's exact answer (src/SangNom2.h:63-66)
    assert flt.set_cache_hints(CACHE_GET_MTMODE, 0) == MT_MULTI_INSTANCE
    assert flt.set_cache_hints(0, 0) == 0
    pooled = env.invoke("SangNom2", ArraySource(planes, "GRAY8"),
                        pool_compat=True)
    assert pooled.set_cache_hints(CACHE_GET_MTMODE, 0) == MT_SERIALIZED


def test_pool_compat_chains_across_windows(rng):
    planes = _stacked(rng, n=7, fmt_name="YUV420P8")
    env = _env()
    flt = env.invoke("SangNom2", ArraySource(planes, "YUV420P8"),
                     pool_compat=True, batch=3)
    got = _collect(flt, env)
    ref = sangnom2(Clip.from_numpy(planes, "YUV420P8"), pool_compat=True)
    for g, r in zip(got, ref.planes):
        np.testing.assert_array_equal(g, np.asarray(r))


def test_frame_index_clamping(rng):
    planes = _stacked(rng, n=3, fmt_name="GRAY8")
    env = _env()
    flt = env.invoke("SangNom2", ArraySource(planes, "GRAY8"), batch=2)
    np.testing.assert_array_equal(flt.get_frame(-5, env).planes[0],
                                  flt.get_frame(0, env).planes[0])
    np.testing.assert_array_equal(flt.get_frame(99, env).planes[0],
                                  flt.get_frame(2, env).planes[0])


# --- MT stress -------------------------------------------------------------

def _hammer(flt, env, indices, n_threads):
    results = {}
    lock = threading.Lock()

    def worker(ns):
        for n in ns:
            fr = flt.get_frame(n, env)
            with lock:
                results.setdefault(n, []).append(
                    [p.copy() for p in fr.planes])

    chunks = [indices[i::n_threads] for i in range(n_threads)]
    with ThreadPoolExecutor(n_threads) as ex:
        list(ex.map(worker, chunks))
    return results


@pytest.mark.parametrize("pool_compat", [False, True])
def test_stress_parallel_out_of_order(rng, pool_compat):
    planes = _stacked(rng, n=10, fmt_name="YUV420P8")
    env = _env()
    flt = env.invoke("SangNom2", ArraySource(planes, "YUV420P8"),
                     pool_compat=pool_compat, batch=3)
    order = list(rng.permutation(np.repeat(np.arange(10), 3)))
    results = _hammer(flt, env, order, n_threads=6)
    ref = sangnom2(Clip.from_numpy(planes, "YUV420P8"),
                   pool_compat=pool_compat)
    refp = [np.asarray(p) for p in ref.planes]
    for n, copies in results.items():
        for planes_copy in copies:
            for i, p in enumerate(planes_copy):
                np.testing.assert_array_equal(p, refp[i][n])


def test_stress_multi_instance_model(rng):
    """MT_MULTI_INSTANCE: the host instantiates one filter per thread via
    the factory; every instance must agree bit-for-bit."""
    planes = _stacked(rng, n=6, fmt_name="GRAY16")
    env = _env()
    src = ArraySource(planes, "GRAY16")
    ref = sangnom2(Clip.from_numpy(planes, "GRAY16"), dh=True)
    refp = np.asarray(ref.planes[0])

    def one_instance(seed):
        flt = env.invoke("SangNom2", src, dh=True, batch=4)
        order = list(np.random.default_rng(seed).permutation(6))
        return [flt.get_frame(n, env).planes[0] for n in order], order

    with ThreadPoolExecutor(4) as ex:
        for got, order in ex.map(one_instance, range(4)):
            for p, n in zip(got, order):
                np.testing.assert_array_equal(p, refp[n])


# --- host built-ins + the canonical double-rate recipe ----------------------

def test_separate_weave_round_trip(rng):
    planes = _stacked(rng, n=4, fmt_name="YUV420P8")
    env = _env()
    for assume in ("AssumeTFF", "AssumeBFF"):
        src = env.invoke(assume, ArraySource(planes, "YUV420P8"))
        flds = env.invoke("SeparateFields", src)
        vi = flds.get_video_info()
        assert vi.num_frames == 8 and vi.height == 8
        # parity alternates starting at the dominance
        tff = assume == "AssumeTFF"
        assert [flds.get_parity(k) for k in range(4)] == [tff, not tff] * 2
        back = env.invoke("Weave", flds)
        got = _collect(back, env)
        for g, p in zip(got, planes):
            np.testing.assert_array_equal(g, p)


def test_select_even_odd(rng):
    planes = _stacked(rng, n=5, fmt_name="GRAY8")
    env = _env()
    src = ArraySource(planes, "GRAY8")
    ev = env.invoke("SelectEven", src)
    od = env.invoke("SelectOdd", src)
    assert ev.get_video_info().num_frames == 3
    assert od.get_video_info().num_frames == 2
    np.testing.assert_array_equal(_collect(ev, env)[0], planes[0][0::2])
    np.testing.assert_array_equal(_collect(od, env)[0], planes[0][1::2])


def test_separate_fields_height_error(rng):
    env = _env()
    src = ArraySource([p[:, :7] for p in _stacked(rng, fmt_name="GRAY8",
                                                  h=16)], "GRAY8")
    with pytest.raises(AvisynthError, match="SeparateFields: height"):
        env.invoke("SeparateFields", src)


@pytest.mark.parametrize("assume", ["AssumeTFF", "AssumeBFF"])
def test_canonical_bob_recipe_matches_core_bob(rng, assume):
    """The reference's documented double-rate recipe (src/SangNom2.cpp:
    18-23), run verbatim through the script environment, must equal the
    core bob() fast path bit for bit."""
    from sangnom_jax.core.fields import bob

    planes = _stacked(rng, n=3, fmt_name="YUV420P8")
    env = _env()
    chain = env.invoke("SangNom2",
                       env.invoke("DoubleWeave",
                                  env.invoke("SeparateFields",
                                             env.invoke(assume,
                                                        ArraySource(
                                                            planes,
                                                            "YUV420P8")))),
                       order=0, batch=4)
    vi = chain.get_video_info()
    assert vi.num_frames == 6 and vi.height == 16
    got = _collect(chain, env)
    ref = bob(Clip.from_numpy(planes, "YUV420P8"),
              tff=(assume == "AssumeTFF"))
    for g, r in zip(got, ref.planes):
        np.testing.assert_array_equal(g, np.asarray(r))


def test_trim_builtin(rng):
    planes = _stacked(rng, n=6, fmt_name="GRAY8")
    env = _env()
    src = ArraySource(planes, "GRAY8",
                      parity=np.array([True, False] * 3))
    t = env.invoke("Trim", src, 2, 4)        # inclusive last index
    assert t.get_video_info().num_frames == 3
    np.testing.assert_array_equal(_collect(t, env)[0], planes[0][2:5])
    assert t.get_parity(0) == src.get_parity(2)
    t0 = env.invoke("Trim", src, first=4)    # last=0 -> to end
    assert t0.get_video_info().num_frames == 2
    tn = env.invoke("Trim", src, 1, -2)      # negative last = count
    np.testing.assert_array_equal(_collect(tn, env)[0], planes[0][1:3])
    with pytest.raises(AvisynthError, match="Trim: first frame"):
        env.invoke("Trim", src, 99)
    with pytest.raises(AvisynthError, match="Trim: invalid range"):
        env.invoke("Trim", src, 4, 2)
