"""Parameter-surface validation tests.

Mirrors every rule in the reference factories (reference src/SangNom2.cpp:
399-472), including exact error strings.
"""

import numpy as np
import pytest

import sangnom_jax
from sangnom_jax import Clip, get_format, sangnom, sangnom2
from sangnom_jax.api import SangNomError, register_plugin_functions

from conftest import make_planes


def _clip(fmt_name="YUV420P8", w=32, h=16, n=1, rng=None):
    rng = rng or np.random.default_rng(7)
    fmt = get_format(fmt_name)
    frames = [make_planes(rng, w, h, fmt) for _ in range(n)]
    planes = [
        np.stack([f[i] for f in frames]) for i in range(fmt.num_planes)
    ]
    return Clip.from_numpy(planes, fmt)


@pytest.mark.parametrize(
    "kwargs,msg",
    [
        (dict(order=-1), "SangNom2: order must be between 0..2."),
        (dict(order=3), "SangNom2: order must be between 0..2."),
        (dict(aa=-1), "SangNom2: aa must be between 0..128."),
        (dict(aa=129), "SangNom2: aa must be between 0..128."),
        (dict(aac=-1), "SangNom2: aac must be between 0..128."),
        (dict(aac=129), "SangNom2: aac must be between 0..128."),
        # error string replicated verbatim incl. the reference's off-by-one
        # (reference src/SangNom2.cpp:419-420)
        (dict(opt=-2), "SangNom2: opt must be between -1..2."),
        (dict(opt=2), "SangNom2: opt must be between -1..2."),
    ],
)
def test_sangnom2_param_validation(kwargs, msg):
    with pytest.raises(SangNomError, match=msg.replace(".", r"\.")):
        sangnom2(_clip(), **kwargs)


def test_rejects_rgb():
    clip = _clip("RGBP8")
    with pytest.raises(
        SangNomError, match=r"SangNom2: clip must be in Y/YUV planar format\."
    ):
        sangnom2(clip)


def test_rejects_packed():
    fmt = get_format("YUY2")
    clip = Clip.from_numpy([np.zeros((1, 16, 32), np.uint8)], fmt)
    with pytest.raises(
        SangNomError, match=r"SangNom2: clip must be in Y/YUV planar format\."
    ):
        sangnom2(clip)


def test_rejects_odd_height():
    with pytest.raises(SangNomError, match=r"SangNom2: height must be even\."):
        sangnom2(_clip("YUV444P8", h=15))


def test_rejects_420_height_not_mod4():
    # reference src/SangNom2.cpp:411-412
    with pytest.raises(SangNomError, match=r"SangNom2: height must be mod4\."):
        sangnom2(_clip("YUV420P8", h=18))
    # non-420 formats only need even height
    out = sangnom2(_clip("YUV422P8", h=18))
    assert out.height == 18


def test_legacy_validation_prefix():
    with pytest.raises(SangNomError, match=r"SangNom: order must be between 0\.\.2\."):
        sangnom(_clip(), order=5)


def test_legacy_order_remap():
    """Legacy orders: 0=keep-bottom, 1=keep-top, 2=double-rate
    (reference README.md:70-74, ord[] remap src/SangNom2.cpp:441,463)."""
    clip = _clip(n=2)
    np.testing.assert_array_equal(
        np.asarray(sangnom(clip, order=0).planes[0]),
        np.asarray(sangnom2(clip, order=2).planes[0]),
    )
    np.testing.assert_array_equal(
        np.asarray(sangnom(clip, order=1).planes[0]),
        np.asarray(sangnom2(clip, order=1).planes[0]),
    )
    np.testing.assert_array_equal(
        np.asarray(sangnom(clip, order=2).planes[0]),
        np.asarray(sangnom2(clip, order=0).planes[0]),
    )


def test_threads_param_accepted_and_ignored():
    clip = _clip()
    a = sangnom2(clip, threads=0)
    b = sangnom2(clip, threads=8)
    np.testing.assert_array_equal(np.asarray(a.planes[0]), np.asarray(b.planes[0]))


def test_defaults_match_reference():
    """order=1, aa=48, aac=0, dh=False, luma/chroma=True, opt=-1
    (reference src/SangNom2.cpp:402-405, 424-434)."""
    clip = _clip()
    np.testing.assert_array_equal(
        np.asarray(sangnom2(clip).planes[0]),
        np.asarray(
            sangnom2(
                clip, order=1, aa=48, aac=0, threads=0, dh=False,
                luma=True, chroma=True, opt=-1,
            ).planes[0]
        ),
    )


def test_plugin_registry():
    reg = {}
    assert register_plugin_functions(reg) == "SangNom2"
    assert reg["SangNom2"] is sangnom2 and reg["SangNom"] is sangnom


def test_dh_doubles_height():
    out = sangnom2(_clip(w=32, h=16), dh=True)
    assert out.height == 32 and out.width == 32
    # chroma doubled too
    assert out.planes[1].shape[1:] == (16, 16)


def test_version_metadata():
    assert sangnom_jax.__version__
    assert sangnom_jax.REFERENCE_VERSION == "0.6.1"


def test_opt1_requires_gpu_backend(monkeypatch):
    """opt=1 without a GPU is a construction-time error unless the
    interpreter is explicitly requested — the analogue of the reference's
    CPUID gate (reference src/SangNom2.cpp:420-421 "opt=1 requires
    SSE2.")."""
    from sangnom_jax.api import SangNom2Filter

    monkeypatch.delenv("SANGNOM_INTERPRET", raising=False)
    # this suite runs on the CPU mesh, so the gate must fire
    with pytest.raises(SangNomError,
                       match=r"SangNom2: opt=1 requires a GPU backend\."):
        sangnom2(_clip(), opt=1)
    with pytest.raises(SangNomError,
                       match=r"SangNom: opt=1 requires a GPU backend\."):
        sangnom(_clip(), opt=1)
    with pytest.raises(SangNomError,
                       match=r"SangNom2: opt=1 requires a GPU backend\."):
        SangNom2Filter(opt=1)
    # opt=-1 auto and opt=0 stay available (auto picks the XLA path here)
    sangnom2(_clip(), opt=-1)
    sangnom2(_clip(), opt=0)
    # the explicit interpreter escape restores opt=1 (what this suite's
    # conftest does globally)
    monkeypatch.setenv("SANGNOM_INTERPRET", "1")
    sangnom2(_clip(), opt=1)
    SangNom2Filter(opt=1)
    # opt=-1 auto and opt=0 stay available (auto picks the XLA path here)
    sangnom2(_clip(), opt=-1)
    sangnom2(_clip(), opt=0)
    # the explicit interpret-mode escape restores opt=1 (what this suite's
    # conftest does globally)
    monkeypatch.setenv("SANGNOM_INTERPRET", "1")
    sangnom2(_clip(), opt=1)
    SangNom2Filter(opt=1)
