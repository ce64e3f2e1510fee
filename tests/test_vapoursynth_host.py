"""Drive the VapourSynth host adapter against a mock host (VERDICT_r3 #8;
concurrency redesign + stress harness VERDICT_r4 #1).

VapourSynth is not installable here (zero egress), so the adapter is
exercised against a mock implementing the exact host surface the adapter
uses — `core.std.{BlankClip, ModifyFrame, Trim, Splice, Loop,
SelectEvery}`, frames exposing plane arrays / `.copy()` / `.props`, and
format objects with the documented attributes.  The adapter itself
contains no mock-specific code: the same path runs against a real
`vapoursynth`.

The mock's ModifyFrame reproduces the real host's dependency semantics:
it prefetches every `clips` frame BEFORE invoking the selector, and the
source node records any `get_frame` issued from selector context (a
nested fetch — the stateful-Python-filter deadlock trigger the redesign
eliminates).  The stress tests drive N threads of out-of-order parallel
requests through both the plain and pool_compat paths and assert byte
identity plus zero nested fetches where the design guarantees it.
"""

import sys
import threading
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from sangnom_jax import Clip, get_format, sangnom, sangnom2
from sangnom_jax.api import SangNomError


# --- the mock host ----------------------------------------------------------

_SELECTOR_CTX = threading.local()  # .depth > 0 == inside a selector


class _MockFormat:
    def __init__(self, color_family, bits, sample_type, sub_w, sub_h):
        self.color_family = color_family
        self.bits_per_sample = bits
        self.sample_type = sample_type
        self.subsampling_w = sub_w
        self.subsampling_h = sub_h


class _MockFrame:
    def __init__(self, planes, props=None):
        self._planes = [np.array(p) for p in planes]
        self.props = dict(props or {})

    def __getitem__(self, i):
        return self._planes[i]

    def copy(self):
        return _MockFrame(self._planes, self.props)


class _MockNode:
    def __init__(self, frames, fmt, width, height):
        self._frames = frames
        self.format = fmt
        self.width = width
        self.height = height
        self.nested_fetches = 0  # get_frame calls issued from a selector

    @property
    def num_frames(self):
        return len(self._frames)

    def get_frame(self, n):
        if getattr(_SELECTOR_CTX, "depth", 0) > 0:
            self.nested_fetches += 1
        return self._frames[n]


class _MapNode(_MockNode):
    """A node whose frame n delegates to base frame idx(n) — the shape of
    std.Trim / Loop / Splice / SelectEvery."""

    def __init__(self, base, idx, length):
        self._base, self._idx, self._len = base, idx, length
        self.format = base.format
        self.width, self.height = base.width, base.height
        self.nested_fetches = 0

    @property
    def num_frames(self):
        return self._len

    def get_frame(self, n):
        if not 0 <= n < self._len:
            raise IndexError(f"frame {n} out of range 0..{self._len - 1}")
        return self._base.get_frame(self._idx(n))


class _MockStd:
    def BlankClip(self, clip, width, height, length):
        sub_w, sub_h = clip.format.subsampling_w, clip.format.subsampling_h
        f0 = clip.get_frame(0)
        n_pl = len(f0._planes)
        dt = f0._planes[0].dtype
        frames = []
        for _ in range(length):
            planes = [np.zeros((height, width), dt)]
            for _i in range(n_pl - 1):
                planes.append(np.zeros(
                    (height >> sub_h, width >> sub_w), dt))
            frames.append(_MockFrame(planes))
        return _MockNode(frames, clip.format, width, height)

    def Trim(self, clip, first=0, last=None):
        last = clip.num_frames - 1 if last is None else last
        assert 0 <= first <= last < clip.num_frames
        return _MapNode(clip, lambda n: first + n, last - first + 1)

    def Loop(self, clip, times):
        base_n = clip.num_frames
        return _MapNode(clip, lambda n: n % base_n, base_n * times)

    def Splice(self, clips):
        bounds = []
        total = 0
        for c in clips:
            bounds.append((total, c))
            total += c.num_frames

        def idx(n):
            for off, c in reversed(bounds):
                if n >= off:
                    return off, c
            raise IndexError(n)

        node = _MapNode(clips[0], lambda n: n, total)

        def get_frame(n):
            off, c = idx(n)
            return c.get_frame(n - off)

        node.get_frame = get_frame
        return node

    def SelectEvery(self, clip, cycle, offsets):
        assert clip.num_frames % cycle == 0, \
            "mock SelectEvery expects whole cycles (adapter pads)"
        assert all(0 <= o < cycle for o in offsets)
        per = len(offsets)
        length = (clip.num_frames // cycle) * per
        return _MapNode(
            clip, lambda n: (n // per) * cycle + offsets[n % per], length)

    def ModifyFrame(self, clip, clips, selector):
        class _Out(_MockNode):
            def get_frame(self, n):
                # the real host fetches every dependency through its own
                # scheduler BEFORE the selector runs; selector context is
                # marked so nested fetches are detectable
                deps = [c.get_frame(n) for c in clips]
                depth = getattr(_SELECTOR_CTX, "depth", 0)
                _SELECTOR_CTX.depth = depth + 1
                try:
                    return selector(n, deps)
                finally:
                    _SELECTOR_CTX.depth = depth

        return _Out(clip._frames, clip.format, clip.width, clip.height)


def _install_mock(monkeypatch):
    vs = types.ModuleType("vapoursynth")
    vs.GRAY, vs.YUV, vs.RGB = 0, 1, 2
    vs.INTEGER, vs.FLOAT = 0, 1
    vs.core = types.SimpleNamespace(std=_MockStd())
    monkeypatch.setitem(sys.modules, "vapoursynth", vs)
    return vs


def _src_node(vs, rng, w=32, h=16, n=6, fmt_name="YUV420P8", props=None):
    fmt = get_format(fmt_name)
    sub = 1 if fmt.name.startswith("YUV420") else 0
    mock_fmt = _MockFormat(vs.YUV if fmt.num_planes == 3 else vs.GRAY,
                           fmt.bits, vs.FLOAT if fmt.is_float else vs.INTEGER,
                           sub, sub)
    frames = []
    all_planes = [[] for _ in range(fmt.num_planes)]
    for k in range(n):
        planes = []
        for i in range(fmt.num_planes):
            pw, ph = fmt.plane_dims(w, h, i)
            planes.append(rng.integers(0, 256, (ph, pw)).astype(fmt.dtype))
            all_planes[i].append(planes[-1])
        frames.append(_MockFrame(planes, (props or {}).get(k)))
    node = _MockNode(frames, mock_fmt, w, h)
    stacked = [np.stack(ps) for ps in all_planes]
    return node, stacked


def test_adapter_matches_direct_filter(rng, monkeypatch):
    vs = _install_mock(monkeypatch)
    from sangnom_jax.hosts.vapoursynth import SangNom2

    node, stacked = _src_node(vs, rng)
    out = SangNom2(node, order=1, dh=True, opt=0, batch=4)
    want = sangnom2(Clip.from_numpy(stacked, "YUV420P8"),
                    order=1, dh=True, opt=0)
    assert out.height == 32
    for n in range(node.num_frames):
        f = out.get_frame(n)
        for i in range(3):
            np.testing.assert_array_equal(
                f[i], np.asarray(want.planes[i])[n],
                err_msg=f"frame {n} plane {i}")
    assert node.nested_fetches == 0


def test_adapter_partial_last_window(rng, monkeypatch):
    """num_frames not divisible by batch: the end-padded gather clips must
    not leak padding into the outputs."""
    vs = _install_mock(monkeypatch)
    from sangnom_jax.hosts.vapoursynth import SangNom2

    node, stacked = _src_node(vs, rng, n=7)
    out = SangNom2(node, order=2, opt=0, batch=4)
    want = sangnom2(Clip.from_numpy(stacked, "YUV420P8"), order=2, opt=0)
    for n in (6, 5, 4, 0, 3):
        f = out.get_frame(n)
        for i in range(3):
            np.testing.assert_array_equal(
                f[i], np.asarray(want.planes[i])[n],
                err_msg=f"frame {n} plane {i}")
    assert node.nested_fetches == 0


def test_adapter_order0_field_props(rng, monkeypatch):
    """order=0 parity comes from the _Field frame prop (std.SeparateFields
    semantics: 1 = top), the analogue of host GetParity(n)."""
    vs = _install_mock(monkeypatch)
    from sangnom_jax.hosts.vapoursynth import SangNom2

    props = {k: {"_Field": k % 2} for k in range(6)}
    node, stacked = _src_node(vs, rng, props=props)
    out = SangNom2(node, order=0, opt=0, batch=8)
    parity = np.arange(6) % 2 == 1
    want = sangnom2(Clip.from_numpy(stacked, "YUV420P8", parity=parity),
                    order=0, opt=0)
    for n in range(6):
        f = out.get_frame(n)
        for i in range(3):
            np.testing.assert_array_equal(
                f[i], np.asarray(want.planes[i])[n])


def test_adapter_pool_compat_chains_across_windows(rng, monkeypatch):
    """pool_compat through the adapter must be byte-identical to whole-clip
    processing even when the batch window is smaller than the clip — the
    pool is cross-frame state and chains through the windows (the round-4
    review's confirmed repro: unaligned w=52, batch=3, plane 0 diverged at
    frame 3 before the fix)."""
    vs = _install_mock(monkeypatch)
    from sangnom_jax.hosts.vapoursynth import SangNom2

    node, stacked = _src_node(vs, rng, w=52, h=16, n=7)
    out = SangNom2(node, order=2, opt=0, batch=3, pool_compat=True)
    want = sangnom2(Clip.from_numpy(stacked, "YUV420P8"),
                    order=2, opt=0, pool_compat=True)
    for n in range(7):
        f = out.get_frame(n)
        for i in range(3):
            np.testing.assert_array_equal(
                f[i], np.asarray(want.planes[i])[n],
                err_msg=f"frame {n} plane {i}")
    # sequential playback consumed only prefetched frames
    assert node.nested_fetches == 0
    # random access BEHIND the chain restarts it — still byte-identical;
    # the restart's fetches run on the adapter's prefetch thread, which
    # is NOT selector context, so the detector stays clean
    f0 = out.get_frame(0)
    for i in range(3):
        np.testing.assert_array_equal(f0[i], np.asarray(want.planes[i])[0])
    assert node.nested_fetches == 0


def test_adapter_pool_compat_forward_seek(rng, monkeypatch):
    """A seek PAST the chain (intermediate windows never requested) fills
    the gap through the off-worker prefetcher and stays byte-identical."""
    vs = _install_mock(monkeypatch)
    from sangnom_jax.hosts.vapoursynth import SangNom2

    node, stacked = _src_node(vs, rng, w=52, h=16, n=9)
    out = SangNom2(node, order=1, opt=0, batch=2, pool_compat=True)
    want = sangnom2(Clip.from_numpy(stacked, "YUV420P8"),
                    order=1, opt=0, pool_compat=True)
    for n in (7, 2, 8, 0):  # seek forward, back, tail, restart
        f = out.get_frame(n)
        for i in range(3):
            np.testing.assert_array_equal(
                f[i], np.asarray(want.planes[i])[n],
                err_msg=f"frame {n} plane {i}")
    assert node.nested_fetches == 0


def test_adapter_propagates_source_props(rng, monkeypatch):
    """Output frames carry the SOURCE frame's props (colorimetry/range),
    with field-ness rewritten to progressive."""
    vs = _install_mock(monkeypatch)
    from sangnom_jax.hosts.vapoursynth import SangNom2

    props = {k: {"_Matrix": 1, "_ColorRange": 1, "_Field": k % 2}
             for k in range(6)}
    node, _ = _src_node(vs, rng, props=props)
    out = SangNom2(node, order=0, opt=0, batch=8)
    f = out.get_frame(2)
    assert f.props["_Matrix"] == 1 and f.props["_ColorRange"] == 1
    assert f.props["_FieldBased"] == 0
    assert "_Field" not in f.props


def test_adapter_rejects_unsupported_depth(rng, monkeypatch):
    """9-bit VS formats raise the adapter's fail-fast SangNomError, not a
    raw registry KeyError."""
    vs = _install_mock(monkeypatch)
    from sangnom_jax.hosts.vapoursynth import SangNom2

    node, _ = _src_node(vs, rng)
    node.format = _MockFormat(vs.YUV, 9, vs.INTEGER, 1, 1)
    with pytest.raises(SangNomError, match="unsupported bit depth 9"):
        SangNom2(node)


def test_adapter_legacy_and_errors(rng, monkeypatch):
    vs = _install_mock(monkeypatch)
    from sangnom_jax.hosts.vapoursynth import SangNom, register

    node, stacked = _src_node(vs, rng)
    out = SangNom(node, order=0, opt=0, batch=3)  # legacy 0 = keep bottom
    want = sangnom(Clip.from_numpy(stacked, "YUV420P8"), order=0, opt=0)
    for n in (0, 5):
        f = out.get_frame(n)
        for i in range(3):
            np.testing.assert_array_equal(
                f[i], np.asarray(want.planes[i])[n])

    ns: dict = {}
    assert register(ns) == "SangNom2"
    assert set(ns) == {"SangNom2", "SangNom"}

    with pytest.raises(SangNomError, match="order must be between 0..2."):
        ns["SangNom2"](node, order=5).get_frame(0)


# --- multithreaded stress (VERDICT_r4 #1b) ----------------------------------

STRESS_TIMEOUT = 120  # generous: the CPU mesh is slow


def _hammer(out_node, order_of_requests, n_threads):
    """Drive the node with parallel out-of-order frame requests; returns
    {frame_index: planes} and raises on worker error or deadlock.

    The executor is NOT used as a context manager: __exit__ would block
    in shutdown(wait=True) on deadlocked workers, turning the intended
    TimeoutError into an indefinite test hang.  On timeout the stuck
    daemon-less threads are abandoned via shutdown(wait=False) and the
    TimeoutError propagates — the test FAILS instead of hanging."""
    results = {}
    res_lock = threading.Lock()

    def worker(indices):
        for n in indices:
            f = out_node.get_frame(n)
            got = [np.array(f[i]) for i in range(3)]
            with res_lock:
                prev = results.get(n)
                if prev is not None:
                    for a, b in zip(prev, got):
                        np.testing.assert_array_equal(a, b)
                results[n] = got

    ex = ThreadPoolExecutor(max_workers=n_threads)
    try:
        futs = [ex.submit(worker, chunk) for chunk in order_of_requests]
        for fu in futs:
            fu.result(timeout=STRESS_TIMEOUT)  # deadlock -> TimeoutError
    finally:
        ex.shutdown(wait=False, cancel_futures=True)
    return results


def test_stress_parallel_out_of_order(rng, monkeypatch):
    """N threads, shuffled request orders, windows overlapping: every frame
    byte-identical to the direct filter, zero nested fetches — the worker
    pool cannot be exhausted because workers never re-enter the host."""
    vs = _install_mock(monkeypatch)
    from sangnom_jax.hosts.vapoursynth import SangNom2

    N = 12
    node, stacked = _src_node(vs, rng, n=N)
    out = SangNom2(node, order=1, opt=0, batch=4)
    want = sangnom2(Clip.from_numpy(stacked, "YUV420P8"), order=1, opt=0)

    orders = [list(rng.permutation(N)) for _ in range(6)]
    results = _hammer(out, orders, n_threads=6)
    assert len(results) == N
    for n in range(N):
        for i in range(3):
            np.testing.assert_array_equal(
                results[n][i], np.asarray(want.planes[i])[n],
                err_msg=f"frame {n} plane {i}")
    assert node.nested_fetches == 0


def test_stress_single_flight_dedup(rng, monkeypatch):
    """All threads storming ONE window: the window is computed once (single
    flight), not once per thread."""
    vs = _install_mock(monkeypatch)
    import sangnom_jax.hosts.vapoursynth as host

    node, stacked = _src_node(vs, rng, n=8)
    runs = []
    orig = host._WindowRunner._run_window

    def counting_run(self, frames):
        runs.append(threading.get_ident())
        return orig(self, frames)

    monkeypatch.setattr(host._WindowRunner, "_run_window", counting_run)
    out = host.SangNom2(node, order=1, opt=0, batch=8)
    want = sangnom2(Clip.from_numpy(stacked, "YUV420P8"), order=1, opt=0)

    results = _hammer(out, [list(range(8))] * 8, n_threads=8)
    assert len(runs) == 1, f"window recomputed {len(runs)}x despite dedup"
    for n in range(8):
        np.testing.assert_array_equal(
            results[n][0], np.asarray(want.planes[0])[n])


def test_stress_pool_compat_parallel(rng, monkeypatch):
    """pool_compat under the same parallel out-of-order load: byte-identical
    to whole-clip processing, no deadlock, no nested fetches from selector
    context (gap/restart fetches ride the adapter's own thread)."""
    vs = _install_mock(monkeypatch)
    from sangnom_jax.hosts.vapoursynth import SangNom2

    N = 10
    node, stacked = _src_node(vs, rng, w=52, h=16, n=N)
    out = SangNom2(node, order=2, opt=0, batch=3, pool_compat=True)
    want = sangnom2(Clip.from_numpy(stacked, "YUV420P8"),
                    order=2, opt=0, pool_compat=True)

    orders = [list(rng.permutation(N)) for _ in range(5)]
    results = _hammer(out, orders, n_threads=5)
    assert len(results) == N
    for n in range(N):
        for i in range(3):
            np.testing.assert_array_equal(
                results[n][i], np.asarray(want.planes[i])[n],
                err_msg=f"frame {n} plane {i}")
    assert node.nested_fetches == 0


def test_stress_pool_compat_sequential_parallel_lookahead(rng, monkeypatch):
    """The designed pool use: sequential playback with parallel lookahead
    (each thread walks forward from a small offset, like a frame server's
    request pipeline).  Byte-identical, zero nested fetches — AND zero
    off-worker fetches: the ordered turn-taking means a later-window
    selector that runs first WAITS for its in-flight predecessors
    instead of re-fetching their windows through the host (the round-5
    review's confirmed hazard in the first-come-takes-the-chain
    design)."""
    vs = _install_mock(monkeypatch)
    import sangnom_jax.hosts.vapoursynth as host

    off_worker = []
    orig_fetch = host._WindowRunner._fetch_off_worker

    def counting_fetch(self, start):
        off_worker.append(start)
        return orig_fetch(self, start)

    monkeypatch.setattr(host._WindowRunner, "_fetch_off_worker",
                        counting_fetch)

    N = 12
    node, stacked = _src_node(vs, rng, n=N)
    out = host.SangNom2(node, order=1, opt=0, batch=4, pool_compat=True)
    want = sangnom2(Clip.from_numpy(stacked, "YUV420P8"),
                    order=1, opt=0, pool_compat=True)

    orders = [list(range(off, N)) for off in range(4)]
    results = _hammer(out, orders, n_threads=4)
    for n in range(N):
        for i in range(3):
            np.testing.assert_array_equal(
                results[n][i], np.asarray(want.planes[i])[n],
                err_msg=f"frame {n} plane {i}")
    assert node.nested_fetches == 0
    assert off_worker == [], (
        f"sequential parallel lookahead re-entered the host for windows "
        f"{off_worker}")
