"""Command-line host: deinterlace .y4m streams standalone.

The reference runs inside an AviSynth host; this CLI is the framework's own
minimal host runtime, exposing the exact script-function surface over files:

    python -m sangnom_jax input.y4m output.y4m --order 1 --aa 48 --dh
    python -m sangnom_jax in.y4m out.y4m --legacy --order 2   # SangNom()

Reads/writes YUV4MPEG2 on files or stdin/stdout ("-").
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

from sangnom_jax import __version__, sangnom, sangnom2
from sangnom_jax.io import iter_y4m, read_y4m, write_y4m, write_y4m_frames


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sangnom-jax",
        description="SangNom2 edge-directed deinterlacer / anti-aliaser "
        "(JAX, GPU). Parameter names, defaults and semantics match the "
        "AviSynth plugin.",
    )
    p.add_argument("input", help=".y4m input path, or - for stdin")
    p.add_argument("output", help=".y4m output path, or - for stdout")
    p.add_argument("--order", type=int, default=1,
                   help="0: per-frame parity (bob), 1: keep top, 2: keep "
                   "bottom (default 1)")
    p.add_argument("--aa", type=int, default=48, help="luma AA strength 0..128")
    p.add_argument("--aac", type=int, default=0, help="chroma AA strength 0..128")
    p.add_argument("--threads", type=int, default=0,
                   help="accepted and ignored (reference compatibility)")
    p.add_argument("--dh", action="store_true", help="double height")
    p.add_argument("--no-luma", dest="luma", action="store_false")
    p.add_argument("--no-chroma", dest="chroma", action="store_false")
    p.add_argument("--opt", type=int, default=-1,
                   help="-1 auto, 0 jnp reference, 1 fused Pallas")
    p.add_argument("--pool-compat", action="store_true",
                   help="reproduce the reference's shared-buffer-pool "
                   "stale-data semantics bit-for-bit (frames become "
                   "sequential)")
    p.add_argument("--numerics", choices=("c", "sse2"), default="c",
                   help="numeric contract: the reference's C path "
                   "(default) or its diverging SSE2 path")
    p.add_argument("--legacy", action="store_true",
                   help="use the legacy SangNom() surface (order remap; "
                   "aa/opt only)")
    p.add_argument("--bob", action="store_true",
                   help="double-rate deinterlace: SeparateFields -> "
                   "DoubleWeave -> SangNom2(order=0); doubles the frame "
                   "count and framerate")
    p.add_argument("--tff", dest="tff", action="store_true", default=None,
                   help="force top-field-first (default: stream flag)")
    p.add_argument("--bff", dest="tff", action="store_false",
                   help="force bottom-field-first")
    p.add_argument("--frames", type=int, default=None,
                   help="process at most N frames")
    p.add_argument("--window", type=int, default=None,
                   help="stream in windows of N frames (bounded memory for "
                   "long inputs; default: whole clip at once)")
    p.add_argument("--overlap-write", action="store_true", default=None,
                   help="with --window: pipeline the host stages across "
                   "threads — a reader thread (parse+upload), the main "
                   "thread (filter dispatch), and a writer thread (device "
                   "fetch + y4m serialization) — so end-to-end throughput "
                   "approaches min(reader, writer, device) instead of "
                   "their serial sum (byte-identical output; single "
                   "reader/writer preserve order).  DEFAULT ON when "
                   "--window is given and the host has >1 CPU.")
    p.add_argument("--no-overlap-write", dest="overlap_write",
                   action="store_false",
                   help="force the single-threaded windowed loop")
    p.add_argument("--fps", default=None,
                   help="output framerate N:D (default: input stream's, "
                   "doubled under --bob)")
    p.add_argument("--aot", default=None, metavar="DIR",
                   help="directory of prewarmed jax.export program "
                   "artifacts (see the 'prewarm' verb): matching "
                   "dispatches skip trace and lowering, so a fresh "
                   "process starts fast even on a "
                   "geometry the compile cache has never seen. Misses "
                   "fall back to the normal jit path (same bits either "
                   "way).")
    p.add_argument("--cache-dir", default=None,
                   help="persistent XLA compilation cache directory: "
                   "repeat invocations skip the first-call compile. "
                   "Default: $JAX_COMPILATION_CACHE_DIR, else .jax_cache/ "
                   "at the checkout root on a GPU; pass an empty string "
                   "to disable. The AviSynth host amortizes compile cost "
                   "by keeping the process resident; this is the "
                   "one-shot-CLI analogue.")
    p.add_argument("--version", action="version",
                   version=f"sangnom-jax {__version__}")
    return p


#: the compile cache's default home: a fixed directory at the checkout
#: root (a cache path that moves between runs never hits)
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def resolve_cache_dir(cache_dir_arg: str | None, backend: str) -> str | None:
    """The persistent compile cache directory, or None for no cache: an
    explicit ``--cache-dir`` wins ('' disables), then
    ``$JAX_COMPILATION_CACHE_DIR``, then `DEFAULT_CACHE_DIR` on a GPU.
    The CPU backend gets no default (its compiles are cheap, and XLA's CPU
    loader logs an ERROR line on every cache load)."""
    if cache_dir_arg is not None:
        return cache_dir_arg or None
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return str(DEFAULT_CACHE_DIR) if backend == "gpu" else None


def setup_compile_cache(cache_dir_arg: str | None = None) -> str | None:
    """Resolve and install the persistent compile cache for this process —
    the one home of the policy, shared by the CLI verbs, bench.py and
    chip_smoke.py.  Call it before the first compile: JAX opens the cache
    once.  Returns the directory in use (None: caching off)."""
    import jax

    cache_dir = resolve_cache_dir(cache_dir_arg, jax.default_backend())
    if cache_dir is None:
        jax.config.update("jax_enable_compilation_cache", False)
        return None
    if cache_dir != os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        try:
            os.makedirs(cache_dir, exist_ok=True)
        except OSError as e:
            print(f"warning: compile cache disabled ({e})", file=sys.stderr)
            jax.config.update("jax_enable_compilation_cache", False)
            return None
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_enable_compilation_cache", True)
    # cache every program: the filter dispatches a handful of jits and
    # even the small ones pay trace+compile on a cold process
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "prewarm":
        return _prewarm_main(argv[1:])
    if argv and argv[0] == "script":
        return _script_main(argv[1:])

    args = build_parser().parse_args(argv)
    setup_compile_cache(args.cache_dir)
    # configure UNCONDITIONALLY (None disables): aot config is process-
    # global, and an in-process host calling main() repeatedly must not
    # leak one run's --aot directory (or its hit/miss stats) into a later
    # run that did not ask for it
    from sangnom_jax import aot

    aot.configure(args.aot or None)
    src = sys.stdin.buffer if args.input == "-" else args.input
    dst = sys.stdout.buffer if args.output == "-" else args.output

    from sangnom_jax.api import SangNomError

    t0 = time.perf_counter()
    try:
        if args.legacy and args.bob:
            # --bob would silently run the SangNom2 surface and drop
            # --legacy; SangNom2-only knobs (--dh/--aac/--no-chroma) are
            # instead IGNORED under --legacy, matching the legacy
            # surface's documented parameter set (pinned by
            # tests/test_io_cli.py)
            raise ValueError(
                "--legacy cannot be combined with --bob (bob runs the "
                "SangNom2 surface; use --legacy --order 0 for per-frame "
                "parity)"
            )
        if args.fps is not None:
            num, den = (int(x) for x in args.fps.split(":"))
            if den <= 0 or num <= 0:
                raise ValueError(f"invalid --fps {args.fps!r}")
            fps = (num, den)
        else:
            fps = None
        if args.overlap_write and args.window is None:
            raise ValueError("--overlap-write requires --window")
        if args.overlap_write is None:
            # default: overlap when the host can actually run the stages in
            # parallel (a 1-vCPU host would only pay thread switching)
            args.overlap_write = (
                args.window is not None and (os.cpu_count() or 1) > 1
            )
        if args.window is not None:
            return _run_windowed(src, dst, args, fps, t0)
        clip = read_y4m(src, max_frames=args.frames)
        out = _filter_one(_override_tff(clip, args), args)
        if fps is None:
            fps = clip.props.get("y4m_fps", (25, 1))
            if args.bob:
                # double-rate output; an EXPLICIT --fps is already the
                # output rate (its documented meaning) and stays as-is
                fps = (fps[0] * 2, fps[1])
        write_y4m(dst, out, fps=fps,
                  interlace=_out_interlace(args, clip.num_planes, clip.props))
    except (SangNomError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    dt = time.perf_counter() - t0
    _aot_note(args)
    print(
        f"{clip.num_frames} frames {clip.width}x{clip.height} -> "
        f"{out.width}x{out.height} in {dt:.2f}s "
        f"({clip.num_frames / dt:.1f} fps end-to-end)",
        file=sys.stderr,
    )
    return 0


def _aot_note(args) -> None:
    if not getattr(args, "aot", None):
        return
    from sangnom_jax import aot

    h, m = aot.STATS["hits"], aot.STATS["misses"]
    print(f"aot: {h} dispatch(es) served from artifacts, {m} miss(es)",
          file=sys.stderr)


def _out_interlace(args, num_planes: int, props: dict) -> str:
    """Output-stream interlace tag.  The filter produces progressive output
    ('p') whenever it actually processes a plane; a pure pass-through run
    (no --dh/--bob and every existing plane masked off — chroma flags are
    moot on GRAY clips) forwards the input stream's tag instead of
    restamping interlaced content.  Single policy for the whole-clip and
    windowed writers."""
    processes = (
        args.bob or args.dh or args.luma or (args.chroma and num_planes >= 3)
    )
    if processes:
        return "p"
    return props.get("y4m_interlace", "p")


def _override_tff(clip, args):
    if args.tff is None:
        return clip
    # force field dominance over the stream's interlace flag
    # (applies to every mode, not just --bob)
    from sangnom_jax import Clip

    return Clip(clip.planes, clip.format, parity=None, tff=args.tff,
                props=clip.props)


def _filter_one(clip, args):
    compat = dict(pool_compat=args.pool_compat, numerics=args.numerics)
    if args.bob:
        from sangnom_jax import bob as bob_fn

        return bob_fn(clip, aa=args.aa, aac=args.aac, luma=args.luma,
                      chroma=args.chroma, opt=args.opt, tff=args.tff,
                      **compat)
    if args.legacy:
        return sangnom(clip, order=args.order, aa=args.aa, opt=args.opt,
                       **compat)
    return sangnom2(
        clip, order=args.order, aa=args.aa, aac=args.aac,
        threads=args.threads, dh=args.dh, luma=args.luma,
        chroma=args.chroma, opt=args.opt, **compat,
    )


def _prefetch_windows(it, depth: int = 2):
    """Run a window iterator on its own READER thread with a bounded
    handoff queue: the y4m parse + device upload of window k+1 overlap the
    main thread's dispatch and the writer thread's fetch/serialize of
    window k.  Order is preserved (single reader, FIFO queue) so output
    stays byte-identical; reader exceptions re-raise on the consuming
    thread.  The bounded queue keeps at most ``depth`` parsed windows in
    flight (same memory ceiling as the serial loop's lookahead)."""
    import queue as _queue
    import threading

    q = _queue.Queue(maxsize=depth)
    err: list = []
    done = object()
    stop = threading.Event()

    def _put(x) -> bool:
        # bounded put that gives up when the consumer is gone — without
        # this, an error in the windowed loop would leave the reader
        # thread blocked in q.put forever, pinning its parsed+uploaded
        # windows and the input stream (an in-process host calling
        # cli.main() repeatedly would accumulate them)
        while not stop.is_set():
            try:
                q.put(x, timeout=0.2)
                return True
            except _queue.Full:
                continue
        return False

    def _loop():
        try:
            for x in it:
                if not _put(x):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised on consumer
            err.append(e)
        finally:
            _put(done)

    reader = threading.Thread(target=_loop, name="sangnom-reader",
                              daemon=True)
    reader.start()
    try:
        while True:
            x = q.get()
            if x is done:
                if err:
                    raise err[0]
                return
            yield x
    finally:
        stop.set()
        # let a window the reader is still parsing or uploading finish:
        # a process that exits while the thread is inside the runtime
        # aborts instead of returning its exit code
        reader.join(timeout=30)


def _run_windowed(src, dst, args, fps, t0) -> int:
    """Streaming mode: process in --window sized batches, write
    incrementally.  The filter has no temporal taps so windows are exact;
    the bob pipeline pairs each frame's trailing field with the NEXT
    frame's leading field, so windows are processed with one frame of
    lookahead and the overlap outputs dropped."""
    from sangnom_jax import Clip
    from sangnom_jax.api import SangNomError

    if args.pool_compat and args.bob:
        # bob windows overlap by one lookahead frame; processing it twice
        # would corrupt the carried pool state vs whole-clip output
        print("error: --pool-compat with --bob requires whole-clip "
              "processing (drop --window)", file=sys.stderr)
        return 2

    # opened lazily at the first emit so a failed run never truncates a
    # pre-existing output file (matching whole-clip mode's behavior)
    state = {"fh": None, "close": False, "out": 0, "in": 0, "shape": None}

    pool_state = {"p": None}

    def fone(w):
        if not args.pool_compat:
            return _filter_one(w, args)
        # pool-compat streaming: the pool is cross-frame state and must
        # survive window boundaries for byte-identity with whole-clip mode
        from sangnom_jax.api import _LEGACY_ORDER_REMAP, _validate
        from sangnom_jax.ops.sangnom import sangnom2_pool_stream

        if args.legacy:
            # the legacy surface has NO dh/luma/chroma parameters — mirror
            # sangnom()'s fixed defaults so windowed output stays
            # byte-identical to whole-clip legacy mode
            _validate("SangNom", w, args.order, args.aa, 0, args.opt)
            order = (_LEGACY_ORDER_REMAP[args.order]
                     if args.order != 1 else 1)
            aac, dh, luma, chroma = 0, False, True, True
        else:
            order, aac = args.order, args.aac
            dh, luma, chroma = args.dh, args.luma, args.chroma
        out, pool_state["p"] = sangnom2_pool_stream(
            w, pool_state["p"], order=order, aa=args.aa, aac=aac,
            dh=dh, luma=luma, chroma=chroma,
            numerics=args.numerics, opt=args.opt,
        )
        return out

    def emit(out_clip, in_props):
        f = fps
        if f is None:
            f = in_props.get("y4m_fps", (25, 1))
            if args.bob:
                # explicit --fps is the OUTPUT rate; only the
                # input-derived rate doubles under --bob
                f = (f[0] * 2, f[1])
        if state["fh"] is None:
            if isinstance(dst, (str, bytes)):
                state["fh"], state["close"] = open(dst, "wb"), True
            else:
                state["fh"] = dst
            ilace = _out_interlace(args, out_clip.num_planes, in_props)
            write_y4m(state["fh"], out_clip, fps=f, interlace=ilace)
        else:
            write_y4m_frames(state["fh"], out_clip)
        state["out"] += out_clip.num_frames
        state["shape"] = (out_clip.width, out_clip.height)

    # --overlap-write: a single writer THREAD runs emit(), so window k's
    # device fetch (np.asarray releases the GIL on the device->host wait)
    # and y4m serialization overlap window k+1's read/parse on the main
    # thread.  FIFO queue + one writer preserves emission order exactly —
    # output stays byte-identical (pinned by tests).  Bounded queue keeps
    # the same backpressure as serial emission; writer exceptions are
    # re-raised on the main thread (the writer then drains so the
    # producer never blocks on a dead consumer).
    emit_err: list = []
    wq = wthread = None
    if args.overlap_write:
        import queue as _queue
        import threading

        wq = _queue.Queue(maxsize=2)

        def _writer_loop():
            drain = False
            while True:
                item = wq.get()
                if item is None:
                    return
                if drain:
                    continue
                try:
                    emit(*item)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    emit_err.append(e)
                    drain = True

        wthread = threading.Thread(
            target=_writer_loop, name="sangnom-writer", daemon=True
        )
        wthread.start()

    def submit(out_clip, in_props):
        if wq is None:
            emit(out_clip, in_props)
            return
        if emit_err:
            raise emit_err[0]
        wq.put((out_clip, in_props))

    pending = None
    inflight = None  # one-window software pipeline (see below)
    windows = iter_y4m(src, args.window, max_frames=args.frames)
    if args.overlap_write:
        # third pipeline stage: parse+upload on a reader thread
        windows = _prefetch_windows(windows)
    try:
        for w in windows:
            w = _override_tff(w, args)
            state["in"] += w.num_frames
            if args.bob:
                if pending is not None:
                    feed = Clip.concat(pending, w[0:1])  # 1-frame lookahead
                    out = fone(feed)
                    submit(out[0 : 2 * pending.num_frames], pending.props)
                pending = w
            else:
                # JAX dispatch is asynchronous: launch window k, then let the
                # NEXT window's host-side y4m parse overlap the device
                # compute, and only then force/emit window k.  Same emission
                # order (byte-identical output), one extra window in flight.
                out = fone(w)
                if inflight is not None:
                    submit(*inflight)
                inflight = (out, w.props)
        if args.bob and pending is not None:
            # final window: the degenerate last pairing, as unwindowed
            submit(fone(pending), pending.props)
        if inflight is not None:
            submit(*inflight)
        if wthread is not None:
            wq.put(None)
            wthread.join()
            wthread = None
            if emit_err:
                raise emit_err[0]
        if state["in"] == 0:
            raise ValueError("y4m stream contains no frames")
    except (SangNomError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    finally:
        if wthread is not None:
            # exception path: stop the writer before closing its file
            wq.put(None)
            wthread.join()
        if state["close"] and state["fh"] is not None:
            state["fh"].close()
    dt = time.perf_counter() - t0
    _aot_note(args)
    w_, h_ = state["shape"]
    print(
        f"{state['in']} frames -> {state['out']} frames {w_}x{h_} in "
        f"{dt:.2f}s ({state['in'] / dt:.1f} fps end-to-end, "
        f"window={args.window})",
        file=sys.stderr,
    )
    return 0


def _prewarm_main(argv: list[str]) -> int:
    """``sangnom-jax prewarm``: export serialized compiled programs for a
    (format, geometry, params) combo so later CLI runs with ``--aot DIR``
    start fast — the analogue of the reference's AOT-.so zero-warmup
    property (precompiled path selected at construction, reference
    src/SangNom2.cpp:312-329)."""
    p = argparse.ArgumentParser(
        prog="sangnom-jax prewarm",
        description="Export AOT program artifacts (jax.export) for a "
        "format/geometry/parameter combo. Run with the SAME filter flags "
        "you will pass to the main CLI, plus the clip geometry; then give "
        "the main CLI --aot DIR.",
    )
    p.add_argument("--aot", required=True, metavar="DIR",
                   help="artifact directory (created if missing)")
    p.add_argument("--format", required=True, dest="fmt",
                   help="video format name, e.g. YUV420P8, GRAY16, YUV444PS")
    p.add_argument("--size", required=True, metavar="WxH",
                   help="input frame geometry, e.g. 1920x1080")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--window", type=int,
                   help="frames per program for windowed runs (--window N "
                   "on the main CLI; --bob additionally exports the N+1 "
                   "lookahead feed). The trailing partial window of a clip "
                   "whose length is not a multiple falls back to jit.")
    g.add_argument("--frames", type=int,
                   help="frames per program for whole-clip runs (the exact "
                   "clip length)")
    p.add_argument("--order", type=int, default=1)
    p.add_argument("--aa", type=int, default=48)
    p.add_argument("--aac", type=int, default=0)
    p.add_argument("--dh", action="store_true")
    p.add_argument("--no-luma", dest="luma", action="store_false")
    p.add_argument("--no-chroma", dest="chroma", action="store_false")
    p.add_argument("--opt", type=int, default=-1)
    p.add_argument("--numerics", choices=("c", "sse2"), default="c")
    p.add_argument("--legacy", action="store_true")
    p.add_argument("--bob", action="store_true")
    p.add_argument("--tff", dest="tff", action="store_true", default=True,
                   help="field dominance baked into --bob programs "
                   "(default tff; must match the stream/flags at run time)")
    p.add_argument("--bff", dest="tff", action="store_false")
    p.add_argument("--cache-dir", default=None,
                   help="persistent XLA compile cache to warm alongside "
                   "the artifacts (same default as the main CLI); the "
                   "exported program is called once on zeros so a later "
                   "--aot run skips BOTH trace+lower and backend compile")
    p.add_argument("--no-warm-call", dest="warm_call", action="store_false",
                   help="export artifacts only; skip the compile-cache "
                   "warming call")
    args = p.parse_args(argv)
    setup_compile_cache(args.cache_dir)

    from sangnom_jax import aot
    from sangnom_jax.api import (_LEGACY_ORDER_REMAP, SangNomError,
                                 _validate, _validate_geometry,
                                 _validate_numerics)
    from sangnom_jax.core.formats import get_format

    t0 = time.perf_counter()
    try:
        if args.legacy and args.bob:
            raise ValueError("--legacy cannot be combined with --bob")
        try:
            w, h = (int(x) for x in args.size.lower().split("x"))
        except ValueError:
            raise ValueError(f"invalid --size {args.size!r} (want WxH)")
        fmt = get_format(args.fmt)
        _validate("SangNom2", None, args.order, args.aa, args.aac, args.opt)
        _validate_numerics("SangNom2", args.numerics)
        _validate_geometry("SangNom2", fmt, h)

        def shapes(n):
            return tuple(
                ((n,) + tuple(reversed(fmt.plane_dims(w, h, i))),
                 str(np.dtype(fmt.dtype)))
                for i in range(fmt.num_planes)
            )

        jobs = []  # (kind, n_frames, statics)
        n0 = args.window if args.window is not None else args.frames
        if n0 <= 0:
            raise ValueError("--window/--frames must be positive")
        if args.bob:
            statics = aot.bob_statics(args.aa, args.aac, args.tff,
                                      args.opt, args.numerics)
            jobs.append(("bob", n0, statics))
            if args.window is not None:
                # windowed bob feeds window+1 frames (1-frame lookahead)
                jobs.append(("bob", n0 + 1, statics))
        else:
            order = args.order
            if args.legacy:
                # the legacy surface: order remap, fixed aac/dh/luma/chroma
                order = _LEGACY_ORDER_REMAP[order] if order != 1 else 1
                statics = aot.filter_statics(order, args.aa, 0, False,
                                             True, True, args.opt,
                                             args.numerics)
            else:
                statics = aot.filter_statics(order, args.aa, args.aac,
                                             args.dh, args.luma,
                                             args.chroma, args.opt,
                                             args.numerics)
            jobs.append(("filter", n0, statics))

        for kind, n, statics in jobs:
            tj = time.perf_counter()
            path = aot.save_program(args.aot, kind, fmt, shapes(n), statics)
            dt_export = time.perf_counter() - tj
            note = ""
            if args.warm_call:
                # land the .call path's backend executable in the compile
                # cache: a later --aot run then skips trace+lower (the
                # artifact) AND backend compile (the cache)
                note = f", warm-called {aot.warm_call(path):.1f}s"
            print(
                f"  {path.name}: {path.stat().st_size / 1e6:.2f} MB "
                f"({kind}, {n} frames, export {dt_export:.1f}s{note})",
                file=sys.stderr,
            )
    except (SangNomError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(
        f"prewarmed {len(jobs)} program(s) for {args.fmt} {w}x{h} into "
        f"{args.aot} in {time.perf_counter() - t0:.1f}s",
        file=sys.stderr,
    )
    return 0


def _script_main(argv: list[str]) -> int:
    """``sangnom-jax script``: run an AviSynth recipe file over a y4m
    stream through the script host (hosts/avs_script.py) — existing .avs
    lines drive the filter unmodified.  Frames are served through the
    chain's windowed device batching; the output frame rate scales with the
    recipe's frame-count ratio (e.g. the double-rate bob recipe doubles
    it) unless --fps pins it."""
    p = argparse.ArgumentParser(
        prog="sangnom-jax script",
        description="Evaluate an AviSynth script file (the plugin's usage "
        "subset: SangNom2/SangNom, AssumeTFF/BFF, SeparateFields, "
        "DoubleWeave, Weave, SelectEven/Odd, implicit last, chaining) "
        "over a y4m input.",
    )
    p.add_argument("recipe", help=".avs script file ('-' for stdin is NOT "
                   "supported here: stdin carries the video)")
    p.add_argument("input", help="input .y4m ('-' for stdin)")
    p.add_argument("output", help="output .y4m ('-' for stdout)")
    p.add_argument("--frames", type=int, default=None,
                   help="process at most N input frames")
    p.add_argument("--fps", default=None, metavar="N:D",
                   help="force the OUTPUT frame rate")
    p.add_argument("--tff", dest="tff", action="store_true", default=None,
                   help="override the stream's field dominance")
    p.add_argument("--bff", dest="tff", action="store_false")
    p.add_argument("--cache-dir", default=None,
                   help="persistent XLA compile cache directory (same "
                   "default as the main CLI)")
    args = p.parse_args(argv)
    setup_compile_cache(args.cache_dir)

    from sangnom_jax import Clip
    from sangnom_jax.api import SangNomError
    from sangnom_jax.hosts.avisynth import (ArraySource, ScriptEnvironment,
                                            avisynth_plugin_init)
    from sangnom_jax.hosts.avs_script import eval_script

    t0 = time.perf_counter()
    try:
        with open(args.recipe, "r", encoding="utf-8") as fh:
            text = fh.read()
        src_stream = sys.stdin.buffer if args.input == "-" else args.input
        clip = read_y4m(src_stream, max_frames=args.frames)
        tff = clip.tff if args.tff is None else args.tff
        src = ArraySource([np.asarray(pl) for pl in clip.planes],
                          clip.format, parity=tff)
        env = ScriptEnvironment()
        avisynth_plugin_init(env)
        result = eval_script(env, text, last=src)
        if not hasattr(result, "get_video_info"):
            raise SangNomError(
                f"script result is not a clip (got {type(result).__name__})")
        vi = result.get_video_info()
        frames = [result.get_frame(n, env) for n in range(vi.num_frames)]
        planes = [np.stack([fr.planes[i] for fr in frames])
                  for i in range(vi.num_components())]
        out = Clip.from_numpy(planes, vi.format, props=clip.props)
        if args.fps is not None:
            num, den = (int(x) for x in args.fps.split(":"))
            if den <= 0 or num <= 0:
                raise ValueError(f"invalid --fps {args.fps!r}")
            fps = (num, den)
        else:
            num, den = clip.props.get("y4m_fps", (25, 1))
            # scale by the recipe's frame-count ratio (bob 2x, SelectEven
            # 0.5x, ...) and reduce
            num, den = num * vi.num_frames, den * clip.num_frames
            g = math.gcd(num, den)
            fps = (num // g, den // g)
        dst = sys.stdout.buffer if args.output == "-" else args.output
        write_y4m(dst, out, fps=fps)
    except (SangNomError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(
        f"script {args.recipe}: {clip.num_frames} frames "
        f"{clip.width}x{clip.height} -> {vi.num_frames} frames "
        f"{vi.width}x{vi.height} in {time.perf_counter() - t0:.2f}s",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
