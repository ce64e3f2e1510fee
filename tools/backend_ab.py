"""Time the row-scan kernel (opt=1) against the plain XLA path (opt=0) end
to end on the GPU, for the true bob (1080i YUV420P8, 60 frames in, 120
out) and order=1 dh (1080p YUV420P8 fields, 120 frames).

Every arm is checked bit-identical to the kernel arm, and the kernel arm
against the native oracle on a few frames, before anything is timed.  The
arms run in turns within one process (kernel, plain, ..., plain, kernel),
each call ended by ``block_until_ready``.  The plain path runs at its
memory-derived frame chunk (``ops.reference.scan_batch``) and at each
forced chunk of ``--chunks``.

    python tools/backend_ab.py [--rounds 3] [--iters 5] [--chunks 8]

Prints one JSON line to stdout; progress goes to stderr.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--chunks", default="")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        log(f"no GPU: default backend is {jax.default_backend()!r}")
        return 1
    from sangnom_jax import Clip, bob, get_format, sangnom2
    from sangnom_jax.core.fields import bob_impl, double_weave, separate_fields
    from sangnom_jax.ops.sangnom import sangnom2_impl
    from sangnom_jax.ops import reference
    from sangnom_jax.oracle import sangnom2_frame_oracle

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card()}
    log("device:", info)
    fmt = get_format("YUV420P8")
    rng = np.random.default_rng(7)

    def planes_of(n, h):
        return [rng.integers(0, 256, (n, h // d, 1920 // d), dtype=np.uint8)
                for d in (1, 2, 2)]

    bob_np = planes_of(60, 1080)
    dh_np = planes_of(120, 540)
    clip_bob = Clip.from_numpy(bob_np, fmt, tff=True)
    clip_dh = Clip.from_numpy(dh_np, fmt)
    parity = jnp.zeros((120,), jnp.bool_)
    impls = {
        "bob": (lambda planes, opt: bob_impl(planes, fmt, 48, 0, True, opt,
                                             "c"), clip_bob.planes),
        "order1_dh": (lambda planes, opt: sangnom2_impl(
            planes, parity, fmt, 1, 48, 0, True, True, True, opt),
            clip_dh.planes),
    }
    work = {
        "bob": lambda opt: bob(clip_bob, opt=opt).planes,
        "order1_dh": lambda opt: sangnom2(clip_dh, order=1, dh=True,
                                          opt=opt).planes,
    }

    # oracle gate on the kernel arm
    out = work["bob"](1)
    woven = double_weave(separate_fields(
        Clip.from_numpy([p[:2] for p in bob_np], fmt, tff=True)))
    for n in range(4):
        want = sangnom2_frame_oracle(
            [np.asarray(p)[n] for p in woven.planes], fmt, order=0,
            frame_parity=woven.get_parity(n))
        for i in range(3):
            if not np.array_equal(np.asarray(out[i][n]), want[i]):
                log(f"bob kernel != oracle (frame {n}, plane {i})")
                return 1
    out = work["order1_dh"](1)
    want = sangnom2_frame_oracle([p[0] for p in dh_np], fmt, order=1, dh=True)
    for i in range(3):
        if not np.array_equal(np.asarray(out[i][0]), want[i]):
            log(f"order1_dh kernel != oracle (plane {i})")
            return 1
    log("kernel == oracle: bob 4 frames, order1_dh 1 frame, all planes")

    chunks = [int(c) for c in args.chunks.split(",") if c]
    arms = [("kernel", 1, None), ("xla", 0, None)] + [
        (f"xla_chunk{c}", 0, c) for c in chunks]
    scan_batch = reference.scan_batch

    def build(arm, wl):
        """One jitted program per (arm, workload); the plain path's frame
        chunk is read while it traces, on the first call."""
        _, opt, chunk = arm
        fn, planes = impls[wl]
        f = jax.jit(lambda p: fn(p, opt))
        if chunk is not None:
            reference.scan_batch = lambda bufH, S: chunk
        try:
            t0 = time.perf_counter()
            out = jax.block_until_ready(f(planes))
            return f, out, time.perf_counter() - t0
        finally:
            reference.scan_batch = scan_batch

    res = {"device": info, "workloads": {}}
    for wl in impls:
        planes = impls[wl][1]
        ref_out = None
        live = {}
        for arm in arms:
            try:
                f, o, first = build(arm, wl)
            except Exception as e:  # noqa: BLE001 — e.g. out of memory
                log(f"{wl} {arm[0]}: FAILED {type(e).__name__}: "
                    f"{str(e)[:300]}")
                res["workloads"].setdefault(wl, {})[arm[0]] = {
                    "error": f"{type(e).__name__}: {str(e)[:200]}"}
                continue
            if ref_out is None:
                ref_out = o
            same = all(bool(jnp.array_equal(a, b))
                       for a, b in zip(o, ref_out))
            log(f"{wl} {arm[0]}: first call {first:.1f}s, "
                f"bit-identical to kernel: {same}")
            if not same:
                return 1
            live[arm[0]] = f
            res["workloads"].setdefault(wl, {})[arm[0]] = {
                "first_call_s": round(first, 3)}
            del o
        times = {name: [] for name in live}
        order = list(live) + list(live)[::-1]
        for _ in range(args.rounds):
            for name in order:
                f = live[name]
                jax.block_until_ready(f(planes))
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    jax.block_until_ready(f(planes))
                times[name].append((time.perf_counter() - t0) / args.iters)
        for name, ts in times.items():
            best = min(ts)
            res["workloads"][wl][name].update(
                ms_best=round(best * 1e3, 3),
                ms_median=round(float(np.median(ts)) * 1e3, 3),
                fps_best=round(120 / best, 1), ms_all=[round(t * 1e3, 3)
                                                      for t in ts])
            log(f"{wl} {name}: best {best * 1e3:.2f} ms / 120 frames "
                f"({120 / best:.0f} fps), median "
                f"{np.median(ts) * 1e3:.2f} ms  [{info['card']}]")
        del live, ref_out
    res["peak_bytes_in_use"] = dev.memory_stats().get("peak_bytes_in_use")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
