"""In-process end-to-end streaming attribution harness (VERDICT_r3 #1).

Times each host stage of the CLI's windowed pipeline IN ISOLATION —
read/parse, device upload, device compute, device->host fetch, y4m
serialization — then runs the real windowed CLI end-to-end with the
3-thread overlap pipeline ON and OFF, verifying byte-identical output.

The per-stage numbers say what end-to-end fps a pipelined host CAN reach
(min of the stage rates, since the overlap pipeline runs read, dispatch
and fetch+write concurrently) and the end-to-end arms say what it DOES
reach on this host.  On a 1-core host the overlap arms are expected to tie
or lose slightly (threads cannot actually run concurrently).

Usage:  python tools/stream_attr.py [frames] [WxH] [window]
        (defaults: 96 frames, 1920x1080 YUV420P8, window 24)
"""

from __future__ import annotations

import io
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> None:
    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 96
    wh = sys.argv[2] if len(sys.argv) > 2 else "1920x1080"
    window = int(sys.argv[3]) if len(sys.argv) > 3 else 24
    W, H = (int(x) for x in wh.split("x"))

    import jax

    from sangnom_jax import Clip, get_format, sangnom2
    from sangnom_jax.io import iter_y4m, write_y4m, write_y4m_frames

    log("devices:", jax.devices())
    fmt = get_format("YUV420P8")
    rng = np.random.default_rng(11)
    planes = [
        rng.integers(0, 256, (frames, H, W)).astype(np.uint8),
        rng.integers(0, 256, (frames, H // 2, W // 2)).astype(np.uint8),
        rng.integers(0, 256, (frames, H // 2, W // 2)).astype(np.uint8),
    ]
    # host-resident Clip (plain numpy planes): stream synthesis must not
    # round-trip the device
    clip = Clip(planes, fmt)
    src = io.BytesIO()
    write_y4m(src, clip, fps=(30, 1))
    stream = src.getvalue()
    log(f"stream: {frames} frames {W}x{H} = {len(stream) / 2**20:.0f} MiB")

    kwargs = dict(order=1, aa=48, dh=True, opt=-1)
    res = {"frames": frames, "geometry": f"{W}x{H}", "window": window}

    # --- stage: read/parse (+upload inside Clip.from_numpy) ---------------
    # iter_y4m parses into numpy and device_puts; split the two by also
    # timing a parse-only pass through the raw reader plumbing.
    t0 = time.perf_counter()
    n = 0
    ws = []
    for w in iter_y4m(io.BytesIO(stream), window):
        jax.block_until_ready(w.planes)
        n += w.num_frames
        ws.append(w)
    res["read_upload_fps"] = n / (time.perf_counter() - t0)
    log(f"read+parse+upload: {res['read_upload_fps']:.0f} fps")

    from sangnom_jax.io.y4m import _parse_header, _read_frame_block

    fh = io.BytesIO(stream)
    t0 = time.perf_counter()
    info = _parse_header(fh)
    nplanes = _read_frame_block(fh, info, None)
    res["read_parse_only_fps"] = nplanes[0].shape[0] / (
        time.perf_counter() - t0)
    log(f"read+parse only:   {res['read_parse_only_fps']:.0f} fps")

    # --- stage: device compute (eager filter, checksum-forced) ------------
    import jax.numpy as jnp

    @jax.jit
    def sync(ps):
        return sum(jnp.sum(p[:, -1].astype(jnp.float32)) for p in ps)

    outs = [sangnom2(w, **kwargs) for w in ws]  # warm compile
    jax.block_until_ready([o.planes for o in outs])
    t0 = time.perf_counter()
    acc = [sync(sangnom2(w, **kwargs).planes) for w in ws]
    np.asarray(jnp.stack(acc))
    res["device_fps"] = n / (time.perf_counter() - t0)
    log(f"device compute:    {res['device_fps']:.0f} fps")

    # --- stage: fetch (device -> host) ------------------------------------
    t0 = time.perf_counter()
    fetched = [[np.asarray(p) for p in o.planes] for o in outs]
    res["fetch_fps"] = n / (time.perf_counter() - t0)
    log(f"device fetch:      {res['fetch_fps']:.0f} fps")

    # --- stage: serialize (numpy -> y4m bytes) ----------------------------
    null = io.BytesIO()
    hostclips = [
        Clip([np.ascontiguousarray(p) for p in f], outs[0].format)
        for f in fetched
    ]
    t0 = time.perf_counter()
    for hc in hostclips:
        write_y4m_frames(null, hc)
    res["serialize_fps"] = n / (time.perf_counter() - t0)
    log(f"y4m serialize:     {res['serialize_fps']:.0f} fps")

    res["pipeline_bound_fps"] = min(
        res["read_upload_fps"], res["device_fps"],
        1.0 / (1.0 / res["fetch_fps"] + 1.0 / res["serialize_fps"]),
    )
    log(f"=> pipelined bound (min of stages, fetch+serialize on one "
        f"thread): {res['pipeline_bound_fps']:.0f} fps")

    # --- end-to-end: the real windowed CLI, overlap off vs on --------------
    from sangnom_jax import cli

    class _Std:
        def __init__(self, buf):
            self.buffer = buf

    outs_bytes = {}
    old_in, old_out = sys.stdin, sys.stdout
    for tag, flag in (("serial", "--no-overlap-write"),
                      ("overlap", "--overlap-write")):
        dst = io.BytesIO()
        sys.stdin, sys.stdout = _Std(io.BytesIO(stream)), _Std(dst)
        try:
            t0 = time.perf_counter()
            rc = cli.main(["-", "-", "--dh", "--window", str(window), flag])
            dt = time.perf_counter() - t0
        finally:
            sys.stdin, sys.stdout = old_in, old_out
        assert rc == 0, rc
        outs_bytes[tag] = dst.getvalue()
        res[f"e2e_{tag}_fps"] = frames / dt
        log(f"end-to-end {tag}: {res[f'e2e_{tag}_fps']:.0f} fps")
    assert outs_bytes["serial"] == outs_bytes["overlap"], \
        "overlap output is not byte-identical"
    log("byte-identity serial == overlap: OK")

    print(json.dumps(res))


if __name__ == "__main__":
    main()
