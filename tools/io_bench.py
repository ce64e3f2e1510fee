"""Host-side y4m I/O throughput A/B: legacy staging path vs readinto path.

When the device outruns the host, the CLI's end-to-end throughput is
bounded by the y4m framing layer, so its copy count matters.  Legacy read: fh.read -> frombuffer views -> np.stack
(copy) -> astype (copy) -> jnp.asarray (copy).  New read
(io/y4m._read_frame_block): readinto directly into preallocated per-plane
arrays -> jnp.asarray — two copies total.  Legacy write: per-frame
ascontiguousarray+astype (copy) + tobytes (copy) + fh.write (copy).  New
write: one astype per plane-clip, zero-copy per-frame memoryview writes.

Interleaved trials (this host is 1-vCPU and contended; sequential arms
mis-measure), best-of reported, round-trip equality asserted.
"""
from __future__ import annotations

import io
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from sangnom_jax.core.clip import Clip  # noqa: E402
from sangnom_jax.core.formats import get_format  # noqa: E402
from sangnom_jax.io.y4m import (  # noqa: E402
    _parse_header,
    read_y4m,
    write_y4m,
)

N, H, W = 64, 1080, 1920
TRIALS = 6


def _legacy_read(data: bytes) -> Clip:
    """The pre-round-3 read path, verbatim semantics."""
    fh = io.BytesIO(data)
    info = _parse_header(fh)
    frames = []
    while True:
        line = fh.readline()
        if not line:
            break
        if not line.startswith(b"FRAME"):
            raise ValueError("marker")
        buf = fh.read(info["frame_bytes"])
        if len(buf) < info["frame_bytes"]:
            raise ValueError("truncated")
        planes, off = [], 0
        for pw, ph in info["geom"]:
            planes.append(
                np.frombuffer(buf, info["dt"], count=pw * ph, offset=off)
                .reshape(ph, pw)
            )
            off += pw * ph * info["dt"].itemsize
        frames.append(planes)
    fmt = info["fmt"]
    stacked = [
        np.stack([fr[i] for fr in frames]).astype(fmt.dtype)
        for i in range(fmt.num_planes)
    ]
    return Clip.from_numpy(stacked, fmt)


def _legacy_write(clip: Clip) -> bytes:
    fh = io.BytesIO()
    fh.write(
        f"YUV4MPEG2 W{clip.width} H{clip.height} F25:1 Ip A1:1 C420\n".encode()
    )
    arrs = [np.asarray(p) for p in clip.planes]
    dt = np.dtype("u1")
    for n in range(clip.num_frames):
        fh.write(b"FRAME\n")
        for p in arrs:
            fh.write(np.ascontiguousarray(p[n]).astype(dt).tobytes())
    return fh.getvalue()


def main() -> None:
    rng = np.random.default_rng(20260818)
    fmt = get_format("YUV420P8")
    planes = [rng.integers(0, 256, (N, H >> s, W >> s), dtype=np.uint8)
              for s in (0, 1, 1)]
    clip = Clip.from_numpy(planes, fmt)

    buf = io.BytesIO()
    write_y4m(buf, clip)
    data = buf.getvalue()

    res: dict[str, list[float]] = {k: [] for k in
                                   ("read_old", "read_new",
                                    "write_old", "write_new")}
    for t in range(TRIALS):
        t0 = time.perf_counter()
        c_old = _legacy_read(data)
        res["read_old"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        c_new = read_y4m(io.BytesIO(data))
        res["read_new"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        d_old = _legacy_write(clip)
        res["write_old"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        b2 = io.BytesIO()
        write_y4m(b2, clip)
        d_new = b2.getvalue()
        res["write_new"].append(time.perf_counter() - t0)

        if t == 0:
            for po, pn in zip(c_old.planes, c_new.planes):
                assert np.array_equal(np.asarray(po), np.asarray(pn))
            assert d_old == d_new == data
            print("round-trip byte/bit-identical across arms")

    for k, ts in res.items():
        best = min(ts)
        print(f"{k:10s} best {N/best:8.1f} fps   "
              f"trials {[f'{N/x:.0f}' for x in ts]}")
    print(f"read speedup  x{min(res['read_old']) / min(res['read_new']):.2f}")
    print(f"write speedup x{min(res['write_old']) / min(res['write_new']):.2f}")


if __name__ == "__main__":
    main()
