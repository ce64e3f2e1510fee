"""Big randomized parity campaign: jnp backend (opt=0) vs native oracle.

Hundreds of random configs across the full parameter lattice, with larger
frames than CI can afford. Any mismatch prints the full config.
"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_platforms", "cpu")

import numpy as np
from sangnom_jax import Clip, get_format, sangnom2
from sangnom_jax.oracle import sangnom2_frame_oracle

FMTS = ["GRAY8", "GRAY10", "GRAY12", "GRAY14", "GRAY16", "GRAYS",
        "YUV420P8", "YUV420P16", "YUV420PS", "YUV422P8", "YUV422P10",
        "YUV422PS", "YUV444P8", "YUV444P12", "YUV444PS",
        "YUVA420P8", "YUVA444P16"]

import sys as _sys

# usage: parity_campaign_cpu.py [n_random] [seed_base] [n_compat]
N = int(_sys.argv[1]) if len(_sys.argv) > 1 else 300
SEED = int(_sys.argv[2]) if len(_sys.argv) > 2 else 77000
fails = 0
for case in range(N):
    rng = np.random.default_rng(SEED + case)
    fmt = get_format(FMTS[int(rng.integers(len(FMTS)))])
    w = int(rng.integers(1, 90)) * 2          # 2..178
    h = int(rng.integers(1, 24)) * 4          # 4..92
    order = int(rng.integers(0, 3))
    aa = int(rng.integers(0, 129)); aac = int(rng.integers(0, 129))
    dh = bool(rng.integers(0, 2))
    luma = bool(rng.integers(0, 2)); chroma = bool(rng.integers(0, 2))
    tff = bool(rng.integers(0, 2))
    planes = []
    for i in range(fmt.num_planes):
        pw, ph = fmt.plane_dims(w, h, i)
        if fmt.is_float:
            planes.append((rng.random((ph, pw), np.float32)*2-0.5).astype(np.float32))
        else:
            top = (1 << (8*fmt.component_size)) - 1
            planes.append(rng.integers(0, top+1, (ph, pw)).astype(fmt.dtype))
    clip = Clip.from_numpy([p[None] for p in planes], fmt, tff=tff)
    got = sangnom2(clip, order=order, aa=aa, aac=aac, dh=dh,
                   luma=luma, chroma=chroma, opt=0)
    want = sangnom2_frame_oracle(planes, fmt, order=order, aa=aa, aac=aac,
                                 dh=dh, luma=luma, chroma=chroma,
                                 frame_parity=tff)
    for i, wp in enumerate(want):
        g = np.asarray(got.planes[i])[0]
        if not np.array_equal(g, wp):
            fails += 1
            d = (g.astype(np.float64) - wp.astype(np.float64))
            print(f"MISMATCH case {case}: {fmt.name} {w}x{h} order={order} "
                  f"aa={aa} aac={aac} dh={dh} luma={luma} chroma={chroma} "
                  f"tff={tff} plane {i}: {np.count_nonzero(d)} px, "
                  f"max {np.abs(d).max()}", flush=True)
    if case % 50 == 49:
        print(f"{case+1}/{N} done, {fails} failures", flush=True)
print(f"CAMPAIGN DONE: {N} configs, {fails} failures")

# ---- compat-axis campaign: pool_compat x numerics, multi-frame clips ----
# Truth is the pure-Python scalar spec (the only oracle that implements
# every combination); frames stay tiny to keep it tractable.
import sys  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
from scalar_model import sangnom2_clip_scalar  # noqa: E402

C_FMTS = ["GRAY8", "YUV420P8", "YUV420P16", "YUV422P8", "YUV411P8",
          "YUV444P8", "YUV420PS"]
cfails = 0
NC = int(_sys.argv[3]) if len(_sys.argv) > 3 else 60
for case in range(NC):
    rng = np.random.default_rng(SEED + 11000 + case)
    fmt = get_format(C_FMTS[int(rng.integers(len(C_FMTS)))])
    w = int(rng.integers(4, 17)) * 4          # 16..64
    h = int(rng.integers(2, 5)) * 4           # 8..16
    nfr = int(rng.integers(2, 4))
    order = int(rng.integers(0, 3))
    aa = int(rng.integers(0, 129)); aac = int(rng.integers(0, 129))
    dh = bool(rng.integers(0, 2))
    luma = bool(rng.integers(0, 2)); chroma = bool(rng.integers(0, 2))
    pool_compat = bool(rng.integers(0, 2))
    numerics = "sse2" if rng.integers(0, 2) and not fmt.is_float else "c"
    parities = [bool(rng.integers(0, 2)) for _ in range(nfr)]
    frames = []
    for _ in range(nfr):
        fplanes = []
        for i in range(fmt.num_planes):
            pw, ph = fmt.plane_dims(w, h, i)
            if fmt.is_float:
                fplanes.append((rng.random((ph, pw), np.float32)*2-0.5
                                ).astype(np.float32))
            else:
                top = (1 << (8*fmt.component_size)) - 1
                fplanes.append(
                    rng.integers(0, top+1, (ph, pw)).astype(fmt.dtype))
        frames.append(fplanes)
    kw = dict(order=order, aa=aa, aac=aac, dh=dh, luma=luma, chroma=chroma)
    want = sangnom2_clip_scalar(frames, fmt, parities=parities,
                                pool_compat=pool_compat, numerics=numerics,
                                **kw)
    planes = [np.stack([f[i] for f in frames])
              for i in range(fmt.num_planes)]
    clip = Clip.from_numpy(planes, fmt, parity=np.asarray(parities))
    got = sangnom2(clip, pool_compat=pool_compat, numerics=numerics, **kw)
    for n in range(nfr):
        for i in range(fmt.num_planes):
            g = np.asarray(got.planes[i])[n]
            wp = np.asarray(want[n][i], dtype=g.dtype)
            if not np.array_equal(g, wp):
                cfails += 1
                print(f"COMPAT MISMATCH case {case}: {fmt.name} {w}x{h} "
                      f"n={nfr} {kw} pool={pool_compat} num={numerics} "
                      f"parities={parities} frame {n} plane {i}", flush=True)
    if case % 20 == 19:
        print(f"compat {case+1}/{NC} done, {cfails} failures", flush=True)
print(f"COMPAT CAMPAIGN DONE: {NC} configs, {cfails} failures")
import sys  # noqa: E402

sys.exit(1 if fails + cfails else 0)  # scripted callers gate on $?
