"""Verify drive: user-style checks on the GPU (.claude/skills/verify/SKILL.md).

1. Diagonal-edge drive: edge-directed interpolation vs naive average.
2. Float path end to end: YUV444PS opt=1 (the row-scan kernel)
   vs opt=0 vs native oracle, bit-exact; all three orders + dh + mixed
   per-frame parity (order=0) on a multi-frame clip.
3. Error probes: exact reference strings
   (/root/reference/src/SangNom2.cpp:399-472).

Run on the GPU (no JAX_PLATFORMS pin); exits non-zero on any failure.
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # repo root, so `python tools/x.py` works uninstalled
import sys

import numpy as np
import jax

def log(*a):
    print(*a, file=sys.stderr, flush=True)

assert jax.default_backend() == "gpu", jax.default_backend()
log("devices:", jax.devices())

from sangnom_jax import Clip, sangnom2, sangnom
from sangnom_jax.api import SangNomError
from sangnom_jax.core.formats import get_format
from sangnom_jax.oracle import sangnom2_frame_oracle

FMT_S = get_format("YUV444PS")

# --- 1. diagonal edge ---
yy, xx = np.mgrid[0:64, 0:64]
full = np.where(xx > yy, 255, 16).astype(np.uint8)
clip = Clip.from_numpy([full[None]], "GRAY8")
res = np.asarray(sangnom2(clip, order=1).planes[0])[0]
assert np.array_equal(res[0::2], full[0::2]), "kept field not verbatim"
k = 31
win = res[k - 1 : k + 2, 26:38]
log("rows around diagonal (k-1 kept, k interp, k+1 kept):")
for r in win:
    log("  ", " ".join(f"{v:3d}" for v in r))
# edge-directed: interpolated row's transition column sits between its
# neighbors' (stairstep), and no ~136 vertical-blur value at the edge
interp_row = res[k]
trans = int(np.argmax(interp_row > 100))
t_up = int(np.argmax(res[k - 1] > 100))
t_dn = int(np.argmax(res[k + 1] > 100))
assert min(t_up, t_dn) <= trans <= max(t_up, t_dn), (trans, t_up, t_dn)
assert not np.any(np.abs(res[k].astype(int) - 136) < 6), "vertical blur at edge"
log(f"edge-directed OK (transition cols: up {t_up}, interp {trans}, dn {t_dn})")

# dh doubles height; legacy remap
resdh = sangnom2(clip, order=1, dh=True)
assert np.asarray(resdh.planes[0]).shape[1] == 128
r_leg = np.asarray(sangnom(clip, order=0).planes[0])[0]
r_new = np.asarray(sangnom2(clip, order=2).planes[0])[0]
assert np.array_equal(r_leg, r_new), "legacy remap broken"
log("dh + legacy remap OK")

# --- 2. float path (the changed surface) ---
rng = np.random.default_rng(42)
N, H, W = 4, 72, 104
planes = [
    (rng.random((N, H, W), np.float32) * 2 - 0.5).astype(np.float32)
    for _ in range(3)
]
fails = 0
for order in (0, 1, 2):
    for dh in (False, True):
        cfg_fails_before = fails
        par_arr = np.array([1, 0, 0, 1], bool) if order == 0 else None
        # mixed per-frame parity (order=0) exercises the per-frame-offset weave
        clip_f = Clip.from_numpy(
            [p.copy() for p in planes], "YUV444PS", parity=par_arr
        )
        o1 = sangnom2(clip_f, order=order, dh=dh, aa=32, aac=16, opt=1)
        o0 = sangnom2(clip_f, order=order, dh=dh, aa=32, aac=16, opt=0)
        for i in range(3):
            a1, a0 = np.asarray(o1.planes[i]), np.asarray(o0.planes[i])
            if not np.array_equal(a1, a0):
                log(f"FAIL opt1-vs-opt0 order={order} dh={dh} plane {i}")
                fails += 1
        # oracle anchor on frame 0 and last
        for n in (0, N - 1):
            par = bool(par_arr[n]) if order == 0 else True
            want = sangnom2_frame_oracle(
                [p[n] for p in planes], FMT_S, order=order, dh=dh,
                aa=32, aac=16, frame_parity=par,
            )
            for i in range(3):
                got = np.asarray(o1.planes[i])[n]
                if not np.array_equal(got, want[i]):
                    d = np.abs(got.astype(np.float64) - want[i].astype(np.float64))
                    log(f"FAIL oracle order={order} dh={dh} f{n} p{i} "
                        f"maxdiff {d.max()} at {np.unravel_index(d.argmax(), d.shape)}")
                    fails += 1
        log(f"float order={order} dh={dh}: opt1==opt0==oracle "
            f"{'OK' if fails == cfg_fails_before else 'FAIL'}")
assert fails == 0, f"{fails} float parity failures"

# --- 3. error probes ---
for kw, msg in [
    (dict(order=5), "SangNom2: order must be between 0..2."),
    (dict(aa=300), "SangNom2: aa must be between 0..128."),
    (dict(opt=7), "SangNom2: opt must be between -1..2."),
]:
    try:
        sangnom2(clip, **kw)
    except SangNomError as e:
        assert str(e) == msg, (str(e), msg)
    else:
        raise AssertionError(f"no error for {kw}")
log("error probes OK")
log("VERIFY DRIVE: ALL OK")
