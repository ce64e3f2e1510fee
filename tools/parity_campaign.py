"""On-card parity campaign: the row-scan kernel (opt=1) against the plain
XLA path (opt=0) and the native oracle, across format families and
geometries — a fixed case set (``CASES``, also run by chip_smoke.py),
including 4:1:1 chroma, alpha, an odd width and two 4K geometries.

    python tools/parity_campaign.py                # the fixed CASES
    python tools/parity_campaign.py --random N [seed]
    python tools/parity_campaign.py --compat N [seed]   # sse2 / pool_compat
    python tools/parity_campaign.py --bob N [seed]      # fused bob pipeline
    python tools/parity_campaign.py --sharded N [seed]  # width-sharded scan

Integer formats must match bit for bit.  Float formats report the largest
distance in units in the last place (ulp) and fail above
``FLOAT_ULP_LIMIT`` (the documented float contract, docs/PARITY.md).
Exits non-zero on any failure.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sangnom_jax import Clip, get_format, sangnom2  # noqa: E402
from sangnom_jax.oracle import (  # noqa: E402
    sangnom2_clip_oracle,
    sangnom2_frame_oracle,
)

FLOAT_ULP_LIMIT = 1

CASES = [
    # (fmt, w, h, n, kwargs)
    ("GRAY8", 640, 480, 2, dict(order=1)),                 # BASELINE cfg 1
    ("YUV420P8", 640, 480, 2, dict(order=2)),              # cfg 2
    ("YUV420P8", 640, 480, 2, dict(order=1, dh=True)),     # cfg 3
    ("YUV422P10", 1920, 540, 2, dict(order=0, dh=True)),   # cfg 4 (1080i bob)
    ("GRAY16", 1920, 1080, 1, dict(order=1, aa=128, aac=64)),  # cfg 5
    ("YUV444PS", 960, 540, 1, dict(order=2, aa=48, aac=16)),   # cfg 5 float
    ("GRAYS", 1920, 1080, 1, dict(order=1, aa=48)),        # float, full width
    ("YUV420P8", 1920, 1080, 9, dict(order=1, aa=48, aac=48)),  # width tiers
    ("GRAY8", 1919, 1080, 1, dict(order=2)),               # odd width
    ("YUVA420P8", 640, 480, 1, dict(order=1, dh=True)),    # alpha + dh
    ("YUV411P8", 640, 480, 1, dict(order=1, aa=48, aac=48)),  # 4:1:1 chroma
    ("YUV420P8", 3840, 2160, 2, dict(order=1, aa=48, aac=48)),  # 4K
    ("GRAY16", 3840, 1080, 1, dict(order=2, dh=True)),     # 4K-wide u16 dh
]

RANDOM_FORMATS = [
    "GRAY8", "GRAY10", "GRAY16", "YUV420P8", "YUV420P10", "YUV420P16",
    "YUV422P8", "YUV422P12", "YUV444P8", "YUV444P14", "YUV411P8",
    "YUVA420P8", "YUVA444P16", "GRAYS", "YUV444PS",
]


def random_cases(n_cases: int, seed: int):
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n_cases):
        fname = RANDOM_FORMATS[rng.integers(len(RANDOM_FORMATS))]
        # 411 needs w % 4 == 0; keep all dims subsampling-safe via mod 4
        w = int(rng.integers(24, 260)) * 4  # 96..1036
        h = int(rng.integers(4, 180)) * 4  # 16..716
        kw = dict(
            order=int(rng.integers(3)),
            dh=bool(rng.integers(2)),
            aa=int(rng.integers(129)),
            aac=int(rng.integers(129)),
            luma=bool(rng.integers(2)),
            chroma=bool(rng.integers(2)),
        )
        # with dh=False and every processed plane masked off the filter
        # copies the input verbatim (dh=True always processes — SURVEY
        # quirk 7); keep every case a real filter run
        has_chroma = get_format(fname).num_planes > 1
        if not kw["dh"] and not kw["luma"] and not (
            kw["chroma"] and has_chroma
        ):
            kw["luma"] = True
        cases.append((fname, w, h, int(rng.integers(1, 4)), kw))
    return cases


def compat_cases(n_cases: int, seed: int):
    """Random cases over the compat axes (numerics=sse2, pool_compat),
    checked as opt=1 vs opt=0 plus an oracle anchor where the oracle
    implements the case's contract."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n_cases):
        fname = RANDOM_FORMATS[rng.integers(len(RANDOM_FORMATS))]
        w = int(rng.integers(24, 200)) * 4
        h = int(rng.integers(4, 140)) * 4
        kw = dict(
            order=int(rng.integers(3)),
            dh=bool(rng.integers(2)),
            aa=int(rng.integers(129)),
            aac=int(rng.integers(129)),
            pool_compat=bool(rng.integers(2)),
        )
        if not get_format(fname).is_float:
            kw["numerics"] = "sse2" if rng.integers(2) else "c"
            if not kw["pool_compat"] and kw["numerics"] == "c":
                kw["numerics"] = "sse2"  # every case exercises a compat axis
        elif not kw["pool_compat"]:
            # float: numerics='sse2' is a documented no-op (primitives.py)
            kw["pool_compat"] = True
        cases.append((fname, w, h, int(rng.integers(1, 3)), kw))
    return cases


def bob_cases(n_cases: int, seed: int):
    """Random interlaced clips for the fused bob pipeline, checked as
    bob(opt=1) vs the explicit SeparateFields -> DoubleWeave ->
    SangNom2(order=0, opt=0) pipeline plus an oracle anchor."""
    rng = np.random.default_rng(seed)
    fmts = [f for f in RANDOM_FORMATS if "A" not in f]  # alpha falls back
    cases = []
    for _ in range(n_cases):
        fname = fmts[rng.integers(len(fmts))]
        w = int(rng.integers(24, 200)) * 4
        h = int(rng.integers(6, 120)) * 4
        kw = dict(aa=int(rng.integers(129)), aac=int(rng.integers(129)),
                  tff=bool(rng.integers(2)))
        cases.append((fname, w, h, int(rng.integers(1, 4)), kw))
    return cases


def sharded_cases(n_cases: int, seed: int):
    """Random cases through the width-sharded scan on a 1-device
    ('data', 'space') mesh, checked vs the unsharded opt=0 backend plus an
    oracle anchor."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n_cases):
        fname = RANDOM_FORMATS[rng.integers(len(RANDOM_FORMATS))]
        w = int(rng.integers(24, 200)) * 4
        h = int(rng.integers(4, 140)) * 4
        kw = dict(order=int(rng.integers(3)), dh=bool(rng.integers(2)),
                  aa=int(rng.integers(129)), aac=int(rng.integers(129)))
        if not get_format(fname).is_float and rng.integers(2):
            kw["numerics"] = "sse2"
        cases.append((fname, w, h, int(rng.integers(1, 4)), kw))
    return cases


def case_planes(k: int, fname: str, w: int, h: int, n: int):
    """The seeded input planes of case ``k``."""
    rng = np.random.default_rng(500 + k)
    fmt = get_format(fname)
    planes = []
    for i in range(fmt.num_planes):
        pw, ph = fmt.plane_dims(w, h, i)
        if fmt.is_float:
            planes.append(
                (rng.random((n, ph, pw), np.float32) * 2 - 0.5)
                .astype(np.float32))
        else:
            top = (1 << (8 * fmt.component_size)) - 1
            planes.append(
                rng.integers(0, top + 1, (n, ph, pw)).astype(fmt.dtype))
    return planes


def ulp_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance between two float32 arrays in units in the last
    place (0 when bit-identical)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    # map the sign-magnitude bit patterns onto one monotonic integer line
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max(initial=0))


class Tally:
    """Failures and the largest float ulp distance seen, with a log."""

    def __init__(self, label: str):
        self.label, self.fails, self.max_ulp = label, 0, 0

    def compare(self, got, want, what: str, is_float: bool) -> None:
        got, want = np.asarray(got), np.asarray(want)
        if is_float:
            d = ulp_distance(got, want)
            self.max_ulp = max(self.max_ulp, d)
            bad = d > FLOAT_ULP_LIMIT
        else:
            d = None
            bad = not np.array_equal(got, want)
        if bad:
            self.fails += 1
            extra = "" if d is None else f" ({d} ulp)"
            print(f"MISMATCH {self.label}: {what}{extra}", flush=True)


def run_case(k: int, case, mode: str = "oracle") -> Tally:
    """Check one case; ``mode`` is "oracle" (opt=1 and opt=0 vs each other
    and the oracle), "opt0", "bob" or "sharded"."""
    fname, w, h, n, kw = case
    kw = dict(kw)
    fmt = get_format(fname)
    planes = case_planes(k, fname, w, h, n)
    t = Tally(f"{fname} {w}x{h} n={n} {kw}")
    fl = fmt.is_float
    if mode == "bob":
        from sangnom_jax.core.fields import bob, double_weave, separate_fields

        tff = kw.pop("tff")
        clip = Clip.from_numpy(planes, fmt, tff=tff)
        got = bob(clip, opt=1, **kw)
        woven = double_weave(separate_fields(clip))
        want_clip = sangnom2(woven, order=0, opt=0, **kw)
        for i in range(fmt.num_planes):
            t.compare(got.planes[i], want_clip.planes[i],
                      f"bob vs explicit pipeline, plane {i}", fl)
        for fr in sorted({0, 2 * n - 1}):
            want = sangnom2_frame_oracle(
                [np.asarray(p)[fr] for p in woven.planes], fmt, order=0,
                frame_parity=woven.get_parity(fr), **kw)
            for i, wp in enumerate(want):
                t.compare(np.asarray(got.planes[i])[fr], wp,
                          f"bob vs oracle, frame {fr} plane {i}", fl)
        return t
    clip = Clip.from_numpy(planes, fmt)
    if mode == "sharded":
        from sangnom_jax.parallel import default_mesh, sangnom2_sharded

        if kw.get("order") == 0 and n > 1:
            par = np.asarray(np.random.default_rng(k).integers(0, 2, n),
                             dtype=bool)
            clip = Clip.from_numpy(planes, fmt, parity=par)
        got = sangnom2_sharded(clip, default_mesh(data=1, space=1),
                               space_axis="space", **kw)
        want_clip = sangnom2(clip, opt=0, **kw)
        for i in range(fmt.num_planes):
            t.compare(got.planes[i], want_clip.planes[i],
                      f"sharded vs opt=0, plane {i}", fl)
        return t
    got = sangnom2(clip, opt=1, **kw)
    want_clip = sangnom2(clip, opt=0, **kw)
    for i in range(fmt.num_planes):
        t.compare(got.planes[i], want_clip.planes[i],
                  f"opt=1 vs opt=0, plane {i}", fl)
    if kw.get("numerics", "c") != "c":
        # the sse2 contract's ground truth is the compiled reference SSE2
        # itself (tests/test_sse2_numerics.py), not the oracle
        return t
    okw = {key: v for key, v in kw.items() if key != "numerics"}
    frames = [[p[f] for p in planes] for f in range(n)]
    pars = [bool(clip.get_parity(f)) for f in range(n)]
    if mode == "opt0":
        want_o = sangnom2_clip_oracle(frames, fmt, parities=pars, **okw)
    else:
        want_o = {f: sangnom2_frame_oracle(frames[f], fmt,
                                           frame_parity=pars[f], **okw)
                  for f in {0, n - 1}}
    for f in sorted({0, n - 1}):
        for i in range(fmt.num_planes):
            for label, c in (("opt=1", got), ("opt=0", want_clip)):
                t.compare(np.asarray(c.planes[i])[f], want_o[f][i],
                          f"{label} vs oracle, frame {f} plane {i}", fl)
    return t


_MODES = {
    "--sharded": (sharded_cases, "sharded"),
    "--bob": (bob_cases, "bob"),
    "--compat": (compat_cases, "opt0"),
    "--random": (random_cases, "oracle"),
}


def main(argv: list[str]) -> int:
    cases, mode = CASES, "oracle"
    for flag, (gen, m) in _MODES.items():
        if flag in argv:
            i = argv.index(flag)
            try:
                n_rand = int(argv[i + 1])
            except (IndexError, ValueError):
                print(f"usage: parity_campaign.py {flag} N [seed]")
                return 2
            seed = int(argv[i + 2]) if len(argv) > i + 2 else 20260817
            cases, mode = gen(n_rand, seed), m
            print(f"{flag[2:]} campaign: {n_rand} cases, seed {seed}",
                  flush=True)
            break
    fails, max_ulp = 0, 0
    for k, case in enumerate(cases):
        t = run_case(k, case, mode)
        fails += t.fails
        max_ulp = max(max_ulp, t.max_ulp)
        verdict = "OK" if t.fails == 0 else f"FAIL ({t.fails})"
        ulp = f", max {t.max_ulp} ulp" if get_format(case[0]).is_float else ""
        print(f"[{k + 1}/{len(cases)}] {mode} {t.label}: {verdict}{ulp}",
              flush=True)
    print(f"CAMPAIGN DONE: {len(cases)} cases, {fails} failures, "
          f"max float ulp {max_ulp}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
