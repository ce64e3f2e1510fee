"""Smoke run of the main path on one GPU: the quickest proof that the
system still starts on the card.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the sharded paths only

Phases (one process; the CLI runs in-process through cli.main):

1. device  — require a GPU; print the devices and the card's name and
   power limit (nvidia-smi).
2. compile — compile the full-width programs (1080i true bob, 1080p
   order=1 dh), print their memory analysis and compile seconds; check
   opt=1 against opt=0 and the native oracle on the parity campaign's
   fixed cases (tools/parity_campaign.py: 8/10/16-bit and float, 4:1:1,
   alpha, odd width, 4K); check bob() against the explicit
   SeparateFields -> DoubleWeave -> SangNom2(order=0) pipeline.
3. main path — a seeded 60-frame 1080i YUV420P8 y4m through the CLI
   (--bob whole clip and --window 8, byte-compared; prewarm then --aot,
   served from artifacts; the `script` verb against --bob), the
   AviSynth-model host and SangNom2Filter against the oracle, and
   pool_compat on 8 frames against the oracle's shared-pool mode.
4. chip tests — the `chip`-marked tests, in this process.
5. rough timings — end-to-end frames/s of the bob and order=1 dh (not
   the benchmark).

Any failed phase exits non-zero before the last line.  The last line of
stdout is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

#: the main-path clip: 1080i YUV420P8, frames in
MAIN_W, MAIN_H, MAIN_N = 1920, 1080, 60
#: --multi: frame width and the frame-sharded batch
MULTI_W, MULTI_N = 1920, 120


def log(*a) -> None:
    print(*a, flush=True)


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


class CacheEvents:
    """Counts JAX persistent compile-cache hits and misses."""

    def __init__(self):
        import jax

        self.hits = self.misses = 0
        jax.monitoring.register_event_listener(self._on_event)

    def _on_event(self, event: str, **_) -> None:
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1


def phase_device(multi: bool):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX found {devs}")
    if multi and len(devs) < 4:
        raise RuntimeError(f"--multi needs 4 GPUs, JAX found {len(devs)}")
    log(f"devices: {devs}")
    log(f"device_kind: {devs[0].device_kind}")
    return devs


def phase_compile(fmt) -> None:
    import jax
    import jax.numpy as jnp

    from parity_campaign import CASES, run_case
    from sangnom_jax import get_format
    from sangnom_jax.core.fields import _bob_jit
    from sangnom_jax.ops.sangnom import _sangnom2_jit

    progs = {
        "bob 1080i x60": (_bob_jit, (
            tuple(jax.ShapeDtypeStruct(s, jnp.uint8) for s in
                  ((60, 1080, 1920), (60, 540, 960), (60, 540, 960))),
            fmt, 48, 0, True, 1, "c")),
        "order=1 dh 1080p x120": (_sangnom2_jit, (
            tuple(jax.ShapeDtypeStruct(s, jnp.uint8) for s in
                  ((120, 540, 1920), (120, 270, 960), (120, 270, 960))),
            jax.ShapeDtypeStruct((120,), jnp.bool_), fmt, 1, 48, 0, True,
            True, True, 1, "c")),
    }
    for name, (fn, args) in progs.items():
        t0 = time.perf_counter()
        compiled = fn.lower(*args).compile()
        log(f"compiled {name} in {time.perf_counter() - t0:.2f}s; "
            f"memory_analysis: {compiled.memory_analysis()}")

    fails, max_ulp = 0, 0
    for k, case in enumerate(CASES):
        t = run_case(k, case)
        fails += t.fails
        is_float = get_format(case[0]).is_float
        max_ulp = max(max_ulp, t.max_ulp)
        log(f"  campaign [{k + 1}/{len(CASES)}] {t.label}: "
            f"{'OK' if not t.fails else f'FAIL ({t.fails})'}"
            + (f", max {t.max_ulp} ulp vs oracle/opt=0" if is_float else ""))
    for tff in (True, False):
        t = run_case(100 + tff, ("YUV420P8", 1920, 1080, 2,
                                 dict(aa=48, aac=0, tff=tff)), mode="bob")
        fails += t.fails
        log(f"  bob() vs explicit pipeline + oracle, tff={tff}: "
            f"{'OK' if not t.fails else f'FAIL ({t.fails})'}")
    log(f"parity: {fails} failures; float max ulp {max_ulp} "
        f"(0 = bit-exact)")
    if fails:
        raise RuntimeError(f"{fails} parity failures")


def _y4m_clip(path: Path, fmt) -> None:
    from sangnom_jax import Clip
    from sangnom_jax.io import write_y4m

    rng = np.random.default_rng(2024)
    planes = [rng.integers(0, 256, (MAIN_N, MAIN_H // d, MAIN_W // d),
                           dtype=np.uint8) for d in (1, 2, 2)]
    write_y4m(str(path), Clip.from_numpy(planes, fmt, tff=True),
              fps=(30000, 1001), interlace="t")


def _cli(*argv) -> None:
    from sangnom_jax import cli

    rc = cli.main([str(a) for a in argv])
    if rc != 0:
        raise RuntimeError(f"cli {' '.join(map(str, argv))} -> rc {rc}")


def phase_main_path(fmt, tmp: Path) -> None:
    from sangnom_jax import Clip, SangNom2Filter, aot, sangnom, sangnom2
    from sangnom_jax.hosts.avisynth import (ArraySource, ScriptEnvironment,
                                            avisynth_plugin_init)
    from sangnom_jax.io import read_y4m
    from sangnom_jax.oracle import sangnom2_clip_oracle, sangnom2_frame_oracle

    src = tmp / "in.y4m"
    _y4m_clip(src, fmt)
    _cli(src, tmp / "bob_whole.y4m", "--bob")
    _cli(src, tmp / "bob_win8.y4m", "--bob", "--window", "8")
    whole = (tmp / "bob_whole.y4m").read_bytes()
    if whole != (tmp / "bob_win8.y4m").read_bytes():
        raise RuntimeError("--bob --window 8 differs from the whole clip")
    log(f"cli --bob whole == --window 8: byte-identical ({len(whole)} B)")

    _cli("prewarm", "--aot", tmp / "aot", "--format", "YUV420P8",
         "--size", f"{MAIN_W}x{MAIN_H}", "--window", "8", "--bob")
    _cli(src, tmp / "bob_aot.y4m", "--bob", "--window", "8", "--aot",
         tmp / "aot")
    if aot.STATS["hits"] == 0:
        raise RuntimeError(f"--aot served nothing from artifacts: "
                           f"{aot.STATS}")
    if (tmp / "bob_aot.y4m").read_bytes() != whole:
        raise RuntimeError("--aot output differs")
    log(f"aot: {aot.STATS['hits']} dispatch(es) served from artifacts, "
        f"{aot.STATS['misses']} miss(es); output byte-identical")
    aot.configure(None)

    recipe = tmp / "bob.avs"
    recipe.write_text(
        "AssumeTFF().SeparateFields().DoubleWeave().SangNom2(order=0)\n")
    _cli("script", recipe, src, tmp / "bob_script.y4m", "--frames", "8")
    got = read_y4m(str(tmp / "bob_script.y4m"))
    want = read_y4m(str(tmp / "bob_whole.y4m"), max_frames=16)
    for i in range(3):
        if not np.array_equal(np.asarray(got.planes[i]),
                              np.asarray(want.planes[i])):
            raise RuntimeError(f"script verb differs from --bob, plane {i}")
    log("cli script (AssumeTFF.SeparateFields.DoubleWeave.SangNom2) == "
        "--bob: 16 frames identical")

    clip = read_y4m(str(src), max_frames=8)
    planes = [np.asarray(p) for p in clip.planes]
    env = ScriptEnvironment()
    avisynth_plugin_init(env)
    flt = env.invoke("SangNom2", ArraySource(planes, fmt), order=1, opt=1)
    frame = flt.get_frame(3, env)
    want = sangnom2_frame_oracle([p[3] for p in planes], fmt, order=1)
    out_f = SangNom2Filter(order=2, aa=64, opt=1)(clip)
    want_f = sangnom2_frame_oracle([p[5] for p in planes], fmt, order=2,
                                   aa=64)
    out_l = sangnom(clip, order=0, opt=1)  # legacy order 0 -> keep bottom
    want_l = sangnom2_frame_oracle([p[0] for p in planes], fmt, order=2)
    for i in range(3):
        for what, g, w in (
                ("AviSynth host", frame.get_read_ptr(i), want[i]),
                ("SangNom2Filter", np.asarray(out_f.planes[i])[5], want_f[i]),
                ("sangnom legacy", np.asarray(out_l.planes[i])[0], want_l[i])):
            if not np.array_equal(np.asarray(g), w):
                raise RuntimeError(f"{what} != oracle, plane {i}")
    log("AviSynth-model host, SangNom2Filter, sangnom: == oracle")

    got = sangnom2(clip, order=1, pool_compat=True)
    frames = [[p[n] for p in planes] for n in range(8)]
    want = sangnom2_clip_oracle(frames, fmt, parities=[True] * 8, order=1,
                                pool_compat=True)
    for n in range(8):
        for i in range(3):
            if not np.array_equal(np.asarray(got.planes[i])[n], want[n][i]):
                raise RuntimeError(f"pool_compat != oracle, frame {n} "
                                   f"plane {i}")
    log("pool_compat 8 frames 1080p YUV420P8 == oracle shared-pool mode")


def phase_chip_tests() -> None:
    import pytest

    os.environ["SANGNOM_CHIP_TESTS"] = "1"  # conftest: keep the GPU

    rc = pytest.main(["-q", "-m", "chip", "-p", "no:cacheprovider",
                      str(ROOT / "tests")])
    if rc != 0:
        raise RuntimeError(f"chip tests: pytest rc {rc}")


def phase_timings(fmt, card_name: str) -> None:
    import jax

    from sangnom_jax import Clip, bob, sangnom2

    rng = np.random.default_rng(7)
    clip_bob = Clip.from_numpy(
        [rng.integers(0, 256, (60, 1080 // d, 1920 // d), dtype=np.uint8)
         for d in (1, 2, 2)], fmt, tff=True)
    clip_dh = Clip.from_numpy(
        [rng.integers(0, 256, (120, 540 // d, 1920 // d), dtype=np.uint8)
         for d in (1, 2, 2)], fmt)
    for name, fn in (("true bob 1080i", lambda: bob(clip_bob).planes),
                     ("order=1 dh 1080p", lambda: sangnom2(
                         clip_dh, order=1, dh=True).planes)):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(10):
            jax.block_until_ready(fn())
        dt = (time.perf_counter() - t0) / 10
        log(f"rough timing {name}: {dt * 1e3:.2f} ms / 120 output frames "
            f"= {120 / dt:.0f} frames/s [{card_name}]")
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    log(f"peak_bytes_in_use: {peak} [{card_name}]")


def phase_multi(fmt) -> None:
    import jax

    from sangnom_jax import Clip, sangnom2
    from sangnom_jax.parallel import default_mesh, sangnom2_sharded

    rng = np.random.default_rng(11)

    def planes_of(n, h):
        return [rng.integers(0, 256, (n, h // d, MULTI_W // d),
                             dtype=np.uint8) for d in (1, 2, 2)]

    h = MULTI_W * 9 // 16  # 16:9 frames
    dh_clip = Clip.from_numpy(planes_of(MULTI_N, h // 2), fmt)
    mixed = Clip.from_numpy(planes_of(32, h), fmt,
                            parity=rng.integers(0, 2, 32).astype(bool))
    wide = Clip.from_numpy(planes_of(8, h), fmt)
    runs = (
        (f"frame-sharded order=1 dh x{MULTI_N}", default_mesh(data=4),
         dh_clip, dict(order=1, dh=True), {}),
        ("frame-sharded order=0 mixed parity x32", default_mesh(data=4),
         mixed, dict(order=0), {}),
        ("width-sharded scan data=2 space=2 x8",
         default_mesh(data=2, space=2), wide, dict(order=1),
         dict(space_axis="space")),
    )
    for name, mesh, clip, kw, skw in runs:
        t0 = time.perf_counter()
        got = sangnom2_sharded(clip, mesh, **kw, **skw)
        jax.block_until_ready(got.planes)
        dt = time.perf_counter() - t0
        want = sangnom2(clip, **kw)
        for i in range(3):
            if not np.array_equal(np.asarray(got.planes[i]),
                                  np.asarray(want.planes[i])):
                raise RuntimeError(f"{name}: plane {i} != single device")
        devs = sorted({d.id for p in got.planes for d in p.devices()})
        log(f"{name}: bit-identical to single-device sangnom2; output "
            f"shards on devices {devs}; first call {dt:.1f}s")
        if len(devs) != 4:
            raise RuntimeError(f"{name}: output spans {len(devs)} devices")


def main(argv: list[str]) -> int:
    multi = "--multi" in argv
    try:
        devs = phase_device(multi)
    except Exception as e:  # noqa: BLE001 — no result line on failure
        log(f"PHASE device FAILED: {e}")
        return 1
    card_name = card()
    log(f"card: {card_name}")
    from sangnom_jax import get_format
    from sangnom_jax.cli import setup_compile_cache

    cache = CacheEvents()
    cache_dir = setup_compile_cache()
    log(f"compile cache: {cache_dir}")
    fmt = get_format("YUV420P8")
    if multi:
        phases = [("multi", lambda: phase_multi(fmt))]
    else:
        phases = [
            ("compile", lambda: phase_compile(fmt)),
            ("main path", lambda: phase_main_path(fmt, Path(tmp))),
            ("chip tests", phase_chip_tests),
            ("timings", lambda: phase_timings(fmt, card_name)),
        ]
    with tempfile.TemporaryDirectory() as tmp:
        for name, run in phases:
            t0 = time.perf_counter()
            try:
                run()
            except Exception as e:  # noqa: BLE001 — reported, then exit 1
                log(f"PHASE {name} FAILED: {type(e).__name__}: {e}")
                return 1
            log(f"phase {name}: ok ({time.perf_counter() - t0:.1f}s)")
    log(f"compile cache {cache_dir}: {cache.hits} hits, {cache.misses} "
        f"misses")
    dev = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
