"""Unit tests for bench.py's regression gate (VERDICT_r4 #3).

The gate is pure logic (no jax import at bench module level), so it is
tested directly: best-of-history aggregation across driver-wrapped and raw
records, the tolerance floor, parity-gated config filtering, and the
never-crash contract for malformed history files.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))
import bench  # noqa: E402


def _rec(value=None, configs=None, wrap=True, **extra):
    rec = {"metric": "1080p_bob_dh_fps_per_chip"}
    if value is not None:
        rec["value"] = value
    if configs is not None:
        rec["configs"] = configs
    rec.update(extra)
    return {"parsed": rec, "rc": 0} if wrap else rec


def test_flatten_wrapped_and_raw():
    cfgs = {"cfg1": {"fps": 100.0, "parity": "ok"},
            "cfg2": {"fps": 50.0, "parity": "FAIL"}}
    flat_w = bench.flatten_bench(_rec(value=10.0, configs=cfgs,
                                      order1_dh_fps=12.0))
    flat_r = bench.flatten_bench(_rec(value=10.0, configs=cfgs,
                                      order1_dh_fps=12.0, wrap=False))
    assert flat_w == flat_r
    assert flat_w["value"] == 10.0 and flat_w["order1_dh_fps"] == 12.0
    # parity-failed configs never enter the floor
    assert "configs.cfg1" in flat_w and "configs.cfg2" not in flat_w


def test_flatten_skips_null_and_nonnumeric():
    flat = bench.flatten_bench(_rec(value=5.0, pool_compat_fps=None,
                                    order1_dh_fps="n/a"))
    assert flat == {"value": 5.0}


def test_best_of_history_and_pass():
    hist = [_rec(value=5700.0), _rec(value=5950.0), _rec(value=5800.0)]
    gate = bench.check_regression(_rec(value=5500.0, wrap=False), hist,
                                  tolerance=0.10)
    assert gate["ok"] and gate["regressions"] == []
    assert gate["best"]["value"] == 5950.0


def test_regression_flagged_below_tolerance():
    hist = [_rec(value=6000.0,
                 configs={"cfgA": {"fps": 9000.0, "parity": "ok"}})]
    cur = _rec(value=5900.0,
               configs={"cfgA": {"fps": 6000.0, "parity": "ok"}}, wrap=False)
    gate = bench.check_regression(cur, hist, tolerance=0.10)
    assert not gate["ok"]
    assert [r["metric"] for r in gate["regressions"]] == ["configs.cfgA"]
    r = gate["regressions"][0]
    assert r["best"] == 9000.0 and r["current"] == 6000.0
    assert abs(r["drop_pct"] - 33.3) < 0.1


def test_boundary_exactly_at_tolerance_passes():
    hist = [_rec(value=1000.0)]
    gate = bench.check_regression(_rec(value=900.0, wrap=False), hist,
                                  tolerance=0.10)
    assert gate["ok"]  # floor is strict-below best*(1-tol)


def test_new_metric_without_history_passes():
    hist = [_rec(value=1000.0)]
    cur = _rec(value=1000.0,
               configs={"new_cfg": {"fps": 1.0, "parity": "ok"}}, wrap=False)
    assert bench.check_regression(cur, hist)["ok"]


def test_metric_absent_this_run_passes():
    # --headline-only runs measure no configs; absent metrics pass vacuously
    hist = [_rec(value=1000.0,
                 configs={"cfgA": {"fps": 9000.0, "parity": "ok"}})]
    gate = bench.check_regression(_rec(value=990.0, wrap=False), hist)
    assert gate["ok"]


def test_history_loader_skips_garbage(tmp_path):
    (tmp_path / "BENCH_r01.json").write_text(json.dumps(_rec(value=100.0)))
    (tmp_path / "BENCH_r02.json").write_text("{not json")
    (tmp_path / "BENCH_r03.json").write_text(json.dumps(_rec(value=200.0)))
    hist = bench.load_bench_history(tmp_path)
    assert len(hist) == 2
    gate = bench.check_regression(_rec(value=100.0, wrap=False), hist)
    assert not gate["ok"] and gate["best"]["value"] == 200.0


def test_committed_history_loads_and_gates_current_best(tmp_path):
    """History records load from a directory, and a run at the best of
    history passes while a 40%-down run is flagged.  The history is
    written here: no record of another machine gates a run."""
    for k, v in enumerate((5000.0, 6000.0, 5500.0, 5800.0)):
        (tmp_path / f"BENCH_r0{k + 1}.json").write_text(
            json.dumps(_rec(value=v)))
    hist = bench.load_bench_history(tmp_path)
    assert len(hist) == 4
    best = bench.check_regression({"value": 1e9}, hist)["best"]
    assert best["value"] == 6000.0
    ok_run = {"value": best["value"]}
    assert bench.check_regression(ok_run, hist)["ok"]
    bad_run = {"value": best["value"] * 0.6}
    assert not bench.check_regression(bad_run, hist)["ok"]


def test_flatten_tolerates_null_parsed():
    """A failed round's driver record carries 'parsed': null — the gate
    must skip it, not crash (round-5 review finding)."""
    assert bench.flatten_bench({"rc": 2, "parsed": None}) == {}
    assert bench.flatten_bench("not a dict") == {}
    hist = [_rec(value=100.0), {"rc": 2, "parsed": None}]
    assert bench.check_regression(_rec(value=100.0, wrap=False), hist)["ok"]


def test_spread_widens_per_metric_tolerance():
    """A metric whose own timing rounds swing beyond the base tolerance
    gets max(base, spread) — contention noise must not false-alarm, while
    stable metrics keep the tight gate."""
    hist = [_rec(value=6000.0,
                 configs={"noisy": {"fps": 9600.0, "parity": "ok"},
                          "stable": {"fps": 9600.0, "parity": "ok"}})]
    cur = _rec(value=5900.0,
               configs={"noisy": {"fps": 8000.0, "parity": "ok"},
                        "stable": {"fps": 8000.0, "parity": "ok"}},
               wrap=False)
    spreads = {"configs.noisy": 0.30, "configs.stable": 0.02}
    gate = bench.check_regression(cur, hist, tolerance=0.10,
                                  spreads=spreads)
    flagged = [r["metric"] for r in gate["regressions"]]
    assert flagged == ["configs.stable"], gate
    assert gate["regressions"][0]["tolerance_pct"] == 10.0  # max(10%, 2%)
