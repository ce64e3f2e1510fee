"""Smoke test for the streaming attribution harness (tools/stream_attr.py).

Runs the full harness in-process at toy geometry: all five stage timings
produce finite rates, the end-to-end CLI arms run, and the harness's own
byte-identity assertion (serial == overlap output) executes.  Protects
the pipeline instrumentation from bitrot; real numbers come from runs on
the card.
"""

import json
import os
import sys

_TOOLS = os.path.join(os.path.dirname(__file__), os.pardir, "tools")


def test_stream_attr_smoke(capsys, monkeypatch):
    sys.path.insert(0, _TOOLS)
    import stream_attr

    monkeypatch.setattr(sys, "argv",
                        ["stream_attr.py", "6", "64x32", "2"])
    stream_attr.main()
    out = capsys.readouterr().out.strip().splitlines()[-1]
    res = json.loads(out)
    for key in ("read_upload_fps", "read_parse_only_fps", "device_fps",
                "fetch_fps", "serialize_fps", "pipeline_bound_fps",
                "e2e_serial_fps", "e2e_overlap_fps"):
        assert res[key] > 0, (key, res)
    assert res["frames"] == 6
