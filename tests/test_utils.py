"""Observability smoke tests."""

import logging

import numpy as np
import pytest

from sangnom_jax import Clip, sangnom2
from sangnom_jax.utils import get_logger, log_dispatch, stage_scope


def test_dispatch_logging_emits_structured_line(caplog):
    lg = get_logger()
    lg.setLevel(logging.INFO)
    with caplog.at_level(logging.INFO, logger="sangnom_jax"):
        log_dispatch(fmt="GRAY8", backend="x", order=1)
    assert any("fmt=GRAY8" in r.message and "order=1" in r.message
               for r in caplog.records)


def test_dispatch_log_fires_on_filter_call(caplog):
    clip = Clip.from_numpy([np.zeros((1, 8, 16), np.uint8)], "GRAY8")
    get_logger().setLevel(logging.INFO)
    with caplog.at_level(logging.INFO, logger="sangnom_jax"):
        sangnom2(clip, order=2, aa=7)  # fresh param combo forces a retrace
    assert any("aa=7" in r.message for r in caplog.records)


def test_stage_scope_usable():
    with stage_scope("unit-test"):
        pass


@pytest.mark.parametrize("device_bytes,frames", [
    (60 * 2**30, 120),  # 75% of an 80 GB card: the 1080p batch in one scan
    (8 * 2**30, 17),
    (2**20, 1),
])
def test_scan_batch_from_device_memory(monkeypatch, device_bytes, frames):
    """The plain path's frame chunk follows the device's memory: six
    [9, bufH+1, S] int32 arrays per frame within half of it."""
    from sangnom_jax.ops import reference

    monkeypatch.setattr(reference, "_device_bytes", lambda: device_bytes)
    g = reference.scan_batch(540, 1920)
    assert g >= frames and g >= 1
    assert g * 6 * 9 * 541 * 1920 * 4 <= max(device_bytes // 2,
                                             6 * 9 * 541 * 1920 * 4)
