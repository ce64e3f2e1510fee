"""Collective-count audit of the width-sharded scan.

The width-sharded backend's communication pattern: per processed plane,
ONE kept-field halo exchange outside the row scan, then one line halo
exchange per ROW inside it — each exchange a left+right `lax.ppermute`
pair (parallel/width_sharded._exchange_halo).  These tests pin the pattern
by counting ppermute equations (and scan trip counts) in the traced
jaxpr, so a refactor that silently adds a collective — or moves one into
the scan — fails here rather than shipping a slower program.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from sangnom_jax.core.formats import get_format
from sangnom_jax.parallel.sharding import _sharded_jit


def _count(jaxpr, in_scan=False, acc=None):
    """Recursively count ppermute eqns (with operand dtype/shape — the
    BYTES side of the contract), split by scan-body membership, and record
    top-level scan trip counts."""
    if acc is None:
        acc = {"outside": 0, "inside_scan": 0, "scan_lengths": [],
               "operands": []}
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "ppermute":
            acc["inside_scan" if in_scan else "outside"] += 1
            v = eqn.invars[0].aval
            acc["operands"].append(
                ("scan" if in_scan else "top", str(v.dtype),
                 tuple(v.shape)))
        sub_in_scan = in_scan or name in ("scan", "while")
        if name == "scan" and not in_scan:
            acc["scan_lengths"].append(eqn.params.get("length"))
        for v in eqn.params.values():
            for x in v if isinstance(v, (list, tuple)) else [v]:
                if hasattr(x, "jaxpr"):
                    _count(x.jaxpr, sub_in_scan, acc)
                elif hasattr(x, "eqns"):
                    _count(x, sub_in_scan, acc)
    return acc


def _audit(fname, opt, w=256, h=16, n_frames=2):
    fmt = get_format(fname)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(1, 8),
                ("data", "space"))
    rng = np.random.default_rng(0)
    planes = []
    for i in range(fmt.num_planes):
        pw, ph = fmt.plane_dims(w, h, i)
        planes.append(jnp.asarray(
            rng.integers(0, 256, (n_frames, ph, pw)).astype(fmt.dtype)))
    parity = jnp.zeros((n_frames,), bool)
    jx = jax.make_jaxpr(
        lambda pl, pa: _sharded_jit(
            pl, pa, mesh=mesh, fmt=fmt, order=1, aa=48, aac=0, dh=True,
            luma=True, chroma=True, opt=opt, numerics="c",
            data_axis="data", space_axis="space", plane_widths=tuple(p.shape[2] for p in planes),
            stride=w,
        )
    )(tuple(planes), parity)
    return _count(jx.jaxpr)


def test_scan_backend_exchanges_per_row():
    """YUV420P8: two plane passes (Y, then the UV-fused batch), each with
    one kept exchange outside its scan and one line exchange inside it,
    the scan running once per ROW (luma 15 rows, chroma 7)."""
    acc = _audit("YUV420P8", 0)
    assert acc["outside"] == 4, acc
    assert acc["inside_scan"] == 4, acc
    assert sorted(acc["scan_lengths"]) == [7, 15], acc


@pytest.mark.parametrize("opt", [0, 1])
def test_scan_collectives_gray8(opt):
    """GRAY8 256x16 dh over 8 width shards (W_loc=32), whatever ``opt``:
    2 ppermutes outside the scan (the kept exchange), 2 inside (the line
    exchange), one scan of bufH-1 = 15 rows, each exchange 3 columns of
    the int32 accumulator."""
    acc = _audit("GRAY8", opt)
    assert (acc["outside"], acc["inside_scan"]) == (2, 2), acc
    assert acc["scan_lengths"] == [15], acc
    assert acc["operands"] == [
        ("top", "int32", (2, 16, 3)),
        ("top", "int32", (2, 16, 3)),
        ("scan", "int32", (9, 2, 3)),
        ("scan", "int32", (9, 2, 3)),
    ], acc["operands"]


def test_scan_collectives_frame_count_independent():
    """Communication scales with plane passes, not frames: 16 frames trace
    the same ppermute sites and trip counts as 2."""
    a = _audit("GRAY8", 0, n_frames=2)
    b = _audit("GRAY8", 0, n_frames=16)
    assert (a["outside"], a["inside_scan"], a["scan_lengths"]) == (
        b["outside"], b["inside_scan"], b["scan_lengths"])
