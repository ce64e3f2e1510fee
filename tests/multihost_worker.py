"""Worker process for the multi-host frame-sharding test.

Launched N times by tests/test_multihost.py (argv: process_id num_processes
port).  Every worker holds only ITS slice of a deterministic global clip,
runs `sangnom2_multihost` over a global 2-process mesh, and checks its
local output shard against the single-process reference computed from the
full clip (tiny shapes, so recomputing the whole expected output locally is
cheap).  Prints CASE_*_OK markers the parent asserts on.
"""

import os
import sys

# The parent test env forces an 8-device CPU platform via XLA_FLAGS; this
# process manages its own device count through jax config instead.
flags = [
    f for f in os.environ.get("XLA_FLAGS", "").split()
    if "xla_force_host_platform_device_count" not in f
]
os.environ["XLA_FLAGS"] = " ".join(flags)

pid, n_proc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])

from sangnom_jax.parallel.multihost import (  # noqa: E402
    initialize_distributed,
    multihost_mesh,
    sangnom2_multihost,
)

initialize_distributed(f"localhost:{port}", n_proc, pid, cpu_devices=2)

import numpy as np  # noqa: E402

from sangnom_jax import sangnom2  # noqa: E402
from sangnom_jax.core.clip import Clip  # noqa: E402
from sangnom_jax.core.formats import get_format  # noqa: E402

fmt = get_format("YUV420P8")
rng = np.random.default_rng(7)
N = 2 * n_proc + 1  # deliberately uneven: the last process holds fewer frames
planes = [
    rng.integers(0, 256, (N, 24, 64)).astype(np.uint8),
    rng.integers(0, 256, (N, 12, 32)).astype(np.uint8),
    rng.integers(0, 256, (N, 12, 32)).astype(np.uint8),
]
parity = rng.integers(0, 2, (N,)).astype(bool)
full = Clip.from_numpy(planes, fmt, parity=parity)

splits = np.array_split(np.arange(N), n_proc)
mine = splits[pid]
lo, hi = int(mine[0]), int(mine[-1]) + 1
local = full[lo:hi]


def check(out, want):
    for i in range(3):
        np.testing.assert_array_equal(
            np.asarray(out.planes[i]), np.asarray(want.planes[i])[lo:hi]
        )


# Case A: pure frame DP across both processes (order=0 exercises the
# per-frame parity path through the global parity array).
mesh = multihost_mesh()  # (n_proc*2) x 1
want = sangnom2(full, order=0, dh=True)
check(sangnom2_multihost(local, mesh, order=0, dh=True), want)
print("CASE_A_OK", flush=True)

# Case B: frames across processes x width inside each process (halo
# exchange stays on the intra-process axis).
mesh2 = multihost_mesh(space=2)  # n_proc x 2
want2 = sangnom2(full, order=1, aa=0, aac=24)
check(
    sangnom2_multihost(local, mesh2, order=1, aa=0, aac=24,
                       space_axis="space"),
    want2,
)
print("CASE_B_OK", flush=True)
