"""Multi-host (DCN) frame sharding: real multi-process jax.distributed run.

Spawns 2 OS processes (tests/multihost_worker.py), each owning only its
slice of the clip, joined through a local coordinator — the CPU-backend
stand-in for one process per host over DCN.  Workers verify their local
output shards bit-exactly against the single-process reference; this test
asserts both workers complete with their CASE markers.
"""

import os
import socket
import subprocess
import sys

N_PROC = 2


def _free_port() -> int:
    """Reserve a genuinely free port via an OS-assigned ephemeral bind
    (a pid-derived constant can collide with any listener in the range)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_multihost_two_processes():
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # worker pins cpu via jax.config
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), str(N_PROC), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for i in range(N_PROC)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert "CASE_A_OK" in out, f"worker {i} missing CASE_A:\n{out}"
        assert "CASE_B_OK" in out, f"worker {i} missing CASE_B:\n{out}"
