"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh (deterministic, no GPU needed),
so the multi-device sharding paths are checked here too, with the
row-scan kernel in the Pallas interpreter (``SANGNOM_INTERPRET=1``).

Tests marked ``chip`` need the GPU and skip here: chip_smoke.py runs them
in its own process on the card with ``SANGNOM_CHIP_TESTS=1``, which keeps
this file from pinning the CPU.
"""

import os

ON_CHIP = os.environ.get("SANGNOM_CHIP_TESTS") == "1"

if not ON_CHIP:
    os.environ["JAX_PLATFORMS"] = "cpu"
    # opt=1 off the GPU is gated like the reference's "opt=1 requires
    # SSE2." construction check; the suite opts into the interpreter
    os.environ.setdefault("SANGNOM_INTERPRET", "1")
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_CHIP:
    assert jax.default_backend() == "cpu", jax.default_backend()
    assert len(jax.devices()) == 8, jax.devices()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def chip():
    """Skips the test unless JAX runs on a GPU (decided here, at run time,
    never at import).  Run the chip tests with `python chip_smoke.py` on
    the card."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU: run `python chip_smoke.py` on the card")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_plane(rng, h, w, fmt):
    """Random plane with full-range values (exercises wrap/extreme paths)."""
    if fmt.is_float:
        return (rng.random((h, w), dtype=np.float32) * 1.5 - 0.25).astype(
            np.float32
        )
    hi = (1 << fmt.bits) - 1
    # deliberately include out-of-nominal-range code values for >8-bit
    # formats: the reference wraps at the STORAGE width, not nominal bits
    top = min(hi * 2, (1 << (8 * fmt.component_size)) - 1)
    return rng.integers(0, top + 1, size=(h, w)).astype(fmt.dtype)


def make_planes(rng, w, h, fmt):
    planes = []
    for i in range(fmt.num_planes):
        pw, ph = fmt.plane_dims(w, h, i)
        planes.append(make_plane(rng, ph, pw, fmt))
    return planes
