"""Multi-chip scaling: shard a frame batch over a device mesh.

Runs on any device count (falls back to a 1-device mesh); on several GPUs
the 'data' axis spreads frames across cards with zero communication, and
the optional 'space' axis splits plane width with a per-row halo
exchange.

    python examples/sharded_batch.py
"""

import numpy as np

import jax
from sangnom_jax import Clip
from sangnom_jax.parallel import default_mesh, sangnom2_sharded

n_dev = len(jax.devices())
mesh = default_mesh(data=n_dev)
print(f"mesh: {dict(mesh.shape)} over {n_dev} device(s)")

rng = np.random.default_rng(0)
planes = [
    rng.integers(0, 256, (8, 540, 1920)).astype(np.uint8),
    rng.integers(0, 256, (8, 270, 960)).astype(np.uint8),
    rng.integers(0, 256, (8, 270, 960)).astype(np.uint8),
]
clip = Clip.from_numpy(planes, "YUV420P8")
out = sangnom2_sharded(clip, mesh, order=1, dh=True)
jax.block_until_ready(out.planes)
print(f"deinterlaced {out.num_frames} frames -> {out.width}x{out.height}")
