"""Double-rate bob deinterlace of interlaced content: every field becomes a
full frame (2N output frames), fields sequenced by stream dominance.

    python examples/bob_double_rate.py interlaced.y4m progressive2x.y4m
"""

import sys

from sangnom_jax import bob
from sangnom_jax.io import read_y4m, write_y4m

clip = read_y4m(sys.argv[1])
out = bob(clip)  # SeparateFields -> DoubleWeave -> SangNom2(order=0)
fps = clip.props.get("y4m_fps", (25, 1))
write_y4m(sys.argv[2], out, fps=(fps[0] * 2, fps[1]))
print(f"{clip.num_frames} -> {out.num_frames} frames (double rate)")
