"""Classic SangNom2 anti-aliasing recipe: supersample vertically with
dh=True, then downscale externally (or keep the doubled height).

The dh mode treats every source line as a kept field line and synthesizes
the in-between lines edge-directedly — the standard AA building block
(reference README.md:33-37).

    python examples/antialias_2x.py in.y4m out2x.y4m
"""

import sys

from sangnom_jax import sangnom2
from sangnom_jax.io import read_y4m, write_y4m

clip = read_y4m(sys.argv[1])
out = sangnom2(clip, dh=True, aa=48, aac=0)
write_y4m(sys.argv[2], out)
print(f"AA-supersampled to {out.width}x{out.height}")
