"""Deinterlace a .y4m file — the simplest end-to-end use.

    python examples/deinterlace_file.py in.y4m out.y4m
"""

import sys

from sangnom_jax import sangnom2
from sangnom_jax.io import read_y4m, write_y4m

clip = read_y4m(sys.argv[1])
out = sangnom2(clip, order=1, aa=48)  # keep top field, default strength
write_y4m(sys.argv[2], out)
print(f"{clip.num_frames} frames {clip.width}x{clip.height} done")
