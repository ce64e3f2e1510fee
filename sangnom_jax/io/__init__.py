"""Clip I/O: YUV4MPEG2 (.y4m) and raw-planar readers/writers.

The reference delegates all frame I/O to its AviSynth host (SURVEY.md §1
layer map, "Host runtime"); a standalone framework needs its own.  y4m is
the lingua franca of deinterlacer pipelines (ffmpeg/mpv/VapourSynth all
speak it), so it is the host-boundary format here.
"""

from sangnom_jax.io.raw import frame_size_bytes, read_raw, write_raw  # noqa: F401
from sangnom_jax.io.y4m import (  # noqa: F401
    iter_y4m,
    read_y4m,
    write_y4m,
    write_y4m_frames,
)
