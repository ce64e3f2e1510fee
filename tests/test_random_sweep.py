"""Seeded randomized parity sweep: jnp backend vs the Python scalar spec
across random geometry/format/parameter combinations.

Deterministic (fixed seed), small frames, broad coverage of the parameter
lattice the explicit tests don't enumerate.
"""

import numpy as np
import pytest

from sangnom_jax import Clip, get_format, sangnom2

from conftest import make_planes
from scalar_model import sangnom2_frame_scalar

FMTS = [
    "GRAY8", "GRAY10", "GRAY16", "GRAYS",
    "YUV420P8", "YUV422P12", "YUV444P14", "YUV420PS", "YUVA422P8",
]


@pytest.mark.parametrize("case", range(24))
def test_random_config(case):
    rng = np.random.default_rng(1000 + case)
    fmt = get_format(FMTS[int(rng.integers(len(FMTS)))])
    w = int(rng.integers(2, 24)) * 2  # 4..46 even (subsampling-safe)
    h = int(rng.integers(1, 8)) * 4   # 4..28 mod4 (420-safe)
    order = int(rng.integers(0, 3))
    aa = int(rng.integers(0, 129))
    aac = int(rng.integers(0, 129))
    dh = bool(rng.integers(0, 2))
    luma = bool(rng.integers(0, 2))
    chroma = bool(rng.integers(0, 2))
    tff = bool(rng.integers(0, 2))

    planes = make_planes(rng, w, h, fmt)
    clip = Clip.from_numpy([p[None] for p in planes], fmt, tff=tff)
    got = sangnom2(clip, order=order, aa=aa, aac=aac, dh=dh,
                   luma=luma, chroma=chroma, opt=0)
    want = sangnom2_frame_scalar(
        planes, fmt, order=order, aa=aa, aac=aac, dh=dh,
        luma=luma, chroma=chroma, frame_parity=tff,
    )
    for i, wp in enumerate(want):
        np.testing.assert_array_equal(
            np.asarray(got.planes[i])[0], wp,
            err_msg=f"case {case}: {fmt.name} {w}x{h} order={order} aa={aa} "
                    f"aac={aac} dh={dh} luma={luma} chroma={chroma} tff={tff} "
                    f"plane {i}",
        )
