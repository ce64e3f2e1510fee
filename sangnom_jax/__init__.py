"""sangnom_jax — a JAX video-filter framework (XLA plus a Pallas GPU kernel).

Reimplements the full capability surface of the SangNom2 AviSynth plugin
(reference: Asd-g/AviSynth-SangNom2 v0.6.1): an edge-directed single-field
deinterlacer / anti-aliaser.  The compute path is pure-functional JAX with a
Pallas row-scan kernel for the hot loop on the GPU; batching is over frames
and scaling is `shard_map` over a device mesh.

Public API (mirrors the AviSynth registration surface,
reference src/SangNom2.cpp:481-482):

    sangnom2(clip, order=1, aa=48, aac=0, threads=0, dh=False,
             luma=True, chroma=True, opt=-1) -> Clip
    sangnom(clip, order=1, aa=48, opt=-1) -> Clip          # legacy wrapper

Plus the core containers: `Clip`, `VideoFormat`, the format registry in
`sangnom_jax.core.formats`, and the parallel layer in `sangnom_jax.parallel`.
"""

__version__ = "0.5.0"

# Version of the reference plugin whose capability surface this framework
# replicates (reference src/SangNom2.rc:4-5, CHANGELOG.md:1).
REFERENCE_VERSION = "0.6.1"

from sangnom_jax.core.formats import VideoFormat, get_format, FORMATS  # noqa: E402
from sangnom_jax.core.clip import Clip  # noqa: E402
from sangnom_jax.core.fields import (  # noqa: E402
    bob,
    double_weave,
    separate_fields,
    weave,
)
from sangnom_jax.api import (  # noqa: E402
    SangNom2Filter,
    register_plugin_functions,
    sangnom,
    sangnom2,
)

__all__ = [
    "Clip",
    "VideoFormat",
    "get_format",
    "FORMATS",
    "sangnom2",
    "sangnom",
    "SangNom2Filter",
    "bob",
    "separate_fields",
    "double_weave",
    "weave",
    "register_plugin_functions",
    "__version__",
    "REFERENCE_VERSION",
]
