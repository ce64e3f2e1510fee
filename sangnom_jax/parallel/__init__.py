"""Multi-chip scaling: device meshes, frame data-parallelism, width sharding.

The reference's only parallelism is host-side frame MT (MT_MULTI_INSTANCE,
reference src/SangNom2.h:63-66) plus SSE2 lanes.  The analogues here:

- frames  -> data parallelism over a mesh axis (zero communication);
             across hosts, the same axis spans processes over DCN
             (sangnom_jax.parallel.multihost)
- width   -> spatial sharding with a `ppermute` halo exchange (the
             context-parallel analogue; rows cannot shard because of the
             vertical smoothing recursion, SURVEY.md §2 quirk 1)
- SIMD    -> the threads of one row-scan kernel program
"""

from sangnom_jax.parallel.multihost import (  # noqa: F401
    initialize_distributed,
    multihost_mesh,
    sangnom2_multihost,
)
from sangnom_jax.parallel.sharding import (  # noqa: F401
    default_mesh,
    sangnom2_sharded,
)
