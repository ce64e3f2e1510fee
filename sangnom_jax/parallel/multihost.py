"""Multi-host (DCN) frame sharding.

The reference scales across threads of ONE host: ``MT_MULTI_INSTANCE``
(reference src/SangNom2.h:63-66) runs N filter instances with private
scratch, zero shared state, one frame each.  The scale axis beyond one
host's directly linked devices is the data-center network — and because
the filter is a stateless per-frame transform (SURVEY.md §2 parallelism
inventory: no cross-frame communication exists anywhere in the reference),
frame sharding across hosts is pure data parallelism.  The only DCN
traffic is a tiny frame-count allgather at setup; width-sharding halos
(`parallel.width_sharded`) stay inside one host because `multihost_mesh`
constrains the 'space' axis to devices of a single process.  (Not yet run
on GPUs: tests drive it on virtual CPU devices in several processes.)

Usage (one process per host, SPMD — every process runs the same code)::

    initialize_distributed(coordinator, num_processes, process_id)
    mesh = multihost_mesh()                  # all global devices
    out_local = sangnom2_multihost(clip_local, mesh, order=1, dh=True)

where ``clip_local`` is the process-LOCAL shard of frames (e.g. each host
reads its own slice of the stream) and ``out_local`` is the matching shard
of the output — no host ever materializes the whole clip.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sangnom_jax.core.clip import Clip


def initialize_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    *,
    cpu_devices: Optional[int] = None,
) -> None:
    """Join the multi-process JAX runtime.

    Thin wrapper over `jax.distributed.initialize` with one extra knob:
    ``cpu_devices`` pins the process to a virtual N-device CPU platform
    BEFORE the distributed service starts (tests / machines without an
    accelerator).
    """
    if cpu_devices is not None:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", cpu_devices)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def multihost_mesh(data: Optional[int] = None, space: int = 1) -> Mesh:
    """A ('data', 'space') mesh over ALL processes' devices.

    Frames shard over 'data' (which may span hosts — communication-free);
    plane width optionally shards over 'space'.  The 'space' axis must fit
    inside one process's devices so the per-row halo exchange
    (width_sharded) stays inside one host, never crossing DCN.
    """
    devices = jax.devices()
    n_proc = jax.process_count()
    if len(devices) % n_proc:
        raise ValueError(
            f"uneven device counts: {len(devices)} devices over "
            f"{n_proc} processes"
        )
    d_local = len(devices) // n_proc
    if space > 1 and d_local % space:
        raise ValueError(
            f"space={space} does not divide the {d_local} local devices of "
            "each process; halo exchange would cross the DCN"
        )
    from sangnom_jax.parallel.sharding import default_mesh

    # jax.devices() is process-contiguous (sorted by process then id), so
    # reshaping (data, space) keeps every 'space' row inside one process.
    return default_mesh(data, space, devices)


def _pad_frames(arr: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad the frame axis to length ``n``."""
    if arr.shape[0] == n:
        return arr
    pad = np.zeros((n - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad])


def _frame_base(garr: jax.Array) -> int:
    """First global frame index owned by this process."""
    return min(s.index[0].start or 0 for s in garr.addressable_shards)


def _local_frames(garr: jax.Array, sharding: NamedSharding, f0: int, n: int) -> np.ndarray:
    """Extract global frames [f0, f0+n) from this process's shards.

    Re-pins to a frame-sharded layout first (eager ops downstream of the
    sharded jit may leave the result replicated), then assembles from
    addressable shards by their global frame slices.
    """
    garr = jax.device_put(garr, sharding)
    out = np.zeros((n,) + garr.shape[1:], dtype=garr.dtype)
    covered = np.zeros((n,), dtype=bool)
    for s in garr.addressable_shards:
        fsl = s.index[0]
        start = fsl.start or 0
        stop = garr.shape[0] if fsl.stop is None else fsl.stop
        lo, hi = max(start, f0), min(stop, f0 + n)
        if lo >= hi:
            continue
        data = np.asarray(s.data)
        out[lo - f0:hi - f0] = data[lo - start:hi - start]
        covered[lo - f0:hi - f0] = True
    if not covered.all():
        raise RuntimeError(
            f"frames {np.flatnonzero(~covered) + f0} of this process's "
            "output shard are not addressable here (unexpected mesh layout)"
        )
    return out


def sangnom2_multihost(
    clip: Clip,
    mesh: Mesh,
    order: int = 1,
    aa: int = 48,
    aac: int = 0,
    threads: int = 0,
    dh: bool = False,
    luma: bool = True,
    chroma: bool = True,
    opt: int = -1,
    data_axis: str = "data",
    space_axis: Optional[str] = None,
) -> Clip:
    """SangNom2 over a multi-process device mesh (SPMD collective call).

    ``clip`` is this process's LOCAL shard of the global clip — processes
    may hold different frame counts (a frame-count allgather evens the
    shards with padding, trimmed from the output).  Returns the local shard
    of the filtered clip as host arrays, same frame count and order as the
    input shard.  Parameter surface and numerics are identical to
    `sangnom_jax.sangnom2` (reference src/SangNom2.cpp:399-435).
    """
    from jax.experimental import multihost_utils

    from sangnom_jax.parallel.sharding import sangnom2_sharded

    n_proc = jax.process_count()
    n_data = mesh.shape[data_axis]
    if n_data % n_proc:
        raise ValueError(
            f"data axis ({n_data}) must be a multiple of the process "
            f"count ({n_proc}) for process-contiguous frame shards"
        )
    d_per_proc = n_data // n_proc

    n_local = clip.num_frames
    counts = np.atleast_1d(
        np.asarray(multihost_utils.process_allgather(np.int64(n_local)))
    )
    # every process pads to the same per-process share so the global frame
    # axis divides evenly over 'data'
    per_proc = -(-int(counts.max()) // d_per_proc) * d_per_proc
    global_n = per_proc * n_proc

    frame_sh = NamedSharding(mesh, P(data_axis))
    gplanes = []
    for p in clip.planes:
        p = _pad_frames(np.asarray(p), per_proc)
        gplanes.append(
            jax.make_array_from_process_local_data(
                frame_sh, p, global_shape=(global_n,) + p.shape[1:]
            )
        )
    par = _pad_frames(np.asarray(clip.parity_array()), per_proc)
    gpar = jax.make_array_from_process_local_data(
        frame_sh, par, global_shape=(global_n,)
    )
    f0 = _frame_base(gplanes[0])

    gclip = Clip(gplanes, clip.format, parity=gpar, tff=clip.tff,
                 props=clip.props)
    out = sangnom2_sharded(
        gclip, mesh, order, aa, aac, threads, dh, luma, chroma, opt,
        data_axis=data_axis, space_axis=space_axis,
    )

    out_planes = [
        _local_frames(p, frame_sh, f0, per_proc)[:n_local] for p in out.planes
    ]
    return Clip(out_planes, clip.format, parity=clip.parity, tff=clip.tff,
                props=clip.props)
