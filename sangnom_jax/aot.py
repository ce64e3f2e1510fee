"""Ahead-of-time program export/load via jax.export (VERDICT_r4 #2).

The reference is an AOT-compiled .so: the first frame at any resolution
costs nothing beyond the library load (a precompiled path is selected at
construction, reference src/SangNom2.cpp:312-329).  The framework's
persistent XLA compile cache only covers PREVIOUSLY SEEN geometry/param
combos in the cache directory; a fresh process on an unseen geometry
still pays the full trace and lowering.  This module closes the gap with
`jax.export`:

* ``sangnom-jax prewarm --aot DIR --size WxH --format F [params]``
  exports the serialized program(s) for a (format, geometry, params)
  combo;
* ``sangnom-jax IN OUT --aot DIR [params]`` loads them and skips trace
  and lowering.

Coverage: the two single-program dispatch families the CLI rides —
the whole-batch filter program (orders 0/1/2, the body of
`ops.sangnom._sangnom2_jit`; order=0 runs the traced-parity path, which
is bit-identical to the eager static split by the backend contract) and
the fused single-jit bob program (the body of `core.fields._bob_jit`).
``pool_compat`` stays on the jit path (sequential bug-emulation mode; the
persistent cache covers it).  A lookup miss (different shapes/params than
prewarmed) falls back to the normal jit path silently — AOT is a
fast-start overlay, never a correctness surface: the exported program IS
the jit program (same trace, same bits).

Artifacts are keyed by (kind, format, per-plane shapes+dtypes, params,
backend platform, JAX version) — a cpu-exported program never loads on a
GPU and vice versa.  On the GPU the program carries the row-scan kernel as
a Triton custom call, which has no cross-version compatibility guarantee,
so the JAX version is part of the key and export allows that one custom
call target explicitly.  A too-old artifact fails to deserialize and is
treated as a miss (re-prewarm).

An artifact is the `jax.export.Exported` program pickled (its VJP hook
dropped): JAX's own `serialize()` needs the `flatbuffers` package, which
the GPU hosts do not have.  Pickles run code when loaded, so point
``--aot`` only at directories this program's ``prewarm`` wrote.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import threading
from pathlib import Path

import numpy as np

#: process-wide AOT directory (None = disabled); set via configure()
_AOT_DIR: Path | None = None
_CACHE: dict[str, object] = {}  # key -> Exported | None (negative-cached)
_LOCK = threading.Lock()
#: observability: how many jit dispatches were served from AOT artifacts
STATS = {"hits": 0, "misses": 0}


def configure(aot_dir: str | os.PathLike | None) -> None:
    """Enable (or disable with None) AOT lookup for this process."""
    global _AOT_DIR
    with _LOCK:
        _AOT_DIR = Path(aot_dir) if aot_dir else None
        _CACHE.clear()
        STATS["hits"] = STATS["misses"] = 0


def is_configured() -> bool:
    return _AOT_DIR is not None


def _canonical(kind: str, fmt_name: str, shapes, statics: dict) -> str:
    """The canonical JSON the key hashes — includes the backend platform
    (exported programs are platform-locked) and the JAX version (the GPU
    kernel's custom call is only valid for the JAX that lowered it)."""
    import jax

    return json.dumps(
        {
            "kind": kind,
            "fmt": fmt_name,
            "shapes": [[list(s), str(d)] for s, d in shapes],
            "statics": {k: statics[k] for k in sorted(statics)},
            "platform": jax.default_backend(),
            "jax": jax.__version__,
        },
        sort_keys=True,
    )


def program_key(kind: str, fmt_name: str, shapes, statics: dict) -> str:
    """Human-scannable, collision-safe artifact name."""
    canon = _canonical(kind, fmt_name, shapes, statics)
    h = hashlib.sha256(canon.encode()).hexdigest()[:16]
    n, hh, w = shapes[0][0]
    return f"{kind}-{fmt_name}-{w}x{hh}x{n}-{h}"


def plane_shapes(planes) -> tuple:
    """((shape, dtype_str), ...) for key construction from live arrays."""
    return tuple((tuple(p.shape), str(np.dtype(p.dtype))) for p in planes)


def filter_statics(order: int, aa: int, aac: int, dh: bool, luma: bool,
                   chroma: bool, opt: int, numerics: str) -> dict:
    """The static-argument identity of the whole-batch filter program —
    ONE definition shared by prewarm (export) and lookup (load), so the
    key cannot drift between them."""
    return dict(order=order, aa=aa, aac=aac, dh=bool(dh), luma=bool(luma),
                chroma=bool(chroma), opt=opt, numerics=numerics)


def bob_statics(aa: int, aac: int, tff: bool, opt: int,
                numerics: str) -> dict:
    return dict(aa=aa, aac=aac, tff=bool(tff), opt=opt, numerics=numerics)


def _build_fn(kind: str, fmt, statics: dict):
    """The jittable program body for ``kind`` — EXACTLY the corresponding
    jit entry's body, so an AOT call returns the same bits as the jit
    path it replaces."""
    if kind == "filter":
        from sangnom_jax.ops.sangnom import sangnom2_impl

        def fn(planes, parity):
            return sangnom2_impl(tuple(planes), parity, fmt, **statics)

        return fn
    if kind == "bob":
        from sangnom_jax.core.fields import bob_impl

        def fn(planes):
            return bob_impl(tuple(planes), fmt, **statics)

        return fn
    raise ValueError(f"unknown AOT program kind {kind!r}")


def _example_args(kind: str, shapes):
    import jax.numpy as jnp

    planes = tuple(jnp.zeros(s, dtype=d) for s, d in shapes)
    if kind == "filter":
        return (planes, jnp.zeros((shapes[0][0][0],), jnp.bool_))
    return (planes,)


def serialize(exp) -> bytes:
    """An exported program as artifact bytes (see the module docstring)."""
    return pickle.dumps(dataclasses.replace(exp, _get_vjp=None))


def deserialize(blob: bytes):
    """Inverse of `serialize`: the `jax.export.Exported` program."""
    return pickle.loads(blob)


#: the custom call a Pallas Triton kernel lowers to on the GPU
TRITON_CUSTOM_CALL = "__gpu$xla.gpu.triton"


def export_program(kind: str, fmt, shapes, statics: dict,
                   platforms: tuple[str, ...] | None = None) -> bytes:
    """Serialized jax.export artifact for one (kind, fmt, shapes, params)
    program, traced and lowered now (for ``platforms``, default: the
    current backend's)."""
    import jax
    from jax import export as jexport

    fn = _build_fn(kind, fmt, statics)
    exp = jexport.export(
        jax.jit(fn), platforms=platforms,
        disabled_checks=[
            jexport.DisabledSafetyCheck.custom_call(TRITON_CUSTOM_CALL)],
    )(*_example_args(kind, shapes))
    return serialize(exp)


def save_program(aot_dir, kind: str, fmt, shapes, statics: dict) -> Path:
    """Export and write one program artifact; returns its path."""
    import tempfile

    aot_dir = Path(aot_dir)
    aot_dir.mkdir(parents=True, exist_ok=True)
    blob = export_program(kind, fmt, shapes, statics)
    path = aot_dir / f"{program_key(kind, fmt.name, shapes, statics)}.jaxexport"
    # unique temp per writer + atomic rename: concurrent readers never see
    # a torn file, and concurrent PREWARMS of the same combo never share a
    # temp path (last rename wins with a complete artifact either way)
    fd, tmp = tempfile.mkstemp(dir=aot_dir, suffix=".tmp")
    try:
        try:
            os.write(fd, blob)
        finally:
            os.close(fd)
        os.replace(tmp, path)
    except BaseException:
        try:  # do not leave orphaned temp files next to the artifacts
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def warm_call(path) -> float:
    """Deserialize one artifact and execute it once on zeros.  Run with a
    persistent XLA compile cache configured, this lands the ``.call``
    path's backend executable in the cache, so a later ``--aot`` process
    skips BOTH trace+lower (the artifact) and backend compile (the cache).
    Returns the wall seconds of deserialize+first-call."""
    import time

    import jax

    t0 = time.perf_counter()
    exp = deserialize(Path(path).read_bytes())
    flat = [np.zeros(a.shape, a.dtype) for a in exp.in_avals]
    args, kwargs = jax.tree_util.tree_unflatten(exp.in_tree, flat)
    jax.block_until_ready(exp.call(*args, **kwargs))
    return time.perf_counter() - t0


def lookup(kind: str, fmt_name: str, shapes, statics: dict):
    """The deserialized program's ``call`` for this dispatch, or None.
    Cheap when unconfigured (one attribute check); artifacts deserialize
    once per process and negative results are cached too.  The global
    lock guards only the dict — the cold read+deserialize runs OUTSIDE
    it so concurrent dispatches with already-cached keys never stall
    behind one slow load (a duplicate deserialize on a cold race is
    harmless: both produce the same program, last store wins)."""
    aot_dir = _AOT_DIR  # snapshot: configure(None) must not race a
    if aot_dir is None:  # dispatch into `None / key` (TypeError)
        return None
    key = program_key(kind, fmt_name, shapes, statics)
    with _LOCK:
        if key in _CACHE:
            exp = _CACHE[key]
            STATS["hits" if exp is not None else "misses"] += 1
            return None if exp is None else exp.call
    path = aot_dir / f"{key}.jaxexport"
    exp = None
    if path.exists():
        try:
            exp = deserialize(path.read_bytes())
        except Exception as e:  # stale/incompatible artifact -> miss
            import sys

            print(f"warning: AOT artifact {path.name} unusable ({e}); "
                  f"falling back to jit", file=sys.stderr)
            exp = None
    with _LOCK:
        _CACHE[key] = exp
        STATS["hits" if exp is not None else "misses"] += 1
    return None if exp is None else exp.call
