"""Native scalar oracle: clean-room C++ ground truth + baseline timer.

The reference validates itself only by its dual C/SSE2 backends (SURVEY.md
§4); this framework's oracle plays that role: an independent, natively
compiled scalar implementation of the numerics contract, bound via ctypes.
It is also the measurable stand-in for the reference's single-core C path
when establishing the performance baseline (BASELINE.md), since the
reference publishes no numbers and needs an AviSynth host to run.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from sangnom_jax.core.formats import VideoFormat
from sangnom_jax.core.geometry import buffer_stride_elems

_SRC = Path(__file__).parent / "oracle.cpp"
_BUILD_DIR = Path(__file__).parent / "_build"
_LIB = _BUILD_DIR / "liboracle.so"

_lib: ctypes.CDLL | None = None


def _compile() -> Path:
    _BUILD_DIR.mkdir(exist_ok=True)
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    base = [
        os.environ.get("CXX", "g++"),
        "-O3",
        "-std=c++17",
        "-shared",
        "-fPIC",
        str(_SRC),
        "-o",
        str(_LIB),
    ]
    try:
        subprocess.run(base[:2] + ["-march=native"] + base[2:], check=True,
                       capture_output=True, text=True)
    except subprocess.CalledProcessError:
        # hosts without -march=native support (cross builds, odd toolchains)
        subprocess.run(base, check=True, capture_output=True, text=True)
    return _LIB


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_compile()))
        for name, ptr_t, pool_t in (
            ("sno_deint_u8", ctypes.c_uint8, ctypes.c_int32),
            ("sno_deint_u16", ctypes.c_uint16, ctypes.c_int32),
            ("sno_deint_f32", ctypes.c_float, ctypes.c_float),
        ):
            common = [
                ctypes.POINTER(ptr_t),
                ctypes.POINTER(ptr_t),
                ctypes.c_long,
                ctypes.c_long,
                ctypes.c_long,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_float,
            ]
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = common
            fnp = getattr(lib, name + "_pool")
            fnp.restype = None
            fnp.argtypes = common + [ctypes.POINTER(pool_t), ctypes.c_long]
        _lib = lib
    return _lib


_ENTRY = {
    np.dtype(np.uint8): ("sno_deint_u8", ctypes.c_uint8),
    np.dtype(np.uint16): ("sno_deint_u16", ctypes.c_uint16),
    np.dtype(np.float32): ("sno_deint_f32", ctypes.c_float),
}


def make_pool_oracle(stride: int, pool_rows: int, is_float: bool) -> np.ndarray:
    """Fresh shared-pool state for pool-compat calls: [9, pool_rows+1, S]
    zeros in the oracle's accumulator dtype."""
    return np.zeros(
        (9, pool_rows + 1, stride), np.float32 if is_float else np.int32
    )


def deinterlace_plane_oracle(
    src: np.ndarray, offset: int, dh: bool, aaf: float, stride: int,
    pool: np.ndarray | None = None,
) -> np.ndarray:
    """One plane through the native oracle. src: [h_src, w]; returns
    [h_out, w] in the same dtype. ``aaf`` is the pre-scaled float threshold
    (truncation to the pixel type happens natively, matching the reference's
    float-as-T argument pass, src/SangNom2.cpp:272).

    ``pool``: optional shared-pool state from :func:`make_pool_oracle`,
    mutated in place (pool-compat mode — the reference's cross-plane buffer
    reuse, src/SangNom2.cpp:265-272)."""
    lib = _load()
    name, ptr_t = _ENTRY[src.dtype]
    h_src, w = src.shape
    h_out = 2 * h_src if dh else h_src
    src = np.ascontiguousarray(src)
    dst = np.zeros((h_out, w), dtype=src.dtype)
    args = [
        src.ctypes.data_as(ctypes.POINTER(ptr_t)),
        dst.ctypes.data_as(ctypes.POINTER(ptr_t)),
        w,
        h_src,
        stride,
        int(offset),
        int(dh),
        ctypes.c_float(aaf),
    ]
    if pool is None:
        getattr(lib, name)(*args)
    else:
        assert pool.flags["C_CONTIGUOUS"] and pool.shape[2] == stride
        pool_t = ctypes.c_float if pool.dtype == np.float32 else ctypes.c_int32
        getattr(lib, name + "_pool")(
            *args,
            pool.ctypes.data_as(ctypes.POINTER(pool_t)),
            pool.shape[1] - 1,
        )
    return dst


def sangnom2_frame_oracle(
    planes: list[np.ndarray],
    fmt: VideoFormat,
    order: int = 1,
    aa: int = 48,
    aac: int = 0,
    dh: bool = False,
    luma: bool = True,
    chroma: bool = True,
    frame_parity: bool = True,
) -> list[np.ndarray]:
    """Full frame through the native oracle (same orchestration contract as
    the framework: GetFrame semantics, reference src/SangNom2.cpp:332-397)."""
    from sangnom_jax.core.geometry import scaled_aa_thresholds
    from sangnom_jax.ops.sangnom import field_offset_py

    offset = field_offset_py(order, frame_parity)
    aafs = scaled_aa_thresholds(aa, aac, fmt)
    stride = buffer_stride_elems(planes[0].shape[1], fmt.component_size)
    process = [luma, chroma, chroma]
    out = []
    for i, p in enumerate(planes):
        if i >= 3:
            # alpha: passthrough, line-doubled under dh (framework contract)
            out.append(np.repeat(p, 2, axis=0) if dh else p.copy())
            continue
        if not dh and not process[i]:
            out.append(p.copy())
            continue
        out.append(deinterlace_plane_oracle(p, offset, dh, aafs[i], stride))
    return out


def sangnom2_clip_oracle(
    frames: list[list[np.ndarray]],
    fmt: VideoFormat,
    order: int = 1,
    aa: int = 48,
    aac: int = 0,
    dh: bool = False,
    luma: bool = True,
    chroma: bool = True,
    parities: list[bool] | None = None,
    pool_compat: bool = False,
) -> list[list[np.ndarray]]:
    """A whole clip through the native oracle; with ``pool_compat=True`` the
    ONE luma-geometry pool is threaded through every processed plane of
    every frame in order, reproducing the reference's constructor-allocated
    shared pool (reference src/SangNom2.cpp:303-310, 265-272)."""
    from sangnom_jax.core.geometry import scaled_aa_thresholds
    from sangnom_jax.ops.sangnom import field_offset_py

    aafs = scaled_aa_thresholds(aa, aac, fmt)
    h0, w0 = frames[0][0].shape
    stride = buffer_stride_elems(w0, fmt.component_size)
    pool = None
    if pool_compat:
        pool_rows = (h0 * 2 if dh else h0) // 2
        pool = make_pool_oracle(stride, pool_rows, fmt.is_float)
    process = [luma, chroma, chroma]
    out = []
    for n, planes in enumerate(frames):
        par = parities[n] if parities is not None else True
        offset = field_offset_py(order, par)
        fout = []
        for i, p in enumerate(planes):
            if i >= 3:
                fout.append(np.repeat(p, 2, axis=0) if dh else p.copy())
                continue
            if not dh and not process[i]:
                fout.append(p.copy())
                continue
            fout.append(
                deinterlace_plane_oracle(p, offset, dh, aafs[i], stride, pool)
            )
        out.append(fout)
    return out
