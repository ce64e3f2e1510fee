"""Clip: the frame container pytree.

The reference operates on host-owned `PVideoFrame` plane pointers handed over
one frame at a time (reference src/SangNom2.cpp:343-359).  The JAX-native
equivalent is a batched, device-resident pytree: each plane is one array of
shape ``[num_frames, plane_height, plane_width]`` so a whole clip streams
through `vmap`-batched, jit-compiled transforms with no per-frame host round
trips.  The format is static pytree metadata, so changing it (e.g. `dh`
doubling height) retraces rather than confusing the compiler with dynamic
shapes.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from sangnom_jax.core.formats import VideoFormat, get_format


@jax.tree_util.register_pytree_node_class
class Clip:
    """A batched planar video clip.

    Attributes:
      planes: tuple of arrays, one per plane, each ``[N, Hp, Wp]`` in the
        format's storage dtype.
      format: static `VideoFormat`.
      parity: per-frame field parity, ``[N]`` bool (True = top-field-first),
        the analogue of AviSynth ``GetParity(n)`` consulted by ``order=0``
        (reference src/SangNom2.cpp:338).  ``None`` means constant `tff`.
      tff: scalar default parity used when `parity` is None.
      props: free-form static frame properties (the analogue of the v8 frame
        prop copy in ``NewVideoFrameP``, reference src/SangNom2.cpp:344).
    """

    def __init__(
        self,
        planes: Sequence[jax.Array],
        format: VideoFormat | str,
        parity: Optional[jax.Array] = None,
        tff: bool = True,
        props: Optional[dict[str, Any]] = None,
    ):
        fmt = get_format(format) if isinstance(format, str) else format
        self.planes = tuple(planes)
        self.format = fmt
        self.parity = parity
        self.tff = bool(tff)
        self.props = dict(props) if props else {}

    # -- geometry ---------------------------------------------------------
    @property
    def num_frames(self) -> int:
        return int(self.planes[0].shape[0])

    @property
    def height(self) -> int:
        return int(self.planes[0].shape[1])

    @property
    def width(self) -> int:
        return int(self.planes[0].shape[2])

    @property
    def num_planes(self) -> int:
        return len(self.planes)

    def get_parity(self, n: int) -> bool:
        """Host-side parity query for frame ``n`` (AviSynth GetParity)."""
        if self.parity is not None:
            return bool(np.asarray(self.parity)[n])
        return self.tff

    def parity_array(self) -> jax.Array:
        """Per-frame parity as a device array (used by traced order=0)."""
        if self.parity is not None:
            return jnp.asarray(self.parity, dtype=jnp.bool_)
        return jnp.full((self.num_frames,), self.tff, dtype=jnp.bool_)

    # -- construction helpers ---------------------------------------------
    @classmethod
    def from_numpy(
        cls,
        planes: Sequence[np.ndarray],
        format: VideoFormat | str,
        **kw,
    ) -> "Clip":
        fmt = get_format(format) if isinstance(format, str) else format
        arrs = [jnp.asarray(np.ascontiguousarray(p), dtype=fmt.dtype) for p in planes]
        return cls(arrs, fmt, **kw)

    def __getitem__(self, s) -> "Clip":
        """Frame-range slicing: clip[2:5] -> a 3-frame Clip; a single int
        yields a 1-frame Clip (bounds-checked)."""
        if isinstance(s, int):
            n = self.num_frames
            if not -n <= s < n:
                raise IndexError(f"frame {s} out of range for {n} frames")
            s = s % n
            s = slice(s, s + 1)
        parity = self.parity[s] if self.parity is not None else None
        return Clip(
            [p[s] for p in self.planes], self.format,
            parity=parity, tff=self.tff, props=self.props,
        )

    @classmethod
    def concat(cls, *clips: "Clip") -> "Clip":
        """Concatenate clips along the frame axis (formats must match).
        Differing field dominance is preserved by materializing the
        per-frame parity array."""
        first = clips[0]
        if any(c.format.name != first.format.name for c in clips):
            raise ValueError("concat: mismatched formats")
        planes = [
            jnp.concatenate([c.planes[i] for c in clips], axis=0)
            for i in range(first.num_planes)
        ]
        if (any(c.parity is not None for c in clips)
                or any(c.tff != first.tff for c in clips)):
            parity = jnp.concatenate([c.parity_array() for c in clips])
        else:
            parity = None
        return cls(planes, first.format, parity=parity, tff=first.tff,
                   props=first.props)

    def with_planes(self, planes: Sequence[jax.Array], format=None) -> "Clip":
        """Functional update preserving parity/props (frame-prop carry-over,
        the analogue of reference src/SangNom2.cpp:344)."""
        return Clip(
            planes,
            self.format if format is None else format,
            parity=self.parity,
            tff=self.tff,
            props=self.props,
        )

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        children = (self.planes, self.parity)
        aux = (self.format, self.tff, tuple(sorted(self.props.items())))
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        planes, parity = children
        fmt, tff, props = aux
        return cls(planes, fmt, parity=parity, tff=tff, props=dict(props))

    def __repr__(self) -> str:
        return (
            f"Clip({self.format.name}, frames={self.num_frames}, "
            f"{self.width}x{self.height}, planes={self.num_planes})"
        )
