"""Depth-plane sampling: linear or inverse-depth spacing, runtime-selectable.

Replaces the reference's compile-time CRTP pair `LinearDepthVector` /
`InverseDepthVector` (mapper_emvs_stereo/include/mapper_emvs_stereo/
depth_vector.hpp:15-163; compile flag `USE_INVERSE_DEPTH`,
mapper_emvs_stereo/CMakeLists.txt:41-44) with a runtime choice.

Formulas match the reference exactly, including its use of N (not N-1) in the
spacing multiplier, so depths[N-1] != max_depth:
  linear :  d_i = min + i * (max - min) / N
  inverse:  1/d_i = 1/max + i * (1/min - 1/max) / N
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

LINEAR = "linear"
INVERSE = "inverse"


@dataclasses.dataclass(frozen=True)
class DepthVector:
    kind: str
    min_depth: float
    max_depth: float
    n: int

    def __post_init__(self):
        assert self.kind in (LINEAR, INVERSE)
        assert self.min_depth > 0 and self.max_depth > 0 and self.n >= 1
        if self.min_depth > self.max_depth:
            lo, hi = self.max_depth, self.min_depth
            object.__setattr__(self, "min_depth", lo)
            object.__setattr__(self, "max_depth", hi)

    @property
    def _mult(self) -> float:
        if self.kind == LINEAR:
            return self.n / (self.max_depth - self.min_depth)
        return self.n / (1.0 / self.min_depth - 1.0 / self.max_depth)

    def depths(self) -> np.ndarray:
        """All plane depths, shape (n,), float32 (depth_vector.hpp:58-64)."""
        i = np.arange(self.n, dtype=np.float64)
        if self.kind == LINEAR:
            return (self.min_depth + i / self._mult).astype(np.float32)
        return (1.0 / (1.0 / self.max_depth + i / self._mult)).astype(np.float32)

    def cell_index_to_depth(self, i):
        d = jnp.asarray(self.depths())
        return d[jnp.asarray(i, dtype=jnp.int32)]

    def depth_at_index(self, i):
        """Closed-form depths (same formulas as `depths()`) for an integer
        index ARRAY, jit-friendly.

        A fused multiply-add instead of a gather from the (n,)-entry depth
        table for every pixel of the index map.  Matches the table to f32
        rounding (the table is built in f64 and cast; here the fold happens
        in f32 — ≤1 ulp apart, verified by test)."""
        i = jnp.asarray(i, jnp.float32)
        if self.kind == LINEAR:
            return (i * np.float32(1.0 / self._mult)
                    + np.float32(self.min_depth))
        return 1.0 / (i * np.float32(1.0 / self._mult)
                      + np.float32(1.0 / self.max_depth))

    def depth_to_cell(self, depth):
        """Fractional cell coordinate (depth_vector.hpp:108-111,156-159)."""
        depth = jnp.asarray(depth)
        if self.kind == LINEAR:
            return (depth - self.min_depth) * self._mult
        return (1.0 / depth - 1.0 / self.max_depth) * self._mult

    def depth_to_cell_index(self, depth):
        """Nearest cell index (round-half-up, as the C++ +0.5 cast)."""
        return jnp.floor(self.depth_to_cell(depth) + 0.5).astype(jnp.int32)
