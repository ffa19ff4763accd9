"""Time-indexed SE(3) trajectory with vectorized linear interpolation.

Batched JAX replacement for the reference's `LinearTrajectory`
(mapper_emvs_stereo/include/mapper_emvs_stereo/trajectory.hpp:7-129): a
`std::map<ros::Time, Transformation>` with per-query SE(3) lerp becomes a
sorted array of poses queried by a batched `searchsorted` + batched lerp —
one fused device computation for all packet timestamps of a chunk instead of
a per-packet binary search on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from . import se3
from .se3 import SE3


class Trajectory(NamedTuple):
    """Sorted pose buffer: ts (N,) float32 seconds, poses: SE3 with batch (N,)."""

    ts: jnp.ndarray
    poses: SE3

    @property
    def n(self) -> int:
        return self.ts.shape[0]

    @property
    def t_start(self):
        return self.ts[0]

    @property
    def t_end(self):
        return self.ts[-1]


def from_arrays(ts, qs, trans) -> Trajectory:
    """Build from numpy/jnp arrays; ts (N,), qs (N,4) wxyz, trans (N,3)."""
    ts = jnp.asarray(ts, dtype=jnp.float32)
    order = jnp.argsort(ts)
    q = se3.quat_normalize(jnp.asarray(qs, dtype=jnp.float32)[order])
    t = jnp.asarray(trans, dtype=jnp.float32)[order]
    return Trajectory(ts[order], SE3(q, t))


def from_matrices(ts, mats) -> Trajectory:
    mats = jnp.asarray(mats, dtype=jnp.float32)
    return from_arrays(ts, se3.matrix_to_quat(mats[..., :3, :3]), mats[..., :3, 3])


def pose_at(traj: Trajectory, t: jnp.ndarray) -> Tuple[SE3, jnp.ndarray]:
    """Interpolated pose at query times t (...,).

    Returns (SE3 with batch shape of t, valid mask).  Queries outside
    [ts[0], ts[-1]] are invalid (no extrapolation), mirroring the reference's
    past/future guards (trajectory.hpp:98-112); the returned pose for invalid
    queries is clamped to the nearest segment and must be masked by callers.
    """
    t = jnp.asarray(t, dtype=traj.ts.dtype)
    # upper_bound(t): first index with ts > t  (trajectory.hpp:99).
    it1 = jnp.searchsorted(traj.ts, t, side="right")
    valid = (it1 > 0) & (it1 < traj.n)
    i1 = jnp.clip(it1, 1, traj.n - 1)
    i0 = i1 - 1
    t0, t1 = traj.ts[i0], traj.ts[i1]
    T0 = SE3(traj.poses.q[i0], traj.poses.t[i0])
    T1 = SE3(traj.poses.q[i1], traj.poses.t[i1])
    alpha = (t - t0) / jnp.maximum(t1 - t0, 1e-12)
    return se3.interpolate(T0, T1, alpha), valid


def apply_right(traj: Trajectory, T: SE3) -> Trajectory:
    """Right-compose every pose with a fixed transform: T_i <- T_i * T.

    Used for hand-eye and camera-extrinsic chains, mirroring
    `applyTransformationRight` (trajectory.hpp:57-63).
    """
    q = jnp.broadcast_to(T.q, traj.poses.q.shape)
    t = jnp.broadcast_to(T.t, traj.poses.t.shape)
    return Trajectory(traj.ts, se3.compose(traj.poses, SE3(q, t)))


def apply_left(traj: Trajectory, T: SE3) -> Trajectory:
    """Left-compose every pose: T_i <- T * T_i (trajectory.hpp:65-71)."""
    q = jnp.broadcast_to(T.q, traj.poses.q.shape)
    t = jnp.broadcast_to(T.t, traj.poses.t.shape)
    return Trajectory(traj.ts, se3.compose(SE3(q, t), traj.poses))


def slice_time(traj: Trajectory, t_start: float, t_stop: float, pad: int = 1) -> Trajectory:
    """Host-side crop to [t_start, t_stop] with `pad` extra poses on each side."""
    ts = np.asarray(traj.ts)
    lo = max(0, int(np.searchsorted(ts, t_start, side="left")) - pad)
    hi = min(len(ts), int(np.searchsorted(ts, t_stop, side="right")) + pad)
    return Trajectory(
        traj.ts[lo:hi],
        SE3(traj.poses.q[lo:hi], traj.poses.t[lo:hi]),
    )
