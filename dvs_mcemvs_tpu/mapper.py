"""Per-camera EMVS mapper: DSI setup, event back-projection, extraction.

JAX equivalent of `EMVS::MapperEMVS`
(reference: mapper_emvs_stereo/include/mapper_emvs_stereo/mapper_emvs_stereo.hpp:94-155
and src/mapper_emvs_stereo.cpp).  Where the reference is a mutable object with
a `Grid3D dsi_` member filled in place, this is an immutable per-camera setup
(virtual camera, rectification LUT, depth planes — all init-time constants)
whose `evaluate_dsi` is a pure, jittable array function: events in, (Z, H, W)
DSI out.  Fusion then happens on plain arrays (see `pipeline.py`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ops import camera as camops, extract, grid as gridops, pointcloud as pcops, se3, trajectory as trajmod, voting
from .ops.camera import PinholeCamera, rectify_lut, virtual_camera
from .ops.depth_vector import DepthVector, INVERSE, LINEAR
from .ops.se3 import SE3


@dataclasses.dataclass(frozen=True)
class DsiShape:
    """Mirrors EMVS::ShapeDSI (mapper_emvs_stereo.hpp:40-65)."""

    dim_x: int = 0  # 0 = use camera resolution (cpp:233-235)
    dim_y: int = 0
    dim_z: int = 100
    fov_deg: float = 0.0  # < 10 = use camera focal length (cpp:222-231)
    min_depth: float = 0.3
    max_depth: float = 10.0


class Events(NamedTuple):
    """A chunk of events from one camera; arrays sorted by timestamp."""

    x: np.ndarray  # (E,) int
    y: np.ndarray  # (E,) int
    t: np.ndarray  # (E,) float seconds
    p: Optional[np.ndarray] = None  # (E,) polarity in {0,1} / {-1,1}, optional

    @property
    def num(self) -> int:
        return int(self.x.shape[0])

    def slice(self, lo: int, hi: int) -> "Events":
        p = None if self.p is None else self.p[lo:hi]
        return Events(self.x[lo:hi], self.y[lo:hi], self.t[lo:hi], p)

    def time_window(self, t0: float, t1: float) -> "Events":
        lo = int(np.searchsorted(self.t, t0, side="left"))
        hi = int(np.searchsorted(self.t, t1, side="right"))
        return self.slice(lo, hi)


@dataclasses.dataclass(frozen=True)
class Mapper:
    """Immutable per-camera mapping setup (ctor + setupDSI + LUT of the
    reference, src/mapper_emvs_stereo.cpp:29-64,208-299)."""

    cam: PinholeCamera
    vcam: PinholeCamera
    depth_vec: DepthVector
    lut: np.ndarray  # (H*W, 2) float32 rectified pixel coordinates

    @property
    def width(self) -> int:
        return self.vcam.width

    @property
    def height(self) -> int:
        return self.vcam.height

    @property
    def dsi_shape(self) -> Tuple[int, int, int]:
        return (self.depth_vec.n, self.vcam.height, self.vcam.width)


def make_mapper(
    cam: PinholeCamera,
    shape: DsiShape,
    depth_sampling: str = LINEAR,
) -> Mapper:
    """Build the per-camera setup.

    `depth_sampling` replaces the reference's compile-time USE_INVERSE_DEPTH
    (mapper_emvs_stereo.hpp:34-38) with a runtime choice.
    """
    dim_x = shape.dim_x or cam.width
    dim_y = shape.dim_y or cam.height
    vcam = virtual_camera(dim_x, dim_y, shape.fov_deg, cam)
    dv = DepthVector(depth_sampling, shape.min_depth, shape.max_depth, shape.dim_z)
    lut = rectify_lut(cam)
    return Mapper(cam=cam, vcam=vcam, depth_vec=dv, lut=lut)


# ---------------------------------------------------------------------------
# DSI evaluation (evaluateDSI, cpp:67-148)
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("z0", "width", "height", "vcam_params", "packet_size",
                     "backend", "plane_block", "rect_params"),
)
def _evaluate_dsi_jit(
    x, y, t, traj_ts, traj_q, traj_t, T_rv_w_q, T_rv_w_t, lut, K_cam, Kv_inv,
    depths, z0, width, height, vcam_params, packet_size, backend, plane_block,
    rect_params=None, ev_weight=None,
):
    traj = trajmod.Trajectory(traj_ts, SE3(traj_q, traj_t))
    packets = voting.warp_events_to_z0(
        x, y, t, traj, SE3(T_rv_w_q, T_rv_w_t), lut, K_cam, Kv_inv,
        z0=z0, width=width, packet_size=packet_size, rect_params=rect_params,
        ev_weight=ev_weight, full=ev_weight is not None,
    )
    fn = voting.resolve_backend(backend)
    return fn(packets, depths, z0, vcam_params, width, height, plane_block=plane_block)


def bucket_capacity(n: int, packet_size: int) -> int:
    """Smallest power-of-two packet count covering n events.

    Quantizing chunk buffers to capacity buckets keeps `_evaluate_dsi_jit`'s
    traced shapes stable across full_seq chunks: O(log E) compiles for a
    whole run instead of one per chunk (the reference re-reads and
    re-processes exact-size buffers every chunk, main.cpp:191-199)."""
    k = -(-n // packet_size)
    return packet_size * (1 << max(k - 1, 0).bit_length())


def evaluate_dsi(
    mapper: Mapper,
    events: Events,
    traj: trajmod.Trajectory,
    T_rv_w: SE3,
    packet_size: int = voting.DEFAULT_PACKET_SIZE,
    backend: str = "scatter",
    plane_block: int = 8,
    rectify: str = "device",
    pad: str = "none",
) -> Optional[jnp.ndarray]:
    """Back-project a chunk of events into a fresh (Z, H, W) DSI.

    Returns None when the chunk is smaller than one packet, mirroring the
    reference's `evaluateDSI` false return (cpp:71-75).

    `rectify` = "device" recomputes event rectification analytically on
    the device, fused into the warp; "lut" gathers the precomputed host LUT (the
    reference-parity path, src/mapper_emvs_stereo.cpp:129-142).

    `pad` = "bucket" pads the event buffer with zero-weight events to a
    power-of-two packet capacity (`bucket_capacity`): jit shapes stay
    stable across varying chunk sizes AND the trailing partial packet votes
    (the reference drops events beyond the last full packet, cpp:88;
    pad="none" keeps that drop semantics exactly).
    """
    if events.num <= packet_size:
        return None
    return _evaluate_dsi_jit(*dsi_step_args(
        mapper, events, traj, T_rv_w, packet_size, backend, plane_block,
        rectify, pad))


def dsi_step_args(
    mapper: Mapper,
    events: Events,
    traj: trajmod.Trajectory,
    T_rv_w: SE3,
    packet_size: int = voting.DEFAULT_PACKET_SIZE,
    backend: str = "scatter",
    plane_block: int = 8,
    rectify: str = "device",
    pad: str = "none",
) -> tuple:
    """The positional arguments `evaluate_dsi` passes to its jitted voting
    step `_evaluate_dsi_jit` (so callers can lower and inspect the exact
    step the pipeline runs)."""
    ev_weight = None
    x_arr, y_arr, t_arr = events.x, events.y, events.t
    if pad == "bucket":
        cap = bucket_capacity(events.num, packet_size)
        extra = cap - events.num
        x_arr = np.pad(np.asarray(x_arr), (0, extra))
        y_arr = np.pad(np.asarray(y_arr), (0, extra))
        t_arr = np.pad(np.asarray(t_arr), (0, extra), mode="edge")
        w = np.zeros(cap, np.float32)
        w[:events.num] = 1.0
        ev_weight = jnp.asarray(w)
    elif pad != "none":
        raise ValueError(f"pad must be 'none' or 'bucket', got {pad!r}")
    depths = jnp.asarray(mapper.depth_vec.depths())
    z0 = float(mapper.depth_vec.depths()[0])
    vp = (
        float(mapper.vcam.fx), float(mapper.vcam.fy),
        float(mapper.vcam.cx), float(mapper.vcam.cy),
    )
    K_cam = jnp.asarray(mapper.cam.P, jnp.float32)
    Kv_inv = jnp.asarray(np.linalg.inv(mapper.vcam.P), jnp.float32)
    rect_params = camops.rect_static(mapper.cam) if rectify == "device" else None
    return (
        jnp.asarray(x_arr, jnp.int32),
        jnp.asarray(y_arr, jnp.int32),
        jnp.asarray(t_arr, jnp.float32),
        traj.ts, traj.poses.q, traj.poses.t,
        T_rv_w.q, T_rv_w.t,
        jnp.asarray(mapper.lut), K_cam, Kv_inv, depths,
        z0, mapper.width, mapper.height, vp, packet_size, backend, plane_block,
        rect_params, ev_weight,
    )


def get_depth_map(
    mapper: Mapper, dsi: jnp.ndarray, options: extract.DepthMapOptions
) -> extract.DepthMapResult:
    """getDepthMapFromDSI on this mapper's depth planes (cpp:332-437)."""
    return extract.get_depth_map_from_dsi(dsi, mapper.depth_vec, options)


@dataclasses.dataclass(frozen=True)
class PointCloudOptions:
    """Mirrors EMVS::OptionsPointCloud (mapper_emvs_stereo.hpp:84-89)."""

    radius_search: float = 0.05
    min_num_neighbors: int = 3


def get_pointcloud(
    mapper: Mapper,
    depth: np.ndarray,
    mask: np.ndarray,
    options: PointCloudOptions,
    backend: str = "kdtree",
) -> pcops.PointCloud:
    """getPointcloud (cpp:440-480): unproject + radius outlier removal."""
    pc = pcops.depth_map_to_pointcloud(np.asarray(depth), np.asarray(mask), mapper.vcam)
    return pcops.radius_outlier_removal(
        pc, options.radius_search, options.min_num_neighbors, backend=backend
    )
