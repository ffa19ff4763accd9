"""Sharded multi-camera mapping step: pjit/shard_map over ("event", "plane").

The full MC-EMVS chunk step — per-camera event warp, depth-plane voting,
cross-camera fusion, Z-collapse, depth-map extraction — compiled once over a
device mesh.  Replaces both the reference's OpenMP loop over depth planes
(reference: mapper_emvs_stereo/src/mapper_emvs_stereo.cpp:166-172) and its
absent multi-node layer with XLA collectives:

  - events are sharded along the "event" mesh axis; each shard votes a
    partial DSI for its slice of the stream and a `psum` over "event"
    reconstructs the exact grid (voting is a linear sum over events,
    cpp:174-203, so the reduction is exact up to float reassociation);
  - depth planes are sharded along the "plane" axis; voting needs zero
    communication there (each shard owns its z-block, same invariant as the
    OpenMP threads), and only the collapsed 2D (confidence, argmax) maps are
    `all_gather`ed for the global depth decision;
  - the post-collapse extraction chain (adaptive threshold, masked median)
    runs replicated — it is 2D and cheap relative to voting.

Event buffers are padded to equal shard/packet multiples with zero-weight
events instead of dropping tails (see `pad_events_for_sharding`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..mapper import Events, Mapper
from ..ops import extract, grid as gridops, trajectory as trajmod, voting
from ..ops.se3 import SE3
from .mesh import EVENT_AXIS, PLANE_AXIS


@dataclasses.dataclass(frozen=True)
class ShardedRigSpec:
    """Static (hashable) description of the rig and DSI geometry."""

    n_cameras: int
    width: int
    height: int
    dim_z: int
    z0: float
    vcam_params: Tuple[float, float, float, float]  # fx, fy, cx, cy of RV cam
    # Optional depth sampling (frozen/hashable): lets extraction run the
    # closed-form index→depth arithmetic instead of a table gather.
    depth_vec: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class ShardedStepConfig:
    """Static algorithm knobs of the fused step."""

    fusion_method: int = gridops.FUSE_HM
    packet_size: int = voting.DEFAULT_PACKET_SIZE
    backend: str = "scatter"
    plane_block: int = 8
    extract_options: extract.DepthMapOptions = extract.DepthMapOptions()


def rig_spec_from_mappers(mappers: Sequence[Mapper]) -> ShardedRigSpec:
    m0 = mappers[0]
    return ShardedRigSpec(
        n_cameras=len(mappers),
        width=m0.width,
        height=m0.height,
        dim_z=m0.depth_vec.n,
        z0=float(m0.depth_vec.depths()[0]),
        vcam_params=(
            float(m0.vcam.fx), float(m0.vcam.fy),
            float(m0.vcam.cx), float(m0.vcam.cy),
        ),
        depth_vec=m0.depth_vec,
    )


def pad_events_for_sharding(
    events: Sequence[Events],
    n_event_shards: int,
    packet_size: int = voting.DEFAULT_PACKET_SIZE,
    capacity: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-camera events into (ncam, E_pad) arrays with vote weights.

    E_pad is a common multiple of `n_event_shards * packet_size` covering the
    largest camera stream (or the explicit `capacity` — use a fixed capacity
    to keep jit shapes stable across chunks).  Padding events carry weight 0
    and the camera's last timestamp, so they land in valid packets but
    contribute nothing (the sharded splat weighs every vote by `w`).
    """
    quantum = n_event_shards * packet_size
    max_e = max(ev.num for ev in events)
    if capacity is not None:
        if capacity < max_e:
            raise ValueError(f"capacity {capacity} < largest stream {max_e}")
        max_e = capacity
    # All-empty streams still pad to one quantum (weight-0) so the step's
    # shapes stay valid; the votes are inert either way.
    e_pad = int(-(-max(max_e, 1) // quantum) * quantum)

    ncam = len(events)
    x = np.zeros((ncam, e_pad), np.int32)
    y = np.zeros((ncam, e_pad), np.int32)
    t = np.zeros((ncam, e_pad), np.float32)
    w = np.zeros((ncam, e_pad), np.float32)
    for c, ev in enumerate(events):
        n = ev.num
        x[c, :n] = ev.x
        y[c, :n] = ev.y
        t[c, :n] = ev.t
        w[c, :n] = 1.0
        t[c, n:] = ev.t[-1] if n else 0.0
    return x, y, t, w


def _local_step(
    spec: ShardedRigSpec,
    cfg: ShardedStepConfig,
    n_plane: int,
    x, y, t, w,
    traj_ts, traj_q, traj_t,
    rv_q, rv_t,
    lut, K_cam, Kv_inv, depths,
):
    """Per-device body (runs under shard_map).

    x, y, t, w: (ncam, E_local); traj_*: per-camera replicated pose tables;
    depths: full (Z,) plane table — each device slices its z-block.
    Returns (fused local DSI block, global confidence, global depth index).
    """
    zblock = spec.dim_z // n_plane
    pi = jax.lax.axis_index(PLANE_AXIS)
    local_depths = jax.lax.dynamic_slice(depths, (pi * zblock,), (zblock,))

    splat = voting.resolve_backend(cfg.backend)
    splat_kw = {}
    if cfg.backend.startswith("hist"):
        # Global correction midpoint: every plane shard bins events with the
        # same first-order sweep correction, so the plane-sharded grid
        # equals the single-device one (not just approximates it).
        u_full = 1.0 / depths
        splat_kw["corr_u_mid"] = 0.5 * (jnp.min(u_full) + jnp.max(u_full))
    dsis = []
    for c in range(spec.n_cameras):
        traj = trajmod.Trajectory(traj_ts[c], SE3(traj_q[c], traj_t[c]))
        packets = voting.warp_events_to_z0(
            x[c], y[c], t[c], traj, SE3(rv_q, rv_t), lut[c], K_cam[c], Kv_inv,
            z0=spec.z0, width=spec.width, packet_size=cfg.packet_size,
            ev_weight=w[c], full=True,
        )
        dsi_c = splat(
            packets, local_depths, spec.z0, spec.vcam_params,
            spec.width, spec.height, plane_block=cfg.plane_block, **splat_kw,
        )
        # Exact reconstruction of the single-device grid: voting is linear in
        # events, so partial grids sum (DSI additivity, SURVEY.md §4).
        dsi_c = jax.lax.psum(dsi_c, EVENT_AXIS)
        dsis.append(dsi_c)

    fused = gridops.fuse_many(dsis, cfg.fusion_method)

    # Local collapse over the z-block, then a global depth decision from the
    # gathered per-shard (max, argmax) pairs.  Ties resolve to the lowest z
    # (first occurrence), matching a sequential scan of the full axis.
    conf_l, idx_l = gridops.collapse(fused, cfg.extract_options.collapse_method)
    idx_l = idx_l.astype(jnp.int32) + pi * zblock
    confs = jax.lax.all_gather(conf_l, PLANE_AXIS)   # (n_plane, H, W)
    idxs = jax.lax.all_gather(idx_l, PLANE_AXIS)
    best = jnp.argmax(confs, axis=0)
    conf = jnp.take_along_axis(confs, best[None], axis=0)[0]
    idx = jnp.take_along_axis(idxs, best[None], axis=0)[0]
    return fused, conf, idx


def make_sharded_step(
    mesh: Mesh,
    spec: ShardedRigSpec,
    cfg: ShardedStepConfig = ShardedStepConfig(),
) -> Callable[..., Dict[str, jnp.ndarray]]:
    """Compile the full chunk step over `mesh`.

    Returns step(x, y, t, w, traj_ts, traj_q, traj_t, rv_q, rv_t, lut,
                 K_cam, Kv_inv, depths) -> dict with:
      "dsi":   (Z, H, W) fused DSI, sharded over planes on the mesh
      "depth", "confidence", "mask", "depth_indices": replicated 2D maps
    """
    n_plane = mesh.shape[PLANE_AXIS]
    if spec.dim_z % n_plane != 0:
        raise ValueError(f"dim_z {spec.dim_z} not divisible by plane shards {n_plane}")

    local = functools.partial(_local_step, spec, cfg, n_plane)

    ev_spec = P(None, EVENT_AXIS)     # (ncam, E) events sharded over streams
    rep = P()
    sharded = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(ev_spec, ev_spec, ev_spec, ev_spec,
                  rep, rep, rep, rep, rep, rep, rep, rep, rep),
        out_specs=(P(PLANE_AXIS), rep, rep),
        check_vma=False,
    )

    def step(x, y, t, w, traj_ts, traj_q, traj_t, rv_q, rv_t,
             lut, K_cam, Kv_inv, depths):
        fused, conf, idx = sharded(
            x, y, t, w, traj_ts, traj_q, traj_t, rv_q, rv_t,
            lut, K_cam, Kv_inv, depths,
        )
        result = extract.extract_from_collapsed(conf, idx, depths,
                                                cfg.extract_options,
                                                depth_vec=spec.depth_vec)
        return {
            "dsi": fused,
            "depth": result.depth,
            "confidence": result.confidence,
            "mask": result.mask,
            "depth_indices": result.depth_indices,
        }

    ev_sh = NamedSharding(mesh, ev_spec)
    rep_sh = NamedSharding(mesh, rep)
    return jax.jit(
        step,
        in_shardings=(ev_sh, ev_sh, ev_sh, ev_sh,
                      rep_sh, rep_sh, rep_sh, rep_sh, rep_sh,
                      rep_sh, rep_sh, rep_sh, rep_sh),
    )


def make_sharded_voting_step(
    mesh: Mesh,
    spec: ShardedRigSpec,
    cfg: ShardedStepConfig = ShardedStepConfig(),
) -> Callable[..., jnp.ndarray]:
    """Voting-only variant of `make_sharded_step`: returns the per-camera
    DSIs (ncam, Z, H, W), event-psum'ed and plane-sharded on the mesh, with
    NO fusion or collapse.

    This is the building block of the sharded temporal algorithms
    (process_2/5): each sub-interval votes on the mesh, and the streaming
    HM/AM accumulators stay plane-sharded between calls — they are
    elementwise, so temporal fusion adds zero communication
    (reference: src/process2.cpp:211-242; SURVEY.md §5 long-sequence row).
    """
    n_plane = mesh.shape[PLANE_AXIS]
    if spec.dim_z % n_plane != 0:
        raise ValueError(
            f"dim_z {spec.dim_z} not divisible by plane shards {n_plane}")

    def local(x, y, t, w, traj_ts, traj_q, traj_t, rv_q, rv_t,
              lut, K_cam, Kv_inv, depths):
        zblock = spec.dim_z // n_plane
        pi = jax.lax.axis_index(PLANE_AXIS)
        local_depths = jax.lax.dynamic_slice(depths, (pi * zblock,), (zblock,))
        splat = voting.resolve_backend(cfg.backend)
        splat_kw = {}
        if cfg.backend.startswith("hist"):
            u_full = 1.0 / depths
            splat_kw["corr_u_mid"] = 0.5 * (jnp.min(u_full) + jnp.max(u_full))
        dsis = []
        for c in range(spec.n_cameras):
            traj = trajmod.Trajectory(traj_ts[c], SE3(traj_q[c], traj_t[c]))
            packets = voting.warp_events_to_z0(
                x[c], y[c], t[c], traj, SE3(rv_q, rv_t), lut[c], K_cam[c],
                Kv_inv, z0=spec.z0, width=spec.width,
                packet_size=cfg.packet_size, ev_weight=w[c], full=True,
            )
            dsi_c = splat(
                packets, local_depths, spec.z0, spec.vcam_params,
                spec.width, spec.height, plane_block=cfg.plane_block,
                **splat_kw,
            )
            dsis.append(jax.lax.psum(dsi_c, EVENT_AXIS))
        return jnp.stack(dsis)

    ev_spec = P(None, EVENT_AXIS)
    rep = P()
    sharded = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(ev_spec, ev_spec, ev_spec, ev_spec,
                  rep, rep, rep, rep, rep, rep, rep, rep, rep),
        out_specs=P(None, PLANE_AXIS),
        check_vma=False,
    )
    ev_sh = NamedSharding(mesh, ev_spec)
    rep_sh = NamedSharding(mesh, rep)
    return jax.jit(
        sharded,
        in_shardings=(ev_sh, ev_sh, ev_sh, ev_sh,
                      rep_sh, rep_sh, rep_sh, rep_sh, rep_sh,
                      rep_sh, rep_sh, rep_sh, rep_sh),
    )


def pad_events_local(
    events: Sequence[Events],
    local_quantum: int,
    local_capacity: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-process variant of `pad_events_for_sharding`: pad THIS process's
    slice of the stream to a multiple of `local_quantum` (= local event
    shards x packet size).  Same weight-0 padding — the quantum is the only
    difference, so it delegates with (1 shard, quantum-sized packets)."""
    return pad_events_for_sharding(events, 1, local_quantum, local_capacity)


def sharded_step_inputs_multihost(
    mesh: Mesh,
    mappers: Sequence[Mapper],
    local_events: Sequence[Events],
    trajs: Sequence[trajmod.Trajectory],
    T_rv_w: SE3,
    packet_size: int = voting.DEFAULT_PACKET_SIZE,
    local_capacity: Optional[int] = None,
):
    """Multi-host assembly of the sharded-step arguments.

    Each process passes only ITS slice of the event stream (`local_events`
    — e.g. the [p/P, (p+1)/P) fraction of the chunk's time window for
    process p of P); no process ever materializes the global stream.  The
    event-sharded buffers become global `jax.Array`s via
    `jax.make_array_from_process_local_data`, so device shards are fed
    straight from process-local host memory — the multi-host replacement
    for the reference's single-process rosbag re-reads
    (reference: mapper_emvs_stereo/src/main.cpp:191-199).

    Pose tables / LUTs / calibration are tiny, computed identically on
    every process from the same files, and replicated.

    When `local_capacity` is None the processes agree on a common local pad
    via a `process_allgather` max (one tiny collective per call); pass an
    explicit capacity in streaming loops to keep jit shapes stable with
    zero collectives.

    Equivalence note: results are bit-identical to a single-process run of
    the concatenated stream only when every process's local slice is an
    exact multiple of `local_quantum` — otherwise the per-process tail
    padding falls mid-stream in the global buffer and shifts boundary-packet
    mid-times (weight-0 events still count toward packet timestamps), which
    perturbs those packets' pose lookups slightly.
    """
    nproc = jax.process_count()
    n_event = mesh.shape[EVENT_AXIS]
    if n_event % nproc != 0:
        raise ValueError(
            f"event shards {n_event} not divisible by processes {nproc}")
    local_quantum = (n_event // nproc) * packet_size

    if local_capacity is None and nproc > 1:
        from jax.experimental import multihost_utils
        local_max = max(ev.num for ev in local_events)
        all_max = multihost_utils.process_allgather(
            np.asarray([local_max], np.int64))
        local_capacity = int(np.max(all_max))

    x, y, t, w = pad_events_local(local_events, local_quantum, local_capacity)

    ev_sh = NamedSharding(mesh, P(None, EVENT_AXIS))
    rep_sh = NamedSharding(mesh, P())

    def glob(a, sh):
        return jax.make_array_from_process_local_data(sh, np.ascontiguousarray(a))

    (traj_ts, traj_q, traj_t, rv_q, rv_t, lut, K_cam, Kv_inv,
     depths) = replicated_step_tables(mappers, trajs, T_rv_w)
    return (glob(x, ev_sh), glob(y, ev_sh), glob(t, ev_sh), glob(w, ev_sh),
            glob(traj_ts, rep_sh), glob(traj_q, rep_sh), glob(traj_t, rep_sh),
            glob(rv_q, rep_sh), glob(rv_t, rep_sh), glob(lut, rep_sh),
            glob(K_cam, rep_sh), glob(Kv_inv, rep_sh), glob(depths, rep_sh))


def replicated_step_tables(
    mappers: Sequence[Mapper],
    trajs: Sequence[trajmod.Trajectory],
    T_rv_w: SE3,
):
    """The event-independent (replicated) arguments of a sharded step: pose
    tables, RV placement, undistortion LUTs, and calibration matrices.

    Pose tables are padded to the largest camera's length (repeating the last
    row, weightless for lookups past the end since `pose_at` clamps and
    flags validity)."""
    n_pose = max(int(tr.ts.shape[0]) for tr in trajs)

    def pad_tail(a, n):
        a = np.asarray(a)
        if a.shape[0] == n:
            return a
        reps = np.repeat(a[-1:], n - a.shape[0], axis=0)
        return np.concatenate([a, reps], axis=0)

    traj_ts = np.stack([pad_tail(tr.ts, n_pose) for tr in trajs])
    traj_q = np.stack([pad_tail(tr.poses.q, n_pose) for tr in trajs])
    traj_t = np.stack([pad_tail(tr.poses.t, n_pose) for tr in trajs])
    lut = np.stack([m.lut for m in mappers])
    K_cam = np.stack([np.asarray(m.cam.P, np.float32) for m in mappers])
    Kv_inv = np.asarray(np.linalg.inv(mappers[0].vcam.P), np.float32)
    depths = np.asarray(mappers[0].depth_vec.depths(), np.float32)
    return (traj_ts.astype(np.float32), traj_q.astype(np.float32),
            traj_t.astype(np.float32), np.asarray(T_rv_w.q, np.float32),
            np.asarray(T_rv_w.t, np.float32), lut, K_cam, Kv_inv, depths)


def sharded_step_inputs(
    mappers: Sequence[Mapper],
    events: Sequence[Events],
    trajs: Sequence[trajmod.Trajectory],
    T_rv_w: SE3,
    n_event_shards: int,
    packet_size: int = voting.DEFAULT_PACKET_SIZE,
    capacity: Optional[int] = None,
):
    """Assemble the array arguments of a sharded step from host-side objects."""
    x, y, t, w = pad_events_for_sharding(events, n_event_shards, packet_size, capacity)
    return (x, y, t, w) + replicated_step_tables(mappers, trajs, T_rv_w)
