"""Command-line driver — the `run_emvs` equivalent.

Mirrors the reference binary's control flow (reference: mapper_emvs_stereo/
src/main.cpp:105-434): calibration dispatch, event/pose ingest, trajectory
chaining through hand-eye and extrinsics, process selection (1/2/5),
single-shot vs sliding-window scheduling, and artifact output.  Accepts the
reference's own `--flagfile=<x>.conf` presets.

Usage:
    python -m dvs_mcemvs_tpu.cli --flagfile configs/example.conf
    python -m dvs_mcemvs_tpu.cli --bag_filename_left ev0.npz ... --process_method 1
"""

from __future__ import annotations

import logging
import os
import sys
import threading
from typing import List, Optional

import numpy as np

from . import pipeline
from .config import RunConfig, config_to_flagfile, parse_args
from .io import calib as calibmod, events as eventsmod, outputs, poses as posesmod
from .io.events import TimeOrigin
from .mapper import DsiShape, Events, Mapper, PointCloudOptions, get_depth_map, get_pointcloud, make_mapper
from .ops import extract, pointcloud as pcops, se3, trajectory as trajmod
from .ops.se3 import SE3

log = logging.getLogger("dvs_mcemvs_tpu")


def _se3_from_mat(T: np.ndarray) -> SE3:
    import jax.numpy as jnp

    return se3.from_matrix(jnp.asarray(T, jnp.float32))


def _load_events(cfg: RunConfig, path: str, topic: str, offset: float,
                 origin: TimeOrigin, t_start: float, t_stop: float) -> Events:
    if path.endswith(".bag"):
        return eventsmod.read_events_rosbag(
            path, topic, t_start=t_start, t_stop=t_stop, offset=offset, origin=origin)
    return eventsmod.read_events(
        path, t_start=t_start, t_stop=t_stop, offset=offset, origin=origin)


def _build_trajectories(
    poses: trajmod.Trajectory, rig: calibmod.RigCalibration, n_cams: int
) -> List[trajmod.Trajectory]:
    """traj_i = poses ∘ T_hand_eye ∘ T_i_0⁻¹ (main.cpp:317-334)."""
    T_he = _se3_from_mat(rig.T_hand_eye)
    traj0 = trajmod.apply_right(poses, T_he)
    trajs = [traj0]
    for i in range(1, n_cams):
        T_i0 = _se3_from_mat(rig.extrinsics(i))
        trajs.append(trajmod.apply_right(traj0, se3.inverse(T_i0)))
    return trajs


def _extract_and_save(
    mapper: Mapper, dsi, cfg: RunConfig, suffix: str, prefix: str,
    opts: extract.DepthMapOptions, precomputed=None,
):
    res = precomputed if precomputed is not None else get_depth_map(mapper, dsi, opts)
    outputs.save_depth_maps(
        np.asarray(res.depth), np.asarray(res.confidence), np.asarray(res.mask),
        cfg.min_depth, cfg.max_depth, suffix, prefix)
    if cfg.save_dense:
        dense = extract.densify_host(res, mapper.depth_vec)
        outputs.save_dense_depth_png(prefix + f"depth_map_dense_{suffix}.png",
                                     dense, cfg.min_depth, cfg.max_depth)
    if cfg.save_conf_stats:
        cmin, cmax = extract.confidence_range_stats(res.confidence)
        outputs.save_conf_stats(
            os.path.join(cfg.out_path, f"conf_range_{suffix}.txt"),
            float(cmin), float(cmax))
    return res


def _make_sharded_runner(cfg: RunConfig, mappers, backend: str, opts,
                         n_dev: int):
    """Compile the fused sharded chunk step and wrap it as a process
    callable (VERDICT r1 item 2: --num_devices drives a real mesh)."""
    from . import mapper as mappermod
    from .parallel import make_mesh, pick_mesh_shape, sharded as shardedmod
    from .pipeline import ProcessResult

    n_event, n_plane = pick_mesh_shape(n_dev, cfg.dimZ, backend=backend)
    mesh = make_mesh(n_event, n_plane)
    spec = shardedmod.rig_spec_from_mappers(mappers)
    scfg = shardedmod.ShardedStepConfig(
        fusion_method=cfg.stereo_fusion, packet_size=cfg.packet_size,
        backend=backend, plane_block=cfg.plane_block, extract_options=opts)
    step = shardedmod.make_sharded_step(mesh, spec, scfg)
    quantum = n_event * cfg.packet_size
    log.info("sharded step over mesh (event=%d, plane=%d), backend %s",
             n_event, n_plane, backend)

    import time as _time

    n_calls = 0

    def run_sharded(mps, evs, trs, ts) -> ProcessResult:
        nonlocal n_calls
        if min(e.num for e in evs) <= cfg.packet_size:
            raise ValueError("chunk smaller than one packet")
        T_rv_w = pipeline.place_reference_view(trs[0], ts, cfg.rv_pos)
        # Power-of-two capacity buckets keep the mesh step's shapes stable
        # across full_seq chunks (same policy as VotingOptions.pad_policy).
        cap = mappermod.bucket_capacity(max(e.num for e in evs), quantum)
        t0 = _time.time()
        args = shardedmod.sharded_step_inputs(
            mps, evs, trs, T_rv_w, n_event, cfg.packet_size, capacity=cap)
        out = step(*args)
        dt = _time.time() - t0  # host prep + dispatch (device may run ahead)
        n_ev = sum(e.num for e in evs)
        res = ProcessResult(
            fused_dsi=out["dsi"], T_rv_w=T_rv_w, ts=ts,
            timings={"sharded_dispatch_s": dt},
            mev_per_s=(n_ev / dt / 1e6) if dt > 0 else None)
        res.extracted = extract.DepthMapResult(
            depth=out["depth"], confidence=out["confidence"],
            mask=out["mask"], depth_dense=None,
            depth_indices=out["depth_indices"])
        # Device-TRUE throughput probe every Nth chunk (VERDICT r3 item 7):
        # block until the step's outputs exist on device so a mesh-side
        # regression shows in logs, not just dispatch overhead.
        every = cfg.timing_sync_every
        if every > 0 and n_calls % every == 0:
            import jax

            jax.block_until_ready(out["depth"])
            dt_dev = _time.time() - t0
            res.timings["sharded_device_s"] = dt_dev
            log.info("sharded chunk %d: %d events, %.3f s device-sync, "
                     "%.1f Mev/s device-true", n_calls, n_ev, dt_dev,
                     n_ev / dt_dev / 1e6 if dt_dev > 0 else 0.0)
        else:
            log.info("sharded chunk: %d events, %.3f s dispatch, %.1f Mev/s "
                     "(dispatch-bound; device overlaps)", n_ev, dt,
                     res.mev_per_s or 0.0)
        n_calls += 1
        return res

    return run_sharded


def _make_multihost_runner(cfg: RunConfig, mappers, backend: str, opts):
    """Multi-process chunk runner: a global ("event", "plane") mesh over all
    processes' devices, each process feeding only ITS slice of the chunk's
    event stream (`sharded_step_inputs_multihost`).

    The launch path the reference never had (it is single-process by
    construction, SURVEY.md §5 distributed-backend row): every process runs
    the same CLI with the same flags plus `--process_id`, and the depth
    decision comes back replicated on every process.

    Slicing policy: each camera's chunk is cut into process_count
    quantum-aligned slices (quantum = local event shards x packet size);
    the sub-quantum global tail is dropped (<= P x quantum events, the
    multi-process analog of the reference's drop-tail packetization,
    mapper_emvs_stereo.cpp:88).  Alignment keeps every process's padding at
    the global stream end, so the run is bit-equal (up to psum
    reassociation) to a single-process run over the same truncated stream.
    """
    import jax

    from . import mapper as mappermod
    from .parallel import mesh as meshmod, sharded as shardedmod
    from .pipeline import ProcessResult

    mesh = meshmod.global_mesh(cfg.dimZ, backend=backend)
    n_event = mesh.shape[meshmod.EVENT_AXIS]
    n_plane = mesh.shape[meshmod.PLANE_AXIS]
    pidx, pcnt = jax.process_index(), jax.process_count()
    if n_event % pcnt != 0:
        raise ValueError(
            f"event shards {n_event} not divisible by {pcnt} processes")
    quantum = (n_event // pcnt) * cfg.packet_size
    spec = shardedmod.rig_spec_from_mappers(mappers)
    scfg = shardedmod.ShardedStepConfig(
        fusion_method=cfg.stereo_fusion, packet_size=cfg.packet_size,
        backend=backend, plane_block=cfg.plane_block, extract_options=opts)
    step = shardedmod.make_sharded_step(mesh, spec, scfg)
    log.info("multihost step: process %d/%d, mesh (event=%d, plane=%d), "
             "backend %s", pidx, pcnt, n_event, n_plane, backend)

    import time as _time

    n_calls = 0

    def run_multihost(mps, evs, trs, ts) -> ProcessResult:
        nonlocal n_calls
        if min(e.num for e in evs) < pcnt * quantum:
            raise ValueError("chunk smaller than one quantum per process")
        T_rv_w = pipeline.place_reference_view(trs[0], ts, cfg.rv_pos)
        local = []
        for ev in evs:
            per = (ev.num // (pcnt * quantum)) * quantum
            local.append(ev.slice(pidx * per, (pidx + 1) * per))
        # Common power-of-two capacity so jit shapes stay stable across
        # chunks AND across processes (slices are equal-sized by
        # construction, so no allgather is needed).
        cap = mappermod.bucket_capacity(max(e.num for e in local), quantum)
        t0 = _time.time()
        args = shardedmod.sharded_step_inputs_multihost(
            mesh, mps, local, trs, T_rv_w, cfg.packet_size,
            local_capacity=cap)
        out = step(*args)
        dt = _time.time() - t0
        n_ev = sum(e.num for e in local) * pcnt
        res = ProcessResult(
            fused_dsi=out["dsi"], T_rv_w=T_rv_w, ts=ts,
            timings={"multihost_dispatch_s": dt},
            mev_per_s=(n_ev / dt / 1e6) if dt > 0 else None)
        # The extraction maps come back replicated; _np_local blocks on this
        # process's shard, so the device-true probe below reuses its wait.
        every = cfg.timing_sync_every
        sync_now = every > 0 and n_calls % every == 0
        res.extracted = extract.DepthMapResult(
            depth=_np_local(out["depth"]), confidence=_np_local(out["confidence"]),
            mask=_np_local(out["mask"]), depth_dense=None,
            depth_indices=_np_local(out["depth_indices"]))
        if sync_now:
            dt_dev = _time.time() - t0
            res.timings["multihost_device_s"] = dt_dev
            log.info("multihost chunk %d: %d events global, %.3f s "
                     "device-sync, %.1f Mev/s device-true", n_calls, n_ev,
                     dt_dev, n_ev / dt_dev / 1e6 if dt_dev > 0 else 0.0)
        else:
            log.info("multihost chunk: %d events global, %.3f s dispatch, "
                     "%.1f Mev/s", n_ev, dt, res.mev_per_s or 0.0)
        n_calls += 1
        return res

    return run_multihost


def _make_sharded_pair_evaluator(cfg: RunConfig, mappers, backend: str,
                                 n_dev: int):
    """Mesh evaluator for the temporal algorithms (VERDICT r2 item 4): each
    sub-interval's two camera DSIs are voted on the ('event','plane') mesh
    (parallel/sharded.make_sharded_voting_step) and come back plane-sharded;
    process_2/5's streaming HM/AM accumulators are elementwise, so they stay
    sharded across sub-intervals with zero extra communication — alg2
    full_seq runs scale like alg1."""
    from . import mapper as mappermod
    from .parallel import make_mesh, pick_mesh_shape, sharded as shardedmod

    n_event, n_plane = pick_mesh_shape(n_dev, cfg.dimZ, backend=backend)
    mesh = make_mesh(n_event, n_plane)
    spec = shardedmod.rig_spec_from_mappers(mappers[:2])
    scfg = shardedmod.ShardedStepConfig(
        fusion_method=cfg.stereo_fusion, packet_size=cfg.packet_size,
        backend=backend, plane_block=cfg.plane_block)
    step = shardedmod.make_sharded_voting_step(mesh, spec, scfg)
    quantum = n_event * cfg.packet_size
    log.info("sharded temporal voting over mesh (event=%d, plane=%d), "
             "backend %s", n_event, n_plane, backend)

    def evaluate_pair(mps, evs, trs, T_rv_w):
        if min(e.num for e in evs) <= cfg.packet_size:
            return None, None
        cap = mappermod.bucket_capacity(max(e.num for e in evs), quantum)
        args = shardedmod.sharded_step_inputs(
            mps[:2], evs, trs[:2], T_rv_w, n_event, cfg.packet_size,
            capacity=cap)
        out = step(*args)  # (2, Z, H, W), plane-sharded
        return out[0], out[1]

    return evaluate_pair


def _open_store_multihost(evstore, path: str, offset: float, origin):
    """Open the streaming .evs cache in a multi-process run.

    Process 0 stream-builds the cache next to the source; peers wait at a
    device barrier, then open the finished file (or, when the filesystem is
    not shared, build their own local copy after the barrier).  The barrier
    fires on both success and failure so a failed build degrades every
    process to the RAM path instead of hanging its peers.
    """
    import jax
    from jax.experimental import multihost_utils

    tag = "evs:" + os.path.basename(path)
    if jax.process_index() == 0:
        try:
            return evstore.NormalizedStore(
                evstore.open_or_build_h5(path), offset, origin)
        finally:
            multihost_utils.sync_global_devices(tag)
    multihost_utils.sync_global_devices(tag)
    return evstore.NormalizedStore(
        evstore.open_or_build_h5(path), offset, origin)


def _make_multihost_pair_evaluator(cfg: RunConfig, mappers, backend: str):
    """Multi-process twin of `_make_sharded_pair_evaluator` for the temporal
    algorithms (process_2/5): each sub-interval's two camera DSIs are voted
    on the GLOBAL ("event", "plane") mesh with every process feeding only
    its quantum-aligned slice of the sub-interval, then reassembled to a
    process-local array from the (intra-process) plane shards — the
    streaming HM/AM accumulators and the extraction chain run identically
    on every process afterwards, so outputs match the single-process run
    (reference: src/process2.cpp:211-242 has no multi-process analog)."""
    import jax

    from . import mapper as mappermod
    from .parallel import mesh as meshmod, sharded as shardedmod

    mesh = meshmod.global_mesh(cfg.dimZ, backend=backend)
    n_event = mesh.shape[meshmod.EVENT_AXIS]
    n_plane = mesh.shape[meshmod.PLANE_AXIS]
    pidx, pcnt = jax.process_index(), jax.process_count()
    if n_event % pcnt != 0:
        raise ValueError(
            f"event shards {n_event} not divisible by {pcnt} processes")
    quantum = (n_event // pcnt) * cfg.packet_size
    spec = shardedmod.rig_spec_from_mappers(mappers[:2])
    scfg = shardedmod.ShardedStepConfig(
        fusion_method=cfg.stereo_fusion, packet_size=cfg.packet_size,
        backend=backend, plane_block=cfg.plane_block)
    step = shardedmod.make_sharded_voting_step(mesh, spec, scfg)
    log.info("multihost temporal voting: process %d/%d, mesh (event=%d, "
             "plane=%d), backend %s", pidx, pcnt, n_event, n_plane, backend)

    def assemble(garr):
        # (2, Z, H, W), replicated over "event" and sharded over "plane";
        # plane shards stay intra-process (global_mesh), so this process's
        # addressable shards cover every plane block.
        out = np.zeros(garr.shape, np.float32)
        for sh in garr.addressable_shards:
            out[sh.index] = np.asarray(sh.data)
        return out

    def evaluate_pair(mps, evs, trs, T_rv_w):
        if min(e.num for e in evs) < pcnt * quantum:
            return None, None
        local = []
        for ev in evs:
            per = (ev.num // (pcnt * quantum)) * quantum
            local.append(ev.slice(pidx * per, (pidx + 1) * per))
        cap = mappermod.bucket_capacity(max(e.num for e in local), quantum)
        args = shardedmod.sharded_step_inputs_multihost(
            mesh, mps[:2], local, trs[:2], T_rv_w, cfg.packet_size,
            local_capacity=cap)
        out = assemble(step(*args))
        return out[0], out[1]

    return evaluate_pair


def _np_local(arr):
    """Materialize a replicated global jax.Array from this process's own
    shards (np.asarray on a non-fully-addressable array raises)."""
    try:
        return np.asarray(arr)
    except Exception:
        return np.asarray(arr.addressable_shards[0].data)


def run(cfg: RunConfig) -> int:
    multihost = False
    if cfg.coordinator or cfg.num_processes > 0 or cfg.process_id >= 0:
        from .parallel.mesh import init_distributed

        pidx, pcnt = init_distributed(
            cfg.coordinator or None,
            cfg.num_processes or None,
            cfg.process_id if cfg.process_id >= 0 else None)
        multihost = pcnt > 1
        if multihost and pidx != 0:
            # Every process computes; process 0's artifacts are canonical.
            # Non-zero processes write to a scratch dir to avoid file races.
            import tempfile

            cfg.out_path = tempfile.mkdtemp(prefix=f"emvs_proc{pidx}_")
            log.info("process %d/%d: outputs redirected to %s",
                     pidx, pcnt, cfg.out_path)
    os.makedirs(cfg.out_path or ".", exist_ok=True)
    rig = calibmod.load_calibration(cfg.calib_type, cfg.calib_path, cfg.mocap_calib_path)

    if cfg.bag_filename:
        cfg.bag_filename_left = cfg.bag_filename
        cfg.bag_filename_right = cfg.bag_filename
        cfg.bag_filename_pose = cfg.bag_filename

    trinocular = bool(cfg.event_topic2) and rig.num_cameras >= 3
    n_cams = 3 if trinocular else 2

    origin = TimeOrigin()
    log.info("Loading poses from %s", cfg.bag_filename_pose)
    # The reference loads poses over the FULL time range even in full_seq mode
    # (main.cpp:201); event files are windowed.
    pose_traj = posesmod.read_poses(cfg.bag_filename_pose, topic=cfg.pose_topic,
                                    origin=origin)

    # Bounded-memory ingest: full_seq runs over HDF5 inputs never
    # materialize the stream — the .evs cache next to the source is
    # stream-built in O(chunk) memory (io/evstore.write_store_streaming) and
    # every window afterwards is an mmap'd O(log E) lookup.  The reference
    # re-parses whole bags per chunk instead (main.cpp:191-199).  Multi-
    # process runs stream too: each process mmap-windows only chunk ranges
    # and slices its quantum share per chunk, so per-process RSS stays
    # O(chunk) instead of O(full range).
    stream_ok = cfg.full_seq and cfg.use_event_store

    def _open_source(path: str, topic: str, offset: float):
        if stream_ok and os.path.splitext(path)[1].lower() in (".h5", ".hdf5"):
            try:
                from .io import evstore

                if multihost:
                    store = _open_store_multihost(evstore, path, offset,
                                                  origin)
                else:
                    store = evstore.NormalizedStore(
                        evstore.open_or_build_h5(path), offset, origin)
                log.info("streaming event store for %s: %d events",
                         path, store.count)
                return store
            except Exception as e:
                log.warning("streaming store unavailable for %s (%s); "
                            "loading in RAM", path, e)
        return _load_events(cfg, path, topic, offset, origin,
                            cfg.start_time_s, cfg.stop_time_s)

    log.info("Loading events")
    events = [
        _open_source(cfg.bag_filename_left, cfg.event_topic0, cfg.offset0),
        _open_source(cfg.bag_filename_right, cfg.event_topic1, cfg.offset1),
    ]
    if trinocular:
        events.append(_open_source(cfg.bag_filename2 or cfg.bag_filename,
                                   cfg.event_topic2, cfg.offset2))

    def _count(src) -> int:
        if isinstance(src, Events):
            return src.num
        return src.window_count(cfg.start_time_s, cfg.stop_time_s)

    log.info("Events: %s", [_count(s) for s in events])

    trajs = _build_trajectories(pose_traj, rig, n_cams)

    shape = DsiShape(cfg.dimX, cfg.dimY, cfg.dimZ, cfg.fov_deg,
                     cfg.min_depth, cfg.max_depth)
    mappers = [make_mapper(rig.cams[i], shape, cfg.depth_sampling)
               for i in range(n_cams)]

    # Event-accumulation previews (main.cpp:336-349); stores contribute a
    # bounded head slice instead of the whole stream.
    for i, src in enumerate(events):
        ev = src if isinstance(src, Events) else src.head(
            1_000_000, cfg.start_time_s, cfg.stop_time_s)
        outputs.save_events_png(
            os.path.join(cfg.out_path, f"events_{i}.png"), ev,
            rig.cams[i].width, rig.cams[i].height)

    opts = extract.DepthMapOptions(
        adaptive_threshold_kernel_size=cfg.adaptive_threshold_kernel_size,
        adaptive_threshold_c=cfg.adaptive_threshold_c,
        median_filter_size=cfg.median_filter_size,
        full_sequence=cfg.full_seq,
        save_conf_stats=cfg.save_conf_stats,
        max_confidence=cfg.max_confidence,
        rv_pos=cfg.rv_pos,
        collapse_method=cfg.collapse_method,
    )
    backend = cfg.splat_backend
    if backend == "auto":
        # Pick the histogram backend with a grouping bounded by the rig's
        # actual travel over one chunk (voting_hist.auto_backend_spec — the
        # same selection the benchmark and golden accuracy gates exercise).
        from .ops.voting_hist import auto_backend_spec

        pos = np.asarray(trajs[0].poses.t)
        span = cfg.duration if cfg.full_seq else (cfg.stop_time_s - cfg.start_time_s)
        total_t = float(np.asarray(trajs[0].ts)[-1] - np.asarray(trajs[0].ts)[0])
        # The default window [0, 1000 s] far exceeds any real recording; the
        # rig can't travel outside the trajectory's actual extent.
        span = min(span, total_t) if total_t > 0 else span
        travel = float(np.linalg.norm(np.diff(pos, axis=0), axis=1).sum())
        chunk_travel = travel * (span / total_t if total_t > 0 else 1.0)
        n_min = min(_count(s) for s in events)
        if cfg.full_seq:
            # Grouping must be sized to a CHUNK's packet count, not the
            # whole range's (auto_group_size pairs travel and packets over
            # the same window).
            whole = cfg.stop_time_s - cfg.start_time_s
            if total_t > 0:
                whole = min(whole, total_t)
            n_min = max(1, int(n_min * (span / max(whole, span))))
        n_pk = max(1, n_min // cfg.packet_size)
        backend = auto_backend_spec(chunk_travel, n_pk,
                                    float(mappers[0].vcam.fx),
                                    cfg.min_depth, cfg.max_depth, cfg.dimZ)
        log.info("auto backend: %s (chunk travel %.3f m, %d packets)",
                 backend, chunk_travel, n_pk)
    vopts = pipeline.VotingOptions(packet_size=cfg.packet_size, backend=backend,
                                   plane_block=cfg.plane_block)

    # --num_devices: 0 = auto (all visible devices on a GPU host; 1 on the
    # CPU, whose "devices" are virtual test shards), N>1 = mesh of N.
    # The sharded step fuses warp -> voting -> psum -> fusion -> collapse ->
    # extraction over an ("event", "plane") mesh (parallel/sharded.py).
    sharded_runner = None
    temporal_eval = None
    if multihost:
        if cfg.process_method == 1:
            sharded_runner = _make_multihost_runner(cfg, mappers, backend,
                                                    opts)
        else:
            temporal_eval = _make_multihost_pair_evaluator(cfg, mappers,
                                                           backend)
    n_dev = cfg.num_devices
    if n_dev == 0:
        import jax

        from .utils.runtime import on_accelerator

        n_dev = len(jax.devices()) if on_accelerator() else 1
    if not multihost and sharded_runner is None and n_dev > 1:
        if cfg.process_method == 1:
            sharded_runner = _make_sharded_runner(cfg, mappers, backend, opts,
                                                  n_dev)
        else:
            temporal_eval = _make_sharded_pair_evaluator(cfg, mappers,
                                                         backend, n_dev)

    def run_process(mps, evs, trs, ts):
        if sharded_runner is not None:
            return sharded_runner(mps, evs, trs, ts)
        if cfg.process_method == 1:
            return pipeline.process_1(mps, evs, trs, ts, cfg.stereo_fusion,
                                      rv_pos=cfg.rv_pos, vopts=vopts)
        if cfg.process_method not in (2, 5):
            raise ValueError(
                f"process_method must be 1, 2 or 5, got {cfg.process_method}")

        on_sub = None
        if not cfg.full_seq:
            # Per-sub-interval depth maps, left/right per camera
            # (process2.cpp:122-127 and the right-camera twin): suffixes
            # 0_{k:03d} / 1_{k:03d} under the run's timestamp prefix.
            prefix = outputs.timestamp_prefix(cfg.out_path, ts)

            def on_sub(k, dsis):
                for c in range(2):
                    _extract_and_save(mps[0], dsis[f"camera{c}"], cfg,
                                      f"{c}_{k:03d}", prefix, opts)

        fn = pipeline.process_2 if cfg.process_method == 2 else pipeline.process_5
        return fn(mps[:2], evs[:2], trs[:2], ts,
                  stereo_fusion=cfg.stereo_fusion,
                  temporal_fusion=cfg.temporal_fusion,
                  num_intervals=cfg.num_intervals,
                  rv_pos=cfg.rv_pos, vopts=vopts, on_subinterval=on_sub,
                  evaluate_pair=temporal_eval)

    flag_text = config_to_flagfile(cfg)
    with open(os.path.join(cfg.out_path, "run_flags.conf"), "w") as f:
        f.write(flag_text)

    if cfg.profile_dir:
        import jax

        jax.profiler.start_trace(cfg.profile_dir)
        log.info("jax profiler tracing to %s", cfg.profile_dir)
    try:
        return _run_configured(cfg, rig, mappers, events, trajs, opts,
                               run_process, flag_text)
    finally:
        # Flush the trace on both paths and on errors (a lost trace is the
        # whole point of --profile_dir).
        if cfg.profile_dir:
            import jax

            jax.profiler.stop_trace()


def _run_configured(cfg, rig, mappers, events, trajs, opts, run_process,
                    flag_text) -> int:
    if cfg.full_seq:
        fopts = pipeline.FullSeqOptions(
            start_time=cfg.start_time_s, stop_time=cfg.stop_time_s,
            duration=cfg.duration, out_skip=cfg.out_skip,
            forward_looking=cfg.forward_looking)
        from .checkpoint import RunCheckpoint, config_fingerprint

        # The skip predicate rides into the scheduler so resumed chunks
        # never reach process() — resume saves the voting compute, not just
        # the file writes (chunk independence, main.cpp:177).
        ckpt = RunCheckpoint(
            os.path.join(cfg.out_path, "checkpoint.json"),
            fingerprint=config_fingerprint(flag_text),
            enabled=cfg.checkpoint)
        import jax as _jax

        if _jax.process_count() > 1:
            # Resume decisions must be process-consistent or the sharded
            # per-chunk collectives misalign (checkpoint.sync_multihost).
            from .checkpoint import sync_multihost

            sync_multihost(ckpt)
        from .mapper import Events as _Events

        if all(not isinstance(s, _Events) for s in events):
            # Streaming ingest already produced stores (bounded memory —
            # the whole range was never materialized).
            runner = pipeline.run_full_seq_stores(
                mappers, events, trajs, fopts, run_process,
                skip=ckpt.is_done)
            log.info("full_seq: streaming event stores + prefetch")
        else:
            # In-RAM sources: materialize any store windows, then (toolchain
            # permitting) rewrite into local stores for mmap windows +
            # prefetch.
            events = [s if isinstance(s, _Events)
                      else s.window(cfg.start_time_s, cfg.stop_time_s)
                      for s in events]
            runner = pipeline.run_full_seq(mappers, events, trajs, fopts,
                                           run_process, skip=ckpt.is_done)
            if cfg.use_event_store:
                try:
                    from .io import evstore

                    stores = []
                    for i, ev in enumerate(events):
                        path = os.path.join(cfg.out_path, f".events_{i}.evs")
                        evstore.write_store(path, ev)
                        stores.append(evstore.EventStore(path))
                    runner = pipeline.run_full_seq_stores(
                        mappers, stores, trajs, fopts, run_process,
                        skip=ckpt.is_done)
                    log.info("full_seq: native event store + prefetch enabled")
                except Exception as e:  # no toolchain: keep the numpy path
                    log.warning("native event store unavailable (%s)", e)
        n_chunks = 0
        ckpt_lock = threading.Lock()

        def save_chunk(k: int, ts: float, res) -> None:
            nonlocal n_chunks
            prefix = outputs.timestamp_prefix(cfg.out_path, ts)
            _extract_and_save(mappers[0], res.fused_dsi, cfg, "fused", prefix,
                              opts, precomputed=res.extracted)
            # Temporal algorithms also write the converse-order (time-then-
            # camera) map every chunk (process2.cpp:299-300; the left/right
            # per-camera maps are skipped in full_sequence mode, :255-263).
            if "camera_time" in res.dsis:
                _extract_and_save(
                    mappers[0], res.dsis["camera_time"], cfg,
                    f"stereo_temporal_camera_time{cfg.temporal_fusion}",
                    prefix, opts)
            if cfg.save_dsi:
                outputs.write_dsi_npy(prefix + "dsi_fused.npy",
                                      np.asarray(res.fused_dsi))
            # Checkpoint writes are serialized: mark_done mutates the
            # ledger and replaces the file, and saves run on pool workers.
            with ckpt_lock:
                ckpt.mark_done(k, ts)
                n_chunks += 1
            log.info("chunk %d @ ts=%.3f done", k, ts)

        # Worker-pool save pipeline (supersedes the r2-r4 one-chunk-deep
        # overlap): chunk saves — extraction dispatch, device->host
        # transfer, PNG/point-list writes — run on `--save_workers`
        # threads with bounded depth, so device compute of later chunks
        # overlaps the host serialization of several earlier ones.
        # save_workers=0 keeps the fully serial reference behavior.
        if cfg.save_workers > 0:
            from .utils.writers import SaveWorkerPool

            with SaveWorkerPool(workers=cfg.save_workers) as pool:
                for item in runner:
                    pool.submit(save_chunk, *item)
        else:
            for item in runner:
                save_chunk(*item)
        log.info("full_seq: %d chunks written (%d total complete)",
                 n_chunks, ckpt.num_done or n_chunks)
        return 0

    # Single-shot path (main.cpp:303-433).
    ts = cfg.resolved_ts()
    res = run_process(mappers, events, trajs, ts)
    prefix = outputs.timestamp_prefix(cfg.out_path, ts)

    dm = _extract_and_save(mappers[0], res.fused_dsi, cfg, "fused", prefix,
                           opts, precomputed=res.extracted)
    if cfg.process_method in (2, 5):
        # Reference artifact set of the temporal algorithms
        # (process2.cpp:255-263,299-300): per-camera temporal fusions, the
        # primary camera-then-time map under its reference name, and the
        # converse time-then-camera fusion order.
        tf = cfg.temporal_fusion
        _extract_and_save(mappers[0], res.dsis["left_temporal"], cfg,
                          f"left_temporal_{tf}", prefix, opts)
        _extract_and_save(mappers[0], res.dsis["right_temporal"], cfg,
                          f"right_temporal_{tf}", prefix, opts)
        _extract_and_save(mappers[0], res.fused_dsi, cfg,
                          f"stereo_temporal_{tf}", prefix, opts,
                          precomputed=res.extracted)
        _extract_and_save(mappers[0], res.dsis["camera_time"], cfg,
                          f"stereo_temporal_camera_time{tf}", prefix, opts)
    if cfg.save_dsi:
        outputs.write_dsi_npy(os.path.join(cfg.out_path, "dsi_fused.npy"),
                              np.asarray(res.fused_dsi))
        # process_2/5 DSI dumps carry the reference's names
        # (process2.cpp:291-297).
        ref_names = {"left_temporal": "fused_0_temporalfusion",
                     "right_temporal": "fused_1_temporalfusion",
                     "camera_time": "stereo_temporalfusion_camera_time"}
        for name, d in res.dsis.items():
            outputs.write_dsi_npy(
                os.path.join(cfg.out_path, f"dsi_{ref_names.get(name, name)}.npy"),
                np.asarray(d))
        if cfg.process_method in (2, 5):
            outputs.write_dsi_npy(
                os.path.join(cfg.out_path, "dsi_stereo_temporalfusion.npy"),
                np.asarray(res.fused_dsi))
    if cfg.save_mono:
        for name, d in res.dsis.items():
            if name.startswith("camera"):
                _extract_and_save(mappers[0], d, cfg, name, prefix, opts)

    if cfg.save_pointcloud:
        pc_opts = PointCloudOptions(cfg.radius_search, cfg.min_num_neighbors)
        pc = get_pointcloud(mappers[0], np.asarray(dm.depth),
                            np.asarray(dm.mask), pc_opts)
        pcops.save_pcd(os.path.join(cfg.out_path, "pointcloud.pcd"), pc)
        log.info("point cloud: %d points", pc.xyz.shape[0])

        if cfg.late_fusion:
            # Per-camera depth -> point cloud -> concatenation (main.cpp:404-432).
            clouds = []
            for name, d in res.dsis.items():
                if not name.startswith("camera"):
                    continue
                r = get_depth_map(mappers[0], d, opts)
                clouds.append(get_pointcloud(
                    mappers[0], np.asarray(r.depth), np.asarray(r.mask), pc_opts))
            if clouds:
                merged = pcops.PointCloud(
                    np.concatenate([c.xyz for c in clouds]),
                    np.concatenate([c.intensity for c in clouds]))
                pcops.save_pcd(os.path.join(cfg.out_path, "pointcloud_late_fused.pcd"),
                               merged)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    cfg = parse_args(argv if argv is not None else sys.argv[1:])
    import jax

    from .utils.runtime import enable_compile_cache

    if cfg.platform:
        jax.config.update("jax_platforms", cfg.platform)
    log.info("compile cache: %s", enable_compile_cache())
    return run(cfg)


if __name__ == "__main__":
    sys.exit(main())
