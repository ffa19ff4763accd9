"""Benchmark: DSI voting and chunk throughput (Mevents/s) on one GPU.

Measures the framework's hot path — event warp + depth-plane voting into a
DSEC-sized DSI (640x480x100, the workload of
cfg/DSEC/interlaken_00_b_2/dsec.conf in the reference) — for the spec the
CLI ships and for the alternative voting backends, plus the process_2
chunk, a sustained full_seq run and the golden accuracy gate.  The
reference instruments the same number via its Mev/s log
(process1.cpp:82-86).

Refuses to run without a GPU.  Prints ONE JSON line; exits non-zero when
the golden gate fails.

Usage: python bench.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

WIDTH, HEIGHT, DIM_Z = 640, 480, 100
N_EVENTS = 1_048_576  # 1 Mi events, packet-aligned
PACKET = 1024


def build_workload():
    import jax.numpy as jnp

    from dvs_mcemvs_tpu import pipeline
    from dvs_mcemvs_tpu.mapper import DsiShape, make_mapper
    from dvs_mcemvs_tpu.ops.camera import PinholeCamera
    from dvs_mcemvs_tpu.ops import trajectory as trajmod
    from dvs_mcemvs_tpu.utils import synthetic

    cam = PinholeCamera(width=WIDTH, height=HEIGHT, fx=WIDTH * 0.9,
                        fy=WIDTH * 0.9, cx=WIDTH / 2, cy=HEIGHT / 2)
    rig = synthetic.SyntheticRig(cam=cam, baseline=0.6, travel=0.5,
                                 plane_depths=(4.0, 12.0))
    mapper = make_mapper(cam, DsiShape(dim_z=DIM_Z, min_depth=2.0,
                                       max_depth=40.0))

    rng = np.random.default_rng(1)
    pts = synthetic.make_scene(rig, rng, 40_000)
    ev = synthetic.simulate_events(rig, pts, 0, n_samples=40, rng=rng)
    # Tile the stream up to the fixed benchmark size (timestamps keep order
    # inside each tile; throughput is content-independent).
    reps = -(-N_EVENTS // ev.num)
    x = np.tile(ev.x, reps)[:N_EVENTS]
    y = np.tile(ev.y, reps)[:N_EVENTS]
    t = np.sort(np.tile(ev.t, reps)[:N_EVENTS], kind="stable")

    ts, q, p = synthetic.rig_poses(rig)
    traj = trajmod.from_arrays(ts, q, p)
    T_rv_w = pipeline.place_reference_view(traj, 0.5)
    return mapper, (x, y, t), traj, T_rv_w


def make_full_chunk_step(mapper, traj, T_rv_w, backend, plane_block):
    """End-to-end process_1 chunk on device: warp -> vote (2 cameras) ->
    HM fusion -> collapse -> extraction, the span the reference's Mev/s log
    actually times (process1.cpp:82-86 wraps the whole evaluateDSI + fusion;
    extraction follows in getDepthMapFromDSI).  Both cameras consume the
    same event buffers with baseline-offset trajectories — throughput is
    content-independent; 2 x N_EVENTS are processed per step."""
    import jax
    import jax.numpy as jnp

    from dvs_mcemvs_tpu.ops import (camera as camops, extract,
                                    grid as gridops,
                                    trajectory as trajmod, voting)
    from dvs_mcemvs_tpu.ops.se3 import SE3

    z0 = float(mapper.depth_vec.depths()[0])
    vp = (float(mapper.vcam.fx), float(mapper.vcam.fy),
          float(mapper.vcam.cx), float(mapper.vcam.cy))
    K_cam = jnp.asarray(mapper.cam.P, jnp.float32)
    Kv_inv = jnp.asarray(np.linalg.inv(mapper.vcam.P), jnp.float32)
    depths = jnp.asarray(mapper.depth_vec.depths(), jnp.float32)
    traj_ts, traj_q = traj.ts, traj.poses.q
    traj_t0 = traj.poses.t
    traj_t1 = traj.poses.t + jnp.asarray([0.6, 0.0, 0.0], traj.poses.t.dtype)
    rv_q, rv_t = T_rv_w.q, T_rv_w.t
    rect_params = camops.rect_static(mapper.cam)
    splat = voting.resolve_backend(backend)
    opts = extract.DepthMapOptions()

    @jax.jit
    def step(x, y, t):
        dsis = []
        for tt in (traj_t0, traj_t1):
            trj = trajmod.Trajectory(traj_ts, SE3(traj_q, tt))
            packets = voting.warp_events_to_z0(
                x, y, t, trj, SE3(rv_q, rv_t), None, K_cam, Kv_inv,
                z0=z0, width=mapper.width, packet_size=PACKET, full=True,
                rect_params=rect_params,
            )
            dsis.append(splat(packets, depths, z0, vp, mapper.width,
                              mapper.height, plane_block=plane_block))
        fused = gridops.fuse_many(dsis, gridops.FUSE_HM)
        res = extract.get_depth_map_from_dsi(fused, mapper.depth_vec, opts)
        return res.depth

    return step


def make_alg2_step(mapper, traj, T_rv_w, backend, plane_block, n_sub=2):
    """process_2 chunk on device — the temporal flagship (VERDICT r4 item
    7): each of `n_sub` equal-event sub-intervals is voted per camera and
    camera-fused (HM), the sub-interval results stream into the temporal
    HM accumulator, then collapse + extraction.  The span the reference
    times for algorithm 2 (process2.cpp:95-96,193-194).  2 x N_EVENTS are
    processed per step (every event votes once, as in process_2)."""
    import jax
    import jax.numpy as jnp

    from dvs_mcemvs_tpu.ops import (camera as camops, extract,
                                    grid as gridops,
                                    trajectory as trajmod, voting)
    from dvs_mcemvs_tpu.ops.se3 import SE3

    z0 = float(mapper.depth_vec.depths()[0])
    vp = (float(mapper.vcam.fx), float(mapper.vcam.fy),
          float(mapper.vcam.cx), float(mapper.vcam.cy))
    K_cam = jnp.asarray(mapper.cam.P, jnp.float32)
    Kv_inv = jnp.asarray(np.linalg.inv(mapper.vcam.P), jnp.float32)
    depths = jnp.asarray(mapper.depth_vec.depths(), jnp.float32)
    traj_ts, traj_q = traj.ts, traj.poses.q
    traj_t0 = traj.poses.t
    traj_t1 = traj.poses.t + jnp.asarray([0.6, 0.0, 0.0], traj.poses.t.dtype)
    rv_q, rv_t = T_rv_w.q, T_rv_w.t
    rect_params = camops.rect_static(mapper.cam)
    splat = voting.resolve_backend(backend)
    opts = extract.DepthMapOptions()
    per = N_EVENTS // n_sub

    @jax.jit
    def step(x, y, t):
        acc = None
        for k in range(n_sub):
            sl = slice(k * per, (k + 1) * per)
            dsis = []
            for tt in (traj_t0, traj_t1):
                trj = trajmod.Trajectory(traj_ts, SE3(traj_q, tt))
                packets = voting.warp_events_to_z0(
                    x[sl], y[sl], t[sl], trj, SE3(rv_q, rv_t), None, K_cam,
                    Kv_inv, z0=z0, width=mapper.width, packet_size=PACKET,
                    full=True, rect_params=rect_params)
                dsis.append(splat(packets, depths, z0, vp, mapper.width,
                                  mapper.height, plane_block=plane_block))
            fused_k = gridops.fuse_pair(dsis[0], dsis[1], gridops.FUSE_HM)
            acc = gridops.add_inverse(
                acc if acc is not None else jnp.zeros_like(fused_k), fused_k)
        fused = gridops.hm_from_sum_of_inv(acc, n_sub)
        res = extract.get_depth_map_from_dsi(fused, mapper.depth_vec, opts)
        return res.depth

    return step


def make_step(mapper, traj, T_rv_w, backend, plane_block):
    import jax
    import jax.numpy as jnp

    from dvs_mcemvs_tpu.ops import trajectory as trajmod, voting
    from dvs_mcemvs_tpu.ops.se3 import SE3

    from dvs_mcemvs_tpu.ops import camera as camops

    z0 = float(mapper.depth_vec.depths()[0])
    vp = (float(mapper.vcam.fx), float(mapper.vcam.fy),
          float(mapper.vcam.cx), float(mapper.vcam.cy))
    K_cam = jnp.asarray(mapper.cam.P, jnp.float32)
    Kv_inv = jnp.asarray(np.linalg.inv(mapper.vcam.P), jnp.float32)
    depths = jnp.asarray(mapper.depth_vec.depths(), jnp.float32)
    traj_ts, traj_q, traj_t = traj.ts, traj.poses.q, traj.poses.t
    rv_q, rv_t = T_rv_w.q, T_rv_w.t
    rect_params = camops.rect_static(mapper.cam)
    splat = voting.resolve_backend(backend)

    @jax.jit
    def step(x, y, t):
        trj = trajmod.Trajectory(traj_ts, SE3(traj_q, traj_t))
        packets = voting.warp_events_to_z0(
            x, y, t, trj, SE3(rv_q, rv_t), None, K_cam, Kv_inv,
            z0=z0, width=mapper.width, packet_size=PACKET, full=True,
            rect_params=rect_params,
        )
        return splat(packets, depths, z0, vp, mapper.width, mapper.height,
                     plane_block=plane_block)

    return step


def time_step(step, dev_args, min_time=1.0):
    """Seconds per call of `step`: one warm-up call (compiles), then the
    minimum over 3 runs of back-to-back calls spanning >= `min_time`
    seconds, each run ending in `block_until_ready`."""
    import math

    import jax

    jax.block_until_ready(step(*dev_args))
    t0 = time.perf_counter()
    jax.block_until_ready(step(*dev_args))
    dt0 = max(time.perf_counter() - t0, 1e-6)
    iters = int(np.clip(math.ceil(min_time / dt0), 1, 1000))
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = step(*dev_args)
        jax.block_until_ready(out)
        runs.append((time.perf_counter() - t0) / iters)
    return min(runs)


def full_seq_sustained(backend, plane_block, n_chunks=22, warmup=2,
                       duration=0.2):
    """Sustained scheduler throughput: >= 20 chunks of
    the headline workload through the full_seq chunk loop with a
    DEVICE-RESIDENT event store — the stream is ingested ONCE (native .evs
    store -> device arrays), each chunk is a device-side dynamic slice,
    and per chunk the full process_1 computation (warp -> vote x2 -> HM
    fuse -> collapse -> extract) runs on-device, with a QUANTIZED single
    device->host transfer feeding the worker-pool save pipeline (the full
    saveDepthMaps artifact set per chunk).  Reports sustained Mev/s
    including the per-chunk downlink and output writes — the span of the
    reference's per-chunk loop (main.cpp:173-302) around its Mev/s probe
    (process1.cpp:82-86).

    Keeping events resident in device memory (hours of stream fit)
    instead of re-uploading per chunk takes the host link off the per-chunk
    path; only the quantized result buffer comes back.

    The stream time-tiles the 1 Mi-event bench stream: chunk k spans
    [k*duration, (k+1)*duration) with the camera advancing the same 0.5 m
    per chunk as the headline workload (continuous across chunks), so the
    auto backend spec and all jit shapes match the headline's exactly.
    """
    import shutil
    import tempfile

    import jax
    import jax.numpy as jnp

    from dvs_mcemvs_tpu.io import outputs
    from dvs_mcemvs_tpu.mapper import Events
    from dvs_mcemvs_tpu.ops import (camera as camops, extract,
                                    grid as gridops,
                                    trajectory as trajmod, voting)
    from dvs_mcemvs_tpu.ops.se3 import SE3
    from dvs_mcemvs_tpu.utils.writers import SaveWorkerPool

    mapper, (x, y, t), traj, T_rv_w = build_workload()
    tmin, tmax = float(t[0]), float(t[-1])
    span = max(tmax - tmin, 1e-9)
    # Chunk k's events: the bench stream remapped into (k*D, (k+1)*D).
    tg = [((t - tmin) / span * 0.96 + 0.02 + k) * duration
          for k in range(n_chunks)]
    x_all = np.tile(x, n_chunks).astype(np.int32)
    y_all = np.tile(y, n_chunks).astype(np.int32)
    t_all = np.concatenate(tg).astype(np.float32)
    p_all = np.ones_like(x_all, np.int8)

    # Continuous trajectory: 0.5 m of travel per `duration` (the headline
    # chunk's travel), camera1 at +0.6 m stereo baseline.
    tsp = np.linspace(0.0, n_chunks * duration, n_chunks * 50)
    qp = np.tile([1.0, 0.0, 0.0, 0.0], (tsp.size, 1))
    pp = np.stack([0.5 * tsp / duration, 0.0 * tsp, 0.0 * tsp], axis=-1)
    traj0 = trajmod.from_arrays(tsp, qp, pp)

    # INGEST (once): write + read back through the native mmap store, then
    # park the stream in device memory.
    from dvs_mcemvs_tpu.io import evstore

    work = tempfile.mkdtemp(prefix="bench_fullseq_")
    path = f"{work}/events.evs"
    evstore.write_store(path, Events(x_all, y_all, t_all, p_all))
    st = evstore.EventStore(path)
    ev = st.window(-1.0, (n_chunks + 1) * duration)
    st.close()
    x_dev = jnp.asarray(ev.x, jnp.int32)
    y_dev = jnp.asarray(ev.y, jnp.int32)
    t_dev = jnp.asarray(ev.t, jnp.float32)

    # Per-chunk slice offsets from the store's time index (host binary
    # search; slices are equal-size by construction so jit shapes stay
    # fixed — the bucket-pad policy of the host scheduler).
    t_np = np.asarray(ev.t)
    offs = [int(np.searchsorted(t_np, k * duration)) for k in range(n_chunks)]
    assert all(o2 - o1 == N_EVENTS for o1, o2 in zip(offs, offs[1:])), offs

    z0 = float(mapper.depth_vec.depths()[0])
    vp = (float(mapper.vcam.fx), float(mapper.vcam.fy),
          float(mapper.vcam.cx), float(mapper.vcam.cy))
    K_cam = jnp.asarray(mapper.cam.P, jnp.float32)
    Kv_inv = jnp.asarray(np.linalg.inv(mapper.vcam.P), jnp.float32)
    depths = jnp.asarray(mapper.depth_vec.depths(), jnp.float32)
    rect_params = camops.rect_static(mapper.cam)
    splat = voting.resolve_backend(backend)
    opts = extract.DepthMapOptions()
    traj_t1 = traj0.poses.t + jnp.asarray([0.6, 0.0, 0.0],
                                          traj0.poses.t.dtype)
    min_d, max_d = 2.0, 40.0
    H, W = mapper.height, mapper.width

    @jax.jit
    def step(off, ts_k, x_dev, y_dev, t_dev):
        # The resident stream rides in as ARGUMENTS: closing over the
        # device arrays would embed them as HLO constants (an ~84 MB
        # compile payload).
        xs = jax.lax.dynamic_slice(x_dev, (off,), (N_EVENTS,))
        ys = jax.lax.dynamic_slice(y_dev, (off,), (N_EVENTS,))
        tsx = jax.lax.dynamic_slice(t_dev, (off,), (N_EVENTS,))
        T_w_rv, _ = trajmod.pose_at(traj0, ts_k)
        from dvs_mcemvs_tpu.ops import se3 as se3mod

        T_rv = se3mod.inverse(T_w_rv)
        dsis = []
        for tt in (traj0.poses.t, traj_t1):
            trj = trajmod.Trajectory(traj0.ts, SE3(traj0.poses.q, tt))
            packets = voting.warp_events_to_z0(
                xs, ys, tsx, trj, T_rv, None, K_cam, Kv_inv,
                z0=z0, width=W, packet_size=PACKET, full=True,
                rect_params=rect_params)
            dsis.append(splat(packets, depths, z0, vp, W, H,
                              plane_block=plane_block))
        fused = gridops.fuse_many(dsis, gridops.FUSE_HM)
        res = extract.get_depth_map_from_dsi(fused, mapper.depth_vec, opts)
        # Quantized single-buffer downlink: u16 depth over [min_d, max_d]
        # (0.6 mm step), u8 min-max confidence (its only artifact is the
        # 8-bit negated PNG, so 256 levels are lossless) + its f32 range,
        # u8 mask.
        dq = jnp.clip((res.depth - min_d) / (max_d - min_d), 0, 1) * 65535
        dq = dq.astype(jnp.uint16)
        cmin, cmax = jnp.min(res.confidence), jnp.max(res.confidence)
        cq = ((res.confidence - cmin) / jnp.maximum(cmax - cmin, 1e-9)
              * 255).astype(jnp.uint8)
        planes = jnp.stack([(dq >> 8).astype(jnp.uint8),
                            (dq & 0xFF).astype(jnp.uint8),
                            cq,
                            res.mask.astype(jnp.uint8)])
        scales = jnp.stack([cmin, cmax]).astype(jnp.float32)
        scales_u8 = jax.lax.bitcast_convert_type(scales, jnp.uint8)
        return jnp.concatenate([planes.reshape(-1),
                                scales_u8.reshape(-1)])

    def save_chunk(k, ts_k, packed):
        arr = np.asarray(packed)  # the one device->host transfer
        scales = arr[-8:].view(np.float32)
        pl4 = arr[:-8].reshape(4, H, W)
        depth = (pl4[0].astype(np.uint16) << 8 | pl4[1]).astype(np.float32)
        depth = depth / 65535.0 * (max_d - min_d) + min_d
        conf = pl4[2].astype(np.float32)
        conf = conf / 255.0 * (scales[1] - scales[0]) + scales[0]
        mask = pl4[3]
        depth = np.where(mask > 0, depth, 0.0)
        prefix = outputs.timestamp_prefix(work, ts_k)
        outputs.save_depth_maps(depth, conf, mask, min_d, max_d, "fused",
                                prefix)

    # Context for the sustained number: the per-chunk downlink (the 1.2 MB
    # quantized buffer) rides the host link.
    probe = step(jnp.int32(offs[0]), jnp.float32(0.5 * duration),
                 x_dev, y_dev, t_dev)
    np.asarray(probe)  # settle
    t0 = time.perf_counter()
    buf = np.asarray(step(jnp.int32(offs[0]), jnp.float32(0.5 * duration),
                          x_dev, y_dev, t_dev))
    downlink_mb_s = buf.nbytes / 2**20 / max(time.perf_counter() - t0, 1e-9)

    pool = SaveWorkerPool()
    n_done = 0
    t_start = None
    for k in range(n_chunks):
        ts_k = (k + 0.5) * duration
        if k == warmup:
            pool.drain()          # warmup chunks fully written
            t_start = time.perf_counter()
        out = step(jnp.int32(offs[k]), jnp.float32(ts_k),
                   x_dev, y_dev, t_dev)
        pool.submit(save_chunk, k, ts_k, out)
        n_done += 1
    pool.drain()
    wall = time.perf_counter() - (t_start or time.perf_counter())
    pool.shutdown()
    n_files = len([f for f in os.listdir(work) if f.endswith(".png")])
    shutil.rmtree(work, ignore_errors=True)
    timed = n_done - warmup
    if timed <= 0 or wall <= 0:
        raise RuntimeError(f"too few chunks timed ({n_done})")
    mev_s = 2 * N_EVENTS * timed / wall / 1e6
    return {"mev_s": mev_s, "chunks_timed": timed,
            "events_per_chunk": 2 * N_EVENTS,
            "seconds_per_chunk": wall / timed,
            "store_ingest": True, "device_resident_events": True,
            "artifact_files": n_files,
            "downlink_mb_per_chunk": buf.nbytes / 2**20,
            "downlink_mb_s": downlink_mb_s,
            "includes": "one-time store ingest -> device-resident stream, "
                        "device-side chunk windowing, voting, fusion, "
                        "extraction, quantized downlink, saveDepthMaps "
                        "artifact writes (worker pool)"}


def golden_gate(spec=None):
    """Run a voting spec on the BENCH16 golden fixture ON THE DEVICE and
    score it against its committed exact-scatter anchor (BUDGET_BENCH16
    + the 5 % metric gate) — so the perf number is taken at certified
    accuracy.  BENCH16 is the zurich_city_04 window whose 0.393 m of real
    travel auto-selects the SAME g16 group size as the headline workload,
    so main() can pass the LITERAL headline spec string and gate exactly
    the backend the throughput number times; `spec=None` uses the
    fixture's own auto spec (identical string by construction — asserted
    by tests/test_golden_fast.py)."""
    from dvs_mcemvs_tpu import pipeline
    from dvs_mcemvs_tpu.mapper import get_depth_map
    from dvs_mcemvs_tpu.ops import extract
    from dvs_mcemvs_tpu.utils import golden

    mappers, events, trajs, scene, ts_rv = golden.build_golden_fixture(
        cfg=golden.BENCH16)
    if spec is None:
        spec = golden.production_backend_spec(events, 1024,
                                              cfg=golden.BENCH16)
    vopts = pipeline.VotingOptions(packet_size=1024, backend=spec,
                                   pad_policy="bucket")
    res = pipeline.process_1(mappers, events, trajs, ts_rv,
                             stereo_fusion=2, vopts=vopts)
    dm = get_depth_map(mappers[0], res.fused_dsi, extract.DepthMapOptions())

    g = np.load(golden.GOLDEN_BENCH16_NPZ)
    gi = np.asarray(g["depth_indices"]).astype(int)
    conf = np.asarray(g["confidence"])
    budget = golden.BUDGET_BENCH16
    sel = conf > np.quantile(conf, budget["confident_quantile"])
    ei = np.abs(np.asarray(dm.depth_indices).astype(int)[sel] - gi[sel])
    m = np.asarray(dm.mask) > 0
    rel = float(np.median(np.abs(np.asarray(dm.depth)[m] - scene.gt_depth[m])
                          / scene.gt_depth[m]))
    within1, within2 = float(np.mean(ei <= 1)), float(np.mean(ei <= 2))
    med = float(np.median(ei))
    ok = (within1 >= budget["frac_within_1_plane"]
          and within2 >= budget["frac_within_2_planes"]
          and med <= budget["median_err_planes"]
          and rel < budget["gt_median_rel_err"])
    return {"spec": spec, "within1": within1,
            "within2": within2, "median_planes": med,
            "gt_median_rel_err": rel, "pass": bool(ok)}


def main():
    import jax
    import jax.numpy as jnp

    from dvs_mcemvs_tpu.config import RunConfig
    from dvs_mcemvs_tpu.ops.voting_hist import (auto_backend_spec,
                                                auto_group_size)
    from dvs_mcemvs_tpu.utils.runtime import enable_compile_cache, on_accelerator

    enable_compile_cache()
    if not on_accelerator():
        print(f"bench.py: no GPU (JAX platform {jax.default_backend()!r}); "
              "device timings need the card", file=sys.stderr)
        return 1
    dev = jax.devices()[0]

    mapper, (x, y, t), traj, T_rv_w = build_workload()
    dev_args = (jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32),
                jnp.asarray(t, jnp.float32))

    # The headline spec is the one the product ships: the same
    # auto_backend_spec call the CLI makes (--splat_backend=auto) and the
    # golden accuracy gates certify, at the CLI's default plane block.
    backend = auto_backend_spec(0.5, N_EVENTS // PACKET, WIDTH * 0.9,
                                2.0, 40.0, DIM_Z)
    plane_block = RunConfig().plane_block

    def timed(maker, spec):
        return time_step(maker(mapper, traj, T_rv_w, spec, plane_block),
                         dev_args)

    dt = timed(make_step, backend)
    mev_s = N_EVENTS / dt / 1e6

    # The full process_1 chunk — warp -> vote (2 cams) -> HM fuse ->
    # collapse -> extract, the span the reference's log times — for the
    # shipped spec and each alternative voting backend.
    g = auto_group_size(0.5, N_EVENTS // PACKET, WIDTH * 0.9, 2.0, 40.0)
    chunk_s = {}
    for spec in (backend, f"hist:g{g},seg16", "scatter", "sort"):
        chunk_s[spec] = timed(make_full_chunk_step, spec)
    chunk_mev_s = {k: 2 * N_EVENTS / v / 1e6 for k, v in chunk_s.items()}

    # process_2 chunk on the shipped spec — 2 sub-intervals, per-sub camera
    # HM fuse, streaming temporal HM, extraction.
    alg2_s = timed(make_alg2_step, backend)

    # Sustained scheduler throughput: >= 20 chunks through stores +
    # worker-pool saves.
    sustained = full_seq_sustained(backend, plane_block)

    # Accuracy certification on the device, on the literal headline spec.
    golden = golden_gate(spec=backend)

    print(json.dumps({
        "metric": "dsi_voting_throughput",
        "value": mev_s,
        "unit": "Mev/s",
        "detail": {
            "backend": backend,
            "backend_is_cli_auto_spec": True,
            "plane_block": plane_block,
            "dsi": [DIM_Z, HEIGHT, WIDTH],
            "events": N_EVENTS,
            "seconds_per_step": dt,
            "full_chunk_events": 2 * N_EVENTS,
            "full_chunk_seconds": chunk_s,
            "full_chunk_mev_s": chunk_mev_s,
            "alg2_chunk_mev_s": 2 * N_EVENTS / alg2_s / 1e6,
            "full_seq_sustained": sustained,
            "golden": golden,
        },
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0 if golden["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
