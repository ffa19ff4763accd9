#!/usr/bin/env python3
"""Smoke test of the MC-EMVS main path on an NVIDIA GPU.

Runs, in one process and with no CPU fallback:

  a. device check: JAX must find a GPU; prints the card's name and power
     limit (nvidia-smi), the compile-cache directory and which optional
     packages import;
  b. process_1 at DSEC size (640x480 sensor, dimZ=100, two cameras,
     1,048,576 events per camera in the chunk) through the CLI entry point
     `dvs_mcemvs_tpu.cli.main`, on synthetic events written from `--seed`;
  c. full_seq over 3 overlapping windows of the same size through the
     native event store;
  d. process_2 (2 intervals), single shot, same size;
  e. the golden fixture (640x480x100, 262,144 events per camera) against
     its committed exact-scatter anchor: the shipped auto spec within
     `golden.BUDGET`, and exact `scatter` within 1e-4 relative per-camera
     vote mass and equal depth index on >= 99 % of the confident pixels;
  f. step report: `memory_analysis()` of the process_1 voting step and the
     device's peak memory after phase b;
  g. the tests marked `gpu` (tests/test_gpu.py), in this process.

`--four` runs only the sharded path on four GPUs, each result compared
with the single-device result computed in the same process on device 0.

Usage:
    python chip_smoke.py [--seed N]
    python chip_smoke.py --four [--seed N]

Exits non-zero if any phase fails.  The last line of standard output is
one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

WIDTH, HEIGHT, DIM_Z = 640, 480, 100
N_CHUNK = 1_048_576          # events per camera in one chunk
PACKET = 1024
MIN_DEPTH, MAX_DEPTH = 1.5, 12.0
SPEED = 0.5                  # m/s of rig travel along the body x axis
STRIPE_DEPTHS = (2.5, 4.0, 6.0, 9.0, 3.0, 5.0)
MASS_REL_TOL = 1e-4          # f32 atomics sum in an unordered way
ARGMAX_AGREE_MIN = 0.99      # of the top-20 % confident pixels


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


class LogCapture(logging.Handler):
    """Keeps the package's log messages so phases can assert which path
    the CLI took."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def grep(self, pattern):
        return [m for m in self.messages if re.search(pattern, m)]


# ---------------------------------------------------------------------------
# Synthetic dataset: a stripe-plane scene seen by the calibrated rig moving
# along its body x axis; events are projected through each camera's real
# rectification (nearest raw pixel of the rectification LUT).
# ---------------------------------------------------------------------------


def _camera_poses(rig, i):
    """(R_w_c, t_w_c at body position 0) of camera i: the CLI's chaining
    T_w_ci = T_w_body * T_hand_eye * T_i_0^-1 with an identity body
    rotation."""
    T = rig.T_hand_eye @ np.linalg.inv(rig.extrinsics(i))
    return T[:3, :3], T[:3, 3]


def make_dataset(out_dir, calib_type, seed, n_chunk=N_CHUNK, span=2.0,
                 chunk=(0.5, 1.5)):
    """Write events_{0,1}.npz and poses_tum.txt to `out_dir`.

    Each camera gets exactly n_chunk/2 events in every half-chunk-long
    segment of [0, span), so the chunk and every window of the chunk's
    length starting on a segment boundary hold exactly `n_chunk` events.
    Returns the dataset description."""
    from scipy.spatial import cKDTree

    from dvs_mcemvs_tpu.io import calib as calibmod
    from dvs_mcemvs_tpu.io.events import write_events_npz
    from dvs_mcemvs_tpu.mapper import Events
    from dvs_mcemvs_tpu.ops.camera import rectify_lut

    os.makedirs(out_dir, exist_ok=True)
    rig = calibmod.load_calibration(calib_type, "", "")
    rng = np.random.default_rng(seed)
    t_mid = 0.5 * (chunk[0] + chunk[1])
    seg = 0.5 * (chunk[1] - chunk[0])
    n_seg = int(round(span / seg))
    per_seg = n_chunk // 2

    # Scene: fronto-parallel stripes in camera 0's frame at t_mid.
    cam0 = rig.cams[0]
    P0, R0 = cam0.P, cam0.Rmat
    R_wc0, t_wc0 = _camera_poses(rig, 0)
    pos_mid = np.array([SPEED * t_mid, 0.0, 0.0])
    n_pts = n_chunk // 16        # ~16 events per scene point per chunk
    S = len(STRIPE_DEPTHS)
    stripe = rng.integers(0, S, n_pts)
    pad = 120.0
    u = (stripe + rng.uniform(0, 1, n_pts)) * (WIDTH + 2 * pad) / S - pad
    v = rng.uniform(-pad, HEIGHT + pad, n_pts)
    depth = np.asarray(STRIPE_DEPTHS)[stripe]
    rays_rect = np.stack([(u - P0[0, 2]) / P0[0, 0],
                          (v - P0[1, 2]) / P0[1, 1], np.ones(n_pts)], -1)
    X_c0 = (rays_rect @ R0) * depth[:, None]        # R0^T * rect ray
    X_w = X_c0 @ R_wc0.T + (t_wc0 + pos_mid)[None, :]

    paths = {}
    for i in range(2):
        cam = rig.cams[i]
        R_wc, t_wc = _camera_poses(rig, i)
        tree = cKDTree(rectify_lut(cam))   # rectified location of each raw pixel
        xs, ys, ts = [], [], []
        for s in range(n_seg):
            need = per_seg
            while need > 0:
                m = 2 * need + 1024
                tt = rng.uniform(s * seg, (s + 1) * seg, m)
                k = rng.integers(0, n_pts, m)
                c = t_wc[None, :] + np.stack([SPEED * tt, 0 * tt, 0 * tt], -1)
                X_r = (X_w[k] - c) @ R_wc @ cam.Rmat.T   # rectified camera frame
                z = X_r[:, 2]
                ok = z > 0.3
                z = np.where(ok, z, 1.0)
                uv = np.stack([cam.P[0, 0] * X_r[:, 0] / z + cam.P[0, 2],
                               cam.P[1, 1] * X_r[:, 1] / z + cam.P[1, 2]], -1)
                dist, idx = tree.query(uv[ok], distance_upper_bound=0.75,
                                       workers=-1)
                hit = np.isfinite(dist)
                take = min(need, int(hit.sum()))
                idx = idx[hit][:take]
                xs.append(idx % cam.width)
                ys.append(idx // cam.width)
                ts.append(tt[ok][hit][:take])
                need -= take
        x = np.concatenate(xs).astype(np.int32)
        y = np.concatenate(ys).astype(np.int32)
        t = np.concatenate(ts)
        order = np.argsort(t, kind="stable")
        ev = Events(x[order], y[order], t[order],
                    rng.integers(0, 2, x.size).astype(np.int8))
        paths[f"events{i}"] = os.path.join(out_dir, f"events_{i}.npz")
        write_events_npz(paths[f"events{i}"], ev)

    ts = np.linspace(0.0, span, 401)
    paths["poses"] = os.path.join(out_dir, "poses_tum.txt")
    with open(paths["poses"], "w") as f:
        f.write("# t x y z qx qy qz qw\n")
        for tk in ts:
            f.write(f"{tk:.9f} {SPEED * tk:.9f} 0 0 0 0 0 1\n")
    paths.update(calib_type=calib_type, chunk=chunk, span=span)
    return paths


def load_chunk(data, lo, hi):
    """(mappers, events, trajs) of the dataset's window [lo, hi] exactly as
    the CLI builds them."""
    from dvs_mcemvs_tpu import cli
    from dvs_mcemvs_tpu.io import calib as calibmod, events as eventsmod
    from dvs_mcemvs_tpu.io import poses as posesmod
    from dvs_mcemvs_tpu.mapper import DsiShape, make_mapper

    rig = calibmod.load_calibration(data["calib_type"], "", "")
    trajs = cli._build_trajectories(posesmod.read_poses(data["poses"]), rig, 2)
    evs = [eventsmod.read_events(data[f"events{i}"], t_start=lo, t_stop=hi)
           for i in range(2)]
    shape = DsiShape(WIDTH, HEIGHT, DIM_Z, 0.0, MIN_DEPTH, MAX_DEPTH)
    mappers = [make_mapper(rig.cams[i], shape, "linear") for i in range(2)]
    return mappers, evs, trajs


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device(four):
    import jax

    from dvs_mcemvs_tpu.utils.runtime import enable_compile_cache, on_accelerator

    cache = enable_compile_cache()
    devs = jax.devices()
    plat = devs[0].platform
    if not on_accelerator(plat):
        raise PhaseError(f"no GPU: JAX platform is {plat!r}")
    need = 4 if four else 1
    check(len(devs) >= need, f"need {need} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        print(line.strip())
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind} "
          f"({plat}); compile cache {cache}")
    have = {}
    for mod in ("cv2", "yaml", "h5py", "hdf5plugin"):
        try:
            __import__(mod)
            have[mod] = True
        except ImportError:
            have[mod] = False
    print("optional packages: " + ", ".join(
        f"{m}={'yes' if ok else 'no'}" for m, ok in have.items()))
    return have


def _cli(args):
    from dvs_mcemvs_tpu import cli

    rc = cli.main(args)
    check(rc == 0, f"cli.main returned {rc}")


def _common_args(data, out, dense):
    return [
        f"--calib_type={data['calib_type']}",
        f"--bag_filename_left={data['events0']}",
        f"--bag_filename_right={data['events1']}",
        f"--bag_filename_pose={data['poses']}",
        f"--out_path={out}", f"--dimX={WIDTH}", f"--dimY={HEIGHT}",
        f"--dimZ={DIM_Z}", f"--min_depth={MIN_DEPTH}",
        f"--max_depth={MAX_DEPTH}", "--splat_backend=auto",
        "--num_devices=1",
    ] + ([] if dense else ["--nosave_dense"])


def _depth_points(path):
    pts = np.loadtxt(path, ndmin=2)
    check(pts.shape[0] > 1000, f"{path}: only {pts.shape[0]} depth points")
    check(np.isfinite(pts).all(), f"{path}: non-finite depth points")
    d = pts[:, 2]
    check(((d >= MIN_DEPTH * 0.999) & (d <= MAX_DEPTH * 1.001)).all(),
          f"{path}: depths outside [{MIN_DEPTH}, {MAX_DEPTH}]")
    return pts


def phase_process1(data, work, dense, logs):
    out = os.path.join(work, "p1")
    lo, hi = data["chunk"]
    t0 = time.perf_counter()
    _cli(_common_args(data, out, dense) + [
        "--process_method=1", f"--start_time_s={lo}", f"--stop_time_s={hi}"])
    wall = time.perf_counter() - t0
    ts = 0.5 * (lo + hi)
    prefix = os.path.join(out, f"{ts:013.9f}")
    want = [prefix + "depth_points_fused.txt",
            prefix + "confidence_map_negated_fused.png",
            prefix + "inv_depth_colored_dilated_fused.png",
            os.path.join(out, "events_0.png"),
            os.path.join(out, "pointcloud.pcd")]
    if dense:
        want.append(prefix + "depth_map_dense_fused.png")
    for f in want:
        check(os.path.isfile(f) and os.path.getsize(f) > 0, f"missing {f}")
    with open(want[1], "rb") as f:
        check(f.read(8) == b"\x89PNG\r\n\x1a\n", "confidence PNG header")
    pts = _depth_points(want[0])
    spec = logs.grep(r"auto backend: ")
    check(spec, "the CLI logged no auto backend spec")
    spec = spec[-1].split("auto backend: ")[1].split()[0]
    print(f"phase b: process_1 via cli.main, spec {spec}, "
          f"{pts.shape[0]} depth points, median depth "
          f"{np.median(pts[:, 2])} m, wall {wall} s (compile included)")
    return spec


def phase_full_seq(data, work, dense, logs):
    out = os.path.join(work, "fs")
    lo, hi = data["chunk"]
    dur = hi - lo
    n0 = len(logs.messages)
    _cli(_common_args(data, out, dense) + [
        "--process_method=1", "--full_seq", "--start_time_s=0",
        f"--stop_time_s={data['span']}", f"--duration={dur}",
        f"--out_skip={dur / 2}", "--nosave_pointcloud"])
    msgs = logs.messages[n0:]
    check(any("native event store + prefetch enabled" in m for m in msgs),
          "full_seq did not take the native event store path")
    check(not any("native event store unavailable" in m for m in msgs),
          "full_seq fell back to the numpy path")
    txt = sorted(f for f in os.listdir(out)
                 if f.endswith("depth_points_fused.txt"))
    check(len(txt) >= 3, f"full_seq wrote {len(txt)} windows, want >= 3")
    for f in txt:
        _depth_points(os.path.join(out, f))
    check(os.path.exists(os.path.join(out, ".events_0.evs")),
          "no native store file in the run dir")
    print(f"phase c: full_seq via cli.main through the native event store, "
          f"{len(txt)} windows")


def phase_process2(data, work, dense):
    out = os.path.join(work, "p2")
    lo, hi = data["chunk"]
    _cli(_common_args(data, out, dense) + [
        "--process_method=2", "--num_intervals=2",
        f"--start_time_s={lo}", f"--stop_time_s={hi}",
        "--nosave_pointcloud"])
    prefix = os.path.join(out, f"{0.5 * (lo + hi):013.9f}")
    pts = _depth_points(prefix + "depth_points_fused.txt")
    for sub in ("0_000", "1_001"):
        check(os.path.isfile(prefix + f"depth_points_{sub}.txt"),
              f"process_2 wrote no sub-interval map {sub}")
    print(f"phase d: process_2 (2 intervals) via cli.main, "
          f"{pts.shape[0]} depth points")


def _index_agreement(idx, ref_idx, ref_conf, q=0.8):
    sel = ref_conf > np.quantile(ref_conf, q)
    return np.abs(np.asarray(idx).astype(int)[sel]
                  - np.asarray(ref_idx).astype(int)[sel])


def phase_golden():
    from dvs_mcemvs_tpu import pipeline
    from dvs_mcemvs_tpu.mapper import get_depth_map
    from dvs_mcemvs_tpu.ops import extract
    from dvs_mcemvs_tpu.utils import golden

    mappers, events, trajs, scene, ts_rv = golden.build_golden_fixture()
    g = np.load(golden.GOLDEN_NPZ)
    meta = json.loads(str(g["meta"]))
    check(meta["events"] == [e.num for e in events],
          "golden fixture drifted from the committed anchor")
    B = golden.BUDGET

    def run(spec):
        vopts = pipeline.VotingOptions(packet_size=1024, backend=spec,
                                       pad_policy="bucket")
        res = pipeline.process_1(mappers, events, trajs, ts_rv,
                                 stereo_fusion=2, vopts=vopts)
        dm = get_depth_map(mappers[0], res.fused_dsi,
                           extract.DepthMapOptions())
        mass = [float(np.asarray(res.dsis[f"camera{c}"], np.float64).sum())
                for c in range(2)]
        mass_rel = [abs(m / a - 1) for m, a in zip(mass, g["cam_mass"])]
        ei = _index_agreement(dm.depth_indices, g["depth_indices"],
                              g["confidence"], B["confident_quantile"])
        m = np.asarray(dm.mask) > 0
        rel = float(np.median(np.abs(np.asarray(dm.depth)[m]
                                     - scene.gt_depth[m]) / scene.gt_depth[m]))
        return dict(spec=spec, within0=float(np.mean(ei == 0)),
                    within1=float(np.mean(ei <= 1)),
                    within2=float(np.mean(ei <= 2)),
                    median_planes=float(np.median(ei)),
                    gt_median_rel_err=rel, cam_mass_rel=mass_rel)

    shipped = run(golden.production_backend_spec(events, 1024))
    print("phase e: shipped spec vs exact-scatter anchor: "
          + json.dumps(shipped))
    check(shipped["within1"] >= B["frac_within_1_plane"]
          and shipped["within2"] >= B["frac_within_2_planes"]
          and shipped["median_planes"] <= B["median_err_planes"]
          and shipped["gt_median_rel_err"] < B["gt_median_rel_err"],
          f"shipped spec outside golden.BUDGET: {shipped}")
    exact = run("scatter")
    print("phase e: scatter vs exact-scatter CPU anchor: " + json.dumps(exact))
    check(max(exact["cam_mass_rel"]) <= MASS_REL_TOL,
          f"scatter vote mass off the anchor by {exact['cam_mass_rel']}")
    check(exact["within0"] >= ARGMAX_AGREE_MIN,
          f"scatter depth index equal on {exact['within0']} of confident "
          f"pixels, want >= {ARGMAX_AGREE_MIN}")


def phase_report(data, spec, peak_after_p1):
    from dvs_mcemvs_tpu import mapper as mappermod, pipeline
    from dvs_mcemvs_tpu.config import RunConfig

    lo, hi = data["chunk"]
    mappers, evs, trajs = load_chunk(data, lo, hi)
    T_rv_w = pipeline.place_reference_view(trajs[0], 0.5 * (lo + hi))
    args = mappermod.dsi_step_args(mappers[0], evs[0], trajs[0], T_rv_w,
                                   PACKET, spec, RunConfig().plane_block,
                                   pad="bucket")
    compiled = mappermod._evaluate_dsi_jit.lower(*args).compile()
    print(f"phase f: process_1 voting step ({spec}, {evs[0].num} events, "
          f"one camera) memory_analysis: {compiled.memory_analysis()}")
    print(f"phase f: peak_bytes_in_use after process_1: {peak_after_p1}; "
          f"now: {_peak_bytes()}")


def phase_gpu_tests():
    """Run the tests marked `gpu` in this process (no second process opens
    the card)."""
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1

    os.environ["EMVS_TEST_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", "-rs",
                      os.path.join(REPO, "tests", "test_gpu.py")],
                     plugins=[Count()])
    check(rc == 0, f"gpu tests failed (pytest exit {rc})")
    check(Count.passed >= 4, f"only {Count.passed} gpu tests passed")
    print(f"phase g: {Count.passed} gpu-marked tests passed")


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase_four(data):
    """Sharded process_1 on (4, 1) and (2, 2) meshes and sharded process_2,
    each against the single-device result on device 0."""
    import jax

    from dvs_mcemvs_tpu import cli, pipeline
    from dvs_mcemvs_tpu.config import RunConfig
    from dvs_mcemvs_tpu.mapper import get_depth_map
    from dvs_mcemvs_tpu.ops import extract
    from dvs_mcemvs_tpu.ops.voting_hist import auto_backend_spec
    from dvs_mcemvs_tpu.parallel import make_mesh, sharded
    from dvs_mcemvs_tpu.utils import golden

    lo, hi = data["chunk"]
    ts = 0.5 * (lo + hi)
    mappers, evs, trajs = load_chunk(data, lo, hi)
    # The spec the CLI's auto path picks for this chunk (phase b logs it).
    spec = auto_backend_spec(SPEED * (hi - lo), N_CHUNK // PACKET,
                             float(mappers[0].vcam.fx), MIN_DEPTH, MAX_DEPTH,
                             DIM_Z)
    print(f"four: shipped spec {spec}")
    evs = [e.slice(0, (e.num // PACKET) * PACKET) for e in evs]
    T_rv_w = pipeline.place_reference_view(trajs[0], ts)
    rspec = sharded.rig_spec_from_mappers(mappers)
    dev0 = jax.devices()[:1]

    def compare(label, dsi, idx, ref_dsi, ref_idx, ref_conf):
        rel = abs(float(np.asarray(dsi, np.float64).sum())
                  / float(np.asarray(ref_dsi, np.float64).sum()) - 1)
        agree = float(np.mean(_index_agreement(idx, ref_idx, ref_conf) == 0))
        print(f"four: {label}: fused vote mass rel {rel}, depth index equal "
              f"on {agree} of confident pixels")
        return rel, agree

    results = {}
    for backend, meshes in (("scatter", [(4, 1), (2, 2)]), (spec, [(4, 1)])):
        cfg = sharded.ShardedStepConfig(fusion_method=2, packet_size=PACKET,
                                        backend=backend)
        ref = sharded.make_sharded_step(make_mesh(1, 1, dev0), rspec, cfg)(
            *sharded.sharded_step_inputs(mappers, evs, trajs, T_rv_w, 1,
                                         PACKET))
        for ne, npl in meshes:
            out = sharded.make_sharded_step(make_mesh(ne, npl), rspec, cfg)(
                *sharded.sharded_step_inputs(mappers, evs, trajs, T_rv_w, ne,
                                             PACKET))
            results[f"process_1 {backend} ({ne},{npl})"] = compare(
                f"process_1 {backend} mesh ({ne},{npl}) vs device 0",
                out["dsi"], out["depth_indices"], ref["dsi"],
                ref["depth_indices"], ref["confidence"])

    # process_2 through the CLI's sharded pair evaluator (the --num_devices
    # path) on all four devices, against the same evaluator on device 0.
    rc = RunConfig(dimZ=DIM_Z, packet_size=PACKET, stereo_fusion=2)
    opts = extract.DepthMapOptions()
    kw = dict(stereo_fusion=2, temporal_fusion=4, num_intervals=2)

    def process_2_on(n_dev):
        ev_pair = cli._make_sharded_pair_evaluator(rc, mappers, "scatter",
                                                   n_dev)
        res = pipeline.process_2(mappers, evs, trajs, ts,
                                 evaluate_pair=ev_pair, **kw)
        return res, get_depth_map(mappers[0], res.fused_dsi, opts)

    ref, ref_dm = process_2_on(1)
    out, out_dm = process_2_on(4)
    results["process_2 scatter sharded pair evaluator"] = compare(
        "process_2 scatter, sharded pair evaluator vs device 0",
        out.fused_dsi, out_dm.depth_indices, ref.fused_dsi,
        ref_dm.depth_indices, ref_dm.confidence)

    bad = {k: v for k, v in results.items()
           if k.startswith(("process_1 scatter", "process_2"))
           and (v[0] > MASS_REL_TOL or v[1] < ARGMAX_AGREE_MIN)}
    check(not bad, f"sharded results off the device-0 result: {bad}")
    # The shipped hist spec regroups its leaf merges per event shard, so it
    # is not bit-near the 1-device run: hold its vote mass to the golden
    # per-camera mass bound instead.
    hist = results[f"process_1 {spec} (4,1)"]
    check(hist[0] < golden.BUDGET["per_camera_mass_rel"],
          f"shipped spec (4,1) vote mass off by {hist[0]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic events")
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    try:
        import dvs_mcemvs_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the dvs_mcemvs_tpu package is not next to this "
              f"script ({e})", file=sys.stderr)
        return 2

    logs = LogCapture()
    logging.getLogger("dvs_mcemvs_tpu").addHandler(logs)
    phase = "a (device check)"
    try:
        have = phase_device(args.four)
        calib = "dsec_zurich04a" if have["cv2"] else "dvsgen3"
        dense = have["cv2"]
        print(f"calibration {calib}; "
              + ("dense depth maps on" if dense else
                 "cv2 absent: CLI runs with --nosave_dense"))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            phase = "data"
            t0 = time.perf_counter()
            data = make_dataset(os.path.join(work, "data"), calib, args.seed)
            print(f"synthetic events: 2 cameras x {2 * N_CHUNK} over "
                  f"[0, {data['span']}) s, {time.perf_counter() - t0} s")
            if args.four:
                phase = "four (sharded)"
                phase_four(data)
            else:
                phase = "b (process_1)"
                spec = phase_process1(data, work, dense, logs)
                peak = _peak_bytes()
                phase = "c (full_seq)"
                phase_full_seq(data, work, dense, logs)
                phase = "d (process_2)"
                phase_process2(data, work, dense)
                phase = "e (golden)"
                phase_golden()
                phase = "f (step report)"
                phase_report(data, spec, peak)
                phase = "g (gpu tests)"
                phase_gpu_tests()
    except Exception as e:  # report which phase failed, then exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: phase {phase} FAILED: {e}", file=sys.stderr)
        return 1
    import jax

    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
