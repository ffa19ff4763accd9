"""Sharding-efficiency measurement on a virtual 8-device CPU mesh.

This measures, without multi-device hardware, the quantity that
*determines* multi-device scaling: the overhead the sharded step adds on top of the same
total compute — event-shard padding, the partial-DSI `psum`, the collapsed
all_gather, and dispatch fan-out.

Protocol: a FIXED workload (same total events, same DSI) is run on meshes
(1,1) -> (8,1) event shards and (1,8) plane shards over virtual CPU
devices that share the host's cores.  Total FLOPs are constant and the
1-device XLA CPU run already uses every core, so ideal sharded time equals
the 1-device time; any slowdown is sharding overhead.  Scaling efficiency
on n real chips is then bounded below by 1 / (overhead ratio), because on
real hardware the compute term drops by n while the overhead term (the
collectives measured here) is what remains.

The reference has no distributed layer at all (SURVEY.md §5); its only
scaling axis is OpenMP threads (mapper_emvs_stereo.cpp:166-172).

Writes SCALING.json and prints it.
"""

import json
import os
import sys
import time

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WIDTH, HEIGHT, DIM_Z = 320, 240, 64
N_EVENTS = 262_144
PACKET = 512
# The collective/padding overhead being measured does not depend on the
# voting spec (the splat is per-shard-local).
BACKEND = "hist:g16,seg8"


def build():
    import jax
    jax.config.update("jax_platforms", "cpu")

    from dvs_mcemvs_tpu import pipeline
    from dvs_mcemvs_tpu.mapper import DsiShape, Events, make_mapper
    from dvs_mcemvs_tpu.ops import trajectory as trajmod
    from dvs_mcemvs_tpu.ops.camera import PinholeCamera
    from dvs_mcemvs_tpu.utils import synthetic

    cam = PinholeCamera(width=WIDTH, height=HEIGHT, fx=WIDTH * 0.9,
                        fy=WIDTH * 0.9, cx=WIDTH / 2, cy=HEIGHT / 2)
    rig = synthetic.SyntheticRig(cam=cam, baseline=0.6, travel=0.3,
                                 plane_depths=(4.0, 12.0))
    mapper = make_mapper(cam, DsiShape(dim_z=DIM_Z, min_depth=2.0,
                                       max_depth=40.0))
    rng = np.random.default_rng(3)
    pts = synthetic.make_scene(rig, rng, 20_000)
    ev = synthetic.simulate_events(rig, pts, 0, n_samples=24, rng=rng)
    reps = -(-N_EVENTS // ev.num)
    x = np.tile(ev.x, reps)[:N_EVENTS].astype(np.int32)
    y = np.tile(ev.y, reps)[:N_EVENTS].astype(np.int32)
    t = np.sort(np.tile(ev.t, reps)[:N_EVENTS], kind="stable").astype(np.float32)
    events = Events(x=x, y=y, t=t, p=np.ones_like(x, np.int8))

    ts, q, p = synthetic.rig_poses(rig)
    traj = trajmod.from_arrays(ts, q, p)
    T_rv_w = pipeline.place_reference_view(traj, 0.5)
    return mapper, events, traj, T_rv_w


def time_mesh(mapper, events, traj, T_rv_w, ne, npl):
    from dvs_mcemvs_tpu.parallel import make_mesh, sharded

    mesh = make_mesh(ne, npl)
    spec = sharded.ShardedRigSpec(
        n_cameras=1, width=mapper.width, height=mapper.height,
        dim_z=mapper.depth_vec.n, z0=float(mapper.depth_vec.depths()[0]),
        vcam_params=(float(mapper.vcam.fx), float(mapper.vcam.fy),
                     float(mapper.vcam.cx), float(mapper.vcam.cy)))
    cfg = sharded.ShardedStepConfig(fusion_method=2, packet_size=PACKET,
                                    backend=BACKEND)
    step = sharded.make_sharded_step(mesh, spec, cfg)
    args = sharded.sharded_step_inputs(
        [mapper], [events], [traj], T_rv_w, ne, PACKET)
    out = step(*args)
    out["depth"].block_until_ready()  # compile + settle
    # Repeated min-of-N (VERDICT r3 item 4): shared-core virtual devices
    # are scheduler-noise-dominated, so each row reports its spread and the
    # verdict rests on the min over 6 independent 3-step runs.
    runs = []
    for _ in range(6):
        t0 = time.perf_counter()
        for _ in range(3):
            out = step(*args)
        out["depth"].block_until_ready()
        runs.append((time.perf_counter() - t0) / 3)
    return min(runs), (max(runs) - min(runs)) / min(runs)


def main():
    from dvs_mcemvs_tpu.parallel import pick_mesh_shape

    mapper, events, traj, T_rv_w = build()
    # The shipped default decomposition for this backend family
    # (backend-aware pick_mesh_shape: hist -> event-only) must be a
    # measured row, so the committed verdict covers what the CLI runs.
    default_mesh = pick_mesh_shape(8, DIM_Z, backend=BACKEND)
    meshes = [(1, 1), (2, 1), (4, 1), (8, 1), (1, 8), (2, 4)]
    assert tuple(default_mesh) in [tuple(m) for m in meshes], default_mesh
    rows = []
    t_base = None
    for ne, npl in meshes:
        dt, spread = time_mesh(mapper, events, traj, T_rv_w, ne, npl)
        if t_base is None:
            t_base = dt
        rows.append({
            "mesh": [ne, npl],
            "seconds_per_step": round(dt, 4),
            "run_spread_rel": round(spread, 3),
            "overhead_vs_1dev": round(dt / t_base - 1.0, 4),
            "projected_efficiency_floor": round(min(1.0, t_base / dt), 4),
            "is_shipped_default": [ne, npl] == list(default_mesh),
        })
        print(f"mesh ({ne},{npl}): {dt*1e3:8.1f} ms/step  "
              f"overhead {dt / t_base - 1.0:+.1%}  spread {spread:.0%}",
              file=sys.stderr)

    # The multi-HOST mesh axis is "event" (its only cross-shard communication
    # is the final grid psum, DCN-tolerant; "plane" stays intra-host on ICI
    # and duplicates the event binning per shard by design).  The two-host
    # efficiency floor is therefore the (2,1) row's.
    two_host = next(r for r in rows if r["mesh"] == [2, 1])
    eight_way = next(r for r in rows if r["mesh"] == [8, 1])
    report = {
        "device": "cpu (virtual devices); not a GPU measurement",
        "protocol": "fixed workload, shared-core virtual devices: ideal "
                    "sharded time == 1-device time; slowdown == sharding "
                    "overhead (collectives+padding+dispatch), the term that "
                    "bounds multi-chip scaling efficiency from below",
        "workload": {"events": N_EVENTS, "dsi": [DIM_Z, HEIGHT, WIDTH],
                     "backend": BACKEND, "packet": PACKET},
        "host_cores": os.cpu_count(),
        "results": rows,
        "target": {"two_host_weak_scaling_efficiency": 0.8},
        "summary": {
            "two_host_efficiency_floor":
                two_host["projected_efficiency_floor"],
            "eight_shard_efficiency_floor":
                eight_way["projected_efficiency_floor"],
            "shipped_default_mesh_8dev": list(default_mesh),
            "meets_target": two_host["projected_efficiency_floor"] >= 0.8,
            "caveat": f"measured on {os.cpu_count()} shared host cores; "
                      "virtual-device rows are scheduler-noise-dominated "
                      "(per-row run_spread_rel); each row is a min over 6 "
                      "independent 3-step runs",
            "note": "multi-host axis is 'event' (grid psum only); for "
                    "hist:* backends plane shards re-bin the whole event "
                    "stream, so pick_mesh_shape ships event-only meshes "
                    "for them (backend-aware since r4); scatter keeps the "
                    "plane preference (the OpenMP analog)",
        },
    }
    out_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "SCALING.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
