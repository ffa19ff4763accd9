"""DSEC-scale golden accuracy fixture: real motion, analytic ground truth.

The accuracy anchor standing in for BASELINE.md's "depth error within 5 % of
reference on DSEC zurich_city" target (the DSEC dataset itself is not in the
image): a 640x480x100 DSI workload — the exact dimensions of the reference's
DSEC runs (cfg/DSEC/interlaken_00_b_2/dsec.conf, dimZ=100) — driven by a
REAL 0.4 s window of the committed zurich_city_04 LiDAR-IMU odometry poses
(data/DSEC/zurich_city_04_pose.npz, converted from the reference's shipped
data/DSEC/zurich_city_04/pose.bag) over a synthetic scene whose depth map at
the reference view is known analytically.

Scene construction: vertical image stripes at the reference view, each
backed by a fronto-parallel plane (constant RV-frame z), so ground truth at
every RV pixel is the stripe's plane depth — the same analytic-GT pattern
as utils/synthetic.py, generalized from linear +x motion to an arbitrary
SE(3) trajectory.

Everything is deterministic (fixed seed): `scripts/make_golden.py` runs the
exact per-event `scatter` backend once to produce the committed golden
artifacts, and `tests/test_golden.py` gates the production (auto-selected
histogram) spec and the 8-device sharded run against them with an explicit
error budget.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from ..mapper import DsiShape, Events, Mapper, make_mapper
from ..ops import se3, trajectory as trajmod
from ..ops.camera import PinholeCamera
from ..ops.se3 import SE3

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
POSE_NPZ = os.path.join(_REPO, "data", "DSEC", "zurich_city_04_pose.npz")

# DSEC event-camera geometry (640x480 VGA, ~555 px rectified focal,
# 0.6 m stereo baseline — the b=0.6 of the reference's bad-p metric,
# evaluate_mcemvs_dsec.py:48-49).
WIDTH, HEIGHT = 640, 480
FX = 555.0
BASELINE = 0.6

# DSI shape of the reference's DSEC configs (dimZ=100); depth range tightened
# to the fixture's scene so every plane is exercised.  Inverse-depth sampling
# (the runtime USE_INVERSE_DEPTH upgrade) gives a constant stereo disparity
# step of fx*B*(1/min-1/max)/dimZ = 0.69 px/plane — every stripe equally
# resolvable, unlike linear sampling whose far planes collapse below the
# integer-pixel event noise.
DIM_Z = 100
MIN_DEPTH, MAX_DEPTH = 4.0, 24.0
DEPTH_SAMPLING = "inverse"

# Pose window: [t0+10 s, t0+10.4 s] of zurich_city_04 — 0.79 m of real
# vehicle travel (typical DSEC chunk motion at the reference's duration=0.2 s
# x2 for margin).
WINDOW_OFFSET_S = 10.0
WINDOW_LEN_S = 0.4

# 8 vertical stripes cycling through 4 scene depths.
STRIPE_DEPTHS = (5.0, 8.0, 12.0, 20.0, 6.0, 10.0, 16.0, 7.0)

SEED = 20260819


@dataclasses.dataclass(frozen=True)
class GoldenConfig:
    """Dimension/effort profile of the golden fixture.  FULL is the
    committed DSEC-scale anchor; SMALL is the fast CI tier (same real pose
    window, same stripe scene, same FOV — fx scales with width) whose
    gates run in seconds instead of minutes (tests/test_golden_fast.py)."""

    width: int = WIDTH
    height: int = HEIGHT
    fx: float = FX
    dim_z: int = DIM_Z
    n_samples: int = 24
    n_per_stripe: int = 4000
    max_events: int = 262_144
    npz_name: str = "golden_dsec.npz"
    window_offset_s: float = WINDOW_OFFSET_S

    @property
    def pad_px(self) -> float:
        """Scene overscan beyond the stripe/image edge, in this profile's
        pixels (80 px at full DSEC resolution)."""
        return 80.0 * self.width / WIDTH


FULL = GoldenConfig()
SMALL = GoldenConfig(width=320, height=240, fx=FX / 2, dim_z=50,
                     n_samples=16, n_per_stripe=1500, max_events=65_536,
                     npz_name="golden_dsec_small.npz")
# The window whose 0.393 m of vehicle travel makes the auto group size g16
# — the SAME group size the headline benchmark workload selects — so the
# on-device golden gate can run the LITERAL headline spec string (the FULL
# window's 0.70 m picks g8).
BENCH16 = GoldenConfig(window_offset_s=10.9,
                       npz_name="golden_dsec_g16.npz")


def dsec_like_camera(cfg: GoldenConfig = FULL) -> PinholeCamera:
    return PinholeCamera(width=cfg.width, height=cfg.height, fx=cfg.fx,
                         fy=cfg.fx, cx=cfg.width / 2 - 0.5,
                         cy=cfg.height / 2 - 0.5)


def golden_trajectories(
        cfg: "GoldenConfig" = None,
) -> Tuple[trajmod.Trajectory, trajmod.Trajectory]:
    """(left, right) camera trajectories over the window, normalized to
    t=0 at window start (device timestamps are float32; absolute DSEC
    times would quantize at ~4 ms)."""
    d = np.load(POSE_NPZ)
    t, q, p = (np.asarray(d["t"], np.float64), np.asarray(d["q"], np.float64),
               np.asarray(d["p"], np.float64))
    offset = WINDOW_OFFSET_S if cfg is None else cfg.window_offset_s
    w0 = t[0] + offset
    sel = (t >= w0 - 0.3) & (t <= w0 + WINDOW_LEN_S + 0.3)  # pad for interp
    t, q, p = t[sel] - w0, q[sel], p[sel]
    traj0 = trajmod.from_arrays(t, q, p)
    T_1_0 = SE3(np.asarray([1.0, 0, 0, 0], np.float32),
                np.asarray([-BASELINE, 0, 0], np.float32))
    traj1 = trajmod.apply_right(traj0, se3.inverse(T_1_0))
    return traj0, traj1


@dataclasses.dataclass(frozen=True)
class GoldenScene:
    pts_w: np.ndarray        # (N, 3) world points
    T_w_rv: SE3              # reference-view pose (left cam at window mid)
    gt_depth: np.ndarray     # (H, W) analytic RV depth (stripe planes)
    stripe_depths: Tuple[float, ...]
    cfg: GoldenConfig = FULL


def make_golden_scene(n_per_stripe: Optional[int] = None,
                      seed: int = SEED,
                      cfg: GoldenConfig = FULL) -> GoldenScene:
    """Stripe-plane scene anchored at the RV (left camera at the window
    midpoint): for stripe s covering image columns [s*W/S, (s+1)*W/S), points
    are sampled on the plane z_rv = STRIPE_DEPTHS[s] across a slightly
    padded pixel extent (so camera motion never uncovers the stripe edge),
    then mapped to world coordinates through T_w_rv."""
    if n_per_stripe is None:
        n_per_stripe = cfg.n_per_stripe
    cam = dsec_like_camera(cfg)
    traj0, _ = golden_trajectories(cfg)
    ts_mid = WINDOW_LEN_S / 2.0
    T_w_rv, valid = trajmod.pose_at(traj0, np.float32(ts_mid))
    assert bool(np.asarray(valid))

    rng = np.random.default_rng(seed)
    S = len(STRIPE_DEPTHS)
    stripe_w = cfg.width / S
    pad = cfg.pad_px  # px of overscan beyond the stripe/image edge
    pts_rv: List[np.ndarray] = []
    for s, depth in enumerate(STRIPE_DEPTHS):
        u = rng.uniform(s * stripe_w - (pad if s == 0 else 2.0),
                        (s + 1) * stripe_w + (pad if s == S - 1 else 2.0),
                        n_per_stripe)
        v = rng.uniform(-pad, cfg.height + pad, n_per_stripe)
        x = (u - cam.cx) / cam.fx * depth
        y = (v - cam.cy) / cam.fy * depth
        pts_rv.append(np.stack([x, y, np.full_like(x, depth)], axis=-1))
    pts = np.concatenate(pts_rv, axis=0)
    pts_w = np.asarray(se3.transform_points(T_w_rv, pts.astype(np.float32)),
                       np.float64)

    us = np.arange(cfg.width)
    stripe_of_col = np.minimum((us / stripe_w).astype(int), S - 1)
    gt = np.asarray(STRIPE_DEPTHS, np.float32)[stripe_of_col]
    gt_depth = np.broadcast_to(gt[None, :], (cfg.height, cfg.width)).copy()
    return GoldenScene(pts_w=pts_w, T_w_rv=T_w_rv, gt_depth=gt_depth,
                       stripe_depths=STRIPE_DEPTHS, cfg=cfg)


def gt_depth_at_pose(scene: GoldenScene, T_w_c: SE3,
                     min_t: float = 0.5,
                     T_w_c_right: Optional[SE3] = None) -> np.ndarray:
    """Analytic GT depth for the left camera at an ARBITRARY pose — the
    multi-frame extension of `GoldenScene.gt_depth` (which is only valid at
    the reference view itself).

    Per pixel, rays are traced against the stripe planes (z = const in the
    RV frame over the stripe's padded column extent, `make_golden_scene`);
    the depth is the nearest hit.  Pixels where a SECOND stripe also hits
    (parallax makes padded stripe extents overlap away from the RV) are
    marked 0 = invalid: the event simulation renders both surfaces without
    occlusion, so no single depth is "true" there — the DSEC evaluator
    masks GT below 0.05 m (scripts/evaluate_dsec.py).

    `T_w_c_right` additionally masks pixels whose surface point falls
    OUTSIDE the right camera's frustum: stereo fusion has no vote support
    there (at z=5 m the rig's 0.6 m baseline is a 67 px disparity, so the
    left image's left edge is stereo-blind), and the real-data protocol
    this stands in for never evaluates such pixels because LiDAR GT and
    event texture coexist only in the stereo-visible field.
    """
    cam = dsec_like_camera(scene.cfg)
    T_rv_c = se3.compose(se3.inverse(scene.T_w_rv), T_w_c)
    R = np.asarray(se3.quat_to_matrix(T_rv_c.q), np.float64)
    o = np.asarray(T_rv_c.t, np.float64)

    us, vs = np.meshgrid(np.arange(cam.width, dtype=np.float64),
                         np.arange(cam.height, dtype=np.float64))
    d_cam = np.stack([(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy,
                      np.ones_like(us)], axis=-1)        # (H, W, 3)
    d_rv = d_cam @ R.T

    S = len(scene.stripe_depths)
    stripe_w = scene.cfg.width / S
    pad = scene.cfg.pad_px
    best = np.full((cam.height, cam.width), np.inf)
    hits = np.zeros((cam.height, cam.width), np.int32)
    for s, z_s in enumerate(scene.stripe_depths):
        lo = s * stripe_w - (pad if s == 0 else 2.0)
        hi = (s + 1) * stripe_w + (pad if s == S - 1 else 2.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            tt = (z_s - o[2]) / d_rv[..., 2]
            X = o[None, None, :] + tt[..., None] * d_rv
            u_rv = cam.fx * X[..., 0] / z_s + cam.cx
            v_rv = cam.fy * X[..., 1] / z_s + cam.cy
        ok = ((tt > min_t) & (u_rv >= lo) & (u_rv <= hi)
              & (v_rv >= -pad) & (v_rv <= scene.cfg.height + pad))
        hits += ok.astype(np.int32)
        best = np.where(ok & (tt < best), tt, best)
    gt = np.where((hits == 1) & np.isfinite(best), best, 0.0)

    if T_w_c_right is not None:
        # Surface point in RV coords -> right camera coords; mask pixels
        # the right camera cannot see (no stereo vote support).
        T_cr_rv = se3.compose(se3.inverse(T_w_c_right), scene.T_w_rv)
        Rr = np.asarray(se3.quat_to_matrix(T_cr_rv.q), np.float64)
        tr = np.asarray(T_cr_rv.t, np.float64)
        tt = np.where(gt > 0, gt, 1.0)
        X_rv = o[None, None, :] + tt[..., None] * d_rv
        X_r = X_rv @ Rr.T + tr[None, None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            u_r = cam.fx * X_r[..., 0] / X_r[..., 2] + cam.cx
            v_r = cam.fy * X_r[..., 1] / X_r[..., 2] + cam.cy
        vis = ((X_r[..., 2] > min_t) & (u_r >= 0) & (u_r <= cam.width - 1)
               & (v_r >= 0) & (v_r <= cam.height - 1))
        gt = np.where(vis, gt, 0.0)
    return gt.astype(np.float32)


def simulate_events_se3(
    cam: PinholeCamera,
    traj: trajmod.Trajectory,
    pts_w: np.ndarray,
    n_samples: int,
    t_range: Tuple[float, float],
    rng: np.random.Generator,
    max_events: Optional[int] = None,
) -> Events:
    """One event per visible (point, sample time) along an arbitrary SE(3)
    trajectory — the general-motion version of synthetic.simulate_events
    (which hard-codes +x translation)."""
    ts_samples = np.linspace(t_range[0], t_range[1], n_samples)
    pts_w32 = pts_w.astype(np.float32)
    xs, ys, ts, ps = [], [], [], []
    for tk in ts_samples:
        T_w_c, valid = trajmod.pose_at(traj, np.float32(tk))
        if not bool(np.asarray(valid)):
            continue
        rel = np.asarray(
            se3.transform_points(se3.inverse(T_w_c), pts_w32), np.float64)
        z = rel[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = cam.fx * rel[:, 0] / z + cam.cx
            v = cam.fy * rel[:, 1] / z + cam.cy
        ok = (z > 0.5) & (u >= 0) & (u < cam.width - 1) & \
             (v >= 0) & (v < cam.height - 1)
        xs.append(np.round(u[ok]).astype(np.int32))
        ys.append(np.round(v[ok]).astype(np.int32))
        n = int(ok.sum())
        ts.append(np.full(n, tk))
        ps.append((rng.uniform(size=n) > 0.5).astype(np.int8))
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    t = np.concatenate(ts)
    p = np.concatenate(ps)
    order = np.argsort(t + rng.uniform(0, 1e-5, t.shape), kind="stable")
    x, y, t, p = x[order], y[order], t[order], p[order]
    if max_events is not None and x.shape[0] > max_events:
        keep = np.sort(rng.choice(x.shape[0], max_events, replace=False))
        x, y, t, p = x[keep], y[keep], t[keep], p[keep]
    return Events(x, y, t, p)


def build_golden_fixture(
    n_samples: Optional[int] = None,
    n_per_stripe: Optional[int] = None,
    max_events: Optional[int] = -1,
    cfg: GoldenConfig = FULL,
):
    """(mappers, events, trajs, scene, ts_rv) — the full golden problem.

    The fixture is ALWAYS constructed on the CPU backend: event pixel
    rounding sits on f32 boundaries, so letting an accelerator evaluate the
    pose interpolation would make the committed anchor device-dependent
    (and dispatch hundreds of tiny per-sample ops to it).  Voting itself
    still runs wherever the caller computes.
    """
    import jax

    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:  # cpu platform not initialized: already default
        cpu = None
    if n_samples is None:
        n_samples = cfg.n_samples
    if max_events == -1:
        max_events = cfg.max_events
    ctx = jax.default_device(cpu) if cpu is not None else _nullcontext()
    with ctx:
        cam = dsec_like_camera(cfg)
        traj0, traj1 = golden_trajectories(cfg)
        scene = make_golden_scene(n_per_stripe=n_per_stripe, cfg=cfg)
        rng = np.random.default_rng(SEED + 1)
        t_range = (0.02, WINDOW_LEN_S - 0.02)
        ev0 = simulate_events_se3(cam, traj0, scene.pts_w, n_samples,
                                  t_range, rng, max_events)
        ev1 = simulate_events_se3(cam, traj1, scene.pts_w, n_samples,
                                  t_range, rng, max_events)
    shape = DsiShape(dim_z=cfg.dim_z, min_depth=MIN_DEPTH,
                     max_depth=MAX_DEPTH)
    mappers = [make_mapper(cam, shape, DEPTH_SAMPLING),
               make_mapper(cam, shape, DEPTH_SAMPLING)]
    return mappers, [ev0, ev1], [traj0, traj1], scene, WINDOW_LEN_S / 2.0


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def production_backend_spec(events, packet_size: int,
                            cfg: GoldenConfig = FULL) -> str:
    """EXACTLY the spec cli.py's auto path selects for this fixture (same
    helper, same travel estimate)."""
    from ..ops.voting_hist import auto_backend_spec

    traj0, _ = golden_trajectories(cfg)
    pos = np.asarray(traj0.poses.t)
    travel = float(np.linalg.norm(np.diff(pos, axis=0), axis=1).sum())
    total_t = float(np.asarray(traj0.ts)[-1] - np.asarray(traj0.ts)[0])
    span = min(WINDOW_LEN_S, total_t)
    chunk_travel = travel * (span / total_t)
    n_pk = max(1, min(e.num for e in events) // packet_size)
    return auto_backend_spec(chunk_travel, n_pk, cfg.fx, MIN_DEPTH,
                             MAX_DEPTH, cfg.dim_z)


GOLDEN_NPZ = os.path.join(_REPO, "tests", "golden", "golden_dsec.npz")
GOLDEN_SMALL_NPZ = os.path.join(_REPO, "tests", "golden",
                                "golden_dsec_small.npz")
GOLDEN_BENCH16_NPZ = os.path.join(_REPO, "tests", "golden",
                                  "golden_dsec_g16.npz")

# Explicit error budget gating the production spec (and the 8-device sharded
# mesh run) against the committed exact-scatter golden artifacts.
#
# Context for the numbers (measured on this fixture, 2026-08): the inverse-
# depth plane step is fx*B*(1/4-1/24)/100 = 0.69 px of stereo disparity —
# finer than one event pixel — so on near-tie pixels the histogram backend's
# sub-pixel blur (ss2 binning 0.25 px + resample hat + grouping tolerance
# 1 px) legitimately flips the argmax by a plane or two; the signed error is
# symmetric (no bias, measured mean +0.13 plane).  Production achieves
# within1 = 0.80-0.85, within2 = 0.88-0.91, per-camera mass ratio 1.0012,
# median metric error 2.1 % (vs the 5 % BASELINE target).  Budgets sit below
# measurements by a safety margin but far above failure modes (a lost
# half-disparity of padding, a broken merge, or a sharding bug each push
# within2 under 0.5 and mass out by >5 %).
BUDGET = {
    "confident_quantile": 0.8,     # "confident" = top-20 % golden confidence
    # Tightened r4 (was 0.75): the shipped auto spec (ss2, segmented)
    # measures within1 = 0.777-0.85 on CPU — 0.76 still leaves >1.5 pt
    # headroom while catching a >2 pt accuracy drift, not just outright
    # breakage.
    "frac_within_1_plane": 0.76,   # confident pixels within +-1 plane index
    "frac_within_2_planes": 0.85,
    "median_err_planes": 1.0,      # median |index - golden index| <= 1
    "per_camera_mass_rel": 0.005,  # per-camera DSI vote mass within 0.5 %
    "gt_median_rel_err": 0.05,     # median metric error vs analytic GT (the
                                   # BASELINE.md "within 5 % on DSEC
                                   # zurich_city" stand-in)
    "golden_gt_median_planes": 0.5,  # the committed golden itself vs GT
}

# Per-fixture calibration of the index gates for the BENCH16 window: its
# 0.39 m of travel gives roughly half the monocular parallax of FULL's
# 0.70 m, so near-tie pixels flip more under ANY approximate backend — the
# exact-scatter anchor itself is unaffected (GT median rel 0.0123 there,
# better than FULL's 0.0244), but an approximate spec loses ~3 pt of
# within1 on this window against FULL (0.747 vs 0.777 for the former
# unsupersampled seg16 spec, on CPU).  Gates sit the same ~1.5-1.7 pt below
# that spec's measured values as FULL's gates do — the same
# drift-catching margin, calibrated to the harder fixture.
BUDGET_BENCH16 = dict(BUDGET, **{
    "frac_within_1_plane": 0.73,
    "frac_within_2_planes": 0.835,
})
