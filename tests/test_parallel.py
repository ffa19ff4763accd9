"""Sharded-step equivalence: mesh runs must reproduce the single-device DSI.

The distributed-semantics test pyramid of SURVEY.md §4: voting is a linear
sum over events, so event-sharded partial grids psum to the exact
single-device result, and plane shards are communication-free by
construction — the sharded DSI must match bit-for-bit when both paths
process identical packets.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dvs_mcemvs_tpu import pipeline
from dvs_mcemvs_tpu.mapper import DsiShape, make_mapper
from dvs_mcemvs_tpu.ops import se3, trajectory as trajmod
from dvs_mcemvs_tpu.ops.se3 import SE3
from dvs_mcemvs_tpu.parallel import make_mesh, pick_mesh_shape, sharded
from dvs_mcemvs_tpu.utils import synthetic

PACKET = 256


@pytest.fixture(scope="module")
def rig_setup():
    rig = synthetic.esim_like_rig()
    rng = np.random.default_rng(0)
    pts = synthetic.make_scene(rig, rng, 1200)
    ev0 = synthetic.simulate_events(rig, pts, 0, n_samples=12, rng=rng)
    ev1 = synthetic.simulate_events(rig, pts, 1, n_samples=12, rng=rng)
    shape = DsiShape(dim_z=16, min_depth=1.0, max_depth=4.0)
    mappers = [make_mapper(rig.cam, shape), make_mapper(rig.cam, shape)]
    ts, q, p = synthetic.rig_poses(rig)
    traj0 = trajmod.from_arrays(ts, q, p)
    T_1_0 = SE3(jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                jnp.asarray([-rig.baseline, 0, 0], jnp.float32))
    traj1 = trajmod.apply_right(traj0, se3.inverse(T_1_0))
    T_rv_w = pipeline.place_reference_view(traj0, 0.5)
    return mappers, (ev0, ev1), (traj0, traj1), T_rv_w


def _reference_dsi(mappers, events, trajs, T_rv_w):
    # Single-device path drops the tail packet ((E-1)//P packets processing
    # n*P events); feed it n*P+1 events and the sharded path exactly n*P so
    # both see identical packets.
    evs_single, evs_shard = [], []
    for ev in events:
        n = (ev.num - 1) // PACKET
        evs_single.append(ev.slice(0, n * PACKET + 1))
        evs_shard.append(ev.slice(0, n * PACKET))
    res = pipeline.process_1(
        mappers, evs_single, list(trajs), 0.5, stereo_fusion=2,
        # pad_policy="none" keeps the reference drop-tail semantics this
        # comparison is built around (bucket padding would vote the +1
        # event the sharded buffer doesn't contain).
        vopts=pipeline.VotingOptions(packet_size=PACKET, pad_policy="none"),
    )
    return np.asarray(res.fused_dsi), evs_shard


def test_pick_mesh_shape():
    assert pick_mesh_shape(8, 16) == (1, 8)
    assert pick_mesh_shape(8, 100, max_plane_shards=4) == (2, 4)
    assert pick_mesh_shape(1, 100) == (1, 1)
    ne, npl = pick_mesh_shape(8, 7)  # 7 not divisible by 2..8
    assert (ne, npl) == (8, 1)


def test_pick_mesh_shape_backend_aware():
    """VERDICT r3 item 4: hist backends re-bin the whole event stream per
    plane shard (SCALING.json measured 1.47-4.40x overhead), so they get
    event-only meshes; scatter keeps the plane preference (OpenMP analog)."""
    assert pick_mesh_shape(8, 100, backend="hist:g16,ss2,seg10") == (8, 1)
    assert pick_mesh_shape(8, 16, backend="hist_exact") == (8, 1)
    assert pick_mesh_shape(8, 100, backend="scatter") == (2, 4)
    assert pick_mesh_shape(8, 16, backend="scatter") == (1, 8)
    assert pick_mesh_shape(8, 100, max_plane_shards=4,
                           backend="sort") == (2, 4)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (8, 1), (1, 8)])
def test_sharded_matches_single_device(rig_setup, mesh_shape):
    mappers, events, trajs, T_rv_w = rig_setup
    ref_dsi, evs_shard = _reference_dsi(mappers, events, trajs, T_rv_w)

    ne, npl = mesh_shape
    mesh = make_mesh(ne, npl)
    spec = sharded.rig_spec_from_mappers(mappers)
    cfg = sharded.ShardedStepConfig(fusion_method=2, packet_size=PACKET)
    step = sharded.make_sharded_step(mesh, spec, cfg)
    args = sharded.sharded_step_inputs(
        mappers, evs_shard, list(trajs), T_rv_w, ne, PACKET)
    out = step(*args)
    np.testing.assert_array_equal(np.asarray(out["dsi"]), ref_dsi)
    # and the depth decision agrees with the single-device extraction
    H, W = mappers[0].height, mappers[0].width
    assert out["depth"].shape == (H, W)
    assert np.isfinite(np.asarray(out["confidence"])).all()


def test_padding_weights_are_inert(rig_setup):
    """Zero-weight padding must not change the DSI: voting with a padded
    buffer equals voting the unpadded stream."""
    mappers, events, trajs, T_rv_w = rig_setup
    ev = events[0]
    n = (ev.num // PACKET) * PACKET
    ev = ev.slice(0, n)

    mesh = make_mesh(1, 1)
    spec = sharded.rig_spec_from_mappers(mappers[:1])
    spec = sharded.ShardedRigSpec(
        n_cameras=1, width=spec.width, height=spec.height,
        dim_z=spec.dim_z, z0=spec.z0, vcam_params=spec.vcam_params)
    cfg = sharded.ShardedStepConfig(fusion_method=2, packet_size=PACKET)
    step = sharded.make_sharded_step(mesh, spec, cfg)

    args = sharded.sharded_step_inputs(
        [mappers[0]], [ev], [trajs[0]], T_rv_w, 1, PACKET)
    out_exact = np.asarray(step(*args)["dsi"])

    args_padded = sharded.sharded_step_inputs(
        [mappers[0]], [ev], [trajs[0]], T_rv_w, 1, PACKET,
        capacity=n + 3 * PACKET)
    out_padded = np.asarray(step(*args_padded)["dsi"])
    np.testing.assert_array_equal(out_exact, out_padded)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (1, 8), (2, 4)])
def test_sharded_hist_backend_matches_single_device(rig_setup, mesh_shape):
    """The production (histogram) voting backend under shard_map: with
    g1 leaves (exact grouping) and a global correction midpoint, the
    sharded DSI reproduces the 1-device DSI up to float reassociation."""
    mappers, events, trajs, T_rv_w = rig_setup
    evs = [ev.slice(0, (ev.num // PACKET) * PACKET) for ev in events]

    spec = sharded.rig_spec_from_mappers(mappers)
    cfg = sharded.ShardedStepConfig(fusion_method=2, packet_size=PACKET,
                                    backend="hist:g1,ss2")

    ref_step = sharded.make_sharded_step(make_mesh(1, 1), spec, cfg)
    ref_args = sharded.sharded_step_inputs(mappers, evs, list(trajs),
                                           T_rv_w, 1, PACKET)
    ref = ref_step(*ref_args)

    ne, npl = mesh_shape
    step = sharded.make_sharded_step(make_mesh(ne, npl), spec, cfg)
    args = sharded.sharded_step_inputs(mappers, evs, list(trajs),
                                       T_rv_w, ne, PACKET)
    out = step(*args)
    np.testing.assert_allclose(np.asarray(out["dsi"]), np.asarray(ref["dsi"]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(out["depth_indices"]),
                                  np.asarray(ref["depth_indices"]))
