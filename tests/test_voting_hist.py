"""Histogram-resample voting backend: convergence to the exact splat.

The hist backend (ops/voting_hist.py) approximates the reference voting
kernel (mapper_emvs_stereo.cpp:151-205) by grouped z0 histograms + per-plane
affine resamples.  With group_size=1 (per-packet coefficients, exact
grouping) and fine supersampling it must converge to the scatter backend's
DSI; the depth decision (argmax) must agree almost everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dvs_mcemvs_tpu import mapper as mappermod, pipeline
from dvs_mcemvs_tpu.mapper import DsiShape, make_mapper
from dvs_mcemvs_tpu.ops import grid as gridops, trajectory as trajmod, voting
from dvs_mcemvs_tpu.ops.voting_hist import auto_group_size
from dvs_mcemvs_tpu.utils import synthetic

PACKET = 512


@pytest.fixture(scope="module")
def setup():
    rig = synthetic.esim_like_rig()
    rng = np.random.default_rng(0)
    pts = synthetic.make_scene(rig, rng, 2000)
    ev = synthetic.simulate_events(rig, pts, 0, n_samples=18, rng=rng)
    shape = DsiShape(dim_z=24, min_depth=1.0, max_depth=4.0)
    m = make_mapper(rig.cam, shape)
    ts, q, p = synthetic.rig_poses(rig)
    traj = trajmod.from_arrays(ts, q, p)
    T_rv_w = pipeline.place_reference_view(traj, 0.5)
    ref = np.asarray(mappermod.evaluate_dsi(
        m, ev, traj, T_rv_w, packet_size=PACKET, backend="scatter"))
    return m, ev, traj, T_rv_w, ref


def _argmax_agreement(ref, dsi, top_frac=0.2):
    cr, ir = gridops.collapse_max(jnp.asarray(ref))
    ch, ih = gridops.collapse_max(jnp.asarray(dsi))
    conf = np.asarray(cr)
    sel = conf > np.quantile(conf, 1 - top_frac)
    return float(np.mean(
        np.abs(np.asarray(ir)[sel].astype(int)
               - np.asarray(ih)[sel].astype(int)) <= 1))


def test_hist_exact_converges(setup):
    m, ev, traj, T_rv_w, ref = setup
    dsi = np.asarray(mappermod.evaluate_dsi(
        m, ev, traj, T_rv_w, packet_size=PACKET, backend="hist:g1,ss2"))
    corr = np.corrcoef(ref.ravel(), dsi.ravel())[0, 1]
    assert corr > 0.995
    assert _argmax_agreement(ref, dsi) > 0.92
    # total vote mass is preserved (away from borders both splat all events)
    assert abs(dsi.sum() / max(ref.sum(), 1) - 1) < 0.05


def test_hist_grouped_reasonable(setup):
    """Coarse grouping with the sweep correction stays structurally close."""
    m, ev, traj, T_rv_w, ref = setup
    dsi = np.asarray(mappermod.evaluate_dsi(
        m, ev, traj, T_rv_w, packet_size=PACKET, backend="hist:g4,ss2"))
    corr = np.corrcoef(ref.ravel(), dsi.ravel())[0, 1]
    assert corr > 0.94


def test_correction_improves_grouping(setup):
    m, ev, traj, T_rv_w, ref = setup
    on = np.asarray(mappermod.evaluate_dsi(
        m, ev, traj, T_rv_w, packet_size=PACKET, backend="hist:g16,ss2"))
    off = np.asarray(mappermod.evaluate_dsi(
        m, ev, traj, T_rv_w, packet_size=PACKET, backend="hist:g16,ss2,nocorr"))
    c_on = np.corrcoef(ref.ravel(), on.ravel())[0, 1]
    c_off = np.corrcoef(ref.ravel(), off.ravel())[0, 1]
    assert c_on > c_off


def test_auto_group_size():
    # slower motion / shorter sweep -> bigger groups
    g_fast = auto_group_size(1.0, 1000, 500, 2, 40)
    g_slow = auto_group_size(0.01, 1000, 500, 2, 40)
    assert g_slow > g_fast >= 1
    # power of two, bounded
    for g in (g_fast, g_slow):
        assert g & (g - 1) == 0
    assert auto_group_size(0.0, 1000, 500, 2, 40) == 1000


def test_resolve_backend_specs():
    fn = voting.resolve_backend("hist:g8,ss2,px96,py16,nocorr,f32")
    assert fn.keywords["group_size"] == 8
    assert fn.keywords["supersample"] == 2
    assert fn.keywords["pad_x"] == 96
    assert fn.keywords["pad_y"] == 16
    assert fn.keywords["correct"] is False
    assert voting.resolve_backend("scatter") is voting.SPLAT_BACKENDS["scatter"]
    with pytest.raises(ValueError):
        voting.resolve_backend("hist:bogus")
    with pytest.raises(ValueError):
        voting.resolve_backend("scatter:g8")


def test_hist_segmented_close_to_unsegmented(setup):
    """Segmented sweep (leaf-merge) stays structurally close to the exact
    splat; int8 binning is accuracy-neutral.

    With per-packet (g1) leaves the segment-level merge correction is MORE
    accurate than the unsegmented event-level correction at the same group
    size (error zeroed at each segment's u-mid instead of globally)."""
    m, ev, traj, T_rv_w, ref = setup
    seg = np.asarray(mappermod.evaluate_dsi(
        m, ev, traj, T_rv_w, packet_size=PACKET, backend="hist:g1,ss2,seg4"))
    corr = np.corrcoef(ref.ravel(), seg.ravel())[0, 1]
    assert corr > 0.98
    assert abs(seg.sum() / max(ref.sum(), 1) - 1) < 0.05
    assert _argmax_agreement(ref, seg) > 0.85

    # Grouped leaves + segments: same leaf size as the unsegmented baseline
    # stays structurally close to it (extra merge blur only).
    base = np.asarray(mappermod.evaluate_dsi(
        m, ev, traj, T_rv_w, packet_size=PACKET, backend="hist:g4,ss2"))
    seg4 = np.asarray(mappermod.evaluate_dsi(
        m, ev, traj, T_rv_w, packet_size=PACKET, backend="hist:g4,ss2,seg4"))
    assert np.corrcoef(base.ravel(), seg4.ravel())[0, 1] > 0.97
    assert _argmax_agreement(base, seg4) > 0.75

    i8 = np.asarray(mappermod.evaluate_dsi(
        m, ev, traj, T_rv_w, packet_size=PACKET, backend="hist:g4,ss2,seg4,i8"))
    corr_i8 = np.corrcoef(seg4.ravel(), i8.ravel())[0, 1]
    assert corr_i8 > 0.999


def test_segment_bounds_equal_u():
    from dvs_mcemvs_tpu.ops.voting_hist import segment_bounds_equal_u

    # Inverse-depth (uniform u) sampling -> equal index chunks.
    u = np.linspace(1 / 40.0, 1 / 2.0, 16)
    b = segment_bounds_equal_u(1.0 / u, 4)
    assert b[0] == 0 and b[-1] == 16
    assert list(b) == sorted(b)
    sizes = np.diff(b)
    assert sizes.min() >= 1
    # Inverse-depth sampling: uniform u -> exactly equal index chunks.
    assert list(b) == [0, 4, 8, 12, 16]
    # Linear-depth sampling -> near planes (large u span) get fewer planes
    # per segment than far planes.
    d = np.linspace(2.0, 40.0, 32)
    b2 = segment_bounds_equal_u(d, 4)
    assert b2[0] == 0 and b2[-1] == 32
    assert np.diff(b2).min() >= 1
    # The u-span of every segment is near-equal up to the grid's local u
    # step (the first inter-plane step is the coarsest).
    u2 = 1.0 / d
    spans = [abs(u2[max(i1 - 1, i0)] - u2[i0]) for i0, i1 in zip(b2, b2[1:])]
    target = abs(u2[-1] - u2[0]) / 4
    step0 = abs(u2[1] - u2[0])
    assert max(spans) <= target + step0
    # Plane counts must grow toward the far end (the descending-u direction
    # bug concentrated ~75% of the u range in segment 0).
    sizes2 = np.diff(b2)
    assert sizes2[-1] > sizes2[0]


def test_resolve_backend_seg_i8():
    import jax.numpy as jnp

    fn = voting.resolve_backend("hist:g8,seg8,i8")
    assert fn.keywords["group_size"] == 8
    assert fn.keywords["segments"] == 8
    assert fn.keywords["bin_dtype"] == jnp.int8


def test_device_rectify_warp_matches_lut_warp(setup):
    """The analytic warp path reproduces the LUT warp end-to-end."""
    m, ev, traj, T_rv_w, ref = setup
    dev = np.asarray(mappermod.evaluate_dsi(
        m, ev, traj, T_rv_w, packet_size=PACKET, backend="scatter",
        rectify="device"))
    lut = np.asarray(mappermod.evaluate_dsi(
        m, ev, traj, T_rv_w, packet_size=PACKET, backend="scatter",
        rectify="lut"))
    corr = np.corrcoef(dev.ravel(), lut.ravel())[0, 1]
    assert corr > 0.9999


def test_weights_binary_matches_explicit_weights(setup):
    """An explicit all-ones weight mask (the sharded path's padding mask
    over a full buffer) reproduces the no-weights result exactly."""
    import jax.numpy as jnp

    from dvs_mcemvs_tpu.ops import camera as camops
    from dvs_mcemvs_tpu.ops import voting as votingmod
    from dvs_mcemvs_tpu.ops import voting_hist as vh

    m, ev, traj, T_rv_w, ref = setup
    z0 = float(m.depth_vec.depths()[0])
    vp = (float(m.vcam.fx), float(m.vcam.fy),
          float(m.vcam.cx), float(m.vcam.cy))
    K_cam = jnp.asarray(m.cam.P, jnp.float32)
    Kv_inv = jnp.asarray(np.linalg.inv(m.vcam.P), jnp.float32)
    depths = jnp.asarray(m.depth_vec.depths(), jnp.float32)

    base = votingmod.warp_events_to_z0(
        ev.x, ev.y, ev.t, traj, T_rv_w, None, K_cam, Kv_inv,
        z0=z0, width=m.width, packet_size=PACKET, full=True,
        rect_params=camops.rect_static(m.cam))
    ones = jnp.ones(base.xy_z0.shape[:2], jnp.float32)
    withw = base._replace(weight=ones)

    kw = dict(plane_block=8, group_size=4, segments=1, pad_x=32, pad_y=32)
    a = np.asarray(vh.splat_hist(base, depths, z0, vp, m.width, m.height,
                                 **kw))
    b = np.asarray(vh.splat_hist(withw, depths, z0, vp, m.width, m.height,
                                 **kw))
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
