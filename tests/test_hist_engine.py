"""The histogram voting backend's building blocks against plain numpy
references: bilinear one-hot binning (`bin_events`,
`build_group_histograms`) and the banded affine resamples (`resample_sum`,
`_resample_hist_affine`), plus the bf16 path against the f32 path end to
end."""

import jax.numpy as jnp
import numpy as np
import pytest

from dvs_mcemvs_tpu.ops.voting import WarpedPackets
from dvs_mcemvs_tpu.ops.voting_hist import (
    _resample_hist_affine, bin_events, build_group_histograms, resample_sum)


def _ref_hist(hx, hy, w, hs, ws):
    """Per-event bilinear splat, float64."""
    G, E = hx.shape
    out = np.zeros((G, hs, ws), np.float64)
    for g in range(G):
        x0 = np.floor(hx[g]).astype(int)
        y0 = np.floor(hy[g]).astype(int)
        fx, fy = hx[g] - x0, hy[g] - y0
        for dy, wy in ((0, 1 - fy), (1, fy)):
            for dx, wx in ((0, 1 - fx), (1, fx)):
                yy, xx = y0 + dy, x0 + dx
                ok = (yy >= 0) & (yy < hs) & (xx >= 0) & (xx < ws)
                np.add.at(out[g], (yy[ok], xx[ok]), (w[g] * wy * wx)[ok])
    return out


def _ref_resample(h, sy, ty, sx, tx, Ho, Wo):
    hs, ws = h.shape
    q, p = np.arange(hs), np.arange(ws)
    v, u = np.arange(Ho), np.arange(Wo)
    Ry = np.maximum(0, 1 - np.abs((q[:, None] * sy + ty) - v[None, :]))
    Cx = np.maximum(0, 1 - np.abs((p[:, None] * sx + tx) - u[None, :]))
    return Ry.T @ h.astype(np.float64) @ Cx


def _max_rel_err(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1.0)


def _bin(hx, hy, w, hs, ws, int8=False):
    return np.asarray(bin_events(
        jnp.asarray(hx, jnp.float32), jnp.asarray(hy, jnp.float32),
        jnp.asarray(w, jnp.float32), hs, ws,
        dtype=jnp.int8 if int8 else jnp.bfloat16))


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("int8", [False, True])
def test_bin_matches_reference(int8):
    rng = np.random.default_rng(0)
    G, E, hs, ws = 3, 256, 16, 128
    hx = rng.uniform(0, ws - 1, (G, E))
    hy = rng.uniform(0, hs - 1, (G, E))
    w = rng.uniform(0.0, 1.0, (G, E))
    got = _bin(hx, hy, w, hs, ws, int8)
    want = _ref_hist(hx, hy, w, hs, ws)
    assert got.shape == (G, hs, ws)
    # bf16 taps carry 8 mantissa bits, int8 taps 1/127 steps.
    np.testing.assert_allclose(got.sum(), want.sum(),
                               rtol=2e-2 if int8 else 5e-3)
    assert np.max(np.abs(got - want)) < (3e-2 if int8 else 1e-2)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dist", ["uniform", "bimodal", "point", "edge"])
def test_bin_distribution_matches_reference(int8, dist):
    """Exact for any event distribution: spread out, split across a huge
    row gap, all in one bin row, or on the clip boundary."""
    rng = np.random.default_rng(7)
    G, E, hs, ws = 2, 2048, 192, 256
    if dist == "uniform":
        hy = rng.uniform(0, hs - 1, (G, E))
    elif dist == "bimodal":
        hy = np.where(rng.random((G, E)) < 0.5,
                      rng.uniform(0, 8, (G, E)),
                      rng.uniform(hs - 9, hs - 1, (G, E)))
    elif dist == "point":
        hy = np.full((G, E), 100.25)
    else:
        hy = np.full((G, E), hs - 1.0)
    hx = rng.uniform(0, ws - 1, (G, E))
    w = rng.uniform(0.0, 1.0, (G, E))
    got = _bin(hx, hy, w, hs, ws, int8)
    want = _ref_hist(hx, hy, w, hs, ws)
    assert _max_rel_err(got, want) < (3e-2 if int8 else 1e-2)
    np.testing.assert_allclose(got.sum(), want.sum(),
                               rtol=2e-2 if int8 else 5e-3)


def test_bin_groups_independent():
    """Binning several groups at once equals binning each group alone."""
    rng = np.random.default_rng(1)
    G, E, hs, ws = 3, 1024, 16, 128
    hx = rng.uniform(0, ws - 1, (G, E))
    hy = rng.uniform(0, hs - 1, (G, E))
    w = np.ones((G, E))
    together = _bin(hx, hy, w, hs, ws)
    for g in range(G):
        alone = _bin(hx[g:g + 1], hy[g:g + 1], w[g:g + 1], hs, ws)
        np.testing.assert_allclose(together[g], alone[0], rtol=1e-6)


def test_bin_zero_weight_events_ignored():
    rng = np.random.default_rng(2)
    G, E, hs, ws = 1, 256, 16, 128
    hx = rng.uniform(0, ws - 1, (G, E))
    hy = rng.uniform(0, hs - 1, (G, E))
    w = np.ones((G, E))
    w[:, E // 2:] = 0.0
    full = _bin(hx, hy, w, hs, ws)
    half = _bin(hx[:, :E // 2], hy[:, :E // 2], w[:, :E // 2], hs, ws)
    np.testing.assert_allclose(full, half, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dist", ["uniform", "bimodal"])
def test_bin_binary_weights_f32_exact(dist):
    """0/1 weights on the f32 path (HIGHEST precision) match the float64
    reference to f32 rounding."""
    rng = np.random.default_rng(11)
    G, E, hs, ws = 2, 1500, 192, 256
    if dist == "uniform":
        hy = rng.uniform(0, hs - 1, (G, E))
    else:
        hy = np.where(rng.random((G, E)) < 0.5,
                      rng.uniform(0, 8, (G, E)),
                      rng.uniform(hs - 9, hs - 1, (G, E)))
    hx = rng.uniform(0, ws - 1, (G, E))
    w = (rng.random((G, E)) < 0.8).astype(np.float64)
    got = np.asarray(bin_events(
        jnp.asarray(hx, jnp.float32), jnp.asarray(hy, jnp.float32),
        jnp.asarray(w, jnp.float32), hs, ws, dtype=jnp.float32))
    want = _ref_hist(hx.astype(np.float32), hy.astype(np.float32), w, hs, ws)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _packets(K, P, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return WarpedPackets(
        xy_z0=jnp.asarray(rng.uniform(lo, hi, (K, P, 2)), jnp.float32),
        centers=jnp.asarray(rng.normal(0, 0.01, (K, 3)), jnp.float32),
        valid=jnp.ones((K,), bool))


def test_group_histograms_pad_to_group_multiple():
    """K packets not a multiple of the group size: the padding packets
    vote nothing, and every in-grid event votes mass 1."""
    K, P = 7, 64
    packets = _packets(K, P, 0.0, 40.0, 3)
    hist, centers = build_group_histograms(
        packets, group_size=4, hs=64, ws=128, pad_x=8, pad_y=4, ss=1,
        dtype=jnp.float32)
    assert hist.shape == (2, 64, 128) and centers.shape == (2, 3)
    np.testing.assert_allclose(float(np.asarray(hist).sum()), K * P,
                               rtol=1e-5)
    # The second group holds 3 real packets.
    np.testing.assert_allclose(float(np.asarray(hist[1]).sum()), 3 * P,
                               rtol=1e-5)


def test_group_histograms_match_reference():
    """Padding offset, supersampling and grid clipping match the plain
    per-event splat of the packets' z0 locations."""
    K, P, g, ss, pad_x, pad_y, hs, ws = 8, 128, 4, 2, 8, 4, 96, 256
    packets = _packets(K, P, -10.0, 120.0, 4)
    hist, _ = build_group_histograms(
        packets, group_size=g, hs=hs, ws=ws, pad_x=pad_x, pad_y=pad_y,
        ss=ss, dtype=jnp.float32)
    xy = np.asarray(packets.xy_z0, np.float64).reshape(K // g, g * P, 2)
    hx = (xy[..., 0] + pad_x) * ss
    hy = (xy[..., 1] + pad_y) * ss
    inb = (hx >= 0) & (hx <= ws - 1) & (hy >= 0) & (hy <= hs - 1)
    want = _ref_hist(np.clip(hx, 0, ws - 1), np.clip(hy, 0, hs - 1),
                     inb.astype(np.float64), hs, ws)
    np.testing.assert_allclose(np.asarray(hist), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Resampling
# ---------------------------------------------------------------------------


def _resample_case(rng, G, hs, ws, N, scale, tyv, txv, jitter):
    hist = rng.uniform(0, 1, (G, hs, ws)).astype(np.float32)
    s = lambda c: (c + rng.uniform(-jitter, jitter, (G, N))).astype(np.float32)
    t = lambda c: (c + rng.uniform(-2, 2, (G, N))).astype(np.float32)
    return hist, s(scale), t(tyv), s(scale), t(txv)


def _check_resample_sum(hist, sy, ty, sx, tx, Ho, Wo):
    got = np.asarray(resample_sum(
        jnp.asarray(hist), jnp.asarray(sy), jnp.asarray(ty),
        jnp.asarray(sx), jnp.asarray(tx), Ho, Wo, dtype=jnp.float32))
    G, N = sy.shape
    want = np.zeros((N, Ho, Wo))
    for n in range(N):
        for g in range(G):
            want[n] += _ref_resample(hist[g], sy[g, n], ty[g, n],
                                     sx[g, n], tx[g, n], Ho, Wo)
    assert got.shape == (N, Ho, Wo)
    assert _max_rel_err(got, want) < 1e-4


@pytest.mark.parametrize("scale,tyv,txv", [
    (1.0, 0.0, 0.0),        # identity
    (0.5, -32.0, -128.0),   # supersampled sweep regime
    (1.1, 5.0, 10.0),       # mild zoom
])
def test_resample_sum_matches_dense(scale, tyv, txv):
    rng = np.random.default_rng(1)
    _check_resample_sum(*_resample_case(rng, 4, 224, 640, 3, scale, tyv,
                                        txv, 0.02), 48, 128)


@pytest.mark.parametrize("scale", [0.3, 0.15])
def test_resample_sum_low_scale(scale):
    """Maps that shrink the grid several-fold stay exact (every input bin
    lands somewhere in the band)."""
    rng = np.random.default_rng(3)
    _check_resample_sum(*_resample_case(rng, 2, 256, 512, 2, scale, 0.0,
                                        0.0, 0.01), 64, 256)


def test_resample_sum_any_output_width():
    """No alignment constraint on the output plane: a 100-column output
    matches the reference."""
    rng = np.random.default_rng(5)
    _check_resample_sum(*_resample_case(rng, 2, 64, 256, 2, 1.0, 3.0, -5.0,
                                        0.05), 40, 100)


def test_resample_affine_blocked_matches_dense():
    """Per-item frame changes summed over K items (the leaf merge)."""
    rng = np.random.default_rng(2)
    N, K, hs, ws = 3, 2, 64, 256
    hist = rng.uniform(0, 1, (N * K, hs, ws)).astype(np.float32)
    sy = (1.0 + rng.uniform(-0.05, 0.05, N * K)).astype(np.float32)
    ty = rng.uniform(-3, 3, N * K).astype(np.float32)
    sx = (1.0 + rng.uniform(-0.05, 0.05, N * K)).astype(np.float32)
    tx = rng.uniform(-3, 3, N * K).astype(np.float32)
    got = np.asarray(_resample_hist_affine(
        jnp.asarray(hist), jnp.asarray(sy), jnp.asarray(ty),
        jnp.asarray(sx), jnp.asarray(tx), dtype=jnp.float32))
    got = got.reshape(N, K, hs, ws).sum(axis=1)
    want = np.zeros((N, hs, ws))
    for n in range(N):
        for k in range(K):
            i = n * K + k
            want[n] += _ref_resample(hist[i], sy[i], ty[i], sx[i], tx[i],
                                     hs, ws)
    assert _max_rel_err(got, want) < 1e-4


def test_resample_affine_mass_conservation():
    """Push-forward resample conserves total mass when the mapped support
    stays inside the grid."""
    rng = np.random.default_rng(3)
    hs, ws = 64, 256
    hist = np.zeros((1, hs, ws), np.float32)
    hist[0, 16:48, 64:192] = rng.uniform(0, 1, (32, 128))
    out = np.asarray(_resample_hist_affine(
        jnp.asarray(hist), jnp.full((1,), 0.9), jnp.full((1,), 4.0),
        jnp.full((1,), 1.05), jnp.full((1,), -8.0)))
    assert out.sum() == pytest.approx(hist.sum(), rel=2e-3)


def test_bf16_matches_f32_end_to_end():
    """The default bf16 operands change the DSI only by bf16 rounding: the
    segmented spec agrees with its f32 (HIGHEST precision) twin."""
    from dvs_mcemvs_tpu import mapper as mappermod, pipeline
    from dvs_mcemvs_tpu.mapper import DsiShape, make_mapper
    from dvs_mcemvs_tpu.ops import trajectory as trajmod
    from dvs_mcemvs_tpu.utils import synthetic

    rig = synthetic.esim_like_rig()
    rng = np.random.default_rng(0)
    pts = synthetic.make_scene(rig, rng, 500)
    ev = synthetic.simulate_events(rig, pts, 0, n_samples=10, rng=rng)
    m = make_mapper(rig.cam, DsiShape(dim_z=16, min_depth=1.0, max_depth=4.0))
    ts, q, p = synthetic.rig_poses(rig)
    traj = trajmod.from_arrays(ts, q, p)
    T_rv_w = pipeline.place_reference_view(traj, 0.5)
    spec = "hist:g4,ss2,seg4"
    a = np.asarray(mappermod.evaluate_dsi(
        m, ev, traj, T_rv_w, packet_size=512, backend=spec + ",f32"))
    b = np.asarray(mappermod.evaluate_dsi(
        m, ev, traj, T_rv_w, packet_size=512, backend=spec))
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.999
    assert abs(b.sum() / a.sum() - 1) < 1e-2
