"""Device behaviour that only the GPU shows: f32 products kept out of
TF32, and the voting backends' DSIs against the same computation on the
host CPU.  Skipped elsewhere; `python chip_smoke.py` runs these on the
card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_f32_products_are_not_tf32(gpu_device):
    """The hist engine's f32 path and the geometry matmuls ask for HIGHEST
    precision; TF32 would leave ~1e-3 relative error."""
    from dvs_mcemvs_tpu.ops.voting_hist import _dot

    rng = np.random.default_rng(0)
    a = rng.normal(size=(256, 512)).astype(np.float32)
    b = rng.normal(size=(512, 256)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    with jax.default_device(gpu_device):
        got = np.asarray(_dot(jnp.asarray(a), jnp.asarray(b),
                              (((1,), (0,)), ((), ())), jnp.float32))
        geo = np.asarray(jnp.matmul(jnp.asarray(a), jnp.asarray(b),
                                    precision=jax.lax.Precision.HIGHEST))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-5
    assert np.abs(geo - want).max() / scale < 1e-5


@pytest.fixture(scope="module")
def small_rig():
    from dvs_mcemvs_tpu import pipeline
    from dvs_mcemvs_tpu.mapper import DsiShape, make_mapper
    from dvs_mcemvs_tpu.ops import trajectory as trajmod
    from dvs_mcemvs_tpu.utils import synthetic

    rig = synthetic.esim_like_rig()
    rng = np.random.default_rng(0)
    pts = synthetic.make_scene(rig, rng, 2000)
    ev = synthetic.simulate_events(rig, pts, 0, n_samples=18, rng=rng)
    m = make_mapper(rig.cam, DsiShape(dim_z=24, min_depth=1.0, max_depth=4.0))
    ts, q, p = synthetic.rig_poses(rig)
    traj = trajmod.from_arrays(ts, q, p)
    T_rv_w = pipeline.place_reference_view(traj, 0.5)
    return m, ev, traj, T_rv_w


def _dsi_on(device, small_rig, backend):
    from dvs_mcemvs_tpu import mapper as mappermod

    m, ev, traj, T_rv_w = small_rig
    with jax.default_device(device):
        return np.asarray(mappermod.evaluate_dsi(
            m, ev, traj, T_rv_w, packet_size=512, backend=backend),
            np.float64)


def test_scatter_dsi_matches_cpu(gpu_device, small_rig):
    """Exact scatter: unordered f32 atomics only reassociate the sums.  The
    two backends also round the warp's f32 arithmetic differently (fused
    multiply-adds), which moves a vote near a pixel or border boundary by
    ~1e-4 of its weight (H100: 1.07e-4 on 1 of 1,036,800 voxels)."""
    g = _dsi_on(gpu_device, small_rig, "scatter")
    c = _dsi_on(jax.devices("cpu")[0], small_rig, "scatter")
    assert abs(g.sum() / c.sum() - 1) < 1e-5
    np.testing.assert_allclose(g, c, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("backend", ["hist:g4,ss2,seg4", "sort"])
def test_backend_dsi_matches_cpu(gpu_device, small_rig, backend):
    g = _dsi_on(gpu_device, small_rig, backend)
    c = _dsi_on(jax.devices("cpu")[0], small_rig, backend)
    assert abs(g.sum() / c.sum() - 1) < 1e-4
    assert np.corrcoef(g.ravel(), c.ravel())[0, 1] > 0.9999
