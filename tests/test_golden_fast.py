"""Fast-tier golden accuracy gates (VERDICT r4 weak #7: the full-dim golden
module votes 2x262k events x 100 planes and outruns CI-scale time on small
hosts).  This tier runs the SAME production spec against a reduced-dim exact-scatter anchor (golden.SMALL: 320x240x50,
2x64k events, same real zurich_city_04 pose window, same stripe scene,
same FOV) in well under a minute on 2 CPU cores.

Budgets are small-fixture-specific: the plane step in disparity is the same
0.69 px as the full fixture (fx halves, dim_z halves), but metric depth
granularity doubles (50 planes over the same 4-24 m), so the metric gates
sit wider while the index gates stay comparable.  Measured on CPU: production
hist:g4,ss2,seg5 within1=0.862 rel=0.035.

Regenerate the anchor with `python scripts/make_golden.py --small`.
"""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from dvs_mcemvs_tpu import pipeline
from dvs_mcemvs_tpu.mapper import get_depth_map
from dvs_mcemvs_tpu.ops import extract
from dvs_mcemvs_tpu.utils import golden

SMALL_BUDGET = {
    "confident_quantile": golden.BUDGET["confident_quantile"],
    "production": {"within1": 0.82, "within2": 0.88, "median": 1.0,
                   "gt_median_rel_err": 0.05},
    "per_camera_mass_rel": golden.BUDGET["per_camera_mass_rel"],
}


@pytest.fixture(scope="module")
def small_fixture():
    mappers, events, trajs, scene, ts_rv = golden.build_golden_fixture(
        cfg=golden.SMALL)
    g = np.load(golden.GOLDEN_SMALL_NPZ)
    meta = json.loads(str(g["meta"]))
    assert meta["seed"] == golden.SEED, "small golden artifacts are stale"
    assert meta["events"] == [e.num for e in events], (
        "fixture drifted from the committed small golden — re-run "
        "scripts/make_golden.py --small")
    return mappers, events, trajs, scene, ts_rv, g


def _run_and_gate(small_fixture, tier):
    mappers, events, trajs, scene, ts_rv, g = small_fixture
    spec = golden.production_backend_spec(events, 1024, cfg=golden.SMALL)
    vopts = pipeline.VotingOptions(packet_size=1024, backend=spec,
                                   pad_policy="bucket")
    res = pipeline.process_1(mappers, events, trajs, ts_rv,
                             stereo_fusion=2, vopts=vopts)
    dm = get_depth_map(mappers[0], res.fused_dsi, extract.DepthMapOptions())

    gi = np.asarray(g["depth_indices"]).astype(int)
    conf = np.asarray(g["confidence"])
    sel = conf > np.quantile(conf, SMALL_BUDGET["confident_quantile"])
    ei = np.abs(np.asarray(dm.depth_indices).astype(int)[sel] - gi[sel])
    b = SMALL_BUDGET[tier]
    w1, w2 = float(np.mean(ei <= 1)), float(np.mean(ei <= 2))
    assert w1 >= b["within1"], f"{spec}: within1={w1}"
    assert w2 >= b["within2"], f"{spec}: within2={w2}"
    assert float(np.median(ei)) <= b["median"], f"{spec}: median"

    cam_mass = np.asarray(g["cam_mass"])
    for c in range(2):
        mass = float(np.asarray(res.dsis[f"camera{c}"], np.float64).sum())
        rel = abs(mass / cam_mass[c] - 1)
        assert rel < SMALL_BUDGET["per_camera_mass_rel"], \
            f"{spec}: cam{c} mass off {rel}"

    m = np.asarray(dm.mask) > 0
    rel = float(np.median(np.abs(np.asarray(dm.depth)[m] - scene.gt_depth[m])
                          / scene.gt_depth[m]))
    assert rel < b["gt_median_rel_err"], f"{spec}: gt median rel {rel}"


def test_small_anchor_on_gt(small_fixture):
    """The committed small anchor itself sits on the analytic GT."""
    *_, scene, ts_rv, g = small_fixture
    m = np.asarray(g["mask"]) > 0
    d = np.asarray(g["depth"])[m]
    gt = scene.gt_depth[m]
    rel = float(np.median(np.abs(d - gt) / gt))
    assert rel < golden.BUDGET["gt_median_rel_err"]
    assert m.sum() > 5_000


def test_small_production_spec(small_fixture):
    """The auto spec, gated in seconds (runs in every dev loop)."""
    _run_and_gate(small_fixture, tier="production")


def test_bench16_fixture_selects_headline_spec():
    """golden.BENCH16's real-pose window must auto-select the SAME backend
    string as the headline benchmark workload, so bench.py's on-device
    golden gate scores the LITERAL spec its throughput number times
    Pure host computation — no voting."""
    import importlib.util

    from dvs_mcemvs_tpu.ops.voting_hist import auto_backend_spec

    spec_mod = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py"))
    bench = importlib.util.module_from_spec(spec_mod)
    sys.modules.setdefault("bench", bench)
    spec_mod.loader.exec_module(bench)

    headline = auto_backend_spec(
        0.5, bench.N_EVENTS // bench.PACKET, bench.WIDTH * 0.9,
        2.0, 40.0, bench.DIM_Z)

    class _N:
        def __init__(self, n):
            self.num = n

    fixture_spec = golden.production_backend_spec(
        [_N(golden.BENCH16.max_events)] * 2, 1024, cfg=golden.BENCH16)
    assert fixture_spec == headline, (fixture_spec, headline)
    assert os.path.exists(golden.GOLDEN_BENCH16_NPZ)
