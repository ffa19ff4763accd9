#!/usr/bin/env python
"""Generate the config-preset corpus mirroring the reference experiment grid.

The reference ships 51 gflags flagfiles under mapper_emvs_stereo/cfg/**
encoding the paper's experiment grid (datasets x algorithms x fusion
variants; taxonomy in docs/running.md:9-16).  This generator re-creates the
same grid for this framework with machine-independent `${DATA}` path
roots (the reference files hard-code the authors' home directories).

Run `python configs/generate.py` from the repo root to (re)write configs/.
Preset values (depth ranges, windows, thresholds, max_confidence
normalization constants) follow the reference's cfg files for parity.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

# Fusion-variant taxonomy (docs/running.md:9-16):
#   alg1          process_1, stereo HM
#   AtHc          process_2: HM across cameras, AM across time
#   AtHc_shuffled process_5 variant of AtHc
#   AcHt          process_2: AM cameras, HM time
#   AcAt / HcHt   both-same grids
#   fusionfuncs   process_1 with each of min/HM/GM/AM/RMS/max
MVSEC_VARIANTS = {
    "alg1": dict(process_method=1, stereo_fusion=2),
    "AtHc": dict(process_method=2, stereo_fusion=2, temporal_fusion=4,
                 num_intervals=2),
    "AtHc_shuffled": dict(process_method=5, stereo_fusion=2,
                          temporal_fusion=4, num_intervals=2),
    "AcHt": dict(process_method=2, stereo_fusion=4, temporal_fusion=2,
                 num_intervals=2),
    "AcAt": dict(process_method=2, stereo_fusion=4, temporal_fusion=4,
                 num_intervals=2),
    "HcHt": dict(process_method=2, stereo_fusion=2, temporal_fusion=2,
                 num_intervals=2),
}

FUSION_FUNCS = {"min": 1, "HM": 2, "GM": 3, "AM": 4, "RMS": 5, "max": 6}

# Reference max_confidence normalization constants per MVSEC variant
# (cfg/upenn_mvsec/**/flying1.conf).
MVSEC_MAXCONF = {"alg1": 57.7, "AtHc": 28.3, "AtHc_shuffled": 28.3,
                 "AcHt": 28.1, "AcAt": 28.4, "HcHt": 28.1}


def emit(path: str, flags: dict) -> None:
    full = os.path.join(ROOT, path)
    os.makedirs(os.path.dirname(full), exist_ok=True)
    with open(full, "w") as f:
        f.write("# generated by configs/generate.py — edit the generator\n")
        for k, v in flags.items():
            if isinstance(v, bool):
                v = "true" if v else "false"
            f.write(f"--{k}={v}\n")


def base(**kw) -> dict:
    d = dict(out_path="")
    d.update(kw)
    return d


def mvsec(seq: int) -> None:
    common = base(
        bag_filename="${DATA}/mvsec/indoor_flying%d_combined.bag" % seq,
        calib_type="yaml_mvsec",
        calib_path="${DATA}/mvsec/calib_in_flying/camchain-imucam-indoor_flying.yaml",
        event_topic0="/davis/left/events",
        event_topic1="/davis/right/events",
        pose_topic="/davis/left/pose",
        min_depth=1, max_depth=6.5, start_time_s=10, stop_time_s=65,
        dimZ=100, out_skip=0.05, duration=1,
        adaptive_threshold_c=14, median_filter_size=9, full_seq=True,
    )
    for name, var in MVSEC_VARIANTS.items():
        flags = dict(common)
        flags.update(var)
        flags["max_confidence"] = MVSEC_MAXCONF[name]
        emit(f"upenn_mvsec/flying{seq}_full/{name}/flying{seq}.conf", flags)
    for fname, code in FUSION_FUNCS.items():
        flags = dict(common)
        flags.update(process_method=1, stereo_fusion=code, max_confidence=0)
        emit(f"upenn_mvsec/flying{seq}_full/fusionfuncs/{fname}.conf", flags)


def dsec() -> None:
    for seq, (t0, t1, skip, maxconf, dur) in {
        "interlaken_00_b": (10, 35, 1.0, 0, 0.2),
        "zurich_city_04_a": (10, 15, 0.1, 468, 0.2),
        "zurich_city_02_a": (10, 25, 0.5, 0, 0.2),
    }.items():
        odom = seq.rsplit("_", 1)[0]
        emit(f"DSEC/{seq}_full/dsec.conf", base(
            bag_filename_left=f"${{DATA}}/DSEC/{seq}/events/left/events.h5",
            bag_filename_right=f"${{DATA}}/DSEC/{seq}/events/right/events.h5",
            bag_filename_pose=f"${{DATA}}/DSEC/{odom}-odometry/pose.bag",
            calib_type="dsec_yaml",
            calib_path=f"${{DATA}}/DSEC/{seq}/{seq}_calibration/cam_to_cam.yaml",
            mocap_calib_path=f"${{DATA}}/DSEC/{seq}/{seq}_calibration/cam_to_lidar.yaml",
            min_depth=4, max_depth=200, start_time_s=t0, stop_time_s=t1,
            duration=dur, out_skip=skip, dimZ=100,
            process_method=1, stereo_fusion=2, adaptive_threshold_c=4,
            max_confidence=maxconf, forward_looking=True, full_seq=True,
        ))


def tumvie() -> None:
    seqs = ["bike-easy-3", "bike-easy-4", "bike-easy-5", "desk2",
            "mocap-1d-trans", "mocap-3d-trans", "running-easy-0",
            "running-easy-1", "skate-easy-1"]
    for s in seqs:
        emit(f"tumvie/{s}_full/tum-vie.conf", base(
            bag_filename_left=f"${{DATA}}/tum-vie/{s}-events_left.h5",
            bag_filename_right=f"${{DATA}}/tum-vie/{s}-events_right.h5",
            bag_filename_pose=f"${{DATA}}/tum-vie/{s}-vi_gt_data/pose.txt",
            calib_type="json",
            calib_path="${DATA}/tum-vie/camera-calibrationB.json",
            min_depth=3, max_depth=100, start_time_s=1, stop_time_s=15,
            dimZ=100, process_method=1, out_skip=0.5, duration=0.5,
            adaptive_threshold_c=5, forward_looking=True, full_seq=True,
        ))


def evimo2() -> None:
    emit("evimo2/evimo2.conf", base(
        bag_filename="${DATA}/evimo2/scene_03_00.bag",
        calib_type="evimo2", calib_path="",
        event_topic0="/samsung/camera/events", offset0=0.001,
        event_topic1="/prophesee/left/cd_events_buffer", offset1=-0.042,
        event_topic2="/prophesee/right/cd_events_buffer", offset2=-0.027,
        pose_topic="/vicon/dvs_rig",
        min_depth=0.5, max_depth=4, start_time_s=20.5, stop_time_s=21.5,
        ts=21, dimZ=100, process_method=1, stereo_fusion=2,
        adaptive_threshold_c=10, median_filter_size=9, save_mono=True,
    ))


def hkust() -> None:
    emit("hkust/hkust_lab.conf", base(
        bag_filename="${DATA}/hkust/hkust_combined.bag",
        calib_type="hkust", calib_path="",
        event_topic0="/davis/left/events", event_topic1="/davis/right/events",
        pose_topic="/esvo_tracking/pose_filtered",
        min_depth=0.5, max_depth=4, start_time_s=31.5, stop_time_s=32.5,
        ts=32, dimZ=100, process_method=1, stereo_fusion=2,
        adaptive_threshold_c=8, median_filter_size=7,
    ))


def eccv18() -> None:
    for scene, (lo, hi) in {"reader": (0.5, 2.5), "monitor_edited": (0.3, 1.2),
                            "boxes_edited": (0.5, 3.0)}.items():
        emit(f"rpg_eccv18/{scene}/alg1/{scene}.conf", base(
            bag_filename=f"${{DATA}}/rpg_eccv18/{scene}.bag",
            calib_type="eccv18", calib_path="",
            event_topic0="/davis/left/events",
            event_topic1="/davis/right/events",
            pose_topic="/optitrack/davis_stereo",
            min_depth=lo, max_depth=hi, dimZ=100,
            process_method=1, stereo_fusion=2,
        ))


def synthetic() -> None:
    """Self-contained preset for the shipped synthetic fixture — the only
    preset runnable without downloading a dataset (see utils/synthetic.py)."""
    emit("synthetic/esim_stereo.conf", base(
        bag_filename_left="data/events_0.npz",
        bag_filename_right="data/events_1.npz",
        bag_filename_pose="data/poses_tum.txt",
        calib_type="esim",
        ts=0.5, dimZ=40, min_depth=1, max_depth=4,
        process_method=1, stereo_fusion=2, radius_search=0.3,
        out_path="out/",
    ))


def main() -> int:
    mvsec(1); mvsec(2); mvsec(3)
    dsec(); tumvie(); evimo2(); hkust(); eccv18(); synthetic()
    n = sum(len(fs) for _, _, fs in os.walk(ROOT))
    print(f"wrote presets under {ROOT} ({n} files incl. generator)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
