"""Fusion pipelines and the streaming scheduler.

JAX equivalents of the reference's three algorithm drivers and its
sliding-window loop:

  - `process_1`  — multi-camera fusion at a reference view
                   (reference: mapper_emvs_stereo/src/process1.cpp:28-224)
  - `process_2`  — camera x time fusion, both fusion orders
                   (src/process2.cpp:28-302)
  - `process_5`  — time fusion with shuffled right-camera sub-intervals
                   (src/process5.cpp:27-260)
  - `full_seq`   — sliding-window chunk scheduler (src/main.cpp:173-302),
                   re-designed around a resident event store sliced per chunk
                   instead of re-parsing input files every chunk.

All functions are host-side orchestration over jitted array computations; the
DSIs they pass around are plain (Z, H, W) arrays.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from . import mapper as mappermod
from .mapper import Events, Mapper
from .ops import extract, grid as gridops, se3, trajectory as trajmod, voting
from .ops.se3 import SE3

log = logging.getLogger(__name__)

# Temporal-fusion enum of the reference (`temporal_fusion` flag, main.cpp:92;
# switch in process2.cpp:211-242): 2 = harmonic mean, 4 = arithmetic mean.
TEMPORAL_HM = 2
TEMPORAL_AM = 4


@dataclasses.dataclass(frozen=True)
class VotingOptions:
    packet_size: int = voting.DEFAULT_PACKET_SIZE
    backend: str = "scatter"
    plane_block: int = 8
    # "bucket" pads chunks to power-of-two packet capacities so the voting
    # jit compiles O(log E) times per run instead of once per chunk size
    # (and the trailing partial packet votes); "none" = reference-exact.
    pad_policy: str = "bucket"
    # True blocks on the device after each chunk's voting for exact Mev/s
    # timing; False (default) lets dispatch run ahead so host prep of
    # chunk k+1 overlaps device compute of chunk k.
    sync: bool = False


@dataclasses.dataclass
class ProcessResult:
    """Fused DSI plus named intermediates, timings, and the RV placement."""

    fused_dsi: jnp.ndarray
    T_rv_w: SE3
    ts: float
    dsis: Dict[str, jnp.ndarray] = dataclasses.field(default_factory=dict)
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)
    mev_per_s: Optional[float] = None
    # Pre-extracted depth map (extract.DepthMapResult) when the producer
    # already ran the extraction chain on-device (the sharded mesh step).
    extracted: Optional[object] = None


def place_reference_view(
    traj0: trajmod.Trajectory, ts: float, rv_pos: float = 0.0
) -> SE3:
    """RV at the left camera pose at `ts`, optionally shifted along the
    stereo baseline by `rv_pos` metres (process1.cpp:60-68).  Returns T_rv_w.
    """
    T_w_l, valid = trajmod.pose_at(traj0, jnp.float32(ts))
    if not bool(np.asarray(valid)):
        raise ValueError(f"reference-view time {ts} outside trajectory")
    shift = SE3(
        jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32),
        jnp.asarray([rv_pos, 0.0, 0.0], jnp.float32),
    )
    T_w_rv = se3.compose(T_w_l, shift)
    return se3.inverse(T_w_rv)


def _evaluate_all(
    mappers: Sequence[Mapper],
    events: Sequence[Events],
    trajs: Sequence[trajmod.Trajectory],
    T_rv_w: SE3,
    vopts: VotingOptions,
) -> Tuple[List[Optional[jnp.ndarray]], float, int]:
    """Per-camera DSIs + wall time + total events (the Mev/s probe of
    process1.cpp:80-86).  With vopts.sync=False the time covers dispatch
    only (the returned DSIs are in flight) — exact per-chunk timing costs
    the ingest/compute overlap, so it is opt-in."""
    t0 = time.time()
    dsis = []
    n_ev = 0
    for m, ev, trj in zip(mappers, events, trajs):
        dsi = mappermod.evaluate_dsi(
            m, ev, trj, T_rv_w,
            packet_size=vopts.packet_size, backend=vopts.backend,
            plane_block=vopts.plane_block, pad=vopts.pad_policy,
        )
        if dsi is not None:
            n_ev += ev.num
        dsis.append(dsi)
    if vopts.sync and any(d is not None for d in dsis):
        [d.block_until_ready() for d in dsis if d is not None]
    return dsis, time.time() - t0, n_ev


def process_1(
    mappers: Sequence[Mapper],
    events: Sequence[Events],
    trajs: Sequence[trajmod.Trajectory],
    ts: float,
    stereo_fusion: int,
    rv_pos: float = 0.0,
    vopts: VotingOptions = VotingOptions(),
) -> ProcessResult:
    """Algorithm 1: fuse per-camera DSIs at a common reference view.

    Mirrors process1.cpp:28-224 with one documented generalization: for three
    cameras the reference only implements n-ary fusion for HM/min/max and
    silently ignores the third camera for GM/AM/RMS (process1.cpp:178-183);
    here all six fusion functions handle any camera count.
    """
    T_rv_w = place_reference_view(trajs[0], ts, rv_pos)
    dsis, dt, n_ev = _evaluate_all(mappers, events, trajs, T_rv_w, vopts)
    live = [d for d in dsis if d is not None]
    if not live:
        raise ValueError("no camera produced a DSI (all chunks too small)")
    fused = gridops.fuse_many(live, stereo_fusion)
    res = ProcessResult(
        fused_dsi=fused, T_rv_w=T_rv_w, ts=ts,
        timings={"dsi_voting_s": dt},
        mev_per_s=(n_ev / dt / 1e6) if dt > 0 else None,
    )
    for i, d in enumerate(dsis):
        if d is not None:
            res.dsis[f"camera{i}"] = d
    log.info("process_1: %d events, %.3f s, %.3f Mev/s",
             n_ev, dt, res.mev_per_s or 0.0)
    return res


def split_subintervals(ev: Events, n: int) -> List[Events]:
    """Equal-event-count sub-intervals (process2.cpp:46-47,104-134).

    The reference drops the remainder events beyond n * (E // n); so do we.
    """
    per = ev.num // n
    return [ev.slice(k * per, (k + 1) * per) for k in range(n)]


def split_subintervals_shifted(ev: Events, n: int, shift: int) -> List[Events]:
    """process_5's shuffled split for the right camera: start at sub-interval
    `shift` and wrap around the end of the stream (process5.cpp:89-93,134-150).
    """
    per = ev.num // n
    out = []
    start = shift * per
    for _ in range(n):
        stop = start + per
        if stop >= ev.num:
            head = ev.slice(start, ev.num)
            stop = stop - ev.num
            tail = ev.slice(0, stop)
            p = None if ev.p is None else np.concatenate([head.p, tail.p])
            out.append(Events(
                np.concatenate([head.x, tail.x]),
                np.concatenate([head.y, tail.y]),
                np.concatenate([head.t, tail.t]),
                p,
            ))
            start = stop
        else:
            out.append(ev.slice(start, stop))
            start = stop
    return out


@dataclasses.dataclass
class TemporalResult(ProcessResult):
    """process_2/5 output: `fused_dsi` is camera-fused-then-time-fused; the
    converse order and per-camera temporal fusions ride along in `dsis`
    under keys 'left_temporal', 'right_temporal', 'camera_time'."""


def _temporal_accumulate(acc, dsi, method: int):
    if method == TEMPORAL_HM:
        return gridops.add_inverse(acc, dsi)
    if method == TEMPORAL_AM:
        return gridops.fuse_add(acc, dsi)
    raise ValueError(f"temporal_fusion must be {TEMPORAL_HM} (HM) or {TEMPORAL_AM} (AM)")


def _temporal_finalize(acc, n: int, method: int):
    if method == TEMPORAL_HM:
        return gridops.hm_from_sum_of_inv(acc, n)
    return gridops.am_from_sum(acc, n)


def process_time_fusion(
    mappers: Sequence[Mapper],
    events: Sequence[Events],
    trajs: Sequence[trajmod.Trajectory],
    ts: float,
    stereo_fusion: int,
    temporal_fusion: int,
    num_intervals: int,
    shuffle: bool = False,
    rv_pos: float = 0.0,
    vopts: VotingOptions = VotingOptions(),
    on_subinterval: Optional[Callable[[int, Dict[str, jnp.ndarray]], None]] = None,
    evaluate_pair: Optional[Callable] = None,
) -> TemporalResult:
    """Algorithm 2: camera x time fusion with streaming accumulators.

    `shuffle=False` reproduces process_2 (src/process2.cpp:28-302);
    `shuffle=True` reproduces process_5's half-rotation of the right camera's
    sub-intervals (src/process5.cpp:27-260).  Both fusion orders are computed:
    the primary output fuses cameras within each sub-interval then fuses
    across time (At(Hc) naming of docs/running.md:9-16); 'camera_time' is the
    converse (time per camera, then across cameras).

    Note: the reference's converse-order switch swaps AM and GM relative to
    every other fusion dispatch (process2.cpp:274-278) — treated as a bug and
    not reproduced; `stereo_fusion` means the same function everywhere here.

    `evaluate_pair(mappers, [ev0, ev1], trajs, T_rv_w) -> (d0, d1)` swaps the
    per-camera DSI evaluator — the hook the CLI uses to vote each
    sub-interval on a device mesh (parallel/sharded.make_sharded_voting_step)
    while the streaming accumulators below stay plane-sharded (they are
    elementwise, so temporal fusion adds zero communication).  Returning
    None for a DSI marks the sub-interval too small, like the default path.
    """
    if len(mappers) != 2:
        raise ValueError("time fusion is defined for stereo rigs (2 cameras)")
    T_rv_w = place_reference_view(trajs[0], ts, rv_pos)

    subs0 = split_subintervals(events[0], num_intervals)
    if shuffle:
        subs1 = split_subintervals_shifted(events[1], num_intervals, num_intervals // 2)
    else:
        subs1 = split_subintervals(events[1], num_intervals)

    acc_fused = acc_left = acc_right = None
    total_ev = 0
    n_live = 0
    t_start = time.time()
    for k in range(num_intervals):
        if evaluate_pair is not None:
            d0, d1 = evaluate_pair(mappers, [subs0[k], subs1[k]], trajs,
                                   T_rv_w)
            total_ev += subs0[k].num + subs1[k].num
        else:
            dsis, dt, n_ev = _evaluate_all(
                mappers, [subs0[k], subs1[k]], trajs, T_rv_w, vopts
            )
            total_ev += n_ev
            d0, d1 = dsis
        if d0 is None or d1 is None:
            log.warning("sub-interval %d too small, skipped", k)
            continue
        n_live += 1
        fused_k = gridops.fuse_pair(d0, d1, stereo_fusion)
        if on_subinterval is not None:
            on_subinterval(k, {"camera0": d0, "camera1": d1, "fused": fused_k})
        z = jnp.zeros_like(d0)
        acc_fused = _temporal_accumulate(acc_fused if acc_fused is not None else z, fused_k, temporal_fusion)
        acc_left = _temporal_accumulate(acc_left if acc_left is not None else z, d0, temporal_fusion)
        acc_right = _temporal_accumulate(acc_right if acc_right is not None else z, d1, temporal_fusion)

    if acc_fused is None:
        raise ValueError("no sub-interval produced a DSI")
    # Normalize by the count of SURVIVING sub-intervals: a skipped (too
    # small) interval contributed nothing to the accumulator, so dividing by
    # the nominal `num_intervals` would bias the HM/AM low (the reference
    # never skips because it asserts every interval has >= one packet).
    fused = _temporal_finalize(acc_fused, n_live, temporal_fusion)
    left = _temporal_finalize(acc_left, n_live, temporal_fusion)
    right = _temporal_finalize(acc_right, n_live, temporal_fusion)
    camera_time = gridops.fuse_pair(left, right, stereo_fusion)
    dt_all = time.time() - t_start

    res = TemporalResult(
        fused_dsi=fused, T_rv_w=T_rv_w, ts=ts,
        timings={"total_s": dt_all},
        mev_per_s=(total_ev / dt_all / 1e6) if dt_all > 0 else None,
    )
    res.dsis["left_temporal"] = left
    res.dsis["right_temporal"] = right
    res.dsis["camera_time"] = camera_time
    return res


def process_2(*args, **kwargs) -> TemporalResult:
    """process_2 of the reference (camera-then-time and converse orders)."""
    return process_time_fusion(*args, shuffle=False, **kwargs)


def process_5(*args, **kwargs) -> TemporalResult:
    """process_5: like process_2 with shuffled right-camera sub-intervals."""
    return process_time_fusion(*args, shuffle=True, **kwargs)


# ---------------------------------------------------------------------------
# Sliding-window scheduler (full_seq, main.cpp:173-302)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FullSeqOptions:
    start_time: float
    stop_time: float
    duration: float  # chunk length, seconds
    out_skip: float  # stride between chunk starts, seconds
    forward_looking: bool = False  # RV at chunk end instead of midpoint


def full_seq_windows(opts: FullSeqOptions) -> Iterator[Tuple[float, float, float]]:
    """Yields (t0, t1, ts_rv) per chunk, mirroring main.cpp:177-188."""
    t0 = opts.start_time
    while t0 + opts.duration <= opts.stop_time + 1e-12:
        t1 = t0 + opts.duration
        ts = t1 if opts.forward_looking else 0.5 * (t0 + t1)
        yield t0, t1, ts
        t0 += opts.out_skip


def run_full_seq(
    mappers: Sequence[Mapper],
    events: Sequence[Events],
    trajs: Sequence[trajmod.Trajectory],
    opts: FullSeqOptions,
    process: Callable[..., ProcessResult],
    skip: Optional[Callable[[int], bool]] = None,
    **process_kwargs,
) -> Iterator[Tuple[int, float, ProcessResult]]:
    """Run `process` over sliding windows of a resident event store.

    The reference re-parses its input bags for every chunk
    (main.cpp:191-199); here the full event arrays stay resident and each
    chunk is a binary-searched slice — the chunks stay independent (the
    restartability property noted in SURVEY.md §5) without the I/O cost.
    Yields (chunk_index, rv_timestamp, result); chunks whose event slice is
    too small are skipped with a warning, like the reference's false return.

    `skip(k)` is consulted BEFORE the chunk is computed — checkpoint resume
    (checkpoint.RunCheckpoint.is_done) must save the voting compute, not
    just the output writes.
    """
    for k, (t0, t1, ts) in enumerate(full_seq_windows(opts)):
        if skip is not None and skip(k):
            log.info("chunk %d @ ts=%.3f already complete; skipped", k, ts)
            continue
        chunk = [ev.time_window(t0, t1) for ev in events]
        try:
            res = process(mappers, chunk, trajs, ts, **process_kwargs)
        except ValueError as e:
            log.warning("chunk %d [%.3f, %.3f): skipped (%s)", k, t0, t1, e)
            continue
        yield k, ts, res


def run_full_seq_stores(
    mappers: Sequence[Mapper],
    stores: Sequence,                     # io.evstore.EventStore per camera
    trajs: Sequence[trajmod.Trajectory],
    opts: FullSeqOptions,
    process: Callable[..., ProcessResult],
    skip: Optional[Callable[[int], bool]] = None,
    **process_kwargs,
) -> Iterator[Tuple[int, float, ProcessResult]]:
    """full_seq over native event stores with chunk-ahead page prefetch.

    Identical chunking to `run_full_seq` (including the pre-compute `skip`
    predicate), but windows come from the mmap'd stores (O(log E) native
    binary search) and while chunk k computes on the device, each store's
    background thread warms chunk k+1's pages — the ingest/compute overlap
    absent from the reference's serial loop (main.cpp:173-302).
    """
    windows = list(full_seq_windows(opts))
    for k, (t0, t1, ts) in enumerate(windows):
        if skip is not None and skip(k):
            log.info("chunk %d @ ts=%.3f already complete; skipped", k, ts)
            continue
        if k + 1 < len(windows):
            n0, n1, _ = windows[k + 1]
            for s in stores:
                s.prefetch(n0, n1)
        chunk = [s.window(t0, t1) for s in stores]
        try:
            res = process(mappers, chunk, trajs, ts, **process_kwargs)
        except ValueError as e:
            log.warning("chunk %d [%.3f, %.3f): skipped (%s)", k, t0, t1, e)
            continue
        yield k, ts, res
