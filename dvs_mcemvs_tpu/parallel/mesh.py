"""Device-mesh construction for the MC-EMVS workload.

The reference's only compute parallelism is an OpenMP loop over depth planes
(reference: mapper_emvs_stereo/src/mapper_emvs_stereo.cpp:166-172).  This
build generalizes it to a 2D logical mesh:

  - axis "event": data parallelism over the event stream.  Voting is a pure
    sum over events (fillVoxelGrid accumulation, cpp:174-203), so each shard
    votes a partial DSI and a `psum` over this axis reconstructs the exact
    single-device grid.
  - axis "plane": model parallelism over depth planes — the direct analog of
    the OpenMP axis.  Zero communication during voting; one cheap
    `all_gather` of collapsed 2D maps at extraction time.

The "event" axis is the one that tolerates a slow link (pure reduce at the
end, so it may span hosts); "plane" stays within a host when both are used.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

EVENT_AXIS = "event"
PLANE_AXIS = "plane"


def _plane_sharding_helps(backend: Optional[str]) -> bool:
    """Whether the splat backend gains from plane shards.

    The hist:* backends bin the full event stream into a dense image
    histogram before resampling it onto each depth plane — a plane shard
    re-bins ALL events for its plane subset, so plane sharding duplicates
    the dominant work (SCALING.json, on CPU virtual devices: (1,8) at 4.40x
    and (2,4) at 1.47x overhead vs (8,1) at 0.27x on the hist backend).  The
    scatter/sort backends splat events per plane (the reference's OpenMP
    mapping, mapper_emvs_stereo.cpp:166-172), so their plane shards are
    communication-free AND work-free — those keep the plane preference.
    """
    return backend is not None and backend.partition(":")[0] not in (
        "hist", "hist_exact")


def pick_mesh_shape(
    n_devices: int, dim_z: int, max_plane_shards: int = 8,
    backend: Optional[str] = None,
) -> Tuple[int, int]:
    """(n_event, n_plane) factorization of `n_devices`, backend-aware.

    For the hist:* backends (the spec the CLI's auto path ships) every
    device goes to the "event" axis — plane shards would duplicate
    the event binning (see _plane_sharding_helps).  For scatter-family
    backends (or unknown, backend=None) plane shards are preferred up to
    `max_plane_shards`, provided they divide `dim_z` evenly; the remaining
    factor becomes event shards.
    """
    if backend is not None and not _plane_sharding_helps(backend):
        return n_devices, 1
    n_plane = 1
    for cand in range(min(max_plane_shards, n_devices), 0, -1):
        if n_devices % cand == 0 and dim_z % cand == 0:
            n_plane = cand
            break
    return n_devices // n_plane, n_plane


def make_mesh(
    n_event: int,
    n_plane: int,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build the ("event", "plane") mesh over the first n_event*n_plane
    devices (or an explicit device list)."""
    if devices is None:
        devices = jax.devices()
    need = n_event * n_plane
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(n_event, n_plane)
    return Mesh(arr, (EVENT_AXIS, PLANE_AXIS))


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Initialize multi-process JAX (the reference has no multi-node layer
    at all — SURVEY.md §2 parallelism inventory; this replaces it with
    `jax.distributed` + XLA collectives).

    Pass all three arguments (coordinator `host:port`, process count, this
    process's index): a GPU host has no cluster environment JAX could
    detect them from.  Safe to call twice.  Returns (process_index,
    process_count).
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already initialized" not in str(e):
            raise
    return jax.process_index(), jax.process_count()


def global_mesh(dim_z: int, max_plane_shards: int = 8,
                backend: Optional[str] = None) -> Mesh:
    """("event", "plane") mesh over ALL devices of a (possibly multi-host)
    run: plane shards stay intra-host by using the per-process device
    order, event shards span hosts (their only communication is the final
    grid psum, which tolerates the slower inter-host link).

    Backend-aware like `pick_mesh_shape`: hist:* backends put every device
    on the "event" axis.  Otherwise the factorization is constrained so the
    "event" axis is divisible by the process count AND the "plane" axis
    never crosses a process boundary — each process then owns a whole
    number of event-shard rows and can feed them from local host memory
    (`sharded_step_inputs_multihost`)."""
    devices = jax.devices()
    n_dev = len(devices)
    pcnt = jax.process_count()
    local = n_dev // pcnt
    n_plane = 1
    if backend is None or _plane_sharding_helps(backend):
        for cand in range(min(max_plane_shards, local), 0, -1):
            if (n_dev % cand == 0 and dim_z % cand == 0
                    and local % cand == 0
                    and (n_dev // cand) % pcnt == 0):
                n_plane = cand
                break
    return make_mesh(n_dev // n_plane, n_plane)
