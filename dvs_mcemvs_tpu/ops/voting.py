"""Event back-projection and DSI voting — the framework's hot path.

Implements the reference's two-step plane-sweep voting
(`MapperEMVS::evaluateDSI` src/mapper_emvs_stereo.cpp:67-148 and
`fillVoxelGrid` :151-205) as batched, jittable device computation:

  1. Packets of `packet_size` consecutive events share the interpolated pose
     at the packet-midpoint timestamp (cpp:88-99).  All packet poses are
     interpolated in one vectorized trajectory query.
  2. Per packet, a single planar homography H_z0 transfers rectified event
     pixels to the z0 depth plane of the reference view (Eq. (8)/(11) of the
     EMVS IJCV paper; cpp:113-142).  All K packets are a batched 3x3 solve +
     one big gather/matmul.
  3. Per depth plane zi, the z0 locations map by the closed-form Eq. (15)
     affine transform (cpp:176-194), then vote with a bilinear 4-neighbor
     splat (cartesian3dgrid.h:253-273).

The reference's OpenMP-over-planes loop (cpp:168) becomes the depth axis of a
(Z, H, W) array; the bilinear splat is a pluggable backend (see `splat_*`):
exact scatter-add, sort + segment-sum, or the scatter-free histogram
formulation of `voting_hist`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import se3, trajectory as trajmod
from .camera import PinholeCamera
from .se3 import SE3

DEFAULT_PACKET_SIZE = 1024


class WarpedPackets(NamedTuple):
    """Events transferred to the z0 plane, grouped in equal-size packets."""

    xy_z0: jnp.ndarray    # (K, P, 2) float32 — Eq. (11) locations on plane z0
    centers: jnp.ndarray  # (K, 3) float32 — camera center in RV frame
    valid: jnp.ndarray    # (K,) bool — pose lookup succeeded
    weight: Optional[jnp.ndarray] = None  # (K, P) per-event vote weight
    # (None = all ones; used for padded / sharded event buffers)

    def event_weights(self) -> jnp.ndarray:
        """(K*P,) flat per-event weight combining packet validity and the
        optional per-event weight (0 for padding)."""
        K, P, _ = self.xy_z0.shape
        w = jnp.repeat(self.valid.astype(jnp.float32), P)
        if self.weight is not None:
            w = w * self.weight.reshape(K * P)
        return w


def num_packets(num_events: int, packet_size: int = DEFAULT_PACKET_SIZE,
                full: bool = False) -> int:
    """Number of packets.  Default mirrors the reference loop, which runs
    while `current + packet_size < num_events` (cpp:88), i.e. floor((E-1)/P).
    With `full=True` every event is packetized (E // P packets) — used by the
    sharded path, where buffers are padded to a packet multiple with
    zero-weight events instead of dropping the tail.
    """
    if full:
        return num_events // packet_size
    return max(0, (num_events - 1) // packet_size)


def packet_mid_times(t: jnp.ndarray, packet_size: int = DEFAULT_PACKET_SIZE,
                     full: bool = False):
    """Midpoint timestamp of each packet (cpp:91): t[k*P + P/2]."""
    K = num_packets(t.shape[0], packet_size, full)
    idx = jnp.arange(K) * packet_size + packet_size // 2
    return t[idx]


def warp_events_to_z0(
    x: jnp.ndarray,
    y: jnp.ndarray,
    t: jnp.ndarray,
    traj: trajmod.Trajectory,
    T_rv_w: SE3,
    lut: jnp.ndarray,
    K_cam: jnp.ndarray,
    Kinv_virtual: jnp.ndarray,
    z0: float,
    width: int,
    packet_size: int = DEFAULT_PACKET_SIZE,
    ev_weight: Optional[jnp.ndarray] = None,
    full: bool = False,
    rect_params: Optional[tuple] = None,
) -> WarpedPackets:
    """Steps 1-2: packet poses, homographies, event transfer to plane z0.

    x, y: (E,) raw integer pixel coords; t: (E,) float32 seconds; lut: the
    (H*W, 2) rectification LUT; K_cam: 3x3 rectified intrinsics of the real
    camera; Kinv_virtual: 3x3 inverse intrinsics of the virtual RV camera.
    When `rect_params` (camera.rect_static) is given, rectification is
    recomputed per event instead of gathered from `lut` (`lut` may be None
    then).

    Divergence from the reference, by design: when a packet's pose lookup
    fails the reference shifts the packet window by one event and retries
    (cpp:95-99); here the fixed-size packet is masked invalid instead.  This
    only differs for events at the very edge of the pose trajectory.
    """
    E = x.shape[0]
    K = num_packets(E, packet_size, full)
    n = K * packet_size
    xk = x[:n].reshape(K, packet_size)
    yk = y[:n].reshape(K, packet_size)

    ts_mid = packet_mid_times(t, packet_size, full)
    T_w_ev, valid = trajmod.pose_at(traj, ts_mid)  # batched SE(3) lerp
    T_rv_ev = se3.compose(
        SE3(
            jnp.broadcast_to(T_rv_w.q, (K, 4)),
            jnp.broadcast_to(T_rv_w.t, (K, 3)),
        ),
        T_w_ev,
    )
    T_ev_rv = se3.inverse(T_rv_ev)
    R = se3.quat_to_matrix(T_ev_rv.q)              # (K, 3, 3)
    tt = T_ev_rv.t                                 # (K, 3)
    # Geometry matmuls run at HIGHEST precision: a reduced-precision f32
    # product (bf16 passes, or TF32 on a GPU) quantizes the fx/cx-scale
    # homography terms by up to ~0.4 % — pixel-scale warp errors (bf16:
    # within1 drops 0.80->0.62 on the golden fixture).  These are 3x3
    # products; the cost is nil.
    hp = jax.lax.Precision.HIGHEST
    centers = -jnp.einsum("kij,ki->kj", R, tt, precision=hp)  # -R^T t (cpp:108)

    # H_z0^{-1} = z0 * R + t e3^T in pixel coords (Eq. (8), cpp:113-120).
    H_inv = z0 * R
    H_inv = H_inv.at[:, :, 2].add(tt)
    H_inv_px = jnp.einsum("ij,kjl,lm->kim", K_cam, H_inv, Kinv_virtual,
                          precision=hp)
    H_px = _inv3x3(H_inv_px)                       # (K, 3, 3)

    # Rectified event locations (LUT gather or analytic), then the
    # per-packet homography (Eq. (11), cpp:129-142).
    if rect_params is not None:
        from .camera import rectify_events_device

        u, v = rectify_events_device(xk, yk, rect_params)
    else:
        rect = lut[yk * width + xk]                # (K, P, 2)
        u, v = rect[..., 0], rect[..., 1]
    hx = H_px[:, None, 0, 0] * u + H_px[:, None, 0, 1] * v + H_px[:, None, 0, 2]
    hy = H_px[:, None, 1, 0] * u + H_px[:, None, 1, 1] * v + H_px[:, None, 1, 2]
    hz = H_px[:, None, 2, 0] * u + H_px[:, None, 2, 1] * v + H_px[:, None, 2, 2]
    xy_z0 = jnp.stack([hx / hz, hy / hz], axis=-1)
    w = None if ev_weight is None else ev_weight[:n].reshape(K, packet_size)
    return WarpedPackets(xy_z0.astype(jnp.float32), centers, valid, w)


def _inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form 3x3 inverse (adjugate / determinant).

    Pure elementwise math, one fused kernel, instead of the LAPACK-style
    `jnp.linalg.inv` lowering for large batches of tiny matrices.  The
    homographies it inverts are well-conditioned (near-identity pixel maps).
    """
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = (1.0 / det)[..., None, None]
    adj = jnp.stack([
        jnp.stack([A00, A01, A02], axis=-1),
        jnp.stack([A10, A11, A12], axis=-1),
        jnp.stack([A20, A21, A22], axis=-1),
    ], axis=-2)
    return adj * inv_det


def eq15_coefficients(centers: jnp.ndarray, depths: jnp.ndarray, z0: float,
                      fx: float, fy: float, cx: float, cy: float):
    """Per-(packet, plane) affine coefficients of Eq. (15) (cpp:176-182).

    Returns (a, bx, by, d) each of shape (K, Z).
    """
    C = centers  # (K, 3)
    zi = depths[None, :]  # (1, Z)
    a = z0 * (zi - C[:, 2:3])
    bx = (z0 - zi) * (C[:, 0:1] * fx + C[:, 2:3] * cx)
    by = (z0 - zi) * (C[:, 1:2] * fy + C[:, 2:3] * cy)
    d = zi * (z0 - C[:, 2:3])
    return a, bx, by, d


def bilinear_corners(xf: jnp.ndarray, yf: jnp.ndarray, width: int, height: int):
    """4-corner indices and weights of the reference splat
    (cartesian3dgrid.h:253-273).  Returns (idx4, w4) with idx flattened to
    y*W+x; out-of-bounds votes get weight 0 and index 0.
    """
    valid = (xf >= 0.0) & (yf >= 0.0)
    x0 = jnp.floor(xf).astype(jnp.int32)
    y0 = jnp.floor(yf).astype(jnp.int32)
    inb = valid & (x0 + 1 < width) & (y0 + 1 < height)
    fx = xf - x0.astype(xf.dtype)
    fy = yf - y0.astype(yf.dtype)
    w00 = (1 - fx) * (1 - fy)
    w10 = fx * (1 - fy)
    w01 = (1 - fx) * fy
    w11 = fx * fy
    x0c = jnp.where(inb, x0, 0)
    y0c = jnp.where(inb, y0, 0)
    base = y0c * width + x0c
    idx4 = jnp.stack([base, base + 1, base + width, base + width + 1], axis=-1)
    w4 = jnp.stack([w00, w10, w01, w11], axis=-1)
    w4 = jnp.where(inb[..., None], w4, 0.0)
    return idx4, w4


# ---------------------------------------------------------------------------
# Splat backends
# ---------------------------------------------------------------------------


def _vote_plane_block_scatter(xy, pw, a, bx, by, d, width, height):
    """Vote a block of planes by flat scatter-add.

    xy: (E, 2) z0 locations (packets flattened); pw: (E,) per-event weight
    (0 for invalid packets); a, bx, by, d: (ZB, E) broadcast coefficients.
    Returns (ZB, H, W).
    """
    ZB = a.shape[0]
    X = (xy[None, :, 0] * a + bx) / d
    Y = (xy[None, :, 1] * a + by) / d
    idx4, w4 = bilinear_corners(X, Y, width, height)   # (ZB, E, 4)
    w4 = w4 * pw[None, :, None]
    plane_offset = (jnp.arange(ZB, dtype=jnp.int32) * (width * height))[:, None, None]
    flat_idx = (idx4 + plane_offset).reshape(-1)
    flat_w = w4.reshape(-1)
    out = jnp.zeros((ZB * height * width,), dtype=jnp.float32)
    out = out.at[flat_idx].add(flat_w)
    return out.reshape(ZB, height, width)


def splat_scatter(
    packets: WarpedPackets,
    depths: jnp.ndarray,
    z0: float,
    vcam_params: Tuple[float, float, float, float],
    width: int,
    height: int,
    plane_block: int = 8,
) -> jnp.ndarray:
    """XLA scatter-add backend: correct everywhere, the portability baseline.

    Scans over blocks of depth planes (the reference's OpenMP axis,
    cpp:166-172) to bound the (ZB, E, 4) index tensor in memory.
    """
    fx, fy, cx, cy = vcam_params
    K, P, _ = packets.xy_z0.shape
    E = K * P
    xy = packets.xy_z0.reshape(E, 2)
    pw = packets.event_weights()
    coeffs = _blocked_coefficients(packets.centers, depths, z0,
                                   (fx, fy, cx, cy), plane_block)
    Z = depths.shape[0]

    def block(c):
        ab, bxb, byb, db = (jnp.repeat(v, P, axis=1) for v in c)  # (ZB, E)
        return _vote_plane_block_scatter(xy, pw, ab, bxb, byb, db, width, height)

    blocks = jax.lax.map(block, coeffs)
    return blocks.reshape(-1, height, width)[:Z]


def _blocked_coefficients(centers, depths, z0, vcam_params, plane_block):
    """Eq. 15 coefficients grouped into depth-plane blocks.

    Returns a 4-tuple of (nblocks, plane_block, K) arrays — mapped operands
    for the per-block voting loop (the reference's OpenMP axis, cpp:166-172).
    """
    fx, fy, cx, cy = vcam_params
    a, bx, by, d = eq15_coefficients(centers, depths, z0, fx, fy, cx, cy)
    Z = depths.shape[0]
    nblocks = -(-Z // plane_block)
    padz = nblocks * plane_block - Z

    def to_blocks(c):  # (K, Z) -> (nblocks, ZB, K)
        c = jnp.pad(c, ((0, 0), (0, padz)), constant_values=1.0)
        return c.T.reshape(nblocks, plane_block, -1)

    return to_blocks(a), to_blocks(bx), to_blocks(by), to_blocks(d)


def splat_sort(
    packets: WarpedPackets,
    depths: jnp.ndarray,
    z0: float,
    vcam_params: Tuple[float, float, float, float],
    width: int,
    height: int,
    plane_block: int = 8,
) -> jnp.ndarray:
    """Sort + segment-sum backend.

    Per plane block: sort the flat voxel indices of all 4-corner votes, apply
    a segmented reduction, and write unique sorted results with a scatter the
    compiler can vectorize: one write per touched voxel instead of one
    atomic add per vote.
    """
    fx, fy, cx, cy = vcam_params
    K, P, _ = packets.xy_z0.shape
    E = K * P
    xy = packets.xy_z0.reshape(E, 2)
    pw = packets.event_weights()
    coeffs = _blocked_coefficients(packets.centers, depths, z0,
                                   (fx, fy, cx, cy), plane_block)
    Z = depths.shape[0]

    def block(c):
        ab, bxb, byb, db = (jnp.repeat(v, P, axis=1) for v in c)  # (ZB, E)
        X = (xy[None, :, 0] * ab + bxb) / db
        Y = (xy[None, :, 1] * ab + byb) / db
        idx4, w4 = bilinear_corners(X, Y, width, height)
        w4 = w4 * pw[None, :, None]
        ZB = ab.shape[0]
        plane_offset = (jnp.arange(ZB, dtype=jnp.int32) * (width * height))[:, None, None]
        flat_idx = (idx4 + plane_offset).reshape(-1)
        flat_w = w4.reshape(-1)
        order = jnp.argsort(flat_idx)
        sidx = flat_idx[order]
        sw = flat_w[order]
        # Segmented sum over runs of equal indices.  Weights are >= 0 so the
        # inclusive cumsum is monotone; the cumsum value just before each
        # run's start can therefore be forward-filled with a running max.
        csum = jnp.cumsum(sw)
        prev_csum = jnp.concatenate([jnp.zeros(1, sw.dtype), csum[:-1]])
        run_start = jnp.concatenate([jnp.array([True]), sidx[1:] != sidx[:-1]])
        is_last = jnp.concatenate([sidx[1:] != sidx[:-1], jnp.array([True])])
        base = jax.lax.cummax(jnp.where(run_start, prev_csum, 0.0))
        run_total = csum - base
        # One scatter with unique live positions (one per run); dead lanes are
        # routed out of range and dropped.
        pos = jnp.where(is_last, sidx, ZB * height * width)
        out = jnp.zeros((ZB * height * width,), dtype=jnp.float32)
        out = out.at[pos].add(jnp.where(is_last, run_total, 0.0), mode="drop")
        return out.reshape(ZB, height, width)

    blocks = jax.lax.map(block, coeffs)
    return blocks.reshape(-1, height, width)[:Z]


SPLAT_BACKENDS = {
    "scatter": splat_scatter,
    "sort": splat_sort,
}


def _register_hist_backend():
    # Deferred import: voting_hist imports WarpedPackets from this module.
    from . import voting_hist

    SPLAT_BACKENDS["hist"] = voting_hist.make_hist_backend(group_size=16)
    SPLAT_BACKENDS["hist_exact"] = voting_hist.make_hist_backend(
        group_size=1, supersample=2)


_register_hist_backend()


@functools.lru_cache(maxsize=None)
def resolve_backend(spec: str):
    """Resolve a backend spec string to a splat callable.

    Plain names index SPLAT_BACKENDS ("scatter", "sort", "hist",
    "hist_exact").  The hist backend takes knobs after a colon:
    "hist:g8" (group_size), "hist:g8,ss2" (supersample),
    "hist:g8,px96,py16" (padding), "hist:g8,nocorr" (disable the sweep
    correction), "hist:g8,f32" (f32 matmuls).  Specs are strings so they
    stay hashable static jit arguments.
    """
    name, _, args = spec.partition(":")
    if not args:
        return SPLAT_BACKENDS[name]
    if name != "hist":
        raise ValueError(f"backend {name!r} takes no {args!r} options")
    from . import voting_hist

    kw = {}
    for tok in args.split(","):
        if tok.startswith("seg"):
            kw["segments"] = int(tok[3:])
        elif tok.startswith("ss"):
            kw["supersample"] = int(tok[2:])
        elif tok.startswith("g"):
            kw["group_size"] = int(tok[1:])
        elif tok.startswith("px"):
            kw["pad_x"] = int(tok[2:])
        elif tok.startswith("py"):
            kw["pad_y"] = int(tok[2:])
        elif tok == "nocorr":
            kw["correct"] = False
        elif tok == "f32":
            kw["dtype"] = jnp.float32
        elif tok == "i8":
            kw["bin_dtype"] = jnp.int8
        else:
            raise ValueError(f"unknown hist option {tok!r} in {spec!r}")
    return voting_hist.make_hist_backend(**kw)


def vote_dsi(
    packets: WarpedPackets,
    depths: jnp.ndarray,
    vcam: PinholeCamera,
    backend: str = "scatter",
    plane_block: int = 8,
) -> jnp.ndarray:
    """Step 3: vote all packets into a fresh (Z, H, W) DSI."""
    z0 = float(np.asarray(depths)[0])
    fn = resolve_backend(backend)
    return fn(
        packets,
        jnp.asarray(depths, dtype=jnp.float32),
        z0,
        (float(vcam.fx), float(vcam.fy), float(vcam.cx), float(vcam.cy)),
        vcam.width,
        vcam.height,
        plane_block=plane_block,
    )
