"""Histogram + separable affine-resample voting backend — a scatter-free
formulation of the DSI hot kernel.

The reference's `fillVoxelGrid` (mapper_emvs_stereo/src/mapper_emvs_stereo.cpp:
151-205) splats every event bilinearly into every depth plane: O(E x Z)
random scatter-adds.  This backend restructures the same math into dense
matrix products:

1. Eq. (15) (cpp:176-194) maps an event's z0-plane location to plane zi by a
   per-packet AFFINE transform whose coefficients depend on the packet only
   through its camera center C.  Neighboring packets have nearly identical
   centers (the rig moves ~mm between 1024-event packets), so packets are
   grouped into super-packets sharing one C — the same kind of controlled
   approximation as the reference's own 1024-event pose sharing (cpp:88-91),
   exposed as `group_size` (1 = exact per-packet coefficients).

2. Binning a group's events into a dense z0 histogram is a ONE-HOT MATMUL:
   hist[q, p] = sum_e w_e hat(q - hy_e) hat(p - hx_e) = (w * Ay)^T @ Ax with
   hat the width-1 triangle (bilinear) kernel — two tall-skinny matrices
   contracted over events, zero scatter.

3. Voting one plane = resampling that histogram under a separable affine map
   with scale ~= 1 (scale = z0(zi-Cz)/(zi(z0-Cz)) -> 1 for |Cz| << depths):
   two more banded-matrix matmuls, DSI[zi] += Ry^T @ hist @ Cx, where
   Ry[q, v] = hat(q*sy + ty - v), Cx[p, u] = hat(p*sx + tx - u).

All contractions run in bf16 with f32 accumulation by default; vote
magnitudes are preserved to ~0.4% — far below vote-count noise.  The `f32`
option runs them on f32 operands at HIGHEST precision (no TF32 rounding).

The composition of the two triangle kernels (event->bin, bin->plane) widens
the effective splat from width-1 to width-2; `supersample=2` bins on a finer
grid to tighten it back toward the reference kernel.

Border semantics diverge deliberately: the reference drops an event's entire
4-corner vote when the +1 neighbor is out of bounds (cartesian3dgrid.h:
258-262); here partial taps at the image edge are kept.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .voting import WarpedPackets


def _dot(a, b, dimension_numbers, dtype):
    """`dot_general` on operands cast to `dtype`, accumulated in f32.
    f32 operands ask for HIGHEST precision so a GPU does not round them to
    TF32; bf16 operands are the deliberate low-precision path."""
    prec = jax.lax.Precision.HIGHEST if dtype == jnp.float32 else None
    return jax.lax.dot_general(
        a.astype(dtype), b.astype(dtype), dimension_numbers=dimension_numbers,
        precision=prec, preferred_element_type=jnp.float32)


def _group_centers(packets: WarpedPackets, group_size: int):
    """Mean camera center over each super-packet's valid packets."""
    K = packets.centers.shape[0]
    G = -(-K // group_size)
    pad_k = G * group_size - K
    vb = packets.valid.astype(jnp.float32)
    cent = jnp.pad(packets.centers, ((0, pad_k), (0, 0)))
    vbp = jnp.pad(vb, (0, pad_k))
    cg = cent.reshape(G, group_size, 3)
    wg = vbp.reshape(G, group_size)
    denom = jnp.maximum(jnp.sum(wg, axis=1, keepdims=True), 1.0)
    return jnp.sum(cg * wg[..., None], axis=1) / denom


def _sweep_correction(xy, centers_k, centers_g, group_size, z0,
                      fx, fy, cx, cy, u_mid):
    """Per-event coordinate shift cancelling the packet-vs-group map error
    to first order in inverse depth.

    Eq. (15)'s affine coefficients are exactly linear in u = 1/zi:
    scale s(u) = alpha_s + beta_s*u with alpha_s = z0/(z0-Cz),
    beta_s = -z0*Cz/(z0-Cz); translation t(u) = alpha_t + beta_t*u with
    kappa = Cx*fx + Cz*cx, alpha_t = -kappa/(z0-Cz),
    beta_t = kappa*z0/(z0-Cz).  Binning an event at X + delta instead of X
    changes its group-map image by delta*s_g(u); choosing
    delta = (A + B*u_mid)/s_g(u_mid) with A/B the constant/slope parts of
    the per-packet-vs-group error zeroes the error at the sweep midpoint
    and minimaxes it over [u_min, u_max] — the residual is a u-odd spread
    (lateral blur), not a depth-correlated bias.  This is what lets
    `group_size` be large without tilting the vote rays.
    """
    K = centers_k.shape[0]

    def coeffs(C):
        Cz = C[:, 2]
        den = z0 - Cz
        a_s = z0 / den
        b_s = -z0 * Cz / den
        kx = C[:, 0] * fx + Cz * cx
        ky = C[:, 1] * fy + Cz * cy
        return (a_s, b_s, -kx / den, kx * z0 / den, -ky / den, ky * z0 / den)

    a_s_k, b_s_k, a_tx_k, b_tx_k, a_ty_k, b_ty_k = coeffs(centers_k)
    a_s_g, b_s_g, a_tx_g, b_tx_g, a_ty_g, b_ty_g = coeffs(centers_g)
    rep = lambda c: jnp.repeat(c, group_size)[:K]
    d_as = a_s_k - rep(a_s_g)
    d_bs = b_s_k - rep(b_s_g)
    s_mid = rep(a_s_g + b_s_g * u_mid)       # (K,), ~= 1

    X, Y = xy[..., 0], xy[..., 1]            # (K, P)
    ax = X * d_as[:, None] + (a_tx_k - rep(a_tx_g))[:, None]
    bx = X * d_bs[:, None] + (b_tx_k - rep(b_tx_g))[:, None]
    ay = Y * d_as[:, None] + (a_ty_k - rep(a_ty_g))[:, None]
    by = Y * d_bs[:, None] + (b_ty_k - rep(b_ty_g))[:, None]
    dx = (ax + bx * u_mid) / s_mid[:, None]
    dy = (ay + by * u_mid) / s_mid[:, None]
    return dx, dy


def bin_events(hx, hy, w, hs: int, ws: int, dtype=jnp.bfloat16):
    """Bilinear histograms of event bin coordinates, one per group.

    hx, hy, w: (G, E) bin coordinates (clipped to the grid) and weights.
    Returns (G, hs, ws) float32: hist[g, q, p] = sum_e w hat(q - hy)
    hat(p - hx), as the one-hot matmul (w * Ay)^T @ Ax.  `dtype` int8 takes
    the quantized path: taps in 1/127 steps, exact int32 accumulation (max
    bin sum E*127^2 < 2^31), one rescale at the end."""
    rows = jnp.arange(hs, dtype=jnp.float32)
    cols = jnp.arange(ws, dtype=jnp.float32)
    contract_events = (((0,), (0,)), ((), ()))

    def one_group(args):
        hxg, hyg, wg = args
        ay = jnp.maximum(0.0, 1.0 - jnp.abs(hyg[:, None] - rows[None, :]))
        ax = jnp.maximum(0.0, 1.0 - jnp.abs(hxg[:, None] - cols[None, :]))
        ay = ay * wg[:, None]
        if dtype == jnp.int8:
            ayq = jnp.round(ay * 127.0).astype(jnp.int8)
            axq = jnp.round(ax * 127.0).astype(jnp.int8)
            acc = jax.lax.dot_general(
                ayq, axq, dimension_numbers=contract_events,
                preferred_element_type=jnp.int32)
            return acc.astype(jnp.float32) * (1.0 / (127.0 * 127.0))
        return _dot(ay, ax, contract_events, dtype)

    return jax.lax.map(one_group, (hx, hy, w))


def build_group_histograms(
    packets: WarpedPackets,
    group_size: int,
    hs: int,
    ws: int,
    pad_x: int,
    pad_y: int,
    ss: int,
    dtype=jnp.bfloat16,
    correction: Optional[Tuple[float, float, float, float, float, float]] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Bilinear-bin each super-packet's z0 locations by one-hot matmul.

    `correction` = (z0, fx, fy, cx, cy, u_mid) enables the first-order
    sweep correction (see `_sweep_correction`).  Returns (hist (G, hs, ws)
    float32, centers (G, 3)).
    """
    K, P, _ = packets.xy_z0.shape
    G = -(-K // group_size)
    Kp = G * group_size
    Eg = group_size * P

    centers = _group_centers(packets, group_size)

    pw = packets.event_weights().reshape(K, P)
    xy = packets.xy_z0
    if correction is not None:
        z0c, fx, fy, cx, cy, u_mid = correction
        dx, dy = _sweep_correction(
            xy, packets.centers, centers, group_size, z0c, fx, fy, cx, cy, u_mid)
        xy = jnp.stack([xy[..., 0] + dx, xy[..., 1] + dy], axis=-1)

    pad_k = Kp - K
    xy = jnp.pad(xy, ((0, pad_k), (0, 0), (0, 0)))
    w = jnp.pad(pw, ((0, pad_k), (0, 0)))

    hx = ((xy[..., 0] + pad_x) * ss).reshape(G, Eg)
    hy = ((xy[..., 1] + pad_y) * ss).reshape(G, Eg)
    w = w.reshape(G, Eg)
    # Drop events whose z0 location falls outside even the padded grid.
    inb = (hx >= 0) & (hx <= ws - 1) & (hy >= 0) & (hy <= hs - 1)
    w = jnp.where(inb, w, 0.0)
    hx = jnp.clip(hx, 0.0, ws - 1)
    hy = jnp.clip(hy, 0.0, hs - 1)
    return bin_events(hx, hy, w, hs, ws, dtype), centers


def _sweep_scale_trans(centers, u, z0, fx, fy, cx, cy):
    """Eq. (15) as scale/translation in inverse depth u = 1/zi.

    X' = s(u) * X + tx(u) (y alike) with s = z0*(1 - Cz*u)/(z0 - Cz),
    tx = (z0*u - 1) * (Cx*fx + Cz*cx)/(z0 - Cz).  centers (N, 3), u (M,).
    Returns s, tx, ty each (N, M).
    """
    C = centers
    den = (z0 - C[:, 2])[:, None]               # (N, 1)
    s = z0 * (1.0 - C[:, 2:3] * u[None, :]) / den
    kx = (C[:, 0] * fx + C[:, 2] * cx)[:, None]
    ky = (C[:, 1] * fy + C[:, 2] * cy)[:, None]
    t_common = (z0 * u[None, :] - 1.0) / den
    return s, kx * t_common, ky * t_common


def _resample_hist_affine(hist, s_y, t_y, s_x, t_x, dtype=jnp.bfloat16):
    """Push-forward resample of histograms under per-item separable affine
    maps in BIN coordinates: mass at bin (q, p) splats bilinearly to
    (q*s_y + t_y, p*s_x + t_x).  hist (N, hs, ws); s/t scalars per item.
    Mass-conserving for maps that stay inside the grid (same convention as
    the sweep's banded resample matrices, `resample_sum`)."""
    N, hs, ws = hist.shape
    qrow = jnp.arange(hs, dtype=jnp.float32)
    prow = jnp.arange(ws, dtype=jnp.float32)

    def one(args):
        h, sy, ty, sx, tx = args
        ry = jnp.maximum(0.0, 1.0 - jnp.abs(
            (qrow[:, None] * sy + ty) - qrow[None, :]))   # (q, q')
        cxm = jnp.maximum(0.0, 1.0 - jnp.abs(
            (prow[:, None] * sx + tx) - prow[None, :]))   # (p, p')
        tmp = _dot(ry, h, (((0,), (0,)), ((), ())), dtype)      # (q', ws)
        return _dot(tmp, cxm, (((1,), (0,)), ((), ())), dtype)  # (q', p')

    return jax.lax.map(one, (hist, s_y, t_y, s_x, t_x))


def _frame_change_maps(centers_src, centers_tgt, u_mid, z0, vcam_params,
                       pad_x, pad_y, ss):
    """Bin-coordinate affine maps m = sweep_tgt(u_mid)^-1 o sweep_src(u_mid)
    taking a histogram built in `centers_src`'s sweep frame into
    `centers_tgt`'s, exact at inverse depth u_mid (first-order across a
    segment).  centers_* (N, 3); returns (s, ty, tx) each (N,)."""
    fx, fy, cx, cy = vcam_params
    u = jnp.atleast_1d(jnp.asarray(u_mid, jnp.float32))
    s_l, tx_l, ty_l = _sweep_scale_trans(centers_src, u, z0, fx, fy, cx, cy)
    s_p, tx_p, ty_p = _sweep_scale_trans(centers_tgt, u, z0, fx, fy, cx, cy)
    m_s = (s_l / s_p)[:, 0]
    m_tx = ((tx_l - tx_p) / s_p)[:, 0]
    m_ty = ((ty_l - ty_p) / s_p)[:, 0]
    bt_x = ss * (m_tx + pad_x * (1.0 - m_s))
    bt_y = ss * (m_ty + pad_y * (1.0 - m_s))
    return m_s, bt_y, bt_x


def merge_leaf_histograms(
    hist: jnp.ndarray,
    centers: jnp.ndarray,
    merge: int,
    u_mid,
    z0: float,
    vcam_params,
    pad_x: int,
    pad_y: int,
    ss: int,
    dtype=jnp.bfloat16,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Merge groups of `merge` leaf histograms into supergroup histograms.

    Each leaf is resampled from its own sweep frame into the supergroup
    center's frame so that at u = u_mid the supergroup map exactly
    reproduces the leaf map (first-order-in-u accurate across a segment —
    the histogram-level analog of `_sweep_correction`).  Returns
    (hist_super (G/merge, hs, ws), centers_super (G/merge, 3)).
    """
    G = hist.shape[0]
    P = -(-G // merge)
    pad_g = P * merge - G
    if pad_g:
        hist = jnp.pad(hist, ((0, pad_g), (0, 0), (0, 0)))
        centers = jnp.concatenate(
            [centers, jnp.broadcast_to(centers[-1:], (pad_g, 3))])
    centers_super = jnp.mean(centers.reshape(P, merge, 3), axis=1)
    m_s, bt_y, bt_x = _frame_change_maps(
        centers, jnp.repeat(centers_super, merge, axis=0), u_mid, z0,
        vcam_params, pad_x, pad_y, ss)
    res = _resample_hist_affine(hist, m_s, bt_y, m_s, bt_x, dtype=dtype)
    return jnp.sum(res.reshape(P, merge, *res.shape[1:]), axis=1), centers_super


def segment_bounds_equal_u(depths: np.ndarray, segments: int) -> Tuple[int, ...]:
    """Plane-index boundaries splitting the sweep into `segments` chunks of
    approximately equal inverse-depth span.  Host-side (static) helper for
    the `segments` mode; returns a (segments+1)-tuple of indices."""
    d = np.asarray(depths, np.float64)
    u = 1.0 / d
    # Edges walk the sweep in PLANE order (u[0] -> u[-1]), so the same
    # search works for ascending-depth (descending-u, the standard case)
    # and descending-depth sweeps: boundary k is the first plane past the
    # k-th equal-u edge along the sweep direction.
    targets = np.linspace(u[0], u[-1], segments + 1)
    sign = 1.0 if u[-1] >= u[0] else -1.0
    idx = [0]
    for k in range(1, segments):
        pos = int(np.searchsorted(sign * u, sign * targets[k]))
        idx.append(int(np.clip(pos, idx[-1] + 1, len(u) - (segments - k))))
    idx.append(len(u))
    return tuple(idx)


def _affine_coeffs(centers, depths, z0, fx, fy, cx, cy, pad_x, pad_y, ss):
    """Per (group, plane) separable affine map from histogram-bin index to
    output pixel: x_out = p * sx + tx (and y alike).

    Derived from Eq. (15): X' = (X*a + bx)/d with bin p at X = p/ss - pad_x.
    """
    C = centers                      # (G, 3)
    zi = depths[None, :]             # (1, Z)
    a = z0 * (zi - C[:, 2:3])        # (G, Z)
    bx = (z0 - zi) * (C[:, 0:1] * fx + C[:, 2:3] * cx)
    by = (z0 - zi) * (C[:, 1:2] * fy + C[:, 2:3] * cy)
    d = zi * (z0 - C[:, 2:3])
    d = jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
    sx = a / (d * ss)
    tx = (bx - pad_x * a) / d
    sy = a / (d * ss)
    ty = (by - pad_y * a) / d
    return sx, tx, sy, ty


def splat_hist(
    packets: WarpedPackets,
    depths: jnp.ndarray,
    z0: float,
    vcam_params: Tuple[float, float, float, float],
    width: int,
    height: int,
    plane_block: int = 8,
    group_size: int = 32,
    supersample: int = 1,
    pad_x: int = 128,
    pad_y: int = 32,
    dtype=jnp.bfloat16,
    correct: bool = True,
    segments: int = 1,
    seg_bounds: Optional[Tuple[int, ...]] = None,
    bin_dtype=None,
    corr_u_mid=None,
) -> jnp.ndarray:
    """Vote all packets into a (Z, H, W) DSI by histogram + affine resample.

    `group_size` packets share one camera center (1 = per-packet exact);
    `pad_x`/`pad_y` extend the z0 grid so events whose z0 location is out of
    frame still vote on planes where they land in frame (the disparity sweep
    reaches ~f*baseline/min_depth pixels); `supersample` refines the bin
    grid to tighten the effective splat kernel; `dtype` is the matmul input
    precision (f32 accumulation either way).

    `segments` > 1 splits the inverse-depth sweep into that many chunks
    (boundaries `seg_bounds`, a static index tuple — equal plane counts if
    None; use `segment_bounds_equal_u` for equal-u chunks).  Within a chunk
    the map varies `segments`x less, so `segments`x more packets can share a
    camera center at the same accuracy: leaf histograms at `group_size` are
    merged into supergroups of `segments` leaves per chunk
    (`merge_leaf_histograms`), cutting the per-plane resample work from
    G x Z to ~G x Z / segments + G x segments merges.  This is a flat
    two-level version of the fast-slant-stack butterfly.
    """
    fx, fy, cx, cy = vcam_params
    ss = supersample
    hs = (height + 2 * pad_y) * ss
    ws = (width + 2 * pad_x) * ss
    Z = depths.shape[0]

    u_all = 1.0 / jnp.asarray(depths)
    # `corr_u_mid` overrides the correction midpoint — plane-sharded runs
    # pass the GLOBAL sweep midpoint so every shard bins identically and
    # the sharded DSI matches the single-device one bit-near.
    u_mid = 0.5 * (jnp.min(u_all) + jnp.max(u_all)) \
        if corr_u_mid is None else corr_u_mid
    corr = (z0, fx, fy, cx, cy, u_mid) if correct else None
    hist, centers = build_group_histograms(
        packets, group_size, hs, ws, pad_x, pad_y, ss,
        dtype=bin_dtype if bin_dtype is not None else dtype,
        correction=corr)
    hist = hist.astype(dtype)

    # Plane-sharded runs sweep small z-blocks: clamp the segment count to
    # the planes actually present.
    if segments > 1 and min(segments, Z) != segments:
        segments, seg_bounds = min(segments, Z), None
    if segments <= 1:
        return _sweep_planes(hist, centers, depths, z0, vcam_params, width,
                             height, pad_x, pad_y, ss, plane_block, dtype)

    if seg_bounds is None:
        bounds = [round(s * Z / segments) for s in range(segments + 1)]
    else:
        bounds = list(seg_bounds)
    parts = []
    for s in range(segments):
        i0, i1 = bounds[s], bounds[s + 1]
        if i0 >= i1:
            continue
        dseg = depths[i0:i1]
        useg = 1.0 / dseg
        u_mid_s = 0.5 * (jnp.min(useg) + jnp.max(useg))
        hist_s, centers_s = merge_leaf_histograms(
            hist, centers, segments, u_mid_s, z0, vcam_params,
            pad_x, pad_y, ss, dtype=dtype)
        parts.append(_sweep_planes(
            hist_s.astype(dtype), centers_s, dseg, z0, vcam_params,
            width, height, pad_x, pad_y, ss,
            min(plane_block, i1 - i0), dtype))
    return jnp.concatenate(parts, axis=0)


def resample_sum(hist, sy, ty, sx, tx, out_h: int, out_w: int,
                 dtype=jnp.bfloat16):
    """Banded affine resample of G histograms onto N output planes, summed
    over the histograms: out[n] = sum_g Ry[g, n]^T @ hist[g] @ Cx[g, n] with
    Ry[q, v] = hat(q*sy + ty - v), Cx[p, u] = hat(p*sx + tx - u).

    hist (G, hs, ws); sy, ty, sx, tx (G, N).  Returns (N, out_h, out_w)
    float32.  The groups are scanned, so only one group's (N, hs, out_h)
    and (N, ws, out_w) band matrices are live at a time."""
    G, hs, ws = hist.shape
    N = sy.shape[1]
    vout = jnp.arange(out_h, dtype=jnp.float32)
    uout = jnp.arange(out_w, dtype=jnp.float32)
    qrow = jnp.arange(hs, dtype=jnp.float32)
    prow = jnp.arange(ws, dtype=jnp.float32)

    def one_group(acc, g):
        y_map = qrow[None, :, None] * sy[g][:, None, None] + ty[g][:, None, None]
        ry = jnp.maximum(0.0, 1.0 - jnp.abs(y_map - vout[None, None, :]))
        x_map = prow[None, :, None] * sx[g][:, None, None] + tx[g][:, None, None]
        cxm = jnp.maximum(0.0, 1.0 - jnp.abs(x_map - uout[None, None, :]))
        resy = _dot(ry, hist[g], (((1,), (0,)), ((), ())), dtype)  # (N, H, ws)
        contrib = _dot(resy, cxm, (((2,), (1,)), ((0,), (0,))), dtype)
        return acc + contrib, None

    acc0 = jnp.zeros((N, out_h, out_w), jnp.float32)
    acc, _ = jax.lax.scan(one_group, acc0, jnp.arange(G))
    return acc


def _sweep_planes(hist, centers, depths, z0, vcam_params, width, height,
                  pad_x, pad_y, ss, plane_block, dtype):
    """Per-plane banded affine resample + sum over groups (step 3 of the
    module docstring), `plane_block` planes at a time."""
    fx, fy, cx, cy = vcam_params
    Z = depths.shape[0]
    G = hist.shape[0]
    sx, tx, sy, ty = _affine_coeffs(
        centers, depths, z0, fx, fy, cx, cy, pad_x, pad_y, ss)

    nblocks = -(-Z // plane_block)
    padz = nblocks * plane_block - Z

    def to_blocks(c):  # (G, Z) -> (nblocks, G, ZB)
        c = jnp.pad(c, ((0, 0), (0, padz)), constant_values=1.0)
        return jnp.moveaxis(c.reshape(G, nblocks, plane_block), 1, 0)

    def one_block(args):
        sxg, txg, syg, tyg = args   # each (G, ZB)
        return resample_sum(hist, syg, tyg, sxg, txg, height, width, dtype)

    blocks = jax.lax.map(one_block,
                         tuple(to_blocks(c) for c in (sx, tx, sy, ty)))
    return blocks.reshape(-1, height, width)[:Z]


def auto_group_size(
    travel_m: float,
    num_packets: int,
    fx: float,
    min_depth: float,
    max_depth: float,
    tol_px: float = 1.0,
    corrected: bool = True,
) -> int:
    """Largest power-of-two packet grouping keeping the grouping error under
    `tol_px` at the depth-sweep extremes.

    Vote-position sensitivity to camera-center error is
    |dX'/dC| ~ fx * (1/min_depth - 1/max_depth); a group spanning
    `spread` metres of camera travel displaces votes by up to
    spread/2 * sensitivity (halved again by the first-order sweep
    correction).  Powers of two bound jit recompiles across chunks.
    """
    if num_packets <= 1 or travel_m <= 0:
        return max(1, num_packets)
    sens = fx * abs(1.0 / min_depth - 1.0 / max_depth)
    corr_gain = 4.0 if corrected else 2.0
    spread_tol = corr_gain * tol_px / max(sens, 1e-9)
    per_packet = travel_m / num_packets
    g = max(1, int(spread_tol / max(per_packet, 1e-12)))
    return 1 << min(int(g).bit_length() - 1, 10)


def auto_backend_spec(
    chunk_travel_m: float,
    n_packets: int,
    fx: float,
    min_depth: float,
    max_depth: float,
    dim_z: int,
) -> str:
    """The production backend spec the CLI auto-selects (one definition so
    the CLI, the benchmark, and the golden accuracy gates all exercise the
    same path): histogram voting with a travel-bounded group size, 2x
    supersampling, and an inverse-depth-segmented sweep when there are
    enough planes to amortize the leaf merges."""
    g = auto_group_size(chunk_travel_m, n_packets, fx, min_depth, max_depth)
    spec = f"hist:g{g},ss2"
    segs = min(16, dim_z // 10)
    if segs >= 2:
        spec += f",seg{segs}"
    return spec


def make_hist_backend(group_size: int = 32, supersample: int = 1,
                      pad_x: int = 128, pad_y: int = 32,
                      dtype=jnp.bfloat16, correct: bool = True,
                      segments: int = 1,
                      seg_bounds: Optional[Tuple[int, ...]] = None,
                      bin_dtype=None):
    """A SPLAT_BACKENDS-compatible callable with fixed histogram knobs."""
    return functools.partial(
        splat_hist, group_size=group_size, supersample=supersample,
        pad_x=pad_x, pad_y=pad_y, dtype=dtype, correct=correct,
        segments=segments, seg_bounds=seg_bounds, bin_dtype=bin_dtype)
