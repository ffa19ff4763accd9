"""Depth-map extraction from a DSI: collapse, threshold, filter, densify.

Port of `MapperEMVS::getDepthMapFromDSI` (src/mapper_emvs_stereo.cpp:332-437)
and the masked Huang median filter (src/median_filtering.cpp:7-158) as fused
device computation.  The O(p) serpentine histogram walk of the reference
becomes a data-parallel binary search over intensity using box-filter counts
— identical outputs (lower-median over masked neighbors), but H*W-parallel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import grid as gridops
from .depth_vector import DepthVector


@dataclasses.dataclass(frozen=True)
class DepthMapOptions:
    """Mirrors EMVS::OptionsDepthMap (mapper_emvs_stereo.hpp:68-81)."""

    adaptive_threshold_kernel_size: int = 5
    adaptive_threshold_c: float = 5.0
    median_filter_size: int = 5
    full_sequence: bool = False
    save_conf_stats: bool = False
    max_confidence: float = 0.0
    rv_pos: float = 0.0
    collapse_method: int = -1  # -1 = argmax of votes; 0-4 = focus measures


class DepthMapResult(NamedTuple):
    depth: jnp.ndarray        # (H, W) float32 metric depth (semi-dense values)
    confidence: jnp.ndarray   # (H, W) float32 raw vote confidence
    mask: jnp.ndarray         # (H, W) uint8 semi-dense support
    depth_dense: Optional[jnp.ndarray]  # inpainted dense depth (None on-device)
    depth_indices: jnp.ndarray  # (H, W) int32 filtered depth cell indices


# ---------------------------------------------------------------------------
# Confidence normalization with the reference's max_confidence pinning
# ---------------------------------------------------------------------------


def normalize_confidence(
    confidence: jnp.ndarray, max_confidence: float = 0.0
) -> jnp.ndarray:
    """Min-max normalize to [0, 255] and quantize to uint8-valued floats.

    Reproduces the (0,0)-pixel pinning hack (cpp:392-397): when
    `max_confidence > 0`, pixel (0,0) is overwritten with it before computing
    the min-max range (fixing the normalization across chunks), then zeroed.
    Rounding matches cv::Mat::convertTo (round-half-to-even).
    """
    conf = confidence
    if max_confidence > 0:
        conf = conf.at[0, 0].set(max_confidence)
    else:
        # cv::normalize still includes (0,0) in the range; value unchanged.
        pass
    cmin = jnp.min(conf)
    cmax = jnp.max(conf)
    scale = 255.0 / jnp.maximum(cmax - cmin, 1e-30)
    norm = (conf - cmin) * scale
    norm = norm.at[0, 0].set(0.0)
    # saturate_cast<uchar>(float) rounds half to even (cvRound).
    q = jnp.clip(jnp.round(norm), 0.0, 255.0)
    return q


# ---------------------------------------------------------------------------
# Adaptive Gaussian threshold (cv::adaptiveThreshold, cpp:403-409)
# ---------------------------------------------------------------------------


def adaptive_threshold_mask(
    conf_u8: jnp.ndarray, kernel_size: int, c: float
) -> jnp.ndarray:
    """mask = conf > local_gaussian_mean(conf) - C, with C = -c as the
    reference passes `-adaptive_threshold_c` (cpp:403-409), i.e. the
    effective rule is conf > mean + c.

    OpenCV computes the Gaussian mean on the uint8 image and rounds it to
    uint8 before comparing; we blur the quantized confidence in float and
    round, matching cv semantics (GaussianBlur on 8U rounds to nearest even;
    borders replicate).  The comparison uses OpenCV's integer tabulation:
    dst = src > mean - C  <=>  src - mean + cvRound(C) > 0  with C rounded.
    """
    k1 = gridops.gaussian_kernel_1d(kernel_size, sigma=-1.0)
    mean = gridops.sep_conv2d_same(conf_u8, k1, k1, border="replicate")
    mean_u8 = jnp.round(mean)
    # cv builds tab[i] = (i > -cvRound(C_param)) with C_param = -c here; the
    # per-pixel rule is src > mean_u8 - cvRound(-c)  ==  src > mean_u8 + round(c)
    ci = jnp.round(jnp.asarray(-c))
    mask = conf_u8 > (mean_u8 - ci)
    return mask.astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Masked median filter (Huang histogram filter, median_filtering.cpp:7-158)
# ---------------------------------------------------------------------------


def _masked_median_bsearch(
    img: jnp.ndarray, mask: jnp.ndarray, patch_size: int, levels: int
) -> jnp.ndarray:
    """Huang's masked histogram median (median_filtering.cpp:7-158) as a
    data-parallel rank binary search: stack the patch_size^2 shifted
    neighbor planes (int16; masked-out neighbors get sentinel `levels`,
    out-of-image neighbors `levels+1`, matching get_value's bounds check),
    then per pixel binary-search the smallest value v with
    #\\{neighbors <= v\\} >= rank, rank = (n+1)//2 — the lower median.

    ceil(log2(levels)) passes of compare+add over a (p^2, H, W) int16 stack:
    elementwise work, ~25x less memory traffic than a one-hot
    (levels, H, W) f32 histogram + cumsum, exact-parity."""
    H, W = img.shape
    m = mask > 0
    v = jnp.clip(img.astype(jnp.int32), 0, levels - 1).astype(jnp.int16)
    v = jnp.where(m, v, jnp.int16(levels))          # masked-out sentinel
    p = patch_size // 2
    big = jnp.int16(levels + 1)                     # out-of-image sentinel
    planes = []
    for dy in range(-p, p + 1):
        for dx in range(-p, p + 1):
            s = jnp.full((H, W), big, jnp.int16)
            ys = slice(max(0, -dy), min(H, H - dy))
            xs = slice(max(0, -dx), min(W, W - dx))
            src_ys = slice(max(0, dy), min(H, H + dy))
            src_xs = slice(max(0, dx), min(W, W + dx))
            planes.append(s.at[ys, xs].set(v[src_ys, src_xs]))
    V = jnp.stack(planes)                            # (p^2, H, W) int16
    n = jnp.sum((V < levels).astype(jnp.int32), axis=0)
    rank = (n + 1) // 2
    lo = jnp.zeros((H, W), jnp.int32)
    hi = jnp.full((H, W), levels - 1, jnp.int32)
    for _ in range(int(np.ceil(np.log2(max(levels, 2))))):
        mid = (lo + hi) >> 1
        cnt = jnp.sum((V <= mid[None].astype(jnp.int16)).astype(jnp.int32),
                      axis=0)
        ge = cnt >= rank
        hi = jnp.where(ge, mid, hi)
        lo = jnp.where(ge, lo, mid + 1)
    return jnp.where(n > 0, lo, 0).astype(jnp.float32)


def masked_median_filter(
    img_u8: jnp.ndarray, mask: jnp.ndarray, patch_size: int,
    levels: Optional[int] = None,
) -> jnp.ndarray:
    """Masked lower-median over the (patch x patch) neighborhood.

    Matches huangMedianFilter exactly: only pixels with mask > 0 contribute;
    the median is the value at rank (n+1)/2 among the n masked neighbors
    (lower median, median_filtering.cpp:7-17); pixels with an empty masked
    neighborhood get 0.

    `levels` (= number of distinct integer values, e.g. dimZ for depth
    indices, 256 for u8 images) selects the fast path: the same 256-bin
    histogram idea as the reference's Huang filter, but as a data-parallel
    rank binary search over the shifted neighbor planes (log2(levels)
    compare+count passes — see _masked_median_bsearch).  Without `levels` (or > 256), falls
    back to gather + small sort per pixel — O(HW p^2 log p^2), still one
    fused device op, and exact for any float input.
    """
    if levels is not None and levels <= 256:
        return _masked_median_bsearch(img_u8, mask, patch_size, levels)
    H, W = img_u8.shape
    p = patch_size // 2
    m = (mask > 0)
    img = img_u8.astype(jnp.float32)
    # Out-of-image or unmasked neighbors get +inf so they sort to the end.
    big = jnp.float32(1e30)
    vals = []
    for dy in range(-p, p + 1):
        for dx in range(-p, p + 1):
            shifted = jnp.full((H, W), big)
            ys = slice(max(0, -dy), min(H, H - dy))
            xs = slice(max(0, -dx), min(W, W - dx))
            src_ys = slice(max(0, dy), min(H, H + dy))
            src_xs = slice(max(0, dx), min(W, W + dx))
            v = jnp.where(m[src_ys, src_xs], img[src_ys, src_xs], big)
            shifted = shifted.at[ys, xs].set(v)
            vals.append(shifted)
    stack = jnp.stack(vals, axis=-1)           # (H, W, p^2)
    srt = jnp.sort(stack, axis=-1)
    n = jnp.sum(stack < big, axis=-1)          # masked neighbor count
    middle = (n + 1) // 2                      # 1-based lower-median rank
    rank = jnp.maximum(middle - 1, 0)
    med = jnp.take_along_axis(srt, rank[..., None], axis=-1)[..., 0]
    return jnp.where(n > 0, med, 0.0)


def masked_median_filter_u8(img_u8, mask, patch_size, levels: int = 256):
    out = masked_median_filter(img_u8, mask, patch_size, levels=levels)
    return out.astype(jnp.int32)


# ---------------------------------------------------------------------------
# Border removal (cpp:314-329)
# ---------------------------------------------------------------------------


def remove_mask_boundary(mask: jnp.ndarray, border_size: int) -> jnp.ndarray:
    """Zero the mask where x <= b, x >= W-b, y <= b or y >= H-b (note the
    inclusive comparisons in removeMaskBoundary, cpp:316-329)."""
    H, W = mask.shape
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    keep = (xs > border_size) & (xs < W - border_size) & \
           (ys > border_size) & (ys < H - border_size)
    return jnp.where(keep, mask, 0).astype(mask.dtype)


# ---------------------------------------------------------------------------
# Full extraction chain
# ---------------------------------------------------------------------------


def extract_from_collapsed(
    confidence: jnp.ndarray,
    depth_indices: jnp.ndarray,
    depths: jnp.ndarray,
    options: DepthMapOptions,
    depth_vec: Optional[DepthVector] = None,
) -> DepthMapResult:
    """Extraction chain after the Z-collapse: confidence normalization,
    adaptive Gaussian threshold, masked median, border removal, index→depth
    (cpp:392-436).  Split out so the sharded path can collapse a
    plane-sharded DSI inside `shard_map` and reuse everything after.

    Pass `depth_vec` when available: the index→depth step then runs as
    closed-form arithmetic (DepthVector.depth_at_index) instead of an
    (H*W,)-sized gather from the small depth table."""
    conf_u8 = normalize_confidence(confidence, options.max_confidence)
    mask = adaptive_threshold_mask(
        conf_u8, options.adaptive_threshold_kernel_size, options.adaptive_threshold_c
    )

    # levels = plane count: depth indices are integers in [0, Z), so the
    # histogram median applies whenever Z fits the 256-bin Huang semantics;
    # larger dimZ falls back to the gather+sort path inside the filter.
    filtered_idx = masked_median_filter_u8(
        depth_indices.astype(jnp.float32), mask, options.median_filter_size,
        levels=int(depths.shape[0]),
    )

    border = max(options.adaptive_threshold_kernel_size // 2, 1)
    mask = remove_mask_boundary(mask, border)

    clipped = jnp.clip(filtered_idx, 0, depths.shape[0] - 1)
    if depth_vec is not None:
        depth = depth_vec.depth_at_index(clipped)
    else:
        depth = depths[clipped]

    return DepthMapResult(
        depth=depth,
        confidence=confidence,
        mask=mask,
        depth_dense=None,
        depth_indices=filtered_idx,
    )


def get_depth_map_from_dsi(
    dsi: jnp.ndarray,
    depth_vec: DepthVector,
    options: DepthMapOptions,
) -> DepthMapResult:
    """The jittable portion of getDepthMapFromDSI (cpp:332-437).

    Telea inpainting (the `depth_map_dense` output) is host-side post-
    processing; see `densify_host`.
    """
    confidence, depth_indices = gridops.collapse(dsi, options.collapse_method)
    depths = jnp.asarray(depth_vec.depths())
    return extract_from_collapsed(confidence, depth_indices, depths, options,
                                  depth_vec=depth_vec)


def densify_host(result: DepthMapResult, depth_vec: DepthVector) -> np.ndarray:
    """Telea inpainting of the filtered depth indices (cpp:429-432).

    Host-side (OpenCV), off the hot path; returns dense metric depth.

    The reference inpaints uint8 indices (its dimZ <= 256 storage artifact,
    main.cpp:156); this framework advertises no such cap (config.py dimZ
    note), so for dimZ > 256 the indices are inpainted as 32F — same Telea
    algorithm, no wraparound — and rounded back to cell indices.
    """
    idx_raw = np.asarray(result.depth_indices)
    mask = np.asarray(result.mask).astype(np.uint8)
    depths = depth_vec.depths()
    n_planes = len(depths)
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "the dense depth map (Telea inpainting) needs OpenCV (cv2); "
            "install it or run with --nosave_dense") from e
    inpaint_mask = (1 - mask).astype(np.uint8)
    if n_planes <= 256:
        # uint8 path: bit parity with the reference's 8U inpaint.
        inpainted = cv2.inpaint(idx_raw.astype(np.uint8), inpaint_mask, 3,
                                cv2.INPAINT_TELEA)
    else:
        inpainted = np.rint(cv2.inpaint(idx_raw.astype(np.float32),
                                        inpaint_mask, 3, cv2.INPAINT_TELEA))
    return depths[np.clip(inpainted.astype(np.int64), 0, n_planes - 1)]


def confidence_range_stats(confidence: jnp.ndarray):
    """Min/max over non-zero confidences (the save_conf_stats probe,
    cpp:378-388)."""
    nz = confidence > 0
    big = jnp.max(confidence)
    cmin = jnp.min(jnp.where(nz, confidence, big))
    cmax = jnp.max(jnp.where(nz, confidence, 0.0))
    return cmin, cmax
