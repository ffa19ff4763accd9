"""Output artifact writers — parity with the reference's savers.

Covers `saveDepthMaps` (reference: mapper_emvs_stereo/src/utils.cpp:22-120:
depth-points txt, negated-confidence PNG, dilated JET inverse-depth PNG),
`accumulateEvents` previews (utils.cpp:184-216), DSI `.npy` dumps
(cartesian3dgrid/src/cartesian3dgrid_IO.cpp:30-36), per-slice PNG dumps
(:39-76), and the conf-range stats file (mapper_emvs_stereo.cpp:378-388).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..mapper import Events


def png_bytes(img: np.ndarray, level: int = 1) -> bytes:
    """Encode an 8-bit grayscale (H, W) or RGB (H, W, 3) image as PNG
    (no row filters, zlib `level`)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        color_type = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f"PNG image must be (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + img[0].size), np.uint8)   # filter byte 0 per row
    rows[:, 1:] = img.reshape(h, -1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def _imwrite(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def jet_colormap(v: np.ndarray) -> np.ndarray:
    """RGB JET colors for 8-bit values (H, W) -> (H, W, 3) uint8; within
    one level of OpenCV's COLORMAP_JET."""
    x = np.asarray(v, np.float64) / 255.0
    rgb = [np.clip(1.5 - np.abs(4.0 * x - c), 0.0, 1.0) for c in (3.0, 2.0, 1.0)]
    return np.round(np.stack(rgb, axis=-1) * 255.0).astype(np.uint8)


def dilate_cross3(img: np.ndarray) -> np.ndarray:
    """Grayscale dilation by the 3x3 ellipse (a cross: center + 4-
    neighbours), pixels outside the image ignored — OpenCV's
    `dilate(img, getStructuringElement(MORPH_ELLIPSE, (3, 3)))`."""
    out = img.copy()
    np.maximum(out[1:], img[:-1], out=out[1:])
    np.maximum(out[:-1], img[1:], out=out[:-1])
    np.maximum(out[:, 1:], img[:, :-1], out=out[:, 1:])
    np.maximum(out[:, :-1], img[:, 1:], out=out[:, :-1])
    return out


def timestamp_prefix(out_dir: str, ts: float) -> str:
    """The reference's '%013.9f'-style time-prefixed basename
    (process1.cpp:121-122)."""
    return os.path.join(out_dir, f"{ts:013.9f}")


def save_depth_points_txt(path: str, depth: np.ndarray, mask: np.ndarray) -> None:
    """`[col row depth]` per masked pixel (utils.cpp:31-46).

    Formats native Python scalars (`.tolist()`) in one %-join: formatting
    numpy scalars line-by-line cost ~130 ms per DSEC-sized chunk — the
    dominant cost of the full_seq save pipeline (the one-chunk-deep overlap
    hides device compute, not host serialization); this path is ~4x
    faster."""
    ys, xs = np.nonzero(np.asarray(mask) > 0)
    d = np.asarray(depth)[ys, xs]
    s = "".join(["%d %d %.7g\n" % tup
                 for tup in zip(xs.tolist(), ys.tolist(), d.tolist())])
    with open(path, "w") as f:
        f.write(s)


def save_confidence_negated_png(path: str, confidence: np.ndarray) -> None:
    """255 - minmax-normalized confidence (utils.cpp:54-58)."""
    c = np.asarray(confidence, np.float64)
    rng = c.max() - c.min()
    norm = (c - c.min()) * (255.0 / rng) if rng > 0 else np.zeros_like(c)
    _imwrite(path, (255.0 - norm).astype(np.uint8))


def save_inv_depth_colored_png(
    path: str, depth: np.ndarray, mask: np.ndarray,
    min_depth: float, max_depth: float,
) -> None:
    """JET-colored inverse depth on black, masked, dilated by a 3x3 ellipse
    (utils.cpp:81-93; the ESVO-style visualization)."""
    depth = np.asarray(depth, np.float64)
    with np.errstate(divide="ignore"):
        inv = np.where(depth > 0, 1.0 / np.maximum(depth, 1e-12), 0.0)
    scale = 255.0 / (1.0 / min_depth - 1.0 / max_depth)
    inv255 = (inv - 1.0 / max_depth) * scale
    inv8 = np.clip(inv255, 0, 255).astype(np.uint8)
    color = jet_colormap(inv8)
    canvas = np.zeros_like(color)
    m = np.asarray(mask) > 0
    canvas[m] = color[m]
    _imwrite(path, dilate_cross3(canvas))


def save_depth_maps(
    depth: np.ndarray,
    confidence: np.ndarray,
    mask: np.ndarray,
    min_depth: float,
    max_depth: float,
    suffix: str,
    out_prefix: str,
) -> None:
    """The full saveDepthMaps artifact set (utils.cpp:22-120)."""
    save_depth_points_txt(f"{out_prefix}depth_points_{suffix}.txt", depth, mask)
    save_confidence_negated_png(
        f"{out_prefix}confidence_map_negated_{suffix}.png", confidence)
    save_inv_depth_colored_png(
        f"{out_prefix}inv_depth_colored_dilated_{suffix}.png",
        depth, mask, min_depth, max_depth)


def accumulate_events_image(
    ev: Events, width: int, height: int, use_polarity: bool = True
) -> np.ndarray:
    """Event-count / polarity-balance preview image (utils.cpp:184-216)."""
    img = np.zeros((height, width), np.float64)
    if ev.num:
        pol = np.ones(ev.num) if ev.p is None else np.where(np.asarray(ev.p) > 0, 1.0, -1.0)
        if not use_polarity:
            pol = np.ones(ev.num)
        np.add.at(img, (np.asarray(ev.y), np.asarray(ev.x)), pol)
    if use_polarity:
        half = max(abs(img.min()), abs(img.max()))
        if half > 0:
            img = img * (128.0 / half) + 128.0
        else:
            img = np.full_like(img, 128.0)
        return np.clip(img, 0, 255).astype(np.uint8)
    rng = img.max() - img.min()
    if rng > 0:
        img = (img - img.min()) * (255.0 / rng)
    return img.astype(np.uint8)


def save_events_png(path: str, ev: Events, width: int, height: int) -> None:
    _imwrite(path, accumulate_events_image(ev, width, height))


def write_dsi_npy(path: str, dsi: np.ndarray) -> None:
    """DSI dump with the reference's (Z, Y, X) layout
    (cartesian3dgrid_IO.cpp:30-36) — our native layout already."""
    np.save(path, np.asarray(dsi, np.float32))


def write_dsi_slices_png(out_dir: str, dsi: np.ndarray, prefix: str = "slice") -> None:
    """Per-z-slice normalized PNGs (cartesian3dgrid_IO.cpp:39-76)."""
    os.makedirs(out_dir, exist_ok=True)
    d = np.asarray(dsi)
    lo, hi = d.min(), d.max()
    scale = 255.0 / (hi - lo) if hi > lo else 0.0
    for z in range(d.shape[0]):
        img = ((d[z] - lo) * scale).astype(np.uint8)
        _imwrite(os.path.join(out_dir, f"{prefix}_{z:04d}.png"), img)


def save_conf_stats(path: str, cmin: float, cmax: float, append: bool = True) -> None:
    """Per-chunk nonzero confidence range (mapper_emvs_stereo.cpp:378-388)."""
    mode = "a" if append else "w"
    with open(path, mode) as f:
        f.write(f"{cmin} {cmax}\n")


def save_dense_depth_png(path: str, depth_dense: np.ndarray,
                         min_depth: float, max_depth: float) -> None:
    """Normalized 8-bit PNG of the Telea-inpainted dense depth map.

    The reference computes this map on every extraction
    (mapper_emvs_stereo.cpp:429-436) but its save path is commented out
    (utils.cpp:96-104); here the artifact is actually written.
    """
    d = np.asarray(depth_dense, np.float32)
    span = max(max_depth - min_depth, 1e-9)
    img = np.clip((d - min_depth) * (255.0 / span), 0, 255).astype(np.uint8)
    _imwrite(path, img)
