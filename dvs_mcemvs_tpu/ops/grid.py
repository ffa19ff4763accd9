"""DSI voxel-grid operations: fusion, Z-collapse, statistics, filtering.

Array replacement for `Grid3D` (cartesian3dgrid/include/cartesian3dgrid/
cartesian3dgrid.h:22-247 and src/cartesian3dgrid.cpp).  A DSI here is a plain
`jnp.ndarray` of shape (Z, H, W) float32 — the reference's
`volume[x + dimX*(y + dimY*z)]` layout transposed so the depth axis is the
leading (cheaply sharded) axis and (H, W) are the trailing (lane-tiled) axes.

All two-grid fusion ops (cartesian3dgrid.h:64-192) are pure element-wise
functions with the reference's exact epsilon semantics, so they vectorize
and fuse with neighbors under XLA.  The serial per-voxel loops of the
reference (its header notes "do not use parallelization yet", h:63) become
single fused device ops.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Fusion-method enum values, matching the `stereo_fusion` flag in
# src/main.cpp:91 and the switch in src/process1.cpp:136-158.
FUSE_MIN = 1
FUSE_HM = 2
FUSE_GM = 3
FUSE_AM = 4
FUSE_RMS = 5
FUSE_MAX = 6

FUSION_NAMES = {
    FUSE_MIN: "min",
    FUSE_HM: "harmonic_mean",
    FUSE_GM: "geometric_mean",
    FUSE_AM: "arithmetic_mean",
    FUSE_RMS: "rms",
    FUSE_MAX: "max",
}


# ---------------------------------------------------------------------------
# Two-grid fusion ops (cartesian3dgrid.h:64-192)
# ---------------------------------------------------------------------------


def fuse_add(g1, g2):
    return g1 + g2


def fuse_subtract(g1, g2):
    return g1 - g2


def fuse_ratio(g1, g2, eps=1e-1):
    return g1 / (jnp.abs(g2) + eps)


def fuse_min(g1, g2):
    return jnp.minimum(g1, g2)


def fuse_max(g1, g2):
    return jnp.maximum(g1, g2)


def fuse_harmonic_mean(g1, g2, eps=1e-1):
    """2 g1 g2 / (g1 + g2 + eps)  (cartesian3dgrid.h:119-127)."""
    return 2.0 * g1 * g2 / (g1 + g2 + eps)


def fuse_harmonic_mean_nary(g1, g2, n, eps=1e-1):
    """Recursive n-ary HM step: g1 is the HM of (n-1) grids, g2 the n-th.

    a = g1/(n-1);  out = n*a*g2 / (a + g2 + eps)   (cartesian3dgrid.h:130-139).
    """
    a = g1 / float(n - 1)
    return float(n) * a * g2 / (a + g2 + eps)


def fuse_geometric_mean(g1, g2):
    return jnp.sqrt(g1 * g2)


def fuse_arithmetic_mean(g1, g2):
    return 0.5 * (g1 + g2)


def fuse_rms(g1, g2):
    return jnp.sqrt(0.5 * (g1 * g1 + g2 * g2))


def fuse_quadratic_mean(g1, g2):
    return jnp.sqrt(0.5 * (g1 * g1 + g2 * g2))


def fuse_cubic_mean(g1, g2):
    return jnp.cbrt(0.5 * (g1 ** 3 + g2 ** 3))


def fuse_pair(g1, g2, method: int):
    """Dispatch on the `stereo_fusion` enum (process1.cpp:136-158)."""
    fns = {
        FUSE_MIN: fuse_min,
        FUSE_HM: fuse_harmonic_mean,
        FUSE_GM: fuse_geometric_mean,
        FUSE_AM: fuse_arithmetic_mean,
        FUSE_RMS: fuse_rms,
        FUSE_MAX: fuse_max,
    }
    if method not in fns:
        raise ValueError(f"unknown fusion method {method}")
    return fns[method](g1, g2)


def fuse_many(grids, method: int):
    """Fuse a list/stacked array of >= 2 grids.

    For min/max this is the plain reduction.  For HM it reproduces the
    reference's recursive n-ary update chain (process1.cpp:169-191 uses
    harmonicMeanTwoGrids(g3, n=3) after the 2-grid HM).  For GM/AM/RMS the
    reference silently ignores cameras beyond the second (process1.cpp:178-183)
    — here we generalize to the true n-ary mean instead, which is the
    documented intentional divergence.
    """
    grids = list(grids)
    n = len(grids)
    if n == 1:
        return grids[0]
    if method in (FUSE_MIN, FUSE_MAX):
        out = grids[0]
        for g in grids[1:]:
            out = fuse_pair(out, g, method)
        return out
    if method == FUSE_HM:
        out = fuse_harmonic_mean(grids[0], grids[1])
        for k in range(2, n):
            out = fuse_harmonic_mean_nary(out, grids[k], k + 1)
        return out
    stack = jnp.stack(grids, axis=0)
    if method == FUSE_AM:
        return jnp.mean(stack, axis=0)
    if method == FUSE_GM:
        return jnp.exp(jnp.mean(jnp.log(jnp.maximum(stack, 1e-30)), axis=0))
    if method == FUSE_RMS:
        return jnp.sqrt(jnp.mean(stack * stack, axis=0))
    raise ValueError(f"unknown fusion method {method}")


def fuse_harmonic_mean_of_local_focus(g1, g2, focus_method: int = 0,
                                      sigma: float = 0.5, eps: float = 1e-1):
    """HM of the per-slice local focus scores of two DSIs
    (fuseDSIs_HarmonicMeanOfLocalFocus, utils.cpp:155-181): each grid is
    replaced by its local focus transform (0 = local std-dev, 1 = local
    mean square; cartesian3dgrid.cpp:417-483) before harmonic-mean fusion."""
    f1 = local_focus_in_place(g1, focus_method, sigma)
    f2 = local_focus_in_place(g2, focus_method, sigma)
    return fuse_harmonic_mean(f1, f2, eps)


# Streaming accumulators for temporal fusion (cartesian3dgrid.h:72-93,
# driven by process2.cpp:211-242).


def add_inverse(acc, g, eps=1e-2):
    """acc + 1/(eps + g)  — the HM running accumulator (h:72-79)."""
    return acc + 1.0 / (eps + g)


def hm_from_sum_of_inv(acc, n: int):
    return float(n) / acc


def am_from_sum(acc, n: int):
    return acc / float(n)


# ---------------------------------------------------------------------------
# Z-collapse: per-pixel argmax/argmin of votes along depth
# (src/cartesian3dgrid.cpp:115-161)
# ---------------------------------------------------------------------------


def collapse_max(dsi: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(confidence, depth_index) per pixel; dsi (Z, H, W).

    Ties resolve to the lowest index, matching std::max_element.
    """
    conf = jnp.max(dsi, axis=0)
    idx = jnp.argmax(dsi, axis=0).astype(jnp.int32)
    return conf, idx


def collapse_min(dsi: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    conf = jnp.min(dsi, axis=0)
    idx = jnp.argmin(dsi, axis=0).astype(jnp.int32)
    return conf, idx


# ---------------------------------------------------------------------------
# 2D convolution helpers (OpenCV-compatible kernels and borders)
# ---------------------------------------------------------------------------


# Kernels up to this many taps run as fused shift-adds; beyond it, lax.conv.
_SHIFT_ADD_MAX_TAPS = 81


def conv2d_same(img: jnp.ndarray, kernel: jnp.ndarray, border: str = "reflect"):
    """2D correlation with `same` output on (..., H, W).

    border: 'reflect' = cv BORDER_REFLECT (edge pixel duplicated),
            'reflect101' = cv BORDER_DEFAULT, 'replicate', 'zero'.

    Small kernels (<= 81 taps — every kernel on the extraction path) are
    lowered as weighted shifted-slice sums: elementwise adds that XLA fuses
    into one pass instead of a 1-channel `lax.conv`; the shift-add path is
    exact in f32, like the Precision.HIGHEST conv used for larger kernels.
    """
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    mode = {
        "reflect": "symmetric",
        "reflect101": "reflect",
        "replicate": "edge",
        "zero": "constant",
    }[border]
    kconst: Optional[np.ndarray]
    try:
        kconst = np.asarray(kernel, dtype=np.float64)
    except Exception:  # traced kernel: keep the general conv path below
        kconst = None
    if kconst is not None and kh * kw <= _SHIFT_ADD_MAX_TAPS:
        H, W = img.shape[-2:]
        pad = [(0, 0)] * (img.ndim - 2) + [(ph, kh - 1 - ph),
                                           (pw, kw - 1 - pw)]
        x = jnp.pad(img, pad, mode=mode)
        out = None
        for i in range(kh):
            for j in range(kw):
                w = float(kconst[i, j])
                if w == 0.0:
                    continue
                sl = x[..., i:i + H, j:j + W]
                term = sl if w == 1.0 else w * sl
                out = term if out is None else out + term
        if out is None:
            return jnp.zeros_like(img)
        return out
    batch_shape = img.shape[:-2]
    H, W = img.shape[-2:]
    x = img.reshape((-1, 1, H, W))
    x = jnp.pad(x, ((0, 0), (0, 0), (ph, kh - 1 - ph), (pw, kw - 1 - pw)), mode=mode)
    k = kernel[None, None, :, :].astype(img.dtype)
    # HIGHEST precision: a reduced-precision conv (bf16 passes, or TF32 on
    # a GPU) perturbs the Gaussian local means by up to ~0.5 u8 steps and
    # flips adaptive-threshold mask pixels vs the OpenCV-parity f32
    # result.  These are tiny kernels on 2D maps — exactness costs nothing
    # next to the DSI work.
    out = jax.lax.conv_general_dilated(
        x, k, window_strides=(1, 1), padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST,
    )
    return out.reshape(batch_shape + (H, W))


def sep_conv2d_same(img, kx, ky, border="reflect"):
    """Separable correlation: rows by kx then columns by ky.

    Small static kernels run as ONE dense outer-product pass through
    `conv2d_same`'s shift-add path (one fused pass instead of two chained
    ones).  Mathematically identical taps — only the f32 summation order
    differs (rows-then-cols vs one 2D sum), ~1 ulp.
    """
    try:
        kxc = np.asarray(kx, dtype=np.float64)
        kyc = np.asarray(ky, dtype=np.float64)
    except Exception:  # traced kernels: keep the two-pass form
        kxc = kyc = None
    if kxc is not None and kxc.size * kyc.size <= _SHIFT_ADD_MAX_TAPS:
        return conv2d_same(img, np.outer(kyc, kxc).astype(np.float32), border)
    out = conv2d_same(img, jnp.asarray(kx)[None, :], border)
    out = jax.lax.optimization_barrier(out)
    return conv2d_same(out, jnp.asarray(ky)[:, None], border)


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """cv::getGaussianKernel for CV_32F/CV_64F inputs."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    i = np.arange(ksize, dtype=np.float64)
    x = i - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_ksize_from_sigma(sigma: float, depth_is_8u: bool = False) -> int:
    """cv::GaussianBlur(Size(0,0), sigma) kernel-size rule."""
    factor = 3 if depth_is_8u else 4
    k = int(round(sigma * factor * 2 + 1)) | 1
    return max(k, 1)


def gaussian_blur(img, sigma: float, border="reflect"):
    """cv::GaussianBlur(src, dst, Size(0,0), sigma) on float32 images."""
    ksize = gaussian_ksize_from_sigma(sigma)
    k = gaussian_kernel_1d(ksize, sigma)
    return sep_conv2d_same(img, k, k, border)


_SOBEL_D = np.array([-1.0, 0.0, 1.0], dtype=np.float32)
_SOBEL_S = np.array([1.0, 2.0, 1.0], dtype=np.float32)
# getDerivKernels(2, 0, ksize=5): second derivative and smoothing taps.
_DERIV2_5 = np.array([1.0, 0.0, -2.0, 0.0, 1.0], dtype=np.float32)
_SMOOTH_5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32)


def sobel_grad_mag_sq(img, border="reflect101"):
    """grad_x^2 + grad_y^2 with cv::Sobel 3x3 kernels (BORDER_DEFAULT)."""
    gx = sep_conv2d_same(img, _SOBEL_D, _SOBEL_S, border)
    gy = sep_conv2d_same(img, _SOBEL_S, _SOBEL_D, border)
    return gx * gx + gy * gy


def laplacian5(img, border="reflect101"):
    """cv::Laplacian(..., ksize=5): d2x (x) smooth_y + smooth_x (x) d2y."""
    a = sep_conv2d_same(img, _DERIV2_5, _SMOOTH_5, border)
    b = sep_conv2d_same(img, _SMOOTH_5, _DERIV2_5, border)
    return a + b


def box_mean(img, half: int):
    """Plain (2*half+1)^2 patch mean (used by the grad-mag focus collapse)."""
    size = 2 * half + 1
    k = jnp.full((size, size), 1.0 / (size * size), dtype=img.dtype)
    return conv2d_same(img, k, border="zero")


# ---------------------------------------------------------------------------
# Focus-measure collapses (src/cartesian3dgrid.cpp:192-414).  Each computes a
# per-slice focus image, then takes the per-pixel max over depth.  Strict >
# comparison against a zero-initialized best reproduces the reference's
# index-0 bias for all-zero rays.
# ---------------------------------------------------------------------------


def _collapse_by_focus(focus_zhw: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    conf = jnp.max(focus_zhw, axis=0)
    idx = jnp.argmax(focus_zhw, axis=0).astype(jnp.int32)
    # Reference keeps (conf=0, idx=0) where no slice beats the 0 init.
    idx = jnp.where(conf > 0, idx, 0)
    return conf, idx


def collapse_by_grad_mag(dsi, half_patchsize: int = 2):
    """Sobel gradient-magnitude focus, patch-averaged (cpp:192-240).

    The reference only updates pixels at least `half_patchsize` from the
    border; we mask the same band to zero focus.
    """
    gm = sobel_grad_mag_sq(dsi)
    focus = box_mean(gm, half_patchsize)
    Z, H, W = dsi.shape
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    interior = (
        (ys >= half_patchsize) & (ys < H - half_patchsize)
        & (xs >= half_patchsize) & (xs < W - half_patchsize)
    )
    focus = jnp.where(interior[None], focus, 0.0)
    conf, idx = _collapse_by_focus(focus)
    return jnp.sqrt(conf), idx


def collapse_by_laplacian(dsi):
    """Squared 5-tap Laplacian focus (cpp:243-281)."""
    hf = laplacian5(dsi)
    conf, idx = _collapse_by_focus(hf * hf)
    return jnp.sqrt(conf), idx


def collapse_by_dog(dsi, sigma: float = 0.5, sigma2_ratio: float = 1.6):
    """|DoG| focus with sigma and 1.6*sigma Gaussians (cpp:284-327)."""
    g1 = gaussian_blur(dsi, sigma)
    g2 = gaussian_blur(dsi, sigma * sigma2_ratio)
    return _collapse_by_focus(jnp.abs(g1 - g2))


def collapse_by_local_var(dsi, sigma: float = 0.5):
    """Gaussian local variance focus (cpp:330-372)."""
    m = gaussian_blur(dsi, sigma)
    ms = gaussian_blur(dsi * dsi, sigma)
    var = jnp.maximum(ms - m * m, 0.0)
    return _collapse_by_focus(var)


def collapse_by_local_mean_square(dsi, sigma: float = 0.5):
    """Gaussian local mean-square focus (cpp:375-414)."""
    ms = gaussian_blur(dsi * dsi, sigma)
    return _collapse_by_focus(ms)


def local_focus_in_place(dsi, focus_method: int = 0, sigma: float = 0.5):
    """computeLocalFocusInPlace (cpp:417-483): per-slice focus transform.

    method 1 = local mean square, else local std-dev.
    """
    if focus_method == 1:
        return gaussian_blur(dsi * dsi, sigma)
    m = gaussian_blur(dsi, sigma)
    ms = gaussian_blur(dsi * dsi, sigma)
    return jnp.sqrt(jnp.maximum(ms - m * m, 0.0))


# Collapse-method enum matching getDepthMapFromDSI's `method` switch
# (src/mapper_emvs_stereo.cpp:348-370).
def collapse(dsi, method: int = -1):
    if method == 0:
        return collapse_by_local_var(dsi)
    if method == 1:
        return collapse_by_local_mean_square(dsi)
    if method == 2:
        return collapse_by_grad_mag(dsi)
    if method == 3:
        return collapse_by_laplacian(dsi)
    if method == 4:
        return collapse_by_dog(dsi)
    return collapse_max(dsi)


# ---------------------------------------------------------------------------
# Statistics (src/cartesian3dgrid.cpp:164-188)
# ---------------------------------------------------------------------------


def mean_square(dsi):
    d = dsi.astype(jnp.float64) if dsi.dtype == jnp.float64 else dsi
    return jnp.mean(d.astype(jnp.float32) ** 2)


def min_max(dsi):
    return jnp.min(dsi), jnp.max(dsi)


def mean_std(dsi):
    """Grid mean and (population) standard deviation — computeMeanStd."""
    m = jnp.mean(dsi)
    return m, jnp.sqrt(jnp.mean((dsi - m) ** 2))


# ---------------------------------------------------------------------------
# 3D smoothing extras — the reference ships these but excludes them from its
# build (cartesian3dgrid/src/cartesian3dgrid_filter.cpp, gaussianiir3d.cpp;
# excluded by cartesian3dgrid/CMakeLists.txt:12-13).  Provided here as live,
# tested capability.
# ---------------------------------------------------------------------------


def laplacian3d(dsi):
    """6-neighbor 3D Laplacian with homogeneous Neumann boundaries
    (Grid3D::laplacianInPlace, filter.cpp:72-110: an out-of-range neighbor
    is replaced by the center sample, i.e. edge-replicate padding)."""
    out = -6.0 * dsi
    pad = jnp.pad(dsi, 1, mode="edge")
    out = out + pad[:-2, 1:-1, 1:-1] + pad[2:, 1:-1, 1:-1]
    out = out + pad[1:-1, :-2, 1:-1] + pad[1:-1, 2:, 1:-1]
    out = out + pad[1:-1, 1:-1, :-2] + pad[1:-1, 1:-1, 2:]
    return out


def diffuse(dsi, sigma: float):
    """Heat-equation smoothing to Gaussian scale `sigma`
    (Grid3D::smoothInPlace, filter.cpp:19-69): explicit Euler steps
    g += dt * laplacian3d(g) with the reference's CFL step rule
    dt = min(1/24, t_final/2), t_final = sigma^2/2, Neumann boundaries."""
    dt_cfl = 1.0 / 12.0
    t_final = 0.5 * sigma * sigma
    dt = min(0.5 * dt_cfl, 0.5 * t_final)
    steps = int(np.ceil(t_final / dt)) if t_final > 0 else 0

    def body(_, g):
        return g + dt * laplacian3d(g)

    return jax.lax.fori_loop(0, steps, body, dsi)


def moran_index_gaussian_weights(dsi, sigma: float) -> jnp.ndarray:
    """Moran's I spatial-autocorrelation index of the grid under a Gaussian
    neighbor-weight kernel (Grid3D::computeMoranIndexGaussianWeights,
    filter.cpp:113-199).

    The grid is standardized, blurred at scale sigma, and the center tap's
    own contribution removed; I = sum(z * (blur(z) - w0 z)) / ((1-w0)(N-1))
    with w0 the blurred-delta central weight.  The reference blurs with a
    3-step Alvarez-Mazorra IIR Gaussian; here an exact separable FIR
    Gaussian of the same sigma is used (documented divergence)."""
    sigma = max(float(sigma), 0.2)
    m, sd = mean_std(dsi)
    z = (dsi - m) / jnp.maximum(sd, 1e-30)
    z_smooth = gaussian_blur_3d(z, sigma)
    # Central weight of the 3D kernel = (center of the 1D kernel)^3.
    k1 = gaussian_kernel_1d(gaussian_ksize_from_sigma(sigma), sigma)
    w0 = float(k1[len(k1) // 2]) ** 3
    n = dsi.size
    numer = jnp.sum(z * (z_smooth - w0 * z))
    denom = (1.0 - w0) * (n - 1.0)
    return numer / (denom + 1e-6)


def gaussian_blur_3d(dsi, sigma: float):
    """Separable 3D Gaussian (replacement for the Alvarez-Mazorra IIR
    gaussianiir3d.cpp) applied along (Z, H, W)."""
    ksize = gaussian_ksize_from_sigma(sigma)
    k = jnp.asarray(gaussian_kernel_1d(ksize, sigma))
    out = dsi
    for axis in range(3):
        moved = jnp.moveaxis(out, axis, -1)
        shape = moved.shape
        flat = moved.reshape(-1, shape[-1])
        conv = conv2d_same(flat[:, None, :], k[None, :], border="replicate")
        out = jnp.moveaxis(conv[:, 0, :].reshape(shape), -1, axis)
    return out
