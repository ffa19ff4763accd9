"""Depth map -> point cloud, with radius outlier removal.

Port of `MapperEMVS::getPointcloud` (src/mapper_emvs_stereo.cpp:440-480).
Unprojection is pure jnp; outlier removal offers two backends:
  - 'kdtree': exact PCL-equivalent RadiusOutlierRemoval via scipy cKDTree on
    the host (post-processing, off the hot path);
  - 'voxel': device-resident approximate filter counting neighbors in a hashed
    voxel grid (cell = radius), counting the 27-cell neighborhood.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from .camera import PinholeCamera


class PointCloud(NamedTuple):
    xyz: np.ndarray        # (N, 3)
    intensity: np.ndarray  # (N,) = 1/z (cpp:462)


def depth_map_to_pointcloud(
    depth: np.ndarray, mask: np.ndarray, vcam: PinholeCamera
) -> PointCloud:
    """Unproject masked pixels through the virtual camera (cpp:449-468).

    xyz = (ray / ray.z) * depth with ray = Kinv (x, y, 1); the reference's
    intermediate normalization cancels in the division.
    """
    ys, xs = np.nonzero(np.asarray(mask) > 0)
    d = np.asarray(depth)[ys, xs]
    bx = (xs - vcam.cx) / vcam.fx
    by = (ys - vcam.cy) / vcam.fy
    xyz = np.stack([bx * d, by * d, d], axis=-1)
    return PointCloud(xyz=xyz.astype(np.float32), intensity=(1.0 / d).astype(np.float32))


def radius_outlier_removal(
    pc: PointCloud, radius: float, min_neighbors: int, backend: str = "kdtree"
) -> PointCloud:
    """pcl::RadiusOutlierRemoval semantics (cpp:471-479): keep points with at
    least `min_neighbors` OTHER points within `radius`.
    """
    if pc.xyz.shape[0] == 0:
        return pc
    if backend == "kdtree":
        keep = _ror_kdtree(pc.xyz, radius, min_neighbors)
    elif backend == "voxel":
        keep = np.asarray(_ror_voxel(jnp.asarray(pc.xyz), radius, min_neighbors))
    else:
        raise ValueError(f"unknown ROR backend {backend}")
    return PointCloud(pc.xyz[keep], pc.intensity[keep])


def _ror_kdtree(xyz: np.ndarray, radius: float, min_neighbors: int) -> np.ndarray:
    from scipy.spatial import cKDTree

    tree = cKDTree(xyz)
    counts = tree.query_ball_point(xyz, r=radius, return_length=True)
    # PCL counts neighbors excluding the query point itself.
    return (counts - 1) >= min_neighbors


def _ror_voxel(xyz: jnp.ndarray, radius: float, min_neighbors: int) -> jnp.ndarray:
    """Approximate ROR: neighbor count over the 27 adjacent voxels of a grid
    with cell size = radius.  Overcounts distant-corner neighbors (upper
    bound), so it is slightly more permissive than the exact filter.
    """
    n = xyz.shape[0]
    cell = jnp.floor(xyz / radius).astype(jnp.int64)
    cmin = jnp.min(cell, axis=0)
    cell = cell - cmin
    dims = jnp.max(cell, axis=0) + 3
    key = (cell[:, 0] + 1) * dims[1] * dims[2] + (cell[:, 1] + 1) * dims[2] + (cell[:, 2] + 1)
    size = int(np.asarray(dims[0] * dims[1] * dims[2]))
    counts = jnp.zeros((size,), jnp.int32).at[key].add(1)
    total = jnp.zeros((n,), jnp.int32)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nk = key + dx * dims[1] * dims[2] + dy * dims[2] + dz
                total = total + counts[jnp.clip(nk, 0, size - 1)]
    return (total - 1) >= min_neighbors


def save_pcd(path: str, pc: PointCloud) -> None:
    """ASCII PCD writer (pcl::savePCDFileASCII equivalent, main.cpp:397)."""
    n = pc.xyz.shape[0]
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\n"
        f"COUNT 1 1 1 1\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA ascii\n"
    )
    with open(path, "w") as f:
        f.write(header)
        for (x, y, z), i in zip(pc.xyz, pc.intensity):
            f.write(f"{x:.6f} {y:.6f} {z:.6f} {i:.6f}\n")
