"""Core array operators: geometry, grids, voting, extraction."""

from . import camera, depth_vector, extract, grid, pointcloud, se3, trajectory, voting  # noqa: F401
