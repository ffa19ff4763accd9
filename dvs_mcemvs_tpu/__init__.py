"""dvs_mcemvs_tpu — multi-camera event-based multi-view stereo in JAX.

A ground-up JAX/XLA re-design of the capabilities of
tub-rip/dvs_mcemvs (MC-EMVS: Ghosh & Gallego, Adv. Intelligent Systems 2022):
event back-projection into ray-density voxel grids (DSIs), multi-camera and
temporal DSI fusion, depth-map extraction, and point clouds — engineered for
accelerator meshes instead of a single-threaded CPU pipeline.

Layout:
  ops/       pure array operators (SE(3), camera, voting, fusion, extraction)
  mapper     per-camera DSI builder (MapperEMVS equivalent)
  pipeline   fusion algorithms (process 1/2/5) + sliding-window scheduler
  io/        calibration registry, event/pose readers, artifact writers
  config     gflags-compatible run configuration (+ reference .conf presets)
  cli        the run_emvs-equivalent driver
  utils/     synthetic scene generator and helpers
"""

__version__ = "0.1.0"
