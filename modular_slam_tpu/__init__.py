"""modular_slam_tpu — a modular RGB-D SLAM engine in JAX for the GPU.

A from-scratch rebuild of the capabilities of marcin-ochman/modular-slam
(C++17, reference at /root/reference) as an idiomatic JAX/XLA/Pallas design:

- fixed-capacity, masked tensor representations everywhere (XLA static shapes)
- frontend kernels (pyramid, FAST, grid top-k selection, IC angle, blur,
  rotated BRIEF-256, Hamming matching, batched RANSAC-PnP) as jnp/Pallas ops
- a tensor-arena map with a covisibility adjacency matrix
- a Levenberg-Marquardt bundle-adjustment backend with Schur-complement
  landmark elimination, shardable over a `jax.sharding.Mesh`
- BoW-style loop detection / relocalization as batched matmul scoring

Reference parity notes cite file:line into /root/reference.
"""

__version__ = "0.2.0"

from modular_slam_tpu.config import (  # noqa: F401
    CameraConfig,
    DetectorConfig,
    MatcherConfig,
    PnpConfig,
    TrackerConfig,
    MapConfig,
    BackendConfig,
    LoopConfig,
    SlamConfig,
    tum_camera_config,
)
