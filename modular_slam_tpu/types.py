"""Core data contracts as pytrees (NamedTuples of arrays).

These replace the reference's value-type headers
(/root/reference/src/lib/modular_slam/include/modular_slam/types/*.hpp):
RgbdFrame (rgbd_frame.hpp:13-19), Keypoint/KeypointDescriptor
(frontend/feature/feature_interface.hpp:18-33), FrontendOutput
(frontend_output.hpp:30-43).  Everything is fixed-capacity with validity
masks so XLA sees static shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from modular_slam_tpu.geometry.se3 import Pose

Array = jnp.ndarray

# RGB -> luma weights (the reference's toGrayScale, frame.cpp:6-27) —
# the single source for every conversion site (engine chunk path, IO
# wire format, DP batching, native loader mirrors it in C++)
LUMA_WEIGHTS = (0.299, 0.587, 0.114)


class RgbdFrame(NamedTuple):
    """One RGB-D frame resident on device.

    rgb:   [H, W, 3] uint8
    gray:  [H, W] float32 (luma, 0..255)
    depth: [H, W] float32 meters (0 = invalid)
    timestamp: scalar float64/float32 seconds
    """

    rgb: Array
    gray: Array
    depth: Array
    timestamp: Array


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set [N] with validity mask.

    uv:       [N, 2] float32 — level-0 pixel coords
    response: [N] float32 — detector score
    angle:    [N] float32 — IC-angle in radians
    level:    [N] int32 — pyramid level
    depth:    [N] float32 — meters sampled from the depth map (0 invalid)
    valid:    [N] bool
    """

    uv: Array
    response: Array
    angle: Array
    level: Array
    depth: Array
    valid: Array

    @property
    def capacity(self) -> int:
        return self.uv.shape[-2]


class Descriptors(NamedTuple):
    """BRIEF-256 descriptors.

    packed:   [N, 8] uint32 — bit-packed, for storage/hashing
    unpacked: [N, 256] int8 — ±1, for matmul Hamming matching
    """

    packed: Array
    unpacked: Array


class Features(NamedTuple):
    keypoints: Keypoints
    descriptors: Descriptors


class Matches(NamedTuple):
    """2-NN ratio-tested matches from frame keypoints to landmark slots.

    lm_slot:  [N] int32 — matched landmark arena slot (undefined when !valid)
    distance: [N] float32 — best Hamming distance
    valid:    [N] bool — passed ratio test + mask checks
    """

    lm_slot: Array
    distance: Array
    valid: Array


class TrackResult(NamedTuple):
    """Per-frame frontend output (reference FrontendOutput,
    frontend_output.hpp:30-43, flattened to arrays)."""

    pose: Pose
    n_matches: Array        # int32 — ratio-test survivors with valid depth
    n_inliers: Array        # int32 — PnP inliers
    tracking_ok: Array      # bool
    new_keyframe: Array     # bool — a keyframe was added this frame
    kf_slot: Array          # int32 — reference keyframe slot after update
    # bool — device-side in-scan relocalization fired on this frame
    # (chunked path with relocalization enabled; None elsewhere)
    relocalized: Array = None


def pack_bits(bits: Array) -> Array:
    """[..., 256] {0,1} -> [..., 8] uint32 little-endian bit packing."""
    b = bits.astype(jnp.uint32).reshape(*bits.shape[:-1], 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts, axis=-1).astype(jnp.uint32)


def unpack_bits(packed: Array) -> Array:
    """[..., 8] uint32 -> [..., 256] {0,1} uint8."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[..., :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(*packed.shape[:-1], 256).astype(jnp.uint8)


def bits_to_pm1(bits: Array) -> Array:
    """{0,1} -> ±1 int8 (for Hamming-as-matmul: ham = (256 - a·b) / 2)."""
    return (bits.astype(jnp.int8) * 2 - 1).astype(jnp.int8)
