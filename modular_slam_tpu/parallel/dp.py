"""Multi-sequence data parallelism: one SLAM instance per mesh "seq" row.

BASELINE config 5's data axis: independent sequences (fr1+fr2+fr3) each
carry their own map arena and tracking state; the batched engine step is
the single-sequence `slam_step` vmapped over a leading sequence axis, with
each device running its own block of sequences under shard_map — zero
cross-sequence communication (tracking is embarrassingly parallel; the
coupling happens in the sharded BA, parallel/sharded_ba.py).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from modular_slam_tpu.config import SlamConfig
from modular_slam_tpu.frontend.tracker import initial_state, track_frame
from modular_slam_tpu.geometry.camera import camera_from_config
from modular_slam_tpu.map.arena import empty_arena
from modular_slam_tpu.ops.detector import detect


def _per_device(cfg: SlamConfig, mesh: Mesh, axis: str) -> Callable:
    """The single-sequence engine step, vmapped over each device's block
    of the sequence axis under shard_map: every device tracks its own
    sequences and nothing crosses devices (nor does XLA ever have to
    partition the Pallas kernels inside the step)."""
    cam = camera_from_config(cfg.camera)

    def one(arena, state, gray, depth, time, key):
        feats = detect(gray, depth, cfg.detector)
        return track_frame(arena, state, feats, cam, cfg, time, key)

    return jax.shard_map(jax.vmap(one), mesh=mesh, in_specs=P(axis),
                         out_specs=P(axis), check_vma=False)


def make_batch_slam_step(cfg: SlamConfig, mesh: Mesh,
                         axis: str = "seq") -> Callable:
    """Jitted batched step: (arenas, states, grays, depths, times, keys)
    -> (arenas, states, results), everything with a leading [B] sequence
    axis sharded over `axis`."""
    return jax.jit(_per_device(cfg, mesh, axis))


def make_batch_slam_scan(cfg: SlamConfig, mesh: Mesh,
                         axis: str = "seq") -> Callable:
    """Chunked batched step: lax.scan of the per-device batched engine
    step over a leading chunk axis — C frames of B sequences in ONE
    dispatch.  fn(arenas, states, grays [C,B,H,W], depths [C,B,H,W],
    times [C,B], keys [C,B,2]) -> (arenas, states, results [C,B]).  The
    scan removes the per-frame host dispatch that made the
    multi-sequence path structurally slower than the single-sequence
    scan.
    """
    step = _per_device(cfg, mesh, axis)

    @jax.jit
    def scan_fn(arenas, states, grays, depths, times, keys):
        def body(carry, frame):
            a, s, r = step(*carry, *frame)
            return (a, s), r
        (arenas, states), results = jax.lax.scan(
            body, (arenas, states), (grays, depths, times, keys))
        return arenas, states, results

    return scan_fn


def make_batch_init(cfg: SlamConfig, mesh: Mesh, batch: int,
                    axis: str = "seq"):
    """Replicated-per-sequence empty arenas + states, sharded over `axis`."""
    arenas = jax.vmap(lambda _: empty_arena(cfg.map))(jnp.arange(batch))
    states = jax.vmap(lambda _: initial_state())(jnp.arange(batch))

    def shard(tree):
        def put(x):
            spec = P(axis, *([None] * (x.ndim - 1)))
            return jax.device_put(x, NamedSharding(mesh, spec))
        return jax.tree.map(put, tree)

    return shard(arenas), shard(states)
