"""Device-mesh helpers.

The reference has no distributed execution at all (SURVEY.md §2.5) — this
layer is this rebuild's addition: a named mesh with
- axis "seq": data parallelism over independent sequences (BASELINE
  config 5), and
- axis "obs": sharding of the observation list for the distributed
  Schur-complement BA reduction (configs 4-5).

On several hosts, call `jax.distributed.initialize()` before
`make_mesh` (standard JAX bootstrap).  The meshes are plain reshapes of
the device list: the GPUs of one host reach each other all to all, so
the mesh follows the algorithm alone and XLA picks the collectives.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    seq: int = 1, obs: Optional[int] = None, devices=None
) -> Mesh:
    """Mesh with axes ("seq", "obs").  `obs` defaults to all remaining
    devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if obs is None:
        if n % seq != 0:
            raise ValueError(f"{n} devices not divisible by seq={seq}")
        obs = n // seq
    if seq * obs != n:
        raise ValueError(f"mesh {seq}x{obs} != {n} devices")
    arr = np.array(devices).reshape(seq, obs)
    return Mesh(arr, ("seq", "obs"))


def make_kf_mesh(kf: int = 1, obs: Optional[int] = None,
                 devices=None) -> Mesh:
    """2-D mesh with axes ("kf", "obs") for keyframe-block sharded global
    BA (parallel/kf_sharded_ba.py, BASELINE config 4): keyframe/landmark
    state blocks over "kf", observation rows over both axes."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if obs is None:
        if n % kf != 0:
            raise ValueError(f"{n} devices not divisible by kf={kf}")
        obs = n // kf
    if kf * obs != n:
        raise ValueError(f"mesh {kf}x{obs} != {n} devices")
    arr = np.array(devices).reshape(kf, obs)
    return Mesh(arr, ("kf", "obs"))


def obs_sharded_specs():
    """PartitionSpecs for (replicated-map-state, obs-sharded-edge-list)."""
    return P(), P("obs")


def replicate(mesh: Mesh, tree):
    """Place a pytree fully replicated on the mesh."""
    s = NamedSharding(mesh, P())
    return jax.device_put(tree, s)
