"""Multi-host bootstrap: `jax.distributed.initialize` wiring.

The reference is strictly single-process (SURVEY.md §2.5: one address
space, shared_ptr wiring, no communication backend).  BASELINE config 5
targets distributed Schur-complement BA across >= 2 hosts; this module is
the process-level entry for that: initialize the JAX distributed runtime
from environment variables (or explicit arguments), then build the
("seq", "obs") mesh over the GLOBAL device set so the same shard_map BA
code (parallel/sharded_ba.py) runs with psums over the devices' own
interconnect within a host and the network across hosts.

Environment contract (standard cluster-launcher shapes):
    SLAM_COORDINATOR   host:port of process 0 (required when >1 process)
    SLAM_NUM_PROCESSES total process count           (default 1)
    SLAM_PROCESS_ID    this process's rank           (default 0)
JAX's own auto-detection (e.g. SLURM) is used when
these are unset — `jax.distributed.initialize()` with no arguments.

CPU testing: pass `cpu_gloo=True` (or set SLAM_CPU_GLOO=1) before any
backend use to select gloo cross-process CPU collectives — this is how
the 2-process smoke test (tests/test_multihost.py) exercises real
process-spanning meshes without accelerators.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

from modular_slam_tpu.parallel.mesh import make_mesh


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    cpu_gloo: bool = False,
) -> bool:
    """Initialize the JAX distributed runtime for multi-host execution.

    Arguments default from the SLAM_* environment variables.  Returns
    True when a multi-process runtime was initialized, False for the
    single-process fallback (no env, no args — local run).

    Must be called BEFORE any JAX backend use (device queries included);
    `jax.distributed.initialize` raises otherwise.
    """
    coordinator = coordinator or os.environ.get("SLAM_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("SLAM_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        pid_env = os.environ.get("SLAM_PROCESS_ID")
        process_id = int(pid_env) if pid_env is not None else None

    if cpu_gloo or os.environ.get("SLAM_CPU_GLOO") == "1":
        jax.config.update("jax_cpu_collectives_implementation", "gloo")

    if coordinator is None and num_processes <= 1:
        # single process: nothing to bootstrap (jax.distributed.initialize
        # with no cluster-detection environment would raise)
        return False

    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes or None,
        process_id=process_id,
    )
    return True


def global_mesh(seq: int = 1, obs: Optional[int] = None):
    """("seq", "obs") mesh over ALL processes' devices (jax.devices()
    is global after `initialize_distributed`)."""
    return make_mesh(seq=seq, obs=obs, devices=jax.devices())


def process_info() -> dict:
    """Rank/size/device summary for logs and the CLI banner."""
    return {
        "process_id": jax.process_index(),
        "num_processes": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
