"""Worker process for the 2-process multi-host smoke test.

Launched by tests/test_multihost.py with SLAM_COORDINATOR /
SLAM_NUM_PROCESSES / SLAM_PROCESS_ID set; each process brings 4 virtual
CPU devices, so the bootstrap yields a REAL process-spanning 8-device
mesh with gloo cross-process collectives — the same shard_map + psum
pattern the distributed Schur-complement BA uses (backend/ba.py
`allreduce`), without accelerators.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

# CPU devices whatever the environment says (as tests/conftest.py does)
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.ops import segment_sum  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


def main() -> int:
    from modular_slam_tpu.parallel.bootstrap import (
        global_mesh, initialize_distributed, process_info)

    assert initialize_distributed(cpu_gloo=True), "env bootstrap missed"
    info = process_info()
    assert info["num_processes"] == 2, info
    assert info["global_devices"] == 8, info
    mesh = global_mesh(seq=1, obs=8)

    # the BA reduction pattern: obs-sharded segment_sum + psum == the
    # unsharded global segment sum
    O, K = 64, 4
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(O,)).astype(np.float32)
    seg = rng.integers(0, K, size=(O,)).astype(np.int32)
    sh = NamedSharding(mesh, P("obs"))
    gvals = jax.make_array_from_callback((O,), sh, lambda i: vals[i])
    gseg = jax.make_array_from_callback((O,), sh, lambda i: seg[i])

    def body(v, s):
        return jax.lax.psum(segment_sum(v, s, num_segments=K), "obs")

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=(P("obs"), P("obs")),
                              out_specs=P()))
    out = np.asarray(f(gvals, gseg))
    want = np.zeros(K, np.float32)
    np.add.at(want, seg, vals)
    np.testing.assert_allclose(out, want, rtol=1e-5)
    print(f"MH OK rank={info['process_id']}", flush=True)

    # --- the REAL distributed Schur-complement BA across processes ------
    # halo-sharded global BA (parallel/halo_ba.py) over the spanning
    # 8-device mesh: ppermute window exchange + far-channel psum run as
    # gloo cross-process collectives — BASELINE config 5's "distributed
    # Schur-complement BA across >= 2 hosts" exercised with 2 real
    # processes (CPU-mesh proxy for the fabric).
    from jax.sharding import NamedSharding as _NS

    from modular_slam_tpu.config import BackendConfig, SlamConfig
    from modular_slam_tpu.parallel import make_halo_sharded_global_ba
    from modular_slam_tpu.parallel.mesh import make_kf_mesh
    from tests.test_backend_ba import CAM_CFG, _build_problem

    # identical deterministic problem on both processes (the same
    # fixture the single-device agreement tests use)
    cfg = SlamConfig(camera=CAM_CFG,
                     backend=BackendConfig(max_iterations=8))
    _cam, arena, _gt, _lm = _build_problem(seed=7)

    kf_mesh = make_kf_mesh(kf=8, obs=1)
    rep = _NS(kf_mesh, P())
    arena_g = jax.tree_util.tree_map(
        lambda x: jax.make_array_from_callback(
            np.asarray(x).shape, rep,
            lambda idx, a=np.asarray(x): a[idx]),
        arena)
    # this dense toy has NO temporal locality (every keyframe observes
    # every landmark), so most observations ride the far channel —
    # size it for the union of out-of-window landmarks
    halo = make_halo_sharded_global_ba(cfg, kf_mesh, halo=1, far_cap=128)
    arena2, stats, diag = halo(arena_g)
    c0, c1 = float(stats.initial_cost), float(stats.final_cost)
    assert np.isfinite(c1) and c1 <= c0 * 0.05, (c0, c1)
    assert int(jax.device_get(diag["n_dropped_obs"])) == 0
    print(f"MH HALO OK rank={info['process_id']} "
          f"cost {c0:.3e}->{c1:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
