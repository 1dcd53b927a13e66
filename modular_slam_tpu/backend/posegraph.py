"""Pose-graph optimization (Gauss-Newton on SE(3) relative-pose edges).

The loop-closure backend the reference never built (its global-BA trigger
expects a loop detection that cannot happen, ceres_backend.cpp:130-133).

Formulation: nodes are keyframe poses T_i (camera-to-world); an edge
(i, j) carries a measured relative transform Z_ij; the residual is
r_e = log(Z_ij^-1 * T_i^-1 * T_j) in se(3), minimized by damped GN with
per-node right-multiplicative retractions T <- T * exp(xi).  Jacobians
come from jax.jacfwd of the per-edge residual (exact, vmapped), the
normal equations are assembled by scatter-add into a dense [6K, 6K]
system (K <= 256 keyframes -> a trivial Cholesky), gauge fixed
at node 0.  Fixed-capacity edge arrays with validity masks keep
everything static-shape.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from modular_slam_tpu.geometry.se3 import (
    Pose,
    pose_compose,
    pose_inverse,
    pose_retract,
    quat_normalize,
    se3_log,
)

Array = jnp.ndarray


class PoseGraphEdges(NamedTuple):
    i: Array       # [E] int32 source node
    j: Array       # [E] int32 target node
    rel_q: Array   # [E, 4] measured T_i^-1 T_j rotation (wxyz)
    rel_t: Array   # [E, 3]
    weight: Array  # [E] float32 (0 = inactive; loop edges may be down/up
    #              weighted vs odometry edges)
    is_loop: Array  # [E] bool — loop-closure measurement (keep as stored);
    #              odometry edges (False) are re-measured from the current
    #              BA-refined poses at optimization time (see
    #              refresh_odometry_edges)


def empty_edges(capacity: int) -> PoseGraphEdges:
    return PoseGraphEdges(
        i=jnp.zeros((capacity,), jnp.int32),
        j=jnp.zeros((capacity,), jnp.int32),
        rel_q=jnp.zeros((capacity, 4), jnp.float32).at[:, 0].set(1.0),
        rel_t=jnp.zeros((capacity, 3), jnp.float32),
        weight=jnp.zeros((capacity,), jnp.float32),
        is_loop=jnp.zeros((capacity,), bool),
    )


def add_edge(edges: PoseGraphEdges, slot: Array, i: Array, j: Array,
             rel: Pose, weight: float = 1.0,
             is_loop: bool = False) -> PoseGraphEdges:
    return PoseGraphEdges(
        i=edges.i.at[slot].set(i, mode="drop"),
        j=edges.j.at[slot].set(j, mode="drop"),
        rel_q=edges.rel_q.at[slot].set(rel.q, mode="drop"),
        rel_t=edges.rel_t.at[slot].set(rel.t, mode="drop"),
        weight=edges.weight.at[slot].set(weight, mode="drop"),
        is_loop=edges.is_loop.at[slot].set(is_loop, mode="drop"),
    )


def refresh_odometry_edges(edges: PoseGraphEdges, kf_q: Array,
                           kf_t: Array) -> PoseGraphEdges:
    """Re-measure non-loop edges from the current keyframe poses.

    Local/global BA keeps refining keyframe poses after an odometry edge
    was recorded, so its creation-time measurement goes stale; optimizing
    against it would snap the graph back to raw odometry and destroy the
    BA refinement.  Loop-closure edges keep their stored measurements —
    they are the new information PGO distributes along the chain."""
    pi = Pose(q=kf_q[edges.i], t=kf_t[edges.i])
    pj = Pose(q=kf_q[edges.j], t=kf_t[edges.j])
    cur = pose_compose(pose_inverse(pi), pj)
    keep = edges.is_loop[:, None]
    return edges._replace(
        rel_q=jnp.where(keep, edges.rel_q, cur.q),
        rel_t=jnp.where(keep, edges.rel_t, cur.t),
    )


def _edge_residual(qi, ti, qj, tj, rq, rt, xi_i, xi_j):
    """Residual for one edge with local deltas applied."""
    Ti = pose_retract(Pose(q=qi, t=ti), xi_i)
    Tj = pose_retract(Pose(q=qj, t=tj), xi_j)
    Z = Pose(q=rq, t=rt)
    err = pose_compose(pose_inverse(Z), pose_compose(pose_inverse(Ti), Tj))
    return se3_log(err)


def optimize_pose_graph(
    kf_q: Array, kf_t: Array, kf_valid: Array,
    edges: PoseGraphEdges,
    iters: int = 20,
    damping: float = 1e-6,
    cg_iters: int = 32,
) -> Tuple[Array, Array, Array]:
    """-> (kf_q, kf_t, final_cost).  Node 0 is the gauge anchor.

    The GN normal system is applied MATRIX-FREE: each H·x is two edge
    gathers + per-edge 6x6 einsums + two segment-sums back to nodes,
    solved by block-Jacobi PCG — the earlier dense formulation built a
    [6K, 6K] Hessian with zipped 2-D block scatter-adds and ran a
    dense solve per GN iteration."""
    from jax.ops import segment_sum

    from modular_slam_tpu.backend.cg import pcg

    K = kf_q.shape[0]
    free = kf_valid & (jnp.arange(K) != 0)

    zero6 = jnp.zeros(6)

    res_fn = lambda qi, ti, qj, tj, rq, rt, xi, xj: _edge_residual(
        qi, ti, qj, tj, rq, rt, xi, xj)
    Ji_fn = jax.vmap(jax.jacfwd(res_fn, argnums=6),
                     in_axes=(0, 0, 0, 0, 0, 0, None, None))
    Jj_fn = jax.vmap(jax.jacfwd(res_fn, argnums=7),
                     in_axes=(0, 0, 0, 0, 0, 0, None, None))
    r_fn = jax.vmap(res_fn, in_axes=(0, 0, 0, 0, 0, 0, None, None))

    def gn_step(carry, _):
        q, t, cost_prev = carry
        qi, ti = q[edges.i], t[edges.i]
        qj, tj = q[edges.j], t[edges.j]

        r = r_fn(qi, ti, qj, tj, edges.rel_q, edges.rel_t, zero6, zero6)
        Ji = Ji_fn(qi, ti, qj, tj, edges.rel_q, edges.rel_t, zero6, zero6)
        Jj = Jj_fn(qi, ti, qj, tj, edges.rel_q, edges.rel_t, zero6, zero6)

        w = edges.weight
        # mask fixed nodes' jacobians
        Ji = Ji * free[edges.i][:, None, None]
        Jj = Jj * free[edges.j][:, None, None]

        wJi = Ji * w[:, None, None]
        wJj = Jj * w[:, None, None]

        b = (segment_sum(-jnp.einsum("eki,ek->ei", wJi, r), edges.i,
                         num_segments=K)
             + segment_sum(-jnp.einsum("eki,ek->ei", wJj, r), edges.j,
                           num_segments=K))

        def matvec(x_flat):
            x = x_flat.reshape(K, 6)
            a = (jnp.einsum("eki,ei->ek", Ji, x[edges.i])
                 + jnp.einsum("eki,ei->ek", Jj, x[edges.j]))   # [E, 6]
            y = (segment_sum(jnp.einsum("eki,ek->ei", wJi, a), edges.i,
                             num_segments=K)
                 + segment_sum(jnp.einsum("eki,ek->ei", wJj, a),
                               edges.j, num_segments=K))
            # damping on free nodes; identity on fixed (keeps H s.p.d.)
            y = jnp.where(free[:, None], y + damping * x, x)
            return y.reshape(-1)

        # block-Jacobi preconditioner from the node-diagonal 6x6 blocks
        D = (segment_sum(jnp.einsum("eki,ekj->eij", wJi, Ji), edges.i,
                         num_segments=K)
             + segment_sum(jnp.einsum("eki,ekj->eij", wJj, Jj), edges.j,
                           num_segments=K))
        D = D + (damping + 1e-8) * jnp.eye(6)[None]
        Dinv = jnp.linalg.inv(D)                               # [K, 6, 6]

        def precond(x_flat):
            x = x_flat.reshape(K, 6)
            y = jnp.einsum("kij,kj->ki", Dinv, x)
            return jnp.where(free[:, None], y, x).reshape(-1)

        b = b * free[:, None]
        dx_flat, _cg_res = pcg(matvec, b.reshape(-1), precond, cg_iters)
        dx = dx_flat.reshape(K, 6) * free[:, None]

        new = pose_retract(Pose(q=q, t=t), dx)
        q_new = quat_normalize(new.q)
        t_new = new.t

        r_new = r_fn(q_new[edges.i], t_new[edges.i], q_new[edges.j],
                     t_new[edges.j], edges.rel_q, edges.rel_t, zero6, zero6)
        cost_new = jnp.sum(w * jnp.sum(r_new * r_new, axis=-1))
        cost_old = jnp.sum(w * jnp.sum(r * r, axis=-1))
        accept = cost_new < cost_old
        q_out = jnp.where(accept, q_new, q)
        t_out = jnp.where(accept, t_new, t)
        return (q_out, t_out, jnp.where(accept, cost_new, cost_old)), None

    r0 = r_fn(kf_q[edges.i], kf_t[edges.i], kf_q[edges.j], kf_t[edges.j],
              edges.rel_q, edges.rel_t, zero6, zero6)
    cost0 = jnp.sum(edges.weight * jnp.sum(r0 * r0, axis=-1))
    (q, t, cost), _ = lax.scan(gn_step, (kf_q, kf_t, cost0), None,
                               length=iters)
    return q, t, cost


def correct_landmarks(
    lm_pos: Array, lm_valid: Array,
    anchor_kf: Array,              # [L] int32 — anchor keyframe per landmark
    old_q: Array, old_t: Array,    # poses before PGO
    new_q: Array, new_t: Array,    # poses after PGO
) -> Array:
    """Move landmarks rigidly with their anchor keyframes:
    l' = T_new * T_old^-1 * l (standard post-PGO map correction)."""
    old = Pose(q=old_q[anchor_kf], t=old_t[anchor_kf])
    new = Pose(q=new_q[anchor_kf], t=new_t[anchor_kf])
    delta = pose_compose(new, pose_inverse(old))
    from modular_slam_tpu.geometry.se3 import pose_apply

    moved = pose_apply(delta, lm_pos)
    return jnp.where(lm_valid[:, None], moved, lm_pos)
