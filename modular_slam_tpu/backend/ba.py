"""Levenberg-Marquardt bundle adjustment with Schur-complement landmark
elimination — the rebuilt (and actually enabled) version of the
reference's CeresBackend (/root/reference/src/lib/modular_slam/
ceres_backend.cpp — dead behind the early return at :95).

Reference parity: 3D point-to-point residual (:19-60), gauge fixed at the
first keyframe (:155-159), local BA over the 1-hop covisibility window of
a new keyframe (:162-171), global BA over the whole graph (:173-183),
outlier classification at residual > 0.15 m (:204-240).

Accelerator design (SURVEY.md §7 step 7, north star):
- landmarks are eliminated analytically (block-diagonal 3x3 V), and the
  reduced camera system S = U - W V^-1 W^T is solved **matrix-free** with
  block-Jacobi PCG: each S·x is two segment-sum sweeps over the
  observation list — pure gather/scatter + small einsums, which is
  exactly the form that shards over a device mesh with one psum per sweep
  (parallel/sharded_ba.py);
- the LM loop is a fixed-length lax.scan with accept/reject damping —
  statically shaped, no host sync;
- robust Huber IRLS weights (delta = BackendConfig.huber_delta).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.ops import segment_sum

from modular_slam_tpu.backend.cg import pcg
from modular_slam_tpu.backend.residuals import (
    ObsData,
    gather_obs,
    huber_weights,
    point2point_residuals,
    reprojection_residuals,
    rgbd_residuals,
)
from modular_slam_tpu.config import SlamConfig
from modular_slam_tpu.frontend.tracker import TrackState
from modular_slam_tpu.geometry.camera import Camera, camera_from_config
from modular_slam_tpu.geometry.se3 import (
    Pose,
    pose_compose,
    pose_inverse,
    quat_normalize,
    quat_to_matrix,
    se3_exp,
)
from modular_slam_tpu.utils.indices import masked_indices
from modular_slam_tpu.map.arena import (
    MapArena,
    khop_keyframes,
    visible_landmarks,
)

Array = jnp.ndarray


class BAStats(NamedTuple):
    initial_cost: Array
    final_cost: Array
    n_active_obs: Array
    n_outliers: Array
    cg_residual: Array


def _stall_update(stall: Array, accept: Array, improved: Array) -> Array:
    """Early-stop stall counter for the LM while_loop.

    A stall is an ACCEPTED step whose cost improvement fell below rtol —
    i.e. true convergence.  REJECTED steps are lambda adaptation: cost is
    unchanged but the optimizer is still searching, so they leave the
    counter untouched (advisor r4 medium: counting rejections used to
    exit after two initial rejections with near-zero optimization when
    init_lambda undershot on a large loop correction).  An improving step
    resets the counter.  `improved` implies `accept` (improvement is a
    strict cost decrease beyond the accept test's plain decrease).
    """
    return jnp.where(improved, 0,
                     jnp.where(accept, stall + 1, stall))


def _huber_cost(r: Array, delta: float, w: Array) -> Array:
    n = jnp.linalg.norm(r, axis=-1)
    rho = jnp.where(n <= delta, 0.5 * n * n, delta * (n - 0.5 * delta))
    return jnp.sum(rho * w)


def _inv3x3(M: Array) -> Array:
    """Batched 3x3 inverse via adjugate (cheaper than LU for [L,3,3])."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    adj = jnp.stack([A, B, C, D, E, F, G, H, I], axis=-1)
    return adj.reshape(*M.shape[:-2], 3, 3) * inv_det[..., None, None]


def ba_core(
    cam: Camera,
    kf_q_wc: Array, kf_t_wc: Array,     # [K,4],[K,3] camera-to-world
    lm_pos: Array,                      # [L,3]
    obs: ObsData,                       # weights already encode activity
    pose_free: Array,                   # [K] bool
    lm_free: Array,                     # [L] bool
    cfg,                                # BackendConfig
    residual_type: str = "p2p",
    allreduce: Callable[[Array], Array] = lambda x: x,
    early_stop_rtol: Optional[float] = None,
) -> Tuple[Array, Array, Array, BAStats]:
    """Run LM; returns (kf_q_wc, kf_t_wc, lm_pos, stats).

    `allreduce` is applied to every observation-reduction (the segment
    sums and scalar costs).  With the identity it is the single-device
    path; under shard_map with `lambda x: lax.psum(x, "obs")` the same
    code runs with observations sharded across a mesh axis — the
    distributed Schur-complement reduction of the north star.

    `early_stop_rtol`: when set, the LM loop runs as a device-side
    lax.while_loop that exits after TWO consecutive steps improving the
    cost by less than rtol (relative) — converged loop-closure polish
    passes stop in a few iterations instead of paying the full static
    budget.  The stop decision depends only on the allreduced cost, so
    it is identical across devices under shard_map.
    """
    K = kf_q_wc.shape[0]
    L = lm_pos.shape[0]

    tcw0 = pose_inverse(Pose(q=kf_q_wc, t=kf_t_wc))
    # huber deltas live in residual units: meters (p2p) vs pixels
    delta = cfg.huber_delta if residual_type == "p2p" else cfg.huber_delta_px

    def residuals(q_cw, t_cw, lm):
        R = quat_to_matrix(q_cw)
        if residual_type == "p2p":
            return point2point_residuals(R, t_cw, lm, obs)
        if residual_type == "rgbd":
            return rgbd_residuals(cam, R, t_cw, lm, obs,
                                  depth_weight=cfg.depth_weight)
        return reprojection_residuals(cam, R, t_cw, lm, obs)

    pf_obs = pose_free[obs.kf].astype(jnp.float32)
    lf_obs = lm_free[obs.lm].astype(jnp.float32)

    def cost_of(q_cw, t_cw, lm):
        r, _, _ = residuals(q_cw, t_cw, lm)
        return allreduce(_huber_cost(r, delta, obs.w))

    def lm_step(carry, _):
        q_cw, t_cw, lm, lam, cost = carry
        r, Jp, Jl = residuals(q_cw, t_cw, lm)
        w = huber_weights(r, delta, obs.w)
        # zero out jacobians of fixed params (their residuals still
        # constrain the free ones)
        Jp = Jp * pf_obs[:, None, None]
        Jl = Jl * lf_obs[:, None, None]

        wJp = Jp * w[:, None, None]
        U = allreduce(segment_sum(
            jnp.einsum("oki,okj->oij", wJp, Jp), obs.kf, num_segments=K
        ))  # [K,6,6]
        V = allreduce(segment_sum(
            jnp.einsum("oki,okj->oij", Jl * w[:, None, None], Jl),
            obs.lm, num_segments=L,
        ))  # [L,3,3]
        b_p = -allreduce(segment_sum(
            jnp.einsum("oki,ok->oi", wJp, r), obs.kf, num_segments=K
        ))  # [K,6]
        b_l = -allreduce(segment_sum(
            jnp.einsum("oki,ok->oi", Jl * w[:, None, None], r),
            obs.lm, num_segments=L,
        ))  # [L,3]

        eyeK = jnp.eye(6)
        eyeL = jnp.eye(3)
        Ud = U + lam * U * eyeK + 1e-8 * eyeK          # Marquardt damping
        Vd = V + lam * V * eyeL + 1e-8 * eyeL
        Vinv = _inv3x3(Vd)

        def matvec(x_flat):
            x = x_flat.reshape(K, 6)
            ux = jnp.einsum("kij,kj->ki", Ud, x)
            a = jnp.einsum("oki,oi->ok", Jp, x[obs.kf])          # [O,d]
            zb = allreduce(segment_sum(
                jnp.einsum("oki,ok->oi", Jl * w[:, None, None], a),
                obs.lm, num_segments=L,
            ))                                                   # [L,3]
            y = jnp.einsum("lij,lj->li", Vinv, zb)
            c = jnp.einsum("oki,oi->ok", Jl, y[obs.lm])          # [O,d]
            wx = allreduce(segment_sum(
                jnp.einsum("oki,ok->oi", wJp, c), obs.kf, num_segments=K
            ))                                                   # [K,6]
            return (ux - wx).reshape(-1)

        # rhs = b_p - W Vinv b_l
        y0 = jnp.einsum("lij,lj->li", Vinv, b_l)
        c0 = jnp.einsum("oki,oi->ok", Jl, y0[obs.lm])
        rhs = b_p - allreduce(segment_sum(
            jnp.einsum("oki,ok->oi", wJp, c0), obs.kf, num_segments=K
        ))

        Uinv = jnp.linalg.inv(Ud + 1e-6 * eyeK)

        def precond(x_flat):
            x = x_flat.reshape(K, 6)
            return jnp.einsum("kij,kj->ki", Uinv, x).reshape(-1)

        dp_flat, cg_res = pcg(matvec, rhs.reshape(-1), precond, cfg.cg_iters)
        dp = dp_flat.reshape(K, 6) * pose_free[:, None]

        # back-substitute landmarks
        a2 = jnp.einsum("oki,oi->ok", Jp, dp[obs.kf])
        z2 = allreduce(segment_sum(
            jnp.einsum("oki,ok->oi", Jl * w[:, None, None], a2),
            obs.lm, num_segments=L,
        ))
        dl = jnp.einsum("lij,lj->li", Vinv, b_l - z2) * lm_free[:, None]

        # tentative update
        dpose = se3_exp(dp)
        tcw_new = pose_compose(dpose, Pose(q=q_cw, t=t_cw))
        lm_new = lm + dl
        new_cost = cost_of(tcw_new.q, tcw_new.t, lm_new)

        accept = new_cost < cost
        q_out = jnp.where(accept, tcw_new.q, q_cw)
        t_out = jnp.where(accept, tcw_new.t, t_cw)
        lm_out = jnp.where(accept, lm_new, lm)
        cost_out = jnp.where(accept, new_cost, cost)
        lam_out = jnp.where(
            accept, lam * cfg.lambda_down, lam * cfg.lambda_up
        )
        lam_out = jnp.clip(lam_out, 1e-9, 1e6)
        return (q_out, t_out, lm_out, lam_out, cost_out), (cg_res, accept)

    cost0 = cost_of(tcw0.q, tcw0.t, lm_pos)
    init = (tcw0.q, tcw0.t, lm_pos, jnp.float32(cfg.init_lambda), cost0)
    if early_stop_rtol is None:
        (q_cw, t_cw, lm_out, _, cost_end), (cg_hist, _) = lax.scan(
            lm_step, init, None, length=cfg.max_iterations
        )
        cg_last = cg_hist[-1]
    else:
        rtol = jnp.float32(early_stop_rtol)

        def w_cond(carry):
            i, stall, _state, _cg = carry
            return (i < cfg.max_iterations) & (stall < 2)

        def w_body(carry):
            i, stall, state, _cg = carry
            prev_cost = state[4]
            state, (cg_res, accept) = lm_step(state, None)
            improved = state[4] < prev_cost * (1.0 - rtol)
            stall = _stall_update(stall, accept, improved)
            return i + 1, stall, state, cg_res

        _, _, (q_cw, t_cw, lm_out, _, cost_end), cg_last = lax.while_loop(
            w_cond, w_body, (jnp.int32(0), jnp.int32(0), init,
                             jnp.float32(0.0)))

    wc = pose_inverse(Pose(q=quat_normalize(q_cw), t=t_cw))

    stats = BAStats(
        initial_cost=cost0,
        final_cost=cost_end,
        n_active_obs=allreduce(jnp.sum((obs.w > 0).astype(jnp.int32))),
        n_outliers=jnp.int32(0),
        cg_residual=cg_last,
    )
    return wc.q, wc.t, lm_out, stats


def ba_solve(
    cam: Camera,
    arena: MapArena,
    pose_free: Array,
    lm_free: Array,
    obs_active: Array,
    cfg,                       # BackendConfig
    residual_type: str = "p2p",
) -> Tuple[MapArena, BAStats]:
    """Bundle-adjust the arena in place (functionally)."""
    obs = gather_obs(cam, arena, obs_active)
    kf_q, kf_t, lm_pos, stats = ba_core(
        cam, arena.kf_q, arena.kf_t, arena.lm_pos, obs,
        pose_free & arena.kf_valid, lm_free & arena.lm_valid,
        cfg, residual_type,
    )

    # outlier classification at the optimized state
    # (reference threshold: squared residual > 0.15^2, ceres_backend.cpp:212)
    R = quat_to_matrix(pose_inverse(Pose(q=kf_q, t=kf_t)).q)
    tcw = pose_inverse(Pose(q=kf_q, t=kf_t)).t
    from modular_slam_tpu.backend.residuals import point2point_residuals as p2p

    r, _, _ = p2p(R, tcw, lm_pos, obs)
    bad = (obs.w > 0) & (jnp.sum(r * r, axis=-1) > cfg.outlier_threshold_m ** 2)
    obs_valid = arena.obs_valid & ~bad
    # clear incidence bits of removed observations
    inc = arena.inc.at[
        jnp.where(bad, arena.obs_kf, arena.max_keyframes),
        jnp.where(bad, arena.obs_lm, arena.max_landmarks),
    ].set(False, mode="drop")

    arena = arena._replace(
        kf_q=kf_q, kf_t=kf_t, lm_pos=lm_pos,
        obs_valid=obs_valid, inc=inc,
    )
    stats = stats._replace(n_outliers=jnp.sum(bad.astype(jnp.int32)))
    return arena, stats


def ba_core_dense(
    cam: Camera,
    kf_q_wc: Array, kf_t_wc: Array,     # [K,4],[K,3] camera-to-world
    lm_pos: Array,                      # [L,3]
    obs: ObsData,
    pose_free: Array,                   # [K] bool
    lm_free: Array,                     # [L] bool
    cfg,                                # BackendConfig
    residual_type: str = "p2p",
) -> Tuple[Array, Array, Array, BAStats]:
    """LM with a DENSE materialized Schur complement — for compacted
    local windows (K small) — the windowed analogue of Ceres'
    SPARSE_NORMAL_CHOLESKY direct solve (ceres_backend.cpp:193-198).

    Dense-grid formulation: observation payloads are scattered ONCE
    into a dense [L, K] grid (absent pairs weight 0); every LM iteration
    is then pure dense math — elementwise residual/Jacobian evaluation
    over the grid plus einsum contractions and one [6K, 6K] solve.  No
    scatter / segment_sum / gather appears inside the loop (the
    per-observation segment-sum assembly it replaced has 65 536 (kf,lm)
    segments at the default caps).  Whether the grid or segment_sum is
    faster on the GPU is an open measurement (ROADMAP speed 7)."""
    K = kf_q_wc.shape[0]
    L = lm_pos.shape[0]

    tcw0 = pose_inverse(Pose(q=kf_q_wc, t=kf_t_wc))
    delta = cfg.huber_delta if residual_type == "p2p" else cfg.huber_delta_px

    # --- one-time dense (l, k)-grid layout of the observations ----------
    # (one (kf,lm) pair holds at most one observation by construction —
    # add_observations records each landmark once per keyframe)
    l_sc = jnp.where(obs.w > 0, obs.lm, L)     # invalid rows -> dropped
    k_sc = jnp.where(obs.w > 0, obs.kf, K)
    w_g = jnp.zeros((L, K), jnp.float32).at[l_sc, k_sc].set(
        obs.w, mode="drop")
    p_g = jnp.zeros((L, K, 3), jnp.float32).at[l_sc, k_sc].set(
        obs.p_obs, mode="drop")
    uv_g = jnp.zeros((L, K, 2), jnp.float32).at[l_sc, k_sc].set(
        obs.uv, mode="drop")

    from modular_slam_tpu.backend.residuals import (
        point2point_residuals_grid,
        reprojection_residuals_grid,
        rgbd_residuals_grid,
    )

    def residuals(q_cw, t_cw, lm):
        # grid-native forms: kf/lm indexing is broadcast, not gather
        R = quat_to_matrix(q_cw)
        if residual_type == "p2p":
            return point2point_residuals_grid(R, t_cw, lm, p_g)
        if residual_type == "rgbd":
            return rgbd_residuals_grid(cam, R, t_cw, lm, p_g, uv_g,
                                       depth_weight=cfg.depth_weight)
        return reprojection_residuals_grid(cam, R, t_cw, lm, p_g, uv_g)

    pf_g = pose_free.astype(jnp.float32)[None, :]         # [1,K]
    lf_g = lm_free.astype(jnp.float32)[:, None]           # [L,1]

    def cost_of(q_cw, t_cw, lm):
        r, _, _ = residuals(q_cw, t_cw, lm)
        return _huber_cost(r, delta, w_g)

    def lm_step(carry, _):
        q_cw, t_cw, lm, lam, cost = carry
        rw, Jp, Jl = residuals(q_cw, t_cw, lm)            # [L,K,d,...]
        w = huber_weights(rw, delta, w_g)                 # [L,K]
        Jpr = Jp * pf_g[:, :, None, None]
        Jlr = Jl * lf_g[:, :, None, None]
        Jpw = Jpr * w[:, :, None, None]                   # weighted Jp
        Jlw = Jlr * w[:, :, None, None]

        U = jnp.einsum("lkdi,lkdj->kij", Jpw, Jpr)        # [K,6,6]
        V = jnp.einsum("lkdi,lkdj->lij", Jlw, Jlr)        # [L,3,3]
        W = jnp.einsum("lkdi,lkdj->klij", Jpw, Jlr)       # [K,L,6,3]
        b_p = -jnp.einsum("lkdi,lkd->ki", Jpw, rw)        # [K,6]
        b_l = -jnp.einsum("lkdi,lkd->li", Jlw, rw)        # [L,3]

        eyeK, eyeL = jnp.eye(6), jnp.eye(3)
        Ud = U + lam * U * eyeK + 1e-8 * eyeK
        Vd = V + lam * V * eyeL + 1e-8 * eyeL
        Vinv = _inv3x3(Vd)

        WVi = jnp.einsum("klim,lmn->klin", W, Vinv)        # [K,L,6,3]
        S = -jnp.einsum("alin,bljn->aibj", WVi, W)         # [K,6,K,6]
        S = S.reshape(K * 6, K * 6)
        idx = jnp.arange(K * 6).reshape(K, 6)
        S = S.at[idx[:, :, None], idx[:, None, :]].add(Ud)
        rhs = (b_p - jnp.einsum("klin,ln->ki", WVi, b_l)).reshape(-1)

        # fixed poses: identity rows/cols force dx = 0
        free6 = jnp.repeat(pose_free, 6)
        S = jnp.where(free6[:, None] & free6[None, :], S, 0.0)
        S = S + jnp.diag(jnp.where(free6, 0.0, 1.0))
        rhs = jnp.where(free6, rhs, 0.0)

        dp = jnp.linalg.solve(S, rhs).reshape(K, 6)
        dp = dp * pose_free[:, None]

        # back-substitute landmarks (dense grid: no segment ops)
        a2 = jnp.einsum("lkdi,ki->lkd", Jpr, dp)
        z2 = jnp.einsum("lkdi,lkd->li", Jlw, a2)
        dl = jnp.einsum("lij,lj->li", Vinv, b_l - z2) * lm_free[:, None]

        dpose = se3_exp(dp)
        tcw_new = pose_compose(dpose, Pose(q=q_cw, t=t_cw))
        lm_new = lm + dl
        new_cost = cost_of(tcw_new.q, tcw_new.t, lm_new)

        accept = new_cost < cost
        q_out = jnp.where(accept, tcw_new.q, q_cw)
        t_out = jnp.where(accept, tcw_new.t, t_cw)
        lm_out = jnp.where(accept, lm_new, lm)
        cost_out = jnp.where(accept, new_cost, cost)
        lam_out = jnp.where(accept, lam * cfg.lambda_down,
                            lam * cfg.lambda_up)
        lam_out = jnp.clip(lam_out, 1e-9, 1e6)
        # converged: an ACCEPTED step improved the cost by < ftol (Ceres'
        # function_tolerance stop, the part a fixed-length scan cannot do)
        done = accept & (cost - new_cost <= 1e-5 * cost)
        return q_out, t_out, lm_out, lam_out, cost_out, done

    cost0 = cost_of(tcw0.q, tcw0.t, lm_pos)

    # lax.while_loop: device-side early exit — local windows typically
    # converge in ~4-6 iterations, and per-keyframe BA latency is on the
    # tracking critical path
    def w_cond(carry):
        it, done, *_ = carry
        return (~done) & (it < cfg.max_iterations)

    def w_body(carry):
        it, _, q_cw, t_cw, lm, lam, cost = carry
        q_cw, t_cw, lm, lam, cost, done = lm_step(
            (q_cw, t_cw, lm, lam, cost), None)
        return (it + 1, done, q_cw, t_cw, lm, lam, cost)

    init = (jnp.int32(0), jnp.array(False), tcw0.q, tcw0.t, lm_pos,
            jnp.float32(cfg.init_lambda), cost0)
    _, _, q_cw, t_cw, lm_out, _, cost_end = lax.while_loop(
        w_cond, w_body, init)

    wc = pose_inverse(Pose(q=quat_normalize(q_cw), t=t_cw))
    stats = BAStats(
        initial_cost=cost0,
        final_cost=cost_end,
        n_active_obs=jnp.sum((obs.w > 0).astype(jnp.int32)),
        n_outliers=jnp.int32(0),
        cg_residual=jnp.float32(0.0),
    )
    return wc.q, wc.t, lm_out, stats


# ---------------------------------------------------------------------------
# windowed local BA: extract -> solve -> merge
#
# Split into three pure stages so the solve can run on a DIFFERENT device
# than tracking (backend/executor.py offloads it to the host CPU and
# overlaps it with the next chunk's tracking — the reference's intended
# async backend, slam.hpp:94 "TODO: run as std::async").  The sync path
# (make_local_ba) fuses all three under one jit.
# ---------------------------------------------------------------------------


class WindowProblem(NamedTuple):
    """A compacted local-BA window + the index maps needed to merge the
    solution back into the (possibly meanwhile-advanced) arena.  Slots
    are append-only, so the merge scatter stays exact even after new
    keyframes/landmarks were appended while the solve was in flight."""

    kf_q: Array        # [Kc, 4] window keyframe poses (camera-to-world)
    kf_t: Array        # [Kc, 3]
    lm_pos: Array      # [Lc, 3]
    obs: ObsData       # [Oc] compacted observations (local indices)
    pose_free: Array   # [Kc] bool (slot 0 = gauge, held fixed)
    kf_ok: Array       # [Kc] bool — which window slots are real
    lm_ok: Array       # [Lc] bool
    kf_idx: Array      # [Kc] global keyframe slots (K = invalid)
    lm_idx: Array      # [Lc] global landmark slots (L = invalid)
    obs_idx: Array     # [Oc] global observation rows (O = invalid)
    obs_kf_g: Array    # [Oc] global kf slot per obs (for incidence clear)
    obs_lm_g: Array    # [Oc] global lm slot per obs


class WindowSolution(NamedTuple):
    kf_q: Array        # [Kc, 4] optimized window poses
    kf_t: Array        # [Kc, 3]
    lm_pos: Array      # [Lc, 3]
    bad: Array         # [Oc] bool — outlier observations to invalidate


def extract_window(cam: Camera, arena: MapArena, kf_slot: Array,
                   bcfg) -> WindowProblem:
    """Compact the new keyframe's covisibility window into small static
    buffers (local_*_cap) so BA cost scales with the window, not the
    arena capacity.  Window semantics match the reference's CeresVisitor:
    only observations *from window keyframes* enter the problem
    (basic_map.cpp:166-183)."""
    K, L, O = (arena.max_keyframes, arena.max_landmarks,
               arena.max_observations)
    Kc = min(bcfg.local_kf_cap, K)
    Lc = min(bcfg.local_lm_cap, L)
    Oc = min(bcfg.local_obs_cap, O)

    window = khop_keyframes(arena, kf_slot, bcfg.local_window_depth)
    window = window & arena.kf_valid
    lm_active = visible_landmarks(arena, window)
    obs_active = (arena.obs_valid & window[arena.obs_kf]
                  & lm_active[arena.obs_lm])

    # keyframe slots are append-only, so slot order == recency.  When
    # the covisibility window exceeds Kc, keep the Kc NEWEST slots
    # (a plain nonzero(size=Kc) would keep the lowest slots and
    # silently drop the keyframe whose insertion triggered this BA —
    # advisor round-2 finding).  dynamic_slice of the full ascending
    # index list keeps the result ascending, so local slot 0 stays
    # the oldest *selected* keyframe (the gauge).
    idx_all = masked_indices(window, K)
    n_w = jnp.sum(window.astype(jnp.int32))
    start = jnp.maximum(n_w - Kc, 0)
    kf_idx = lax.dynamic_slice(idx_all, (start,), (Kc,))
    lm_idx = masked_indices(lm_active, Lc)
    obs_idx = masked_indices(obs_active, Oc)
    kf_ok = kf_idx < K
    lm_ok = lm_idx < L

    inv_kf = jnp.full((K,), Kc, jnp.int32).at[kf_idx].set(
        jnp.arange(Kc, dtype=jnp.int32), mode="drop")
    inv_lm = jnp.full((L,), Lc, jnp.int32).at[lm_idx].set(
        jnp.arange(Lc, dtype=jnp.int32), mode="drop")

    kf_g = jnp.clip(kf_idx, 0, K - 1)
    lm_g = jnp.clip(lm_idx, 0, L - 1)
    obs_g = jnp.clip(obs_idx, 0, O - 1)

    obs_kf_g = arena.obs_kf[obs_g]
    obs_lm_g = arena.obs_lm[obs_g]
    o_kf = inv_kf[obs_kf_g]
    o_lm = inv_lm[obs_lm_g]
    ok = (obs_idx < O) & (o_kf < Kc) & (o_lm < Lc)
    uv = arena.obs_uv[obs_g]
    depth = arena.obs_depth[obs_g]
    from modular_slam_tpu.geometry.camera import backproject

    obs = ObsData(
        kf=jnp.where(ok, o_kf, 0),
        lm=jnp.where(ok, o_lm, 0),
        p_obs=backproject(cam, uv, depth),
        uv=uv,
        w=ok.astype(jnp.float32),
    )
    # gauge: local slot 0 = oldest SELECTED window keyframe
    pose_free = kf_ok & (jnp.arange(Kc) != 0)
    return WindowProblem(
        kf_q=arena.kf_q[kf_g], kf_t=arena.kf_t[kf_g],
        lm_pos=arena.lm_pos[lm_g], obs=obs,
        pose_free=pose_free, kf_ok=kf_ok, lm_ok=lm_ok,
        kf_idx=kf_idx, lm_idx=lm_idx, obs_idx=obs_idx,
        obs_kf_g=obs_kf_g, obs_lm_g=obs_lm_g,
    )


def solve_window(cam: Camera, prob: WindowProblem, bcfg) -> WindowSolution:
    """Dense-Schur LM on the compacted window + outlier classification
    (reference threshold: squared residual > 0.15^2, ceres_backend.cpp
    :212).  Pure function of the problem — runs on whatever device its
    inputs live on."""
    q_n, t_n, lm_n, _ = ba_core_dense(
        cam, prob.kf_q, prob.kf_t, prob.lm_pos, prob.obs,
        prob.pose_free, prob.lm_ok, bcfg,
        residual_type=bcfg.local_residual,
    )
    tcw = pose_inverse(Pose(q=q_n, t=t_n))
    R = quat_to_matrix(tcw.q)
    r, _, _ = point2point_residuals(R, tcw.t, lm_n, prob.obs)
    bad = ((prob.obs.w > 0)
           & (jnp.sum(r * r, axis=-1) > bcfg.outlier_threshold_m ** 2))
    return WindowSolution(kf_q=q_n, kf_t=t_n, lm_pos=lm_n, bad=bad)


def merge_window(arena: MapArena, state: TrackState, prob: WindowProblem,
                 sol: WindowSolution) -> Tuple[MapArena, TrackState]:
    """Scatter an optimized window back into the arena.

    The current sensor pose receives the RELATIVE world-side correction
    of the window's newest keyframe, D = P_new ∘ P_old⁻¹ — when merging
    immediately after the solve (sync path) this equals "pose = optimized
    keyframe pose"; when merging after frames tracked during an async
    flight, it carries the BA correction forward through the odometry
    accumulated since (the same rule loop-closure corrections use)."""
    K, L, O = (arena.max_keyframes, arena.max_landmarks,
               arena.max_observations)
    Kc = prob.kf_idx.shape[0]

    bad_slot = jnp.where(sol.bad, prob.obs_idx, O)
    obs_valid = arena.obs_valid.at[bad_slot].set(False, mode="drop")
    inc = arena.inc.at[
        jnp.where(sol.bad, prob.obs_kf_g, K),
        jnp.where(sol.bad, prob.obs_lm_g, L),
    ].set(False, mode="drop")

    # pose delta of the newest window keyframe: old -> optimized
    n_valid = jnp.sum(prob.kf_ok.astype(jnp.int32))
    newest = jnp.clip(n_valid - 1, 0, Kc - 1)
    old = Pose(q=prob.kf_q[newest], t=prob.kf_t[newest])
    new = Pose(q=sol.kf_q[newest], t=sol.kf_t[newest])
    delta = pose_compose(new, pose_inverse(old))
    corrected = pose_compose(delta, state.pose)
    has_kf = n_valid > 0
    state = state._replace(pose=Pose(
        q=jnp.where(has_kf, corrected.q, state.pose.q),
        t=jnp.where(has_kf, corrected.t, state.pose.t),
    ))

    arena = arena._replace(
        kf_q=arena.kf_q.at[prob.kf_idx].set(sol.kf_q, mode="drop"),
        kf_t=arena.kf_t.at[prob.kf_idx].set(sol.kf_t, mode="drop"),
        lm_pos=arena.lm_pos.at[prob.lm_idx].set(sol.lm_pos, mode="drop"),
        obs_valid=obs_valid,
        inc=inc,
    )
    return arena, state


def make_local_ba(cfg: SlamConfig) -> Callable:
    """Synchronous local BA over the new keyframe's 1-hop covisibility
    window (ceres_backend.cpp:162-171 intent): extract + solve + merge
    fused under one jit.  Returns fn(arena, state, kf_slot) ->
    (arena, state).  Gauge: the oldest keyframe in the window is held
    fixed — a superset of the reference's fix-keyframe-1 rule
    (ceres_backend.cpp:155-159), which leaves the problem gauge-free
    whenever keyframe 1 is outside the window."""
    import dataclasses

    cam = camera_from_config(cfg.camera)
    bcfg = dataclasses.replace(
        cfg.backend, max_iterations=cfg.backend.local_max_iterations)

    def local_ba(arena: MapArena, state: TrackState, kf_slot: Array):
        prob = extract_window(cam, arena, kf_slot, bcfg)
        sol = solve_window(cam, prob, bcfg)
        return merge_window(arena, state, prob, sol)

    return jax.jit(local_ba, donate_argnums=(0,))


def make_global_ba(cfg: SlamConfig) -> Callable:
    """Global BA over every valid keyframe (ceres_backend.cpp:173-183
    intent).  Returns jitted fn(arena) -> (arena, stats).

    Full-capacity sweep — prefer `make_global_ba_compact` (used by the
    loop pipeline), which scales the solve with the live map instead of
    the arena capacity."""
    cam = camera_from_config(cfg.camera)
    bcfg = cfg.backend

    def global_ba(arena: MapArena):
        slot0 = jnp.arange(arena.max_keyframes) == 0
        pose_free = arena.kf_valid & ~slot0
        lm_free = arena.lm_valid
        obs_active = arena.obs_valid
        return ba_solve(cam, arena, pose_free, lm_free, obs_active, bcfg,
                        residual_type=bcfg.global_residual)

    return jax.jit(global_ba, donate_argnums=(0,))


def global_ba_tier(arena: MapArena) -> Tuple[int, int, int]:
    """Smallest power-of-two (Kt, Lt, Ot) caps covering the LIVE map —
    ONE host sync for all three counters (separate int() reads would be
    three blocking syncs), done at closure rate only."""
    return global_ba_tier_counts(arena)[0]


def tier_from_counts(counts: Tuple[int, int, int],
                     caps: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Host-pure tier computation from already-fetched counters (the
    engine's compaction check fetches them at keyframe rate — reuse
    avoids extra device->host syncs)."""
    def up(n, lo, hi):
        t = lo
        while t < min(n, hi):
            t *= 2
        return min(t, hi)

    return (up(counts[0], 16, caps[0]),
            up(counts[1], 1024, caps[1]),
            up(counts[2], 4096, caps[2]))


def standard_tier_ladder(caps: Tuple[int, int, int]):
    """The diagonal global-BA tier ladder a growing map walks:
    (16,1024,4096) doubling every axis until all caps saturate.  Used by
    mslam-prewarm to compile the WHOLE ladder ahead of any run (VERDICT
    r4 next #3: the tool used to cover only the first tier)."""
    K, L, O = caps
    ladder = []
    t = (min(16, K), min(1024, L), min(4096, O))
    while True:
        ladder.append(t)
        if t == (K, L, O):
            break
        t = (min(2 * t[0], K), min(2 * t[1], L), min(2 * t[2], O))
    return ladder


def global_ba_tier_counts(arena: MapArena
                          ) -> Tuple[Tuple[int, int, int],
                                     Tuple[int, int, int]]:
    """-> (tier, (n_kf, n_lm, n_obs)) with a single host sync — callers
    that also need the raw counters (successor-tier prediction in
    loop/pipeline.py) avoid a second device->host sync."""
    n_kf, n_lm, n_obs = (int(x) for x in jax.device_get(
        (arena.n_kf, arena.n_lm, arena.n_obs)))
    caps = (arena.max_keyframes, arena.max_landmarks,
            arena.max_observations)
    return tier_from_counts((n_kf, n_lm, n_obs), caps), (n_kf, n_lm, n_obs)


def make_global_ba_compact(cfg: SlamConfig, tier: Tuple[int, int, int]
                           ) -> Callable:
    """Global BA with the problem COMPACTED to static (Kt, Lt, Ot) caps —
    the local-BA compaction trick applied map-wide, so loop-triggered
    global BA costs scale with the live map, not the arena capacity
    (131072 observation slots at the default).  The caller picks `tier`
    from `global_ba_tier` (host counts at keyframe rate); compiled
    instances are cached per tier by the loop pipeline.

    Returns jitted fn(arena) -> (arena, BAStats)."""
    import dataclasses as _dc

    cam = camera_from_config(cfg.camera)
    # loop-GBA budget: PGO already distributed the correction, this is a
    # polish pass — smaller static budget + device-side early exit
    bcfg = _dc.replace(cfg.backend,
                       max_iterations=cfg.backend.gba_max_iterations,
                       cg_iters=cfg.backend.gba_cg_iters)
    Kt, Lt, Ot = tier

    def global_ba(arena: MapArena):
        K, L, O = (arena.max_keyframes, arena.max_landmarks,
                   arena.max_observations)
        kf_act = arena.kf_valid
        lm_act = arena.lm_valid
        obs_act = (arena.obs_valid & kf_act[arena.obs_kf]
                   & lm_act[arena.obs_lm])

        # --- compact to the tier caps (ascending keeps slot 0 = gauge) --
        kf_idx = masked_indices(kf_act, Kt)
        lm_idx = masked_indices(lm_act, Lt)
        obs_idx = masked_indices(obs_act, Ot)
        kf_ok = kf_idx < K
        lm_ok = lm_idx < L
        inv_kf = jnp.full((K,), Kt, jnp.int32).at[kf_idx].set(
            jnp.arange(Kt, dtype=jnp.int32), mode="drop")
        inv_lm = jnp.full((L,), Lt, jnp.int32).at[lm_idx].set(
            jnp.arange(Lt, dtype=jnp.int32), mode="drop")

        kf_g = jnp.clip(kf_idx, 0, K - 1)
        lm_g = jnp.clip(lm_idx, 0, L - 1)
        obs_g = jnp.clip(obs_idx, 0, O - 1)
        kf_q = arena.kf_q[kf_g]
        kf_t = arena.kf_t[kf_g]
        lm_pos = arena.lm_pos[lm_g]

        o_kf = inv_kf[arena.obs_kf[obs_g]]
        o_lm = inv_lm[arena.obs_lm[obs_g]]
        ok = (obs_idx < O) & (o_kf < Kt) & (o_lm < Lt)
        uv = arena.obs_uv[obs_g]
        depth = arena.obs_depth[obs_g]
        from modular_slam_tpu.geometry.camera import backproject

        obs = ObsData(
            kf=jnp.where(ok, o_kf, 0),
            lm=jnp.where(ok, o_lm, 0),
            p_obs=backproject(cam, uv, depth),
            uv=uv,
            w=ok.astype(jnp.float32),
        )

        pose_free = kf_ok & (jnp.arange(Kt) != 0)
        # matrix-free PCG core at global tiers: the [Lt, Kt] grid pads
        # residual work ~Kt-fold vs the real observation count (at
        # local-window shapes the scatter savings win, at tier shapes
        # the padding loses)
        q_n, t_n, lm_n, stats = ba_core(
            cam, kf_q, kf_t, lm_pos, obs, pose_free, lm_ok, bcfg,
            residual_type=bcfg.global_residual,
            early_stop_rtol=bcfg.gba_early_stop_rtol,
        )

        # --- outlier classification on the compacted problem ------------
        tcw = pose_inverse(Pose(q=q_n, t=t_n))
        R = quat_to_matrix(tcw.q)
        r, _, _ = point2point_residuals(R, tcw.t, lm_n, obs)
        bad = ((obs.w > 0)
               & (jnp.sum(r * r, axis=-1) > bcfg.outlier_threshold_m ** 2))
        bad_slot = jnp.where(bad, obs_idx, O)
        obs_valid = arena.obs_valid.at[bad_slot].set(False, mode="drop")
        inc = arena.inc.at[
            jnp.where(bad, arena.obs_kf[obs_g], K),
            jnp.where(bad, arena.obs_lm[obs_g], L),
        ].set(False, mode="drop")

        arena = arena._replace(
            kf_q=arena.kf_q.at[kf_idx].set(q_n, mode="drop"),
            kf_t=arena.kf_t.at[kf_idx].set(t_n, mode="drop"),
            lm_pos=arena.lm_pos.at[lm_idx].set(lm_n, mode="drop"),
            obs_valid=obs_valid,
            inc=inc,
        )
        stats = stats._replace(n_outliers=jnp.sum(bad.astype(jnp.int32)))
        return arena, stats

    return jax.jit(global_ba, donate_argnums=(0,))
