"""Batched RANSAC pose estimation + Gauss-Newton polish.

Reference semantics: cv::solvePnPRansac with 100 iterations, 5.0 px
reprojection threshold, warm start from the current pose, inlier bitset
output (cv_ransac_pnp.cpp:14-85).

Accelerator redesign (SURVEY.md §7 step 4): instead of a sequential
hypothesis loop with early exit, evaluate a *fixed batch* of minimal
hypotheses in parallel and argmax the inlier count:

- RGB-D gives every matched observation a 3D camera-frame point (depth
  back-projection), so a minimal hypothesis is a 3-point rigid alignment
  (Horn triad construction — no SVD needed for 3 points), much
  friendlier to batched device math than P3P root-solving;
- hypothesis 0 is the warm-start pose (covers the reference's
  use-initial-guess path);
- scoring = full reprojection-error inlier count per hypothesis
  (vmapped), PLUS a depth-agreement gate |z_pred - z_meas| <
  depth_inlier_m — RGB-D measures depth, and reprojection alone leaves
  the planar-scene rotation/translation ambiguity unresolved (a narrow
  FOV camera translating parallel to a plane reprojects almost
  identically to one pitching in place; measured round 4: one 96-frame
  lap at fx=640 with 2 cm depth noise drifted 0.59 m ATE with
  reproj-only scoring, 0.04 m noise-free);
- polish = fixed-iteration damped Gauss-Newton on the inlier set over
  the HYBRID residual: 2D reprojection rows + a depth row
  w_d * (z_meas - z_pred), w_d = depth_weight * fx / z_meas — the same
  disparity-scaled hybrid the BA backend uses (backend/residuals.py
  rgbd_residuals), anchoring the along-ray/rotation null space.  The
  reference's cv::solvePnPRansac is reprojection-only; this is a
  deliberate robustness delta (docs/architecture.md).

Everything is static-shape; degenerate samples (collinear / invalid /
duplicate indices) simply score zero inliers.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from modular_slam_tpu.config import PnpConfig
from modular_slam_tpu.geometry.camera import Camera, project
from modular_slam_tpu.geometry.se3 import (
    Pose,
    matrix_to_quat,
    pose_inverse,
    quat_rotate,
    quat_to_matrix,
    se3_exp,
    pose_compose,
    quat_normalize,
)

Array = jnp.ndarray


class PnpResult(NamedTuple):
    pose: Pose          # camera-to-world (reference world pose convention)
    inliers: Array      # [N] bool
    n_inliers: Array    # int32
    ok: Array           # bool — found a pose with >= min_points inliers


def _triad(p1: Array, p2: Array, p3: Array) -> Array:
    """Orthonormal frame [3, 3] (columns) from 3 points; degenerate sets
    produce non-orthonormal garbage that is scored out downstream."""
    e1 = p2 - p1
    e1 = e1 / jnp.maximum(jnp.linalg.norm(e1), 1e-9)
    e2 = p3 - p1
    e2 = e2 - jnp.dot(e2, e1) * e1
    e2 = e2 / jnp.maximum(jnp.linalg.norm(e2), 1e-9)
    e3 = jnp.cross(e1, e2)
    return jnp.stack([e1, e2, e3], axis=-1)


def _align3(cam_pts: Array, world_pts: Array) -> Pose:
    """Rigid camera-to-world transform from 3 correspondences [3, 3]."""
    bw = _triad(world_pts[0], world_pts[1], world_pts[2])
    bc = _triad(cam_pts[0], cam_pts[1], cam_pts[2])
    R = bw @ bc.T
    q = matrix_to_quat(R)
    cw = jnp.mean(cam_pts, axis=0)
    ww = jnp.mean(world_pts, axis=0)
    t = ww - R @ cw
    return Pose(q=q, t=t)


def _reproj_errors(
    cam: Camera, pose: Pose, pts_world: Array, uv: Array
) -> tuple[Array, Array, Array]:
    """Squared pixel errors [N], positive-depth mask [N], and predicted
    camera-frame depth [N] for a pose."""
    qi = quat_normalize(pose.q) * jnp.array([1.0, -1.0, -1.0, -1.0])
    pc = quat_rotate(qi, pts_world - pose.t)
    uv_hat = project(cam, pc)
    err2 = jnp.sum((uv_hat - uv) ** 2, axis=-1)
    return err2, pc[..., 2] > 0.0, pc[..., 2]


def _inlier_mask(
    cam: Camera, pose: Pose, pts_world: Array, uv: Array, z_meas: Array,
    valid: Array, thresh2: float, z_thresh: float,
) -> Array:
    err2, front, z_pred = _reproj_errors(cam, pose, pts_world, uv)
    ok = valid & front & (err2 < thresh2)
    if z_thresh > 0.0:
        ok = ok & (jnp.abs(z_pred - z_meas) < z_thresh)
    return ok


def _count_inliers(
    cam: Camera, pose: Pose, pts_world: Array, uv: Array, z_meas: Array,
    valid: Array, thresh2: float, z_thresh: float,
) -> Array:
    ok = _inlier_mask(cam, pose, pts_world, uv, z_meas, valid, thresh2,
                      z_thresh)
    return jnp.sum(ok.astype(jnp.int32))


def _gauss_newton_polish(
    cam: Camera,
    pose0: Pose,
    pts_world: Array,
    uv: Array,
    z_meas: Array,
    weights: Array,
    iters: int,
    depth_weight: float,
) -> Pose:
    """Damped GN on the HYBRID residual (2D reprojection rows + a
    disparity-scaled depth row, backend/residuals.py convention),
    left-multiplicative update of the camera-from-world transform T_cw;
    returns camera-to-world."""
    # constant w.r.t. the parameters (depends only on the measurement)
    w_d = depth_weight * cam.fx / jnp.maximum(z_meas, 0.1)

    def step(tcw: Pose, _):
        R = quat_to_matrix(tcw.q)
        pc = (pts_world @ R.T) + tcw.t
        z = jnp.maximum(pc[:, 2], 1e-6)
        inv_z = 1.0 / z
        x, y = pc[:, 0], pc[:, 1]
        uv_hat = jnp.stack(
            [x * inv_z * cam.fx + cam.cx, y * inv_z * cam.fy + cam.cy], axis=-1
        )
        r2d = uv - uv_hat  # [N, 2]
        r = jnp.concatenate(
            [r2d, (w_d * (z_meas - pc[:, 2]))[:, None]], axis=-1)  # [N, 3]

        fxz = cam.fx * inv_z
        fyz = cam.fy * inv_z
        zero = jnp.zeros_like(fxz)
        # d uv_hat / d pc
        Jp = jnp.stack(
            [
                jnp.stack([fxz, zero, -fxz * x * inv_z], axis=-1),
                jnp.stack([zero, fyz, -fyz * y * inv_z], axis=-1),
            ],
            axis=-2,
        )  # [N, 2, 3]
        # d pc / d xi (left perturbation of T_cw): [I | -[pc]x]
        px, py, pz = pc[:, 0], pc[:, 1], pc[:, 2]
        zeros = jnp.zeros_like(px)
        skew = jnp.stack(
            [
                jnp.stack([zeros, -pz, py], axis=-1),
                jnp.stack([pz, zeros, -px], axis=-1),
                jnp.stack([-py, px, zeros], axis=-1),
            ],
            axis=-2,
        )  # [N, 3, 3]
        Jxi = jnp.concatenate(
            [jnp.broadcast_to(jnp.eye(3), skew.shape), -skew], axis=-1
        )  # [N, 3, 6]
        J2d = jnp.einsum("nij,njk->nik", Jp, Jxi)  # [N, 2, 6]
        Jz = w_d[:, None] * Jxi[:, 2, :]           # [N, 6]
        J = jnp.concatenate([J2d, Jz[:, None, :]], axis=1)  # [N, 3, 6]

        w = weights[:, None, None]
        H = jnp.einsum("nik,nil->kl", J * w, J)
        g = jnp.einsum("nik,ni->k", J * w, r)
        H = H + 1e-6 * jnp.eye(6)
        xi = jnp.linalg.solve(H, g)
        delta = se3_exp(xi)
        new = pose_compose(delta, tcw)
        return new, None

    tcw0 = pose_inverse(pose0)
    tcw, _ = jax.lax.scan(step, tcw0, None, length=iters)
    return pose_inverse(tcw)


def ransac_pnp(
    cam: Camera,
    pts_world: Array,      # [N, 3] matched landmark positions
    uv: Array,             # [N, 2] observed pixels
    pts_cam: Array,        # [N, 3] depth-backprojected observations
    valid: Array,          # [N] usable matches (ratio-test + valid depth)
    initial: Pose,         # warm start (current sensor pose)
    key: Array,            # PRNG key
    cfg: PnpConfig,
) -> PnpResult:
    n = pts_world.shape[0]
    thresh2 = cfg.inlier_threshold_px ** 2

    # --- hypothesis generation -------------------------------------------
    nvalid = jnp.sum(valid.astype(jnp.int32))
    probs = valid.astype(jnp.float32) + 1e-9  # keep normalizable with 0 valid
    probs = probs / jnp.sum(probs)
    idx = jax.random.choice(
        key, n, shape=(cfg.n_hypotheses, 3), replace=True, p=probs
    )  # duplicate indices within a triplet -> degenerate, scored out

    hyp = jax.vmap(lambda i: _align3(pts_cam[i], pts_world[i]))(idx)
    # prepend warm start as hypothesis 0
    hyp = Pose(
        q=jnp.concatenate([initial.q[None], hyp.q]),
        t=jnp.concatenate([initial.t[None], hyp.t]),
    )

    z_meas = pts_cam[:, 2]
    counts = jax.vmap(
        lambda q, t: _count_inliers(
            cam, Pose(q=q, t=t), pts_world, uv, z_meas, valid, thresh2,
            cfg.depth_inlier_m,
        )
    )(hyp.q, hyp.t)

    best = jnp.argmax(counts)
    best_pose = Pose(q=hyp.q[best], t=hyp.t[best])

    # --- polish on inliers ------------------------------------------------
    inl = _inlier_mask(cam, best_pose, pts_world, uv, z_meas, valid,
                       thresh2, cfg.depth_inlier_m)
    w = inl.astype(jnp.float32)
    refined = _gauss_newton_polish(
        cam, best_pose, pts_world, uv, z_meas, w, cfg.refine_iters,
        cfg.depth_weight,
    )

    # final inlier classification at the refined pose
    inliers = _inlier_mask(cam, refined, pts_world, uv, z_meas, valid,
                           thresh2, cfg.depth_inlier_m)
    n_inl = jnp.sum(inliers.astype(jnp.int32))

    # guard: if refinement somehow degraded below the unrefined best,
    # keep the unrefined hypothesis (degenerate GN on few points)
    keep_refined = n_inl >= counts[best]
    final_pose = Pose(
        q=jnp.where(keep_refined, refined.q, best_pose.q),
        t=jnp.where(keep_refined, refined.t, best_pose.t),
    )
    final_inl = jnp.where(keep_refined, inliers, inl)
    final_n = jnp.sum(final_inl.astype(jnp.int32))

    ok = (final_n >= cfg.min_points) & (nvalid >= cfg.min_points)
    return PnpResult(
        pose=Pose(q=quat_normalize(final_pose.q), t=final_pose.t),
        inliers=final_inl,
        n_inliers=final_n,
        ok=ok,
    )
