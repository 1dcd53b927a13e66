"""Bundle-adjustment residuals and analytic Jacobians.

Three residual types:

- **3D point-to-point** (the reference's choice, ceres_backend.cpp:19-60):
  r = T_cw * l_world - backproject(uv, depth)  in the camera frame.
  RGB-D depth makes this well-conditioned in all three directions.
- **2D reprojection** (MinMseTracker's form,
  ceres_reprojection_error_pnp.cpp:18-63): r = uv - project(T_cw * l).
- **Hybrid RGB-D** (`rgbd_residuals`): 2D reprojection in pixels plus the
  depth measurement as a third row scaled to pixel-comparable units —
  the RGB-D analogue of ORB-SLAM's stereo u_r residual.  Pixels stay the
  clean measurement; the (down-weighted) depth row removes the
  along-ray null space that pure reprojection leaves on landmarks seen
  from short baselines.

Pose parametrization: left-multiplicative se(3) delta on the
camera-from-world transform T_cw (exp(xi) * T_cw), so
d(T_cw * l)/dxi = [I | -[p_c]x] and d(T_cw * l)/dl = R_cw.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from modular_slam_tpu.geometry.camera import Camera, backproject

Array = jnp.ndarray


class ObsData(NamedTuple):
    """Gathered per-observation data, ready for residual evaluation."""

    kf: Array        # [O] int32 keyframe slot
    lm: Array        # [O] int32 landmark slot
    p_obs: Array     # [O, 3] backprojected observed point (camera frame)
    uv: Array        # [O, 2]
    w: Array         # [O] base weight (0 = inactive)


def _skew(v: Array) -> Array:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = jnp.zeros_like(x)
    m = jnp.stack([o, -z, y, z, o, -x, -y, x, o], axis=-1)
    return m.reshape(*v.shape[:-1], 3, 3)


def point2point_residuals(
    R_cw: Array,      # [K, 3, 3] camera-from-world rotations
    t_cw: Array,      # [K, 3]
    lm_pos: Array,    # [L, 3]
    obs: ObsData,
) -> Tuple[Array, Array, Array]:
    """-> (r [O, 3], Jp [O, 3, 6], Jl [O, 3, 3])."""
    Rk = R_cw[obs.kf]                     # [O, 3, 3]
    tk = t_cw[obs.kf]                     # [O, 3]
    l = lm_pos[obs.lm]                    # [O, 3]
    p_c = jnp.einsum("oij,oj->oi", Rk, l) + tk
    r = p_c - obs.p_obs
    eye = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), (r.shape[0], 3, 3))
    Jp = jnp.concatenate([eye, -_skew(p_c)], axis=-1)   # [O, 3, 6]
    Jl = Rk
    return r, Jp, Jl


def reprojection_residuals(
    cam: Camera,
    R_cw: Array, t_cw: Array, lm_pos: Array, obs: ObsData,
) -> Tuple[Array, Array, Array]:
    """-> (r [O, 2], Jp [O, 2, 6], Jl [O, 2, 3])."""
    Rk = R_cw[obs.kf]
    tk = t_cw[obs.kf]
    l = lm_pos[obs.lm]
    p_c = jnp.einsum("oij,oj->oi", Rk, l) + tk
    x, y = p_c[:, 0], p_c[:, 1]
    z = jnp.where(p_c[:, 2] > 1e-6, p_c[:, 2], 1e-6)
    inv_z = 1.0 / z
    uv_hat = jnp.stack(
        [x * inv_z * cam.fx + cam.cx, y * inv_z * cam.fy + cam.cy], axis=-1
    )
    r = uv_hat - obs.uv
    fxz, fyz = cam.fx * inv_z, cam.fy * inv_z
    zero = jnp.zeros_like(fxz)
    Jproj = jnp.stack(
        [
            jnp.stack([fxz, zero, -fxz * x * inv_z], axis=-1),
            jnp.stack([zero, fyz, -fyz * y * inv_z], axis=-1),
        ],
        axis=-2,
    )  # [O, 2, 3]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), (r.shape[0], 3, 3))
    Jpc = jnp.concatenate([eye, -_skew(p_c)], axis=-1)  # [O, 3, 6]
    Jp = jnp.einsum("oij,ojk->oik", Jproj, Jpc)
    Jl = jnp.einsum("oij,ojk->oik", Jproj, Rk)
    return r, Jp, Jl


def rgbd_residuals(
    cam: Camera,
    R_cw: Array, t_cw: Array, lm_pos: Array, obs: ObsData,
    depth_weight: float = 0.25,
) -> Tuple[Array, Array, Array]:
    """-> (r [O, 3], Jp [O, 3, 6], Jl [O, 3, 3]).

    Rows 0-1: pixel reprojection error.  Row 2:
    w_d * (z_pred - z_meas) with w_d = depth_weight * fx / z_meas, so a
    depth error contributes in the same units as the pixel shift it
    would induce on nearby geometry (disparity scaling).  w_d depends
    only on the measurement, so it is constant w.r.t. the parameters."""
    Rk = R_cw[obs.kf]
    tk = t_cw[obs.kf]
    l = lm_pos[obs.lm]
    p_c = jnp.einsum("oij,oj->oi", Rk, l) + tk
    x, y = p_c[:, 0], p_c[:, 1]
    z = jnp.where(p_c[:, 2] > 1e-6, p_c[:, 2], 1e-6)
    inv_z = 1.0 / z
    z_meas = obs.p_obs[:, 2]
    w_d = depth_weight * cam.fx / jnp.maximum(z_meas, 0.1)
    r = jnp.stack(
        [
            x * inv_z * cam.fx + cam.cx - obs.uv[:, 0],
            y * inv_z * cam.fy + cam.cy - obs.uv[:, 1],
            w_d * (p_c[:, 2] - z_meas),
        ],
        axis=-1,
    )
    fxz, fyz = cam.fx * inv_z, cam.fy * inv_z
    zero = jnp.zeros_like(fxz)
    Jproj = jnp.stack(
        [
            jnp.stack([fxz, zero, -fxz * x * inv_z], axis=-1),
            jnp.stack([zero, fyz, -fyz * y * inv_z], axis=-1),
            jnp.stack([zero, zero, w_d], axis=-1),
        ],
        axis=-2,
    )  # [O, 3, 3]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), (r.shape[0], 3, 3))
    Jpc = jnp.concatenate([eye, -_skew(p_c)], axis=-1)  # [O, 3, 6]
    Jp = jnp.einsum("oij,ojk->oik", Jproj, Jpc)
    Jl = jnp.einsum("oij,ojk->oik", Jproj, Rk)
    return r, Jp, Jl


# ---------------------------------------------------------------------------
# dense-grid variants: observations laid out [L, K] (backend/ba.py
# ba_core_dense).  In this layout the per-observation pose/landmark
# "gathers" are pure broadcasts (kf index = column, lm index = row), so
# no row-gather appears at all — the [O]-layout forms above gather
# `R_cw[obs.kf]` / `lm_pos[obs.lm]` once per observation row.
# ---------------------------------------------------------------------------


def point2point_residuals_grid(
    R_cw: Array,      # [K, 3, 3]
    t_cw: Array,      # [K, 3]
    lm_pos: Array,    # [L, 3]
    p_obs: Array,     # [L, K, 3] observed points (camera frame)
) -> Tuple[Array, Array, Array]:
    """-> (r [L,K,3], Jp [L,K,3,6], Jl [L,K,3,3])."""
    L, K = p_obs.shape[:2]
    p_c = jnp.einsum("kij,lj->lki", R_cw, lm_pos) + t_cw[None]
    r = p_c - p_obs
    eye = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), (L, K, 3, 3))
    Jp = jnp.concatenate([eye, -_skew(p_c)], axis=-1)
    Jl = jnp.broadcast_to(R_cw[None], (L, K, 3, 3))
    return r, Jp, Jl


def reprojection_residuals_grid(
    cam: Camera,
    R_cw: Array, t_cw: Array, lm_pos: Array,
    p_obs: Array,     # [L, K, 3] (unused beyond shape; kept for parity)
    uv: Array,        # [L, K, 2]
) -> Tuple[Array, Array, Array]:
    """-> (r [L,K,2], Jp [L,K,2,6], Jl [L,K,2,3])."""
    L, K = uv.shape[:2]
    p_c = jnp.einsum("kij,lj->lki", R_cw, lm_pos) + t_cw[None]
    x, y = p_c[..., 0], p_c[..., 1]
    z = jnp.where(p_c[..., 2] > 1e-6, p_c[..., 2], 1e-6)
    inv_z = 1.0 / z
    uv_hat = jnp.stack(
        [x * inv_z * cam.fx + cam.cx, y * inv_z * cam.fy + cam.cy], axis=-1)
    r = uv_hat - uv
    fxz, fyz = cam.fx * inv_z, cam.fy * inv_z
    zero = jnp.zeros_like(fxz)
    Jproj = jnp.stack(
        [
            jnp.stack([fxz, zero, -fxz * x * inv_z], axis=-1),
            jnp.stack([zero, fyz, -fyz * y * inv_z], axis=-1),
        ],
        axis=-2,
    )  # [L,K,2,3]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), (L, K, 3, 3))
    Jpc = jnp.concatenate([eye, -_skew(p_c)], axis=-1)
    Jp = jnp.einsum("lkij,lkjm->lkim", Jproj, Jpc)
    Jl = jnp.einsum("lkij,kjm->lkim", Jproj, R_cw)
    return r, Jp, Jl


def rgbd_residuals_grid(
    cam: Camera,
    R_cw: Array, t_cw: Array, lm_pos: Array,
    p_obs: Array,     # [L, K, 3]
    uv: Array,        # [L, K, 2]
    depth_weight: float = 0.25,
) -> Tuple[Array, Array, Array]:
    """-> (r [L,K,3], Jp [L,K,3,6], Jl [L,K,3,3])."""
    L, K = uv.shape[:2]
    p_c = jnp.einsum("kij,lj->lki", R_cw, lm_pos) + t_cw[None]
    x, y = p_c[..., 0], p_c[..., 1]
    z = jnp.where(p_c[..., 2] > 1e-6, p_c[..., 2], 1e-6)
    inv_z = 1.0 / z
    z_meas = p_obs[..., 2]
    w_d = depth_weight * cam.fx / jnp.maximum(z_meas, 0.1)
    r = jnp.stack(
        [
            x * inv_z * cam.fx + cam.cx - uv[..., 0],
            y * inv_z * cam.fy + cam.cy - uv[..., 1],
            w_d * (p_c[..., 2] - z_meas),
        ],
        axis=-1,
    )
    fxz, fyz = cam.fx * inv_z, cam.fy * inv_z
    zero = jnp.zeros_like(fxz)
    Jproj = jnp.stack(
        [
            jnp.stack([fxz, zero, -fxz * x * inv_z], axis=-1),
            jnp.stack([zero, fyz, -fyz * y * inv_z], axis=-1),
            jnp.stack([zero, zero, w_d], axis=-1),
        ],
        axis=-2,
    )  # [L,K,3,3]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=r.dtype), (L, K, 3, 3))
    Jpc = jnp.concatenate([eye, -_skew(p_c)], axis=-1)
    Jp = jnp.einsum("lkij,lkjm->lkim", Jproj, Jpc)
    Jl = jnp.einsum("lkij,kjm->lkim", Jproj, R_cw)
    return r, Jp, Jl


def huber_weights(r: Array, delta: float, base_w: Array) -> Array:
    """IRLS weights for the Huber loss on the residual norm."""
    nrm = jnp.linalg.norm(r, axis=-1)
    w = jnp.where(nrm <= delta, 1.0, delta / jnp.maximum(nrm, 1e-12))
    return w * base_w


def gather_obs(cam: Camera, arena, active: Array) -> ObsData:
    """Build ObsData from arena observation rows; `active` [O] bool."""
    p_obs = backproject(cam, arena.obs_uv, arena.obs_depth)
    return ObsData(
        kf=arena.obs_kf,
        lm=arena.obs_lm,
        p_obs=p_obs,
        uv=arena.obs_uv,
        w=active.astype(jnp.float32),
    )
