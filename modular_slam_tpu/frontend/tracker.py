"""RGB-D feature-tracking frontend — the per-frame tracking brain.

Reference: RgbdFeatureFrontend
(/root/reference/src/lib/modular_slam/rgbd_feature_frontend.cpp):
- first-frame bootstrap at identity pose, all valid-depth keypoints become
  landmarks (initFirstKeyframe :433-449);
- tracking: match against landmarks visible within a 2-hop covisibility
  neighborhood of the reference keyframe (:256-277, depth 2 at :264),
  depth back-projection (:119-138), RANSAC PnP warm-started at the current
  pose (:345-347), min-matched gate of 10 (:339-343);
- better-reference-keyframe search over 5 hops by visibility voting
  (:544-575);
- new keyframe when PnP inliers < 30 (:156-162, :373): unmatched keypoints
  with 0 < depth <= 3 m become landmarks (:402-431); note the reference's
  index bug #7 (SURVEY.md §2.4) is deliberately NOT reproduced — we use
  true keypoint indices;
- tracking failure: keep the last pose and report failure (the reference
  relocalizer is a stub, orb_relocalizer.cpp:32-36); relocalization
  against the BoW database is wired in at the engine level (loop/).

Fully jittable: all branches are lax.cond over the functional map arena.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from modular_slam_tpu.config import SlamConfig
from modular_slam_tpu.geometry.camera import Camera, backproject
from modular_slam_tpu.geometry.se3 import Pose, identity_pose, pose_apply
from modular_slam_tpu.map.arena import (
    MapArena,
    add_keyframe,
    add_landmarks,
    add_observations,
    khop_keyframes,
    visible_landmarks,
)
from modular_slam_tpu.ops.match import dedupe_matches
from modular_slam_tpu.ops.match_pallas import match_descriptors_fastest
from modular_slam_tpu.ops.pnp import ransac_pnp
from modular_slam_tpu.types import Features, TrackResult

Array = jnp.ndarray


class TrackState(NamedTuple):
    pose: Pose          # current sensor pose (camera-to-world)
    ref_kf: Array       # int32 reference keyframe slot
    frame_idx: Array    # int32 — frames processed
    lost: Array         # bool — tracking currently lost
    # int32 — frames since the last keyframe insertion.  Drives the
    # periodic-keyframe rule (TrackerConfig.max_kf_interval): once the
    # map covers the scene, inlier counts stay high and the inlier rule
    # alone would never insert again — so no local BA ever refines the
    # map and no loop closure can fire (no candidates past min_gap).
    # ORB-SLAM's condition C1 exists for exactly this reason.
    since_kf: Array = None


def initial_state() -> TrackState:
    return TrackState(
        pose=identity_pose(),
        ref_kf=jnp.int32(0),
        frame_idx=jnp.int32(0),
        lost=jnp.array(False),
        since_kf=jnp.int32(0),
    )


def _bootstrap(
    arena: MapArena, state: TrackState, feats: Features, cam: Camera,
    cfg: SlamConfig, time: Array,
) -> Tuple[MapArena, TrackState, TrackResult]:
    """First frame: identity-pose keyframe; valid-depth keypoints ->
    landmarks + observations."""
    kps = feats.keypoints
    pose = identity_pose()
    arena, kf_slot = add_keyframe(arena, pose, time)

    has_depth = kps.valid & (kps.depth > 0.0)
    pts_cam = backproject(cam, kps.uv, kps.depth)
    pts_world = pts_cam  # identity pose

    arena, lm_slots = add_landmarks(
        arena, pts_world, feats.descriptors.unpacked, has_depth
    )
    arena = add_observations(
        arena, kf_slot, lm_slots, kps.uv, kps.depth,
        feats.descriptors.unpacked, has_depth,
    )

    n = jnp.sum(has_depth.astype(jnp.int32))
    result = TrackResult(
        pose=pose,
        n_matches=n,
        n_inliers=n,
        tracking_ok=jnp.array(True),
        new_keyframe=jnp.array(True),
        kf_slot=kf_slot,
    )
    new_state = TrackState(
        pose=pose, ref_kf=kf_slot, frame_idx=state.frame_idx + 1,
        lost=jnp.array(False), since_kf=jnp.int32(0),
    )
    return arena, new_state, result


def _track(
    arena: MapArena, state: TrackState, feats: Features, cam: Camera,
    cfg: SlamConfig, time: Array, key: Array,
    match_fn=None, pnp_fn=None,
) -> Tuple[MapArena, TrackState, TrackResult]:
    kps = feats.keypoints
    desc = feats.descriptors.unpacked
    tcfg = cfg.tracker

    # injected components (rgbd_feature_frontend.cpp:140-154 constructor
    # injection); None -> the built-in ops, closed over cfg
    if match_fn is None:
        match_fn = lambda q, qv, t, tv: match_descriptors_fastest(  # noqa: E731
            q, qv, t, tv, cfg.matcher)
    if pnp_fn is None:
        pnp_fn = lambda pw, uv, pc, v, init, k: ransac_pnp(  # noqa: E731
            cam, pw, uv, pc, v, init, k, cfg.pnp)

    # --- candidate landmarks: 2-hop covisibility of the reference KF ------
    kf_mask = khop_keyframes(arena, state.ref_kf, tcfg.covis_depth_tracking)
    lm_mask = visible_landmarks(arena, kf_mask)

    # --- 2-NN ratio matching against landmark descriptors -----------------
    matches = match_fn(desc, kps.valid, arena.lm_desc, lm_mask)
    matches = dedupe_matches(matches, arena.max_landmarks)

    has_depth = kps.depth > 0.0
    m_ok = matches.valid & has_depth
    n_matches = jnp.sum(m_ok.astype(jnp.int32))

    # --- PnP ---------------------------------------------------------------
    pts_world = arena.lm_pos[matches.lm_slot]
    pts_cam = backproject(cam, kps.uv, kps.depth)
    pnp = pnp_fn(pts_world, kps.uv, pts_cam, m_ok, state.pose, key)

    enough = n_matches >= tcfg.min_matched_points
    ok = enough & pnp.ok
    pose = Pose(
        q=jnp.where(ok, pnp.pose.q, state.pose.q),
        t=jnp.where(ok, pnp.pose.t, state.pose.t),
    )
    n_inliers = jnp.where(ok, pnp.n_inliers, 0)

    # --- keyframe policy ---------------------------------------------------
    # Three triggers, OR-ed:
    # 1. the reference's absolute floor (inliers < 30,
    #    rgbd_feature_frontend.cpp:156-162);
    # 2. RATIO vs the reference keyframe (ORB-SLAM C3 analog): inliers
    #    below a fraction of the ref keyframe's observation count.
    #    Waiting for the absolute floor hands off the map with ~30
    #    badly-conditioned matches clustered at the shrinking overlap's
    #    edge — measured round 4: each handoff baked ~0.15 m of pose
    #    error into the new keyframe's landmarks under 2 cm depth noise
    #    (one 48-frame lap drifted 0.59 m; the ratio trigger inserts
    #    while the match set is still wide and well-spread);
    # 3. the periodic rule: >= max_kf_interval frames since the last
    #    insertion — keeps local BA refining and loop candidates forming
    #    during long stays inside an already-mapped area.
    n_ref_obs = jnp.sum(arena.inc[state.ref_kf].astype(jnp.float32))
    weak_vs_ref = (n_inliers.astype(jnp.float32)
                   < tcfg.new_keyframe_inlier_ratio * n_ref_obs)
    overdue = (state.since_kf + 1) >= tcfg.max_kf_interval
    need_kf = ok & ((n_inliers < tcfg.new_keyframe_min_inliers)
                    | weak_vs_ref | overdue)

    def with_new_keyframe(arena):
        arena, kf_slot = add_keyframe(arena, pose, time)
        # observations of inlier-matched landmarks from the new keyframe
        arena = add_observations(
            arena, kf_slot, matches.lm_slot, kps.uv, kps.depth, desc,
            pnp.inliers,
        )
        # new landmarks from unmatched keypoints with near depth
        unmatched = (
            kps.valid
            & ~matches.valid
            & (kps.depth > 0.0)
            & (kps.depth <= tcfg.new_landmark_max_depth)
        )
        pts_w_new = pose_apply(pose, pts_cam)
        arena, lm_slots = add_landmarks(arena, pts_w_new, desc, unmatched)
        arena = add_observations(
            arena, kf_slot, lm_slots, kps.uv, kps.depth, desc, unmatched
        )
        return arena, kf_slot

    def without_new_keyframe(arena):
        # better-reference search: visibility voting over 5 hops
        hop5 = khop_keyframes(arena, state.ref_kf, tcfg.covis_depth_better_kf)
        inlier_lm = jnp.zeros(arena.max_landmarks, bool).at[
            jnp.where(pnp.inliers, matches.lm_slot, arena.max_landmarks)
        ].set(True, mode="drop")
        # f32 GEMV (int32 matmuls have no matrix-unit path); 0/1 sums
        # are exact
        votes = (arena.inc.astype(jnp.float32)
                 @ inlier_lm.astype(jnp.float32)).astype(jnp.int32)
        votes = jnp.where(hop5 & arena.kf_valid, votes, -1)
        best = jnp.argmax(votes).astype(jnp.int32)
        ref = jnp.where(votes[best] > 0, best, state.ref_kf)
        return arena, ref

    arena, kf_or_ref = lax.cond(
        need_kf, with_new_keyframe, without_new_keyframe, arena
    )
    ref_kf = jnp.where(ok, kf_or_ref, state.ref_kf)

    result = TrackResult(
        pose=pose,
        n_matches=n_matches,
        n_inliers=n_inliers,
        tracking_ok=ok,
        new_keyframe=need_kf,
        kf_slot=jnp.where(need_kf, kf_or_ref, jnp.int32(-1)),
    )
    new_state = TrackState(
        pose=pose,
        ref_kf=ref_kf,
        frame_idx=state.frame_idx + 1,
        lost=~ok,
        since_kf=jnp.where(need_kf, 0, state.since_kf + 1),
    )
    return arena, new_state, result


def track_frame(
    arena: MapArena,
    state: TrackState,
    feats: Features,
    cam: Camera,
    cfg: SlamConfig,
    time: Array,
    key: Array,
    match_fn=None,
    pnp_fn=None,
) -> Tuple[MapArena, TrackState, TrackResult]:
    """One frontend step: bootstrap on the first frame, track afterwards.

    `match_fn` / `pnp_fn` are optional injected components (see
    models/components.py for the contracts); None uses the built-ins."""
    return lax.cond(
        arena.n_kf == 0,
        lambda a: _bootstrap(a, state, feats, cam, cfg, time),
        lambda a: _track(a, state, feats, cam, cfg, time, key,
                         match_fn=match_fn, pnp_fn=pnp_fn),
        arena,
    )
