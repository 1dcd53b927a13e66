"""Fixed-capacity tensor map arena: keyframes, landmarks, observations,
covisibility.

Replaces the reference's pointer-graph BasicMap
(/root/reference/src/lib/modular_slam/basic_map.cpp): unordered_set pools
(:basic_map.hpp:55-56), a multi-index observation container (:58-67) and a
neighbour adjacency map updated per keyframe (basic_map.cpp:141-164), with
BFS visitors (:209-237).

Accelerator design (SURVEY.md §7): preallocated pools with validity masks +
a [K_max, L_max] boolean observation *incidence matrix*.  Covisibility
counts are then one matmul (inc @ inc.T), k-hop BFS becomes
repeated masked boolean matvecs, and "landmarks visible from a keyframe
set" is a single matvec — no pointers, no host sync, fully jittable.

Observations are additionally kept as a COO edge list carrying (uv, depth,
descriptor-free) payloads for bundle adjustment residuals.

Overflow policy: writes beyond capacity are dropped (scatter mode 'drop');
counters saturate.  Capacities come from MapConfig and are static.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
from jax import lax

from modular_slam_tpu.config import MapConfig
from modular_slam_tpu.geometry.se3 import Pose

Array = jnp.ndarray


class MapArena(NamedTuple):
    # keyframe pool [K]
    kf_q: Array          # [K, 4] camera-to-world quats (wxyz)
    kf_t: Array          # [K, 3]
    kf_time: Array       # [K] float32
    kf_valid: Array      # [K] bool
    # landmark pool [L]
    lm_pos: Array        # [L, 3] world positions
    lm_desc: Array       # [L, D] int8 ±1 — most recent observation
    lm_valid: Array      # [L] bool
    # observation incidence [K, L] bool
    inc: Array
    # observation COO edge list [O]
    obs_kf: Array        # [O] int32
    obs_lm: Array        # [O] int32
    obs_uv: Array        # [O, 2] float32 (level-0 pixels)
    obs_depth: Array     # [O] float32 (meters, 0 = no depth)
    obs_valid: Array     # [O] bool
    # counters (saturating)
    n_kf: Array          # int32
    n_lm: Array          # int32
    n_obs: Array         # int32

    @property
    def max_keyframes(self) -> int:
        return self.kf_q.shape[0]

    @property
    def max_landmarks(self) -> int:
        return self.lm_pos.shape[0]

    @property
    def max_observations(self) -> int:
        return self.obs_kf.shape[0]


def empty_arena(cfg: MapConfig) -> MapArena:
    K, L, O, D = (cfg.max_keyframes, cfg.max_landmarks,
                  cfg.max_observations, cfg.descriptor_bits)
    i32 = jnp.int32
    return MapArena(
        kf_q=jnp.zeros((K, 4), jnp.float32).at[:, 0].set(1.0),
        kf_t=jnp.zeros((K, 3), jnp.float32),
        kf_time=jnp.zeros((K,), jnp.float32),
        kf_valid=jnp.zeros((K,), bool),
        lm_pos=jnp.zeros((L, 3), jnp.float32),
        lm_desc=jnp.zeros((L, D), jnp.int8),
        lm_valid=jnp.zeros((L,), bool),
        inc=jnp.zeros((K, L), bool),
        obs_kf=jnp.zeros((O,), i32),
        obs_lm=jnp.zeros((O,), i32),
        obs_uv=jnp.zeros((O, 2), jnp.float32),
        obs_depth=jnp.zeros((O,), jnp.float32),
        obs_valid=jnp.zeros((O,), bool),
        n_kf=jnp.int32(0),
        n_lm=jnp.int32(0),
        n_obs=jnp.int32(0),
    )


def add_keyframe(arena: MapArena, pose: Pose, time: Array) -> Tuple[MapArena, Array]:
    """Append a keyframe; returns (arena, slot).  slot == K (dropped) when
    full — subsequent scatters with that index are no-ops."""
    K = arena.max_keyframes
    slot = arena.n_kf  # == K when full -> .at[K] drops
    has_room = slot < K
    arena = arena._replace(
        kf_q=arena.kf_q.at[slot].set(pose.q, mode="drop"),
        kf_t=arena.kf_t.at[slot].set(pose.t, mode="drop"),
        kf_time=arena.kf_time.at[slot].set(time, mode="drop"),
        kf_valid=arena.kf_valid.at[slot].set(has_room, mode="drop"),
        n_kf=jnp.minimum(arena.n_kf + 1, K),
    )
    return arena, jnp.where(has_room, slot, K)


def add_landmarks(
    arena: MapArena,
    positions: Array,   # [N, 3]
    descs: Array,       # [N, D] int8 ±1
    valid: Array,       # [N] bool — which rows to insert
) -> Tuple[MapArena, Array]:
    """Batch-insert landmarks; returns (arena, slots [N]) with slot == L
    for dropped/invalid rows."""
    L = arena.max_landmarks
    order = jnp.cumsum(valid.astype(jnp.int32)) - 1       # [N]
    slots = jnp.where(valid, arena.n_lm + order, L)
    slots = jnp.where(slots < L, slots, L)
    arena = arena._replace(
        lm_pos=arena.lm_pos.at[slots].set(positions, mode="drop"),
        lm_desc=arena.lm_desc.at[slots].set(descs, mode="drop"),
        lm_valid=arena.lm_valid.at[slots].set(valid & (slots < L), mode="drop"),
        n_lm=jnp.minimum(arena.n_lm + jnp.sum(valid.astype(jnp.int32)), L),
    )
    return arena, slots


def add_observations(
    arena: MapArena,
    kf_slot: Array,     # scalar int32
    lm_slots: Array,    # [N] int32 (== L rows are dropped)
    uv: Array,          # [N, 2]
    depth: Array,       # [N]
    descs: Array,       # [N, D] int8 — refresh landmark descriptors
    valid: Array,       # [N] bool
) -> MapArena:
    """Record keyframe->landmark observations: COO rows + incidence bits +
    most-recent-descriptor refresh (RecentObservationsVisitor semantics,
    rgbd_feature_frontend.cpp:57-80)."""
    L = arena.max_landmarks
    O = arena.max_observations
    ok = valid & (lm_slots < L) & (kf_slot < arena.max_keyframes)

    order = jnp.cumsum(ok.astype(jnp.int32)) - 1
    rows = jnp.where(ok, arena.n_obs + order, O)
    rows = jnp.where(rows < O, rows, O)
    kf_full = jnp.broadcast_to(kf_slot, lm_slots.shape).astype(jnp.int32)

    lm_idx = jnp.where(ok, lm_slots, L)
    arena = arena._replace(
        obs_kf=arena.obs_kf.at[rows].set(kf_full, mode="drop"),
        obs_lm=arena.obs_lm.at[rows].set(lm_slots, mode="drop"),
        obs_uv=arena.obs_uv.at[rows].set(uv, mode="drop"),
        obs_depth=arena.obs_depth.at[rows].set(depth, mode="drop"),
        obs_valid=arena.obs_valid.at[rows].set(ok, mode="drop"),
        inc=arena.inc.at[kf_slot, lm_idx].set(ok, mode="drop"),
        lm_desc=arena.lm_desc.at[lm_idx].set(descs, mode="drop"),
        n_obs=jnp.minimum(arena.n_obs + jnp.sum(ok.astype(jnp.int32)), O),
    )
    return arena


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


def covis_counts(arena: MapArena) -> Array:
    """[K, K] shared-landmark counts (diagonal = own landmark count).

    Reference: neighbours map joined through shared landmarks
    (basic_map.cpp:141-164).  Here: one matmul over the incidence —
    bf16 inputs with f32 accumulation so it runs on the matrix units (an
    int32 matmul has no matrix-unit path); 0/1 products accumulate
    exactly in f32."""
    m = arena.inc.astype(jnp.bfloat16)
    return jnp.matmul(m, m.T,
                      preferred_element_type=jnp.float32).astype(jnp.int32)


def khop_keyframes(arena: MapArena, kf_slot: Array, depth: int) -> Array:
    """[K] bool — keyframes within `depth` covisibility hops of kf_slot
    (inclusive of kf_slot).  Replaces BFS getNeighbourKeyframes
    (basic_map.cpp:209-237); `depth` is static.

    MATRIX-FREE: one hop is "landmarks seen by the visited set, then
    keyframes seeing those landmarks" — two [K,L] GEMVs (~8 MFLOP at
    default capacity) instead of materializing the full inc @ inc.T
    adjacency (~2.1 GFLOP per tracked frame).
    Positive sums accumulate in f32, so the > 0 tests are exact."""
    K = arena.max_keyframes
    inc_f = arena.inc.astype(jnp.bfloat16)
    start = (jnp.arange(K) == kf_slot) & arena.kf_valid

    def body(_, visited):
        lm_hit = jnp.matmul(visited.astype(jnp.bfloat16), inc_f,
                            preferred_element_type=jnp.float32)   # [L]
        back = jnp.matmul(inc_f, (lm_hit > 0).astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)     # [K]
        return (visited | (back > 0)) & arena.kf_valid

    return lax.fori_loop(0, depth, body, start)


def visible_landmarks(arena: MapArena, kf_mask: Array) -> Array:
    """[L] bool — landmarks observed by any keyframe in kf_mask.

    Boolean any-reduction over the incidence rows (elementwise + reduce)
    instead of an integer GEMV."""
    hits = jnp.any(arena.inc & kf_mask[:, None], axis=0)
    return hits & arena.lm_valid


def apply_backend_update(
    arena: MapArena,
    kf_q: Array, kf_t: Array,
    lm_pos: Array,
    kf_mask: Array, lm_mask: Array,
) -> MapArena:
    """Write BA-optimized poses/positions back (the reference's missing
    BasicMap::update(BackendOutput), basic_map.cpp:41-44 TODO)."""
    return arena._replace(
        kf_q=jnp.where(kf_mask[:, None], kf_q, arena.kf_q),
        kf_t=jnp.where(kf_mask[:, None], kf_t, arena.kf_t),
        lm_pos=jnp.where(lm_mask[:, None], lm_pos, arena.lm_pos),
    )
