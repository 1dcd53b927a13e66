"""Benchmark: SLAM throughput, frames/s per device.

Prints ONE JSON line.  Headline metric = BASELINE.md's
"frames/s/chip (tracking + BA)": the full slam pipeline (detect + match +
RANSAC PnP + arena update per frame, local Schur-LM BA per keyframe)
through the chunked engine path in DEFERRED-PIPELINED mode: the host
finishes chunk N's bookkeeping (results fetch, keyframe-rate BA / map
maintenance dispatch) while the device executes chunk N+1, so every
device->host sync overlaps device compute and local BA lands one chunk
late (engine.py defer_chunk_sync).  The CPU-offload async executor
(backend/executor.py) is not the benchmarked configuration.
Also reported: the plain sync variant (blocking host sync per chunk),
tracking-only throughput, scan-probe per-stage device times, the
box-world scene scenario, loop-closure latency, and warm-cache
time-to-first-frame.

Per-stage numbers use the scan-probe method: ops timed INSIDE a
lax.scan over DIFFERENT per-frame inputs, not by re-dispatching one op
on the same inputs (VERDICT r2 weak #1).

Baseline: the reference publishes no numbers (BASELINE.md), and its C++
build (conan/OpenCV/Ceres/Qt toolchain) is not reproducible in this
image, so the baseline is an explicit HOST-CPU PROXY of the reference
pipeline's per-frame hot path, run through the same OpenCV library it
uses — cv::ORB(1000) detect (orb_feature.cpp:25) + BRUTEFORCE_HAMMING
2-NN knnMatch (:84-117) + cv::solvePnPRansac (cv_ransac_pnp.cpp:56-57) —
plus, for the tracking+BA metric, a numpy/BLAS Levenberg-Marquardt local
bundle adjuster with Schur landmark elimination standing in for the
reference's *intended* CeresBackend (point-to-point residuals,
ceres_backend.cpp:19-60; local window :162-171; the shipped backend is
dead behind the early return at :95).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

N_FRAMES = 67
WARMUP = 3
CHUNK = 16  # frames per device dispatch (amortizes host latency)
BA_WINDOW = 3  # proxy local-BA keyframe window (1-hop covis stand-in)


def _sequence(generator="plane"):
    from modular_slam_tpu.config import SlamConfig
    from modular_slam_tpu.eval.synthetic import (BoxSceneGenerator,
                                                 PlaneSceneGenerator)

    cfg = SlamConfig()
    gen_cls = {"plane": PlaneSceneGenerator, "box": BoxSceneGenerator}
    gen = gen_cls[generator](cfg.camera, seed=42)
    # enough motion that landmarks leave the view and keyframes + local BA
    # fire at a realistic rate (~1 keyframe / 15 frames)
    poses = gen.trajectory(N_FRAMES, step_t=(0.05, 0.02, 0.01),
                           step_rot=(0.004, 0.008, 0.004))
    frames = [(rgb, depth, ts) for rgb, depth, ts in gen.sequence(poses)]
    return cfg, frames, poses


def _stage_frames(frames):
    """Stack frames to device arrays once (loader is not what we measure)."""
    import jax
    import jax.numpy as jnp

    w = jnp.array([0.299, 0.587, 0.114], dtype=jnp.float32)
    grays = jnp.stack([
        jnp.tensordot(jnp.asarray(rgb).astype(jnp.float32), w, 1)
        for rgb, _, _ in frames])
    depths = jnp.stack([jnp.asarray(d) for _, d, _ in frames])
    times = jnp.asarray([ts for _, _, ts in frames], jnp.float32)
    jax.block_until_ready((grays, depths))
    return grays, depths, times


# ---------------------------------------------------------------------------
# ours
# ---------------------------------------------------------------------------


def bench_startup(cfg, frames) -> float:
    """Warm-cache time-to-first-tracked-frame: fresh engine, one chunk
    through the full pipeline (compile via the persistent cache + first
    dispatch).  Run FIRST so nothing is pre-compiled in this process."""
    import jax

    from modular_slam_tpu.models.pipelines import slam_pipeline

    t0 = time.perf_counter()
    system = slam_pipeline(cfg, defer_chunk_sync=True)
    grays, depths, times = _stage_frames(frames[:CHUNK])
    system.process_chunk_device(grays, depths, times)
    jax.block_until_ready(system.arena)
    dt = time.perf_counter() - t0
    print(f"startup (warm cache) to first chunk: {dt:.1f}s", file=sys.stderr)
    return dt


def bench_ours_tracking(cfg, frames) -> float:
    """Tracking-only scan path (detect+match+pnp+arena), frames/s."""
    import jax
    import jax.numpy as jnp

    from modular_slam_tpu.engine import make_slam_scan
    from modular_slam_tpu.frontend.tracker import initial_state
    from modular_slam_tpu.map.arena import empty_arena

    scan = make_slam_scan(cfg)
    arena = empty_arena(cfg.map)
    state = initial_state()
    key = jax.random.PRNGKey(0)

    grays, depths, times = _stage_frames(frames)
    keys = jax.random.split(key, len(frames))

    def chunk(a, s, lo, hi):
        return scan(a, s, grays[lo:hi], depths[lo:hi], times[lo:hi],
                    keys[lo:hi])

    # warmup (bootstrap + compile both chunk shapes)
    arena, state, _ = chunk(arena, state, 0, WARMUP)
    arena, state, r0 = chunk(arena, state, WARMUP, WARMUP + CHUNK)
    jax.block_until_ready(state)

    n = len(frames) - WARMUP - CHUNK
    assert n % CHUNK == 0, (n, CHUNK)
    oks = []
    t0 = time.perf_counter()
    for lo in range(WARMUP + CHUNK, len(frames), CHUNK):
        arena, state, res = chunk(arena, state, lo, lo + CHUNK)
        oks.append(res.tracking_ok)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0

    ok = int(jnp.concatenate(oks).sum())
    print(f"ours tracking: {n} frames in {dt:.3f}s, {ok}/{n} tracked ok",
          file=sys.stderr)
    return n / dt


def bench_ours_full(cfg, frames, mode="pipelined", ba_mode="sync"):
    """Full slam pipeline (tracking + per-keyframe local BA) through the
    chunked engine path, steady-state: frames pre-staged on device, first
    chunk is warmup (compiles the scan; the bootstrap keyframe compiles
    local BA), the remaining frames are timed INCLUDING every keyframe's
    BA (submit+harvest in async mode, inline in sync mode), the per-chunk
    host sync, and a final backend flush.
    Returns (fps, n_keyframes, n_tracked)."""
    import jax

    from modular_slam_tpu.models.pipelines import slam_pipeline

    system = slam_pipeline(cfg, defer_chunk_sync=(mode == "pipelined"),
                           ba_mode=ba_mode)
    grays, depths, times = _stage_frames(frames)
    tss = [ts for _, _, ts in frames]

    system.process_chunk_device(grays[:CHUNK], depths[:CHUNK], tss[:CHUNK])
    system.flush_backend()
    jax.block_until_ready(system.arena)

    n = (len(frames) - CHUNK) // CHUNK * CHUNK
    t0 = time.perf_counter()
    for lo in range(CHUNK, CHUNK + n, CHUNK):
        system.process_chunk_device(grays[lo:lo + CHUNK],
                                    depths[lo:lo + CHUNK],
                                    tss[lo:lo + CHUNK])
    system.flush_backend()
    jax.block_until_ready(system.arena)
    dt = time.perf_counter() - t0

    n_ok = sum(1 for r in system.results if bool(r.tracking_ok))
    print(f"ours tracking+BA[{mode}]: {n} frames in {dt:.3f}s, "
          f"{system.n_keyframes} keyframes (BA each), "
          f"{n_ok}/{len(system.results)} ok", file=sys.stderr)
    return n / dt, system.n_keyframes, n_ok, system


def bench_stages(cfg, frames) -> dict:
    """Per-stage steady-state device ms via SCAN PROBES: each stage runs
    inside one jitted lax.scan over different per-frame inputs, so the
    number is the in-context device time the engine actually pays —
    replaces round-2's same-input re-dispatch table whose figures
    contradicted the end-to-end measurement (VERDICT r2 weak #1)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from modular_slam_tpu.engine import make_slam_scan
    from modular_slam_tpu.frontend.tracker import initial_state, track_frame
    from modular_slam_tpu.geometry.camera import camera_from_config
    from modular_slam_tpu.map.arena import empty_arena
    from modular_slam_tpu.ops.detector import detect

    cam = camera_from_config(cfg.camera)
    # amortize each probe's one dispatch over >= 64 scan steps
    n0 = 32
    grays0, depths0, times0 = _stage_frames(frames[WARMUP:WARMUP + n0])
    n = 2 * n0
    grays = jnp.concatenate([grays0, grays0])
    depths = jnp.concatenate([depths0, depths0])
    times = jnp.concatenate([times0, times0 + 100.0])
    keys = jax.random.split(jax.random.PRNGKey(0), n)

    def timed(run, args, per):
        out = run(*args)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args))
        return (time.perf_counter() - t0) / per * 1e3

    # -- detect-only scan ---------------------------------------------------
    @jax.jit
    def run_detect(gs, ds):
        def body(c, x):
            f = detect(x[0], x[1], cfg.detector)
            # consume EVERY output — reducing only uv lets XLA dead-code
            # the descriptor/orientation work and under-reports detect
            return (c + jnp.sum(f.keypoints.uv)
                    + jnp.sum(f.descriptors.unpacked.astype(jnp.float32))
                    + jnp.sum(f.keypoints.angle)
                    + jnp.sum(f.keypoints.depth), 0)
        return lax.scan(body, jnp.float32(0), (gs, ds))[0]

    detect_ms = timed(run_detect, (grays, depths), n)

    # -- full step scan (detect + track) ------------------------------------
    # build a realistic tracked arena first (also yields per-frame features)
    scan_f = make_slam_scan(cfg, with_features=True)
    arena0, state0 = empty_arena(cfg.map), initial_state()
    arena, state, (results, feats) = scan_f(
        arena0, state0, grays, depths, times, keys)
    jax.block_until_ready(arena)

    @jax.jit
    def run_step(arena, state, gs, ds, ts, ks):
        def body(carry, x):
            a, s = carry
            g, d, t, k = x
            f = detect(g, d, cfg.detector)
            a, s, r = track_frame(a, s, f, cam, cfg, t, k)
            return (a, s), r.n_inliers
        return lax.scan(body, (arena, state), (gs, ds, ts, ks))[1]

    step_ms = timed(run_step, (arena, state, grays, depths, times, keys), n)

    # -- track-only scan (pre-computed features) ----------------------------
    @jax.jit
    def run_track(arena, state, fs, ts, ks):
        def body(carry, x):
            a, s = carry
            f, t, k = x
            a, s, r = track_frame(a, s, f, cam, cfg, t, k)
            return (a, s), r.n_inliers
        return lax.scan(body, (arena, state), (fs, ts, ks))[1]

    track_ms = timed(run_track, (arena, state, feats, times, keys), n)

    # -- local BA probe: extract+solve+merge over the tracked arena's
    #    keyframes (different window per step) ------------------------------
    import dataclasses

    from modular_slam_tpu.backend.ba import (extract_window, merge_window,
                                             solve_window)

    bcfg = dataclasses.replace(
        cfg.backend, max_iterations=cfg.backend.local_max_iterations)
    n_kf = max(int(arena.n_kf), 1)
    slots = jnp.asarray(
        [i % n_kf for i in range(16)], jnp.int32)

    @jax.jit
    def run_ba(arena, state, slots):
        def body(c, slot):
            prob = extract_window(cam, arena, slot, bcfg)
            sol = solve_window(cam, prob, bcfg)
            a2, s2 = merge_window(arena, state, prob, sol)
            return c + jnp.sum(a2.kf_t) + s2.pose.t[0], 0
        return lax.scan(body, jnp.float32(0), slots)[0]

    ba_ms = timed(run_ba, (arena, state, slots), len(slots))

    # -- matcher head-to-head (plain vs engine) on the tracked arena -------
    from modular_slam_tpu.ops.match import match_descriptors

    def match_probe(match_fn):
        @jax.jit
        def run(qs, qvs, t, tv):
            def body(c, x):
                m = match_fn(x[0], x[1], t, tv, cfg.matcher)
                return c + jnp.sum(m.distance), 0
            return lax.scan(body, jnp.float32(0), (qs, qvs))[0]
        return timed(run, (feats.descriptors.unpacked, feats.keypoints.valid,
                           arena.lm_desc, arena.lm_valid), n)

    from modular_slam_tpu.ops.match_pallas import match_descriptors_fastest

    match_xla_ms = match_probe(match_descriptors)
    # the engine's matcher: the fused kernel on the GPU, plain on the CPU
    match_engine_ms = match_probe(match_descriptors_fastest)

    kf_rate = n_kf / n  # keyframes per frame on this sequence
    out_match = {"match_xla_ms": round(match_xla_ms, 3),
                 "match_engine_ms": round(match_engine_ms, 3)}
    return {
        "detect_ms": round(detect_ms, 3),
        "step_ms": round(step_ms, 3),
        "track_only_ms": round(track_ms, 3),
        "detect_in_step_ms": round(step_ms - track_ms, 3),
        "local_ba_ms": round(ba_ms, 3),
        "local_ba_amortized_ms_per_frame": round(ba_ms * kf_rate, 3),
        "keyframes_per_frame": round(kf_rate, 4),
        **out_match,
    }


def bench_degraded(n_frames=None) -> dict:
    """Tracking+BA on the DEGRADED plane world (photometric noise,
    exposure jitter, motion blur, moving distractor with its own depth —
    eval/synthetic.py DegradedScene): throughput + tracked fraction +
    ATE vs exact ground truth.  VERDICT r3 next #9: the only available
    path toward TUM-realism credibility without network access."""
    from modular_slam_tpu.config import SlamConfig
    from modular_slam_tpu.eval.ate import ate_rmse
    from modular_slam_tpu.eval.synthetic import (DegradedScene,
                                                 PlaneSceneGenerator)

    cfg = SlamConfig()
    base = PlaneSceneGenerator(cfg.camera, seed=42, depth_noise=0.01)
    gen = DegradedScene(base, seed=42)
    n = n_frames or N_FRAMES
    poses = base.trajectory(n, step_t=(0.05, 0.02, 0.01),
                            step_rot=(0.004, 0.008, 0.004))
    frames = [(rgb, depth, ts) for rgb, depth, ts in gen.sequence(poses)]
    fps, n_kf, n_ok, system = bench_ours_full(cfg, frames, mode="pipelined")
    est = np.array([
        [ts, float(p.t[0]), float(p.t[1]), float(p.t[2]),
         float(p.q[1]), float(p.q[2]), float(p.q[3]), float(p.q[0])]
        for ts, p in system.trajectory])
    gt = np.zeros((len(poses), 8))
    for k, p in enumerate(poses):
        gt[k, 0] = k / 30.0
        gt[k, 1:4] = np.asarray(p.t)
        q = np.asarray(p.q)
        gt[k, 4:7], gt[k, 7] = q[1:4], q[0]
    out = {
        "tracking_ba_fps": round(fps, 3),
        "tracked_ok": int(n_ok),
        "n_frames": len(frames),
        "n_keyframes": int(n_kf),
        "degradations": "noise sigma=4, exposure jitter 12%, 5px motion "
                        "blur, moving distractor w/ own depth, "
                        "depth noise 1cm",
    }
    try:
        out["ate_rmse_m"] = round(ate_rmse(est, gt)["rmse"], 4)
    except ValueError as e:
        out["ate_error"] = str(e)
    print(f"degraded world: {out}", file=sys.stderr)
    return out


def _score_closures(system, poses, min_gap, thr=0.35, opp_thr=0.5,
                    sweep=(0.05, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5)) -> dict:
    """Score accepted closures against synthetic ground truth (VERDICT r3
    next #6): a closure is a TRUE positive when the MEASURED query pose
    from geometric verification lands within `thr` meters of the query
    keyframe's ground-truth position — "did verification recover the
    right pose" (a partial-overlap closure between distant keyframe
    centers is genuine; keyframe-center distance would mislabel it).
    Recall counts keyframes that had a true revisit available (some
    prior keyframe >= min_gap back within `opp_thr` of the same place)
    and fired a closure.  The post-hoc score sweep reuses the event
    log: a closure accepted with BoW score s would have fired at any
    gate <= s."""
    kf_time = np.asarray(system.arena.kf_time)
    kf_valid = np.asarray(system.arena.kf_valid)
    gt_pos = np.array([np.asarray(p.t) for p in poses])

    def slot_gt(slot):
        fi = int(round(kf_time[slot] * 30.0))
        return gt_pos[min(fi, len(gt_pos) - 1)]

    events = []
    for cur, cand, n_inl, score, meas_t in system._loop.closures:
        err = float(np.linalg.norm(np.asarray(meas_t) - slot_gt(cur)))
        events.append((cur, cand, n_inl, score, err < thr))
    tp = sum(1 for e in events if e[4])
    fp = len(events) - tp

    valid_slots = np.nonzero(kf_valid)[0]       # slot order = recency order
    # a revisit is "recognized" when a closure fired at that keyframe OR
    # the map already connects it to a nearby prior keyframe (shared
    # landmarks past the covisibility gate's threshold — continuous
    # tracking reuse / post-fusion linkage, which CORRECTLY suppresses a
    # redundant loop edge; loop/detector.py covisibility gating).
    # Counting only fired closures would under-report exactly the runs
    # where the map did its job without needing an edge.
    inc = np.asarray(system.arena.inc)
    covis_thr = system.cfg.loop.max_covis_overlap
    cooldown = system.cfg.loop.closure_cooldown_keyframes
    opp, hit_closure, hit_connected, hit_cooldown = 0, 0, 0, 0
    # only TRUE-POSITIVE closures recognize a revisit or open a credited
    # cooldown window — a false-positive closure must not launder the
    # opportunities around it into hits (code-review r5 finding #4)
    closed_tp = {cur for cur, _, _, _, is_tp in events if is_tp}
    last_closed_i = -(10 ** 9)
    opp_rows = []   # (i, recognized) per opportunity keyframe
    for i, s in enumerate(valid_slots):
        prior = valid_slots[: max(0, i - min_gap)]
        if len(prior) == 0:
            continue
        near = [p for p in prior
                if float(np.linalg.norm(slot_gt(s) - slot_gt(p))) < opp_thr]
        if not near:
            continue
        opp += 1
        recognized = False
        if s in closed_tp:
            hit_closure += 1
            last_closed_i = i
            recognized = True
        elif any(int((inc[s] & inc[p]).sum()) > covis_thr for p in near):
            hit_connected += 1
            recognized = True
        elif i - last_closed_i <= cooldown:
            hit_cooldown += 1  # suppressed by a true closure's cooldown
            recognized = True
        opp_rows.append((float(kf_time[s]), recognized))
    # EPISODE recall: temporally contiguous opportunity keyframes are
    # one revisit EVENT (a lap re-entering mapped territory spans
    # several keyframes; detection a few keyframes into the episode is
    # a recognized revisit — the convention loop-closure recall is
    # reported with.  The per-keyframe recall above additionally
    # penalizes recognition LATENCY within the episode.)  Episodes
    # break on a > ep_gap_s time gap between opportunity keyframes.
    ep_gap_s = 10.0 / 30.0
    episodes, ep_hits = 0, 0
    j = 0
    while j < len(opp_rows):
        k = j
        hit_ep = False
        while k < len(opp_rows) and (
                k == j or opp_rows[k][0] - opp_rows[k - 1][0] <= ep_gap_s):
            hit_ep = hit_ep or opp_rows[k][1]
            k += 1
        episodes += 1
        ep_hits += int(hit_ep)
        j = k
    hit = hit_closure + hit_connected + hit_cooldown
    out = {
        "closures": len(events),
        "true_positives": tp,
        "false_positives": fp,
        "recall": round(hit / opp, 3) if opp else None,
        "episode_recall": round(ep_hits / episodes, 3) if episodes else None,
        "revisit_episodes": episodes,
        "recall_closure_only": round(hit_closure / opp, 3) if opp else None,
        "revisits_closed": hit_closure,
        "revisits_map_connected": hit_connected,
        "revisits_in_cooldown": hit_cooldown,
        "revisit_opportunities": opp,
        "verify_rejections": system._loop.n_verify_rejects,
    }
    out["score_sweep"] = {
        str(t): {"tp": sum(1 for e in events if e[4] and e[3] >= t),
                 "fp": sum(1 for e in events if not e[4] and e[3] >= t)}
        for t in sweep}
    return out


def bench_loop(_cfg_unused, flagship=False) -> dict:
    """Loop-closure latency on a trajectory that verifiably CLOSES loops
    (the tests' two-lap noisy-depth revisit, tests/test_loop_e2e.py —
    the bench's 640x480 forward sweep never revisits): full pipeline
    (BoW query + verify + PGO + tier-compacted global BA on every
    verified closure), reporting mean wall ms per closure-handling
    keyframe event WITH a per-stage breakdown (bow/query/verify/pgo/
    global-BA/fusion) and precision/recall vs the synthetic ground
    truth.  `flagship=True` runs the 640x480 / 256-kf / 16k-lm /
    131k-obs capacity point (VERDICT r3 next #2)."""
    import dataclasses

    import jax

    from modular_slam_tpu.config import (CameraConfig, DetectorConfig,
                                         LoopConfig, MapConfig, PnpConfig,
                                         SlamConfig, TrackerConfig)
    from modular_slam_tpu.config import BackendConfig as _B
    from modular_slam_tpu.eval.synthetic import PlaneSceneGenerator
    from modular_slam_tpu.models.pipelines import full_slam_pipeline

    if flagship:
        cfg = SlamConfig(
            map=MapConfig(max_keyframes=256, max_landmarks=16384,
                          max_observations=131072),
            # near-every-frame keyframes: ~90 keyframes x ~400 landmarks
            # drive the solve into the big compaction tiers; with ~45
            # keyframes per lap the temporal gap must span most of a lap
            # so only genuine lap-to-lap revisits count as candidates
            tracker=TrackerConfig(new_keyframe_min_inliers=300),
            loop=LoopConfig(min_gap_keyframes=32, min_score=0.05,
                            min_inliers=25, global_ba_on_loop=True),
        )
        gen = PlaneSceneGenerator(cfg.camera, seed=3, depth_noise=0.03)
        poses = gen.loop_trajectory(48, radius=1.2) * 2    # 2 laps, 640x480
    else:
        cfg = SlamConfig(
            camera=CameraConfig(fx=320.0, fy=320.0, cx=159.5, cy=119.5,
                                width=320, height=240),
            detector=DetectorConfig(n_levels=4, max_keypoints=384),
            map=MapConfig(max_keyframes=64, max_landmarks=8192,
                          max_observations=32768),
            pnp=PnpConfig(n_hypotheses=64),
            backend=_B(max_iterations=8),
            loop=LoopConfig(min_gap_keyframes=4, min_score=0.05,
                            min_inliers=25, global_ba_on_loop=True),
        )
        gen = PlaneSceneGenerator(cfg.camera, seed=3, depth_noise=0.03)
        poses = gen.loop_trajectory(24, radius=1.2) * 4    # 4 laps
    frames = [(rgb, depth, ts) for rgb, depth, ts in gen.sequence(poses)]
    grays, depths, times = _stage_frames(frames)
    tss = [ts for _, _, ts in frames]

    import jax.numpy as jnp

    def _one_pass(profile: bool):
        """One full run.  `profile=False` measures the TRUE per-closure
        wall time (one block at event end); `profile=True` additionally
        blocks after every stage for the breakdown — that adds one
        device->host sync PER STAGE, so its event totals must never be
        quoted as the closure latency."""
        system = full_slam_pipeline(cfg, ba_mode="sync")
        system._loop.profile = profile
        # warmup chunk compiles scan+loop jits
        system.process_chunk_device(grays[:CHUNK], depths[:CHUNK],
                                    tss[:CHUNK])
        jax.block_until_ready(system.arena)
        # pre-compile the closure path (verify / PGO / global BA /
        # fusion) so the first real closure's timing is execution, not
        # compilation
        system.process(*frames[CHUNK])
        lp = system._loop
        key = jax.random.PRNGKey(0)
        jax.block_until_ready(lp._verify_slots(
            system.arena, jnp.zeros((cfg.loop.top_k,), jnp.float32),
            jnp.zeros((cfg.loop.top_k,), jnp.int32),
            system.last_features, key))
        jax.block_until_ready(lp._close(
            system.arena, lp.edges, jnp.int32(0), jnp.int32(0),
            jnp.asarray([1.0, 0, 0, 0], jnp.float32),
            jnp.zeros((3,), jnp.float32), jnp.int32(lp._n_edges),
            system.state.pose.q, system.state.pose.t)[0].kf_t)
        a_warm, _ = lp._run_global_ba(system.arena, system.state,
                                      max(system.n_keyframes - 1, 0))
        jax.block_until_ready(a_warm.kf_t)
        system.arena = a_warm  # _run_global_ba donates its input arena
        a2, _ = lp._fuse(system.arena, jnp.int32(0), jnp.int32(0))
        system.arena = a2
        # (the warmup _close call above did NOT commit its edge: its
        # outputs were discarded, so lp.edges still holds only the real
        # odometry edges)
        # precompile the NEXT global-BA compaction tiers the growing map
        # will reach (2x/4x each dim, capped at capacity), so mid-run
        # closures measure execution, not tier compilation
        from modular_slam_tpu.backend.ba import (global_ba_tier,
                                                 make_global_ba_compact)

        t0_ = global_ba_tier(system.arena)
        m = cfg.map
        warm_tiers = {t0_}
        # landmark/observation counts grow faster than keyframes, so
        # cover per-dimension growth combinations, not just uniform ones
        for fk, fl, fo in ((1, 2, 1), (1, 4, 1), (1, 2, 2), (1, 4, 4),
                           (2, 2, 2), (2, 4, 4), (4, 4, 4)):
            warm_tiers.add((min(t0_[0] * fk, m.max_keyframes),
                            min(t0_[1] * fl, m.max_landmarks),
                            min(t0_[2] * fo, m.max_observations)))
        for tier in warm_tiers:
            if tier not in lp._gba_tiers:
                lp._gba_tiers[tier] = make_global_ba_compact(cfg, tier)
                lp._gba_tiers[tier].lower(system.arena).compile()
        # the warmup _run_global_ba may have DEFERRED (tier compiling in
        # background); clear the flag so the first timed closure doesn't
        # run an extra catch-up polish
        lp._gba_pending = False
        gba_warm = lp.n_global_ba
        # warmup keyframes polluted the profile/event logs — reset
        lp.stage_ms = {k: [] for k in lp.stage_ms}
        lp.closures = []
        lp.n_verify_rejects = 0

        orig = lp.on_new_keyframe
        closure_times = []

        def timed_loop(*a, **k):
            t0 = time.perf_counter()
            out = orig(*a, **k)
            jax.block_until_ready(out[0].kf_t)
            dt = time.perf_counter() - t0
            if out[2]:
                closure_times.append(dt)
            return out

        lp.on_new_keyframe = timed_loop
        for lo in range(CHUNK, len(frames) - (len(frames) % CHUNK),
                        CHUNK):
            system.process_chunk_device(
                grays[lo:lo + CHUNK], depths[lo:lo + CHUNK],
                tss[lo:lo + CHUNK])
        jax.block_until_ready(system.arena)
        return system, closure_times, gba_warm

    # pass 1: unprofiled -> authoritative closure latency
    system, closure_times, gba_warmup_runs = _one_pass(profile=False)
    # pass 2: profiled -> per-stage breakdown (inflated totals)
    system_p, _, _ = _one_pass(profile=True)

    out = {
        "n_loop_closures": system.n_loop_closures,
        "n_keyframes": system.n_keyframes,
        "global_ba_runs": system._loop.n_global_ba - gba_warmup_runs,
        "capacity": (f"{cfg.camera.width}x{cfg.camera.height}, "
                     f"kf={cfg.map.max_keyframes}, "
                     f"lm={cfg.map.max_landmarks}, "
                     f"obs={cfg.map.max_observations}"),
    }
    if closure_times:
        import statistics as _st

        # median is the steady-state number: a map growing into a NEW
        # compaction tier compiles that tier once, and that first event
        # carries the compile (the persistent cache absorbs it across
        # runs); mean/max are kept for the worst case
        out["closure_ms_median"] = round(
            1e3 * _st.median(closure_times), 1)
        out["closure_ms_mean"] = round(
            1e3 * sum(closure_times) / len(closure_times), 1)
        out["closure_ms_max"] = round(1e3 * max(closure_times), 1)
    out["gba_tiers_compiled"] = sorted(system._loop._gba_tiers.keys())
    # per-stage breakdown from the PROFILED pass (each stage's number
    # includes its own blocking fetch — sum exceeds the true
    # closure latency above; 'bow'/'query' run on every keyframe, the
    # rest only on closure events)
    import statistics as _st2
    out["stage_ms_median_profiled"] = {
        k: round(_st2.median(v), 1)
        for k, v in system_p._loop.stage_ms.items() if v}
    out["stage_ms_max_profiled"] = {
        k: round(max(v), 1)
        for k, v in system_p._loop.stage_ms.items() if v}
    # score with the EFFECTIVE adaptive gap (loop/detector.py), not the
    # cap: a fixed cap of 32 exceeded the flagship run's keyframe count,
    # so the scorer saw zero revisit opportunities and recall was null
    # (VERDICT r4 weak #7)
    # --- OVERLAPPED closure handling (VERDICT r4 next #5): deferred-
    # pipelined mode parks verification futures and resolves them at the
    # next chunk entry, so closure handling must cost far less than the
    # synchronous latency above.  Measured as the wall-time delta of the
    # whole pipelined run with closures on vs off, per closure.
    def _deferred_wall(enable_loop: bool):
        sysd = full_slam_pipeline(cfg, ba_mode="sync",
                                  defer_chunk_sync=True)
        sysd.enable_loop_closure = enable_loop
        lpd = sysd._loop
        # per-instance jitted closures re-trace for every fresh
        # pipeline; share the already-compiled GBA tier executables and
        # warm the closure-chain jits BEFORE the timed region, exactly
        # like _one_pass — otherwise the "overlap" number times jit
        # loading, not closure handling
        lpd._gba_tiers.update(system._loop._gba_tiers)
        sysd.process_chunk_device(grays[:CHUNK], depths[:CHUNK],
                                  tss[:CHUNK])
        jax.block_until_ready(sysd.arena.kf_t)
        sysd.process(*frames[CHUNK])
        key = jax.random.PRNGKey(0)
        jax.block_until_ready(lpd._verify_slots(
            sysd.arena, jnp.zeros((cfg.loop.top_k,), jnp.float32),
            jnp.zeros((cfg.loop.top_k,), jnp.int32),
            sysd.last_features, key))
        jax.block_until_ready(lpd._close(
            sysd.arena, lpd.edges, jnp.int32(0), jnp.int32(0),
            jnp.asarray([1.0, 0, 0, 0], jnp.float32),
            jnp.zeros((3,), jnp.float32), jnp.int32(lpd._n_edges),
            sysd.state.pose.q, sysd.state.pose.t)[0].kf_t)
        a2_, _ = lpd._fuse(sysd.arena, jnp.int32(0), jnp.int32(0))
        sysd.arena = a2_
        lpd._gba_pending = False
        t0 = time.perf_counter()
        for lo in range(2 * CHUNK, len(frames) - (len(frames) % CHUNK),
                        CHUNK):
            sysd.process_chunk_device(
                grays[lo:lo + CHUNK], depths[lo:lo + CHUNK],
                tss[lo:lo + CHUNK])
        sysd.flush_backend()
        jax.block_until_ready(sysd.arena.kf_t)
        return time.perf_counter() - t0, sysd.n_loop_closures

    w_on, n_cl = _deferred_wall(True)
    w_off, _ = _deferred_wall(False)
    out["deferred_overlap"] = {
        "wall_s_loop_on": round(w_on, 3),
        "wall_s_loop_off": round(w_off, 3),
        "closures": n_cl,
        "added_ms_per_closure": round(
            1e3 * max(w_on - w_off, 0.0) / max(n_cl, 1), 1),
    }

    n_live = int(np.asarray(system.arena.kf_valid).sum())
    eff_gap = int(np.clip(round(cfg.loop.min_gap_fraction * n_live),
                          cfg.loop.min_gap_floor,
                          cfg.loop.min_gap_keyframes))
    out["accuracy"] = _score_closures(system, poses, eff_gap)
    out["accuracy"]["effective_min_gap"] = eff_gap
    print(f"loop bench: {out}", file=sys.stderr)
    return out


# ---------------------------------------------------------------------------
# host-CPU proxy baseline
# ---------------------------------------------------------------------------


def _rodrigues(rvec):
    import cv2

    return cv2.Rodrigues(np.asarray(rvec, np.float64))[0]


def _numpy_local_ba(kf_poses, points, obs, fixed0=True, iters=10,
                    lm_lambda=1e-4):
    """Dense-Schur Levenberg-Marquardt local BA — the CPU proxy for the
    reference's intended CeresBackend local solve (ceres_backend.cpp:
    point-to-point residual :40-44, local window :162-171, <=100 iters).

    kf_poses: list of (R_cw [3,3], t_cw [3]) camera-from-world
    points:   [L, 3] world landmarks (optimized)
    obs:      list of (k, l, x_cam [3]) depth-backprojected measurements
    Returns (kf_poses, points, final_cost).
    """
    K, L = len(kf_poses), len(points)
    R = np.stack([p[0] for p in kf_poses])
    t = np.stack([p[1] for p in kf_poses])
    X = points.copy()
    ks = np.array([o[0] for o in obs])
    ls = np.array([o[1] for o in obs])
    meas = np.stack([o[2] for o in obs])
    lam = lm_lambda

    def cost(R, t, X):
        pc = np.einsum("oij,oj->oi", R[ks], X[ls]) + t[ks]
        return 0.5 * np.sum((pc - meas) ** 2)

    c_prev = cost(R, t, X)
    for _ in range(iters):
        pc = np.einsum("oij,oj->oi", R[ks], X[ls]) + t[ks]
        r = pc - meas                                   # [O, 3]
        # jacobians per obs: pose (w, dt) and landmark
        Jp = np.zeros((len(obs), 3, 6))
        rx = np.einsum("oij,oj->oi", R[ks], X[ls])      # rotated point
        Jp[:, 0, 1], Jp[:, 0, 2] = rx[:, 2], -rx[:, 1]  # -[rx]_x
        Jp[:, 1, 0], Jp[:, 1, 2] = -rx[:, 2], rx[:, 0]
        Jp[:, 2, 0], Jp[:, 2, 1] = rx[:, 1], -rx[:, 0]
        Jp[:, :, 3:] = np.eye(3)
        Jl = R[ks]                                      # [O, 3, 3]

        U = np.zeros((K, 6, 6))
        V = np.zeros((L, 3, 3))
        W = np.zeros((K, L, 6, 3))
        gp = np.zeros((K, 6))
        gl = np.zeros((L, 3))
        np.add.at(U, ks, np.einsum("oai,oaj->oij", Jp, Jp))
        np.add.at(V, ls, np.einsum("oai,oaj->oij", Jl, Jl))
        np.add.at(W, (ks, ls), np.einsum("oai,oaj->oij", Jp, Jl))
        np.add.at(gp, ks, np.einsum("oai,oa->oi", Jp, r))
        np.add.at(gl, ls, np.einsum("oai,oa->oi", Jl, r))

        U += lam * np.eye(6)
        V += lam * np.eye(3)
        Vinv = np.linalg.inv(V)
        # reduced camera system S dx = rhs
        S = np.zeros((K * 6, K * 6))
        for a in range(K):
            S[a * 6:(a + 1) * 6, a * 6:(a + 1) * 6] = U[a]
        WVi = np.einsum("klij,ljm->klim", W, Vinv)      # [K, L, 6, 3]
        S -= np.einsum("alim,bljm->abij", WVi, W).transpose(
            0, 2, 1, 3).reshape(K * 6, K * 6)
        rhs = -(gp - np.einsum("klim,lm->ki", WVi, gl)).reshape(-1)
        if fixed0:  # gauge: oldest keyframe fixed (ceres_backend.cpp:155-159)
            S[:6, :] = 0.0
            S[:, :6] = 0.0
            S[:6, :6] = np.eye(6)
            rhs[:6] = 0.0
        try:
            dxp = np.linalg.solve(S, rhs).reshape(K, 6)
        except np.linalg.LinAlgError:
            lam *= 10
            continue
        dxl = -np.einsum("lij,lj->li", Vinv,
                         gl + np.einsum("klim,ki->lm", W, dxp))

        R_new = np.stack([_rodrigues(dxp[a, :3]) @ R[a] for a in range(K)])
        t_new = t + dxp[:, 3:]
        X_new = X + dxl
        c_new = cost(R_new, t_new, X_new)
        if c_new < c_prev:
            R, t, X, c_prev = R_new, t_new, X_new, c_new
            lam = max(lam * 0.3, 1e-9)
        else:
            lam *= 10
    return [(R[a], t[a]) for a in range(K)], X, c_prev


def _gt_rows(poses):
    gt = np.zeros((len(poses), 8))
    for k, p in enumerate(poses):
        gt[k, 0] = k / 30.0
        gt[k, 1:4] = np.asarray(p.t)
        q = np.asarray(p.q)
        gt[k, 4:7], gt[k, 7] = q[1:4], q[0]
    return gt


def bench_opencv_baseline(cfg, frames, with_ba: bool, collect_traj=None):
    """The reference's per-frame hot path via OpenCV, with the reference's
    keyframe rule (inliers < 30 -> new keyframe, rgbd_feature_frontend.cpp
    :156-162) and, when with_ba, the proxy local BA per keyframe."""
    import cv2

    cam = cfg.camera
    Kmat = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]],
                    np.float32)
    orb = cv2.ORB_create(1000)
    bf = cv2.BFMatcher(cv2.NORM_HAMMING)
    grays = [cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY) for rgb, _, _ in frames]

    def backproject(kps, descs, depth, R_wc, t_wc):
        pts_w, pts_c, good_desc, pix = [], [], [], []
        for k, d in zip(kps, descs):
            u, v = int(round(k.pt[0])), int(round(k.pt[1]))
            z = float(depth[min(v, depth.shape[0] - 1),
                            min(u, depth.shape[1] - 1)])
            if z > 0:
                pc = np.array([(k.pt[0] - cam.cx) * z / cam.fx,
                               (k.pt[1] - cam.cy) * z / cam.fy, z])
                pts_c.append(pc)
                pts_w.append(R_wc @ pc + t_wc)
                good_desc.append(d)
                pix.append(k.pt)
        return (np.array(pts_w, np.float32), np.array(pts_c, np.float64),
                np.array(good_desc), np.array(pix, np.float32))

    t0 = time.perf_counter()
    # bootstrap keyframe at identity
    kp0, des0 = orb.detectAndCompute(grays[0], None)
    I, z3 = np.eye(3), np.zeros(3)
    pts_w, pts_c, desc_ref, _ = backproject(kp0, des0, frames[0][1], I, z3)
    keyframes = [{"R_cw": I.copy(), "t_cw": z3.copy(),
                  "pts_w_idx": np.arange(len(pts_w)), "pts_c": pts_c}]
    world_pts = list(pts_w)
    rvec, tvec = np.zeros((3, 1)), np.zeros((3, 1))
    n, n_kf, ba_ms = 0, 1, 0.0

    for fi in range(WARMUP, len(frames)):
        gray, depth = grays[fi], frames[fi][1]
        kp, des = orb.detectAndCompute(gray, None)
        if des is None or len(des) < 10:
            continue
        matches = bf.knnMatch(des, desc_ref, k=2)
        good = [m for m, s in (p for p in matches if len(p) == 2)
                if m.distance < 0.7 * s.distance]
        n += 1
        if len(good) < 10:
            continue
        obj = pts_w[[m.trainIdx for m in good]]
        img = np.array([kp[m.queryIdx].pt for m in good], np.float32)
        okp, rvec, tvec, inl = cv2.solvePnPRansac(
            obj, img, Kmat, None, rvec=rvec, tvec=tvec,
            useExtrinsicGuess=True, iterationsCount=100,
            reprojectionError=5.0, confidence=0.99)
        n_inl = 0 if inl is None else len(inl)
        if collect_traj is not None and okp:
            Rcw = _rodrigues(rvec.ravel())
            tw = -Rcw.T @ tvec.ravel()
            collect_traj.append((frames[fi][2], Rcw.T, tw))
        if okp and n_inl < 30:  # reference keyframe rule
            R_cw = _rodrigues(rvec.ravel())
            t_cw = tvec.ravel()
            R_wc, t_wc = R_cw.T, -R_cw.T @ t_cw
            pts_w, pts_c, desc_ref, _ = backproject(
                kp, des, depth, R_wc, t_wc)
            base = len(world_pts)
            world_pts.extend(pts_w)
            keyframes.append({
                "R_cw": R_cw, "t_cw": t_cw,
                "pts_w_idx": np.arange(base, base + len(pts_w)),
                "pts_c": pts_c})
            n_kf += 1
            if with_ba:
                tb = time.perf_counter()
                win = keyframes[-BA_WINDOW:]
                lm_ids = np.concatenate([k["pts_w_idx"] for k in win])
                id_map = {g: i for i, g in enumerate(lm_ids)}
                X = np.array([world_pts[g] for g in lm_ids], np.float64)
                obs = []
                for a, kfr in enumerate(win):
                    for g, pc in zip(kfr["pts_w_idx"], kfr["pts_c"]):
                        obs.append((a, id_map[g], pc))
                poses = [(k["R_cw"], k["t_cw"]) for k in win]
                poses, X, _ = _numpy_local_ba(poses, X, obs)
                for a, kfr in enumerate(win):
                    kfr["R_cw"], kfr["t_cw"] = poses[a]
                for i, g in enumerate(lm_ids):
                    world_pts[g] = X[i]
                ba_ms += (time.perf_counter() - tb) * 1e3
    dt = time.perf_counter() - t0
    tag = "track+BA" if with_ba else "tracking"
    print(f"opencv proxy {tag}: {n} frames in {dt:.3f}s, {n_kf} keyframes, "
          f"BA total {ba_ms:.1f}ms", file=sys.stderr)
    return n / dt


def _load_pinned_baseline():
    """BASELINE_PROXY.json (tools/pin_baseline.py): median-of-N pinned
    proxy numbers so vs_baseline has a stable denominator across rounds
    (VERDICT r3 weak #2: the live proxy drifted 26-28 % round-to-round,
    making headline ratios incomparable)."""
    import pathlib

    p = pathlib.Path(__file__).resolve().parent / "BASELINE_PROXY.json"
    if p.exists():
        return json.loads(p.read_text())
    return None


def main() -> int:
    from modular_slam_tpu.utils import setup_compile_cache

    setup_compile_cache()
    import jax

    cfg, frames, gt_poses = _sequence("plane")
    print(f"device: {jax.devices()[0]}", file=sys.stderr)

    startup_s = bench_startup(cfg, frames)
    fps_track = bench_ours_tracking(cfg, frames)
    fps_full, n_kf, n_ok, sys_full = bench_ours_full(cfg, frames,
                                                      mode="pipelined")
    fps_sync, _, _, _ = bench_ours_full(cfg, frames, mode="sync")
    # VERDICT r3 next #3: measure the CPU-offload async executor against
    # inline-sync BA under the same deferred-pipelined chunking
    fps_async, _, _, _ = bench_ours_full(cfg, frames, mode="pipelined",
                                         ba_mode="async")
    stages = bench_stages(cfg, frames)
    proxy_traj = []
    base_track_live = bench_opencv_baseline(cfg, frames, with_ba=False,
                                            collect_traj=proxy_traj)
    base_full_live = bench_opencv_baseline(cfg, frames, with_ba=True)

    # second scenario: box world (occlusion + depth discontinuities)
    cfg_b, frames_b, _ = _sequence("box")
    fps_box, n_kf_box, ok_box, _ = bench_ours_full(cfg_b, frames_b,
                                                   mode="pipelined")
    base_box_live = bench_opencv_baseline(cfg_b, frames_b, with_ba=True)

    # classical-baseline accuracy row: the reference-pipeline proxy's own
    # trajectory scored against exact ground truth, next to ours.  The
    # docker ORB-SLAM3/stella generation of the reference's evaluate.py is
    # environment-impossible (no network/docker); this is the in-env
    # classical comparison substitute (VERDICT r3 missing #3).
    from modular_slam_tpu.eval.ate import ate_rmse

    gt_rows = _gt_rows(gt_poses)
    accuracy = {}
    try:
        est_ours = np.array([
            [ts, float(pp.t[0]), float(pp.t[1]), float(pp.t[2]),
             float(pp.q[1]), float(pp.q[2]), float(pp.q[3]), float(pp.q[0])]
            for ts, pp in sys_full.trajectory])
        accuracy["ours_ate_rmse_m"] = round(
            ate_rmse(est_ours, gt_rows)["rmse"], 4)
    except ValueError as e:
        accuracy["ours_ate_error"] = str(e)
    try:
        est_proxy = np.array([
            [ts, t[0], t[1], t[2], 0.0, 0.0, 0.0, 1.0]
            for ts, _R, t in proxy_traj])
        accuracy["classical_proxy_ate_rmse_m"] = round(
            ate_rmse(est_proxy, gt_rows)["rmse"], 4)
        accuracy["classical_proxy_frames"] = len(proxy_traj)
    except ValueError as e:
        accuracy["classical_proxy_ate_error"] = str(e)

    degraded = bench_degraded()
    loop_stats = bench_loop(cfg)
    loop_flagship = bench_loop(cfg, flagship=True)

    pinned = _load_pinned_baseline()
    if pinned is not None:
        base_track = pinned["tracking_fps"]
        base_full = pinned["tracking_ba_fps"]
        base_box = pinned["box_tracking_ba_fps"]
        base_note = ("host-CPU proxy (PINNED median-of-%d, "
                     "BASELINE_PROXY.json %s): OpenCV ORB+BF+solvePnPRansac"
                     " (+ numpy Schur-LM local BA per keyframe)"
                     % (pinned["n_runs"], pinned["pinned_at"]))
    else:
        base_track, base_full, base_box = (base_track_live, base_full_live,
                                           base_box_live)
        base_note = ("host-CPU proxy (LIVE, unpinned): OpenCV "
                     "ORB+BF+solvePnPRansac (+ numpy Schur-LM local BA)")

    detail = {
        "metric": "tracking_ba_frames_per_s_per_chip",
        "value": round(fps_full, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps_full / base_full, 3),
        "ba_mode": "deferred-pipelined: host bookkeeping + BA dispatch "
                   "overlap the next chunk's device execution",
        "tracking_ba_sync_fps": round(fps_sync, 3),
        "tracking_ba_async_offload_fps": round(fps_async, 3),
        "tracking_frames_per_s_per_chip": round(fps_track, 3),
        "tracking_vs_baseline": round(fps_track / base_track, 3),
        "baseline": base_note,
        "baseline_tracking_fps": round(base_track, 3),
        "baseline_tracking_ba_fps": round(base_full, 3),
        "baseline_tracking_fps_live": round(base_track_live, 3),
        "baseline_tracking_ba_fps_live": round(base_full_live, 3),
        "stage_ms": stages,
        "box_world": {
            "tracking_ba_fps": round(fps_box, 3),
            "vs_baseline": round(fps_box / base_box, 3),
            "baseline_tracking_ba_fps": round(base_box, 3),
            "baseline_tracking_ba_fps_live": round(base_box_live, 3),
            "n_keyframes": int(n_kf_box),
            "tracked_ok": int(ok_box),
        },
        "accuracy_plane_world": accuracy,
        "degraded_world": degraded,
        "loop_closure": loop_stats,
        "loop_closure_flagship": loop_flagship,
        "startup_warm_s": round(startup_s, 1),
        "n_keyframes": int(n_kf),
        "tracked_ok": int(n_ok),
        "n_frames": len(frames),
    }

    # Full detail goes to a FILE; the driver's record keeps only a
    # ~2000-char tail of stdout and parses the LAST line, so round 4's
    # headline was lost when the one-line dump outgrew the tail
    # (VERDICT r4 weak #4 / next #4).  The last stdout line below is a
    # compact headline (< 1.5 kB) referencing the detail by path.
    import os

    detail_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "reports", "bench_detail.json")
    os.makedirs(os.path.dirname(detail_path), exist_ok=True)
    with open(detail_path, "w") as f:
        json.dump(detail, f, indent=2)
    print(f"detail written to {detail_path}", file=sys.stderr)

    def _acc(d, k):
        v = d.get("accuracy", {}).get(k) if d else None
        return v

    headline = {
        "metric": "tracking_ba_frames_per_s_per_chip",
        "value": round(fps_full, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps_full / base_full, 3),
        "tracking_fps": round(fps_track, 3),
        "tracking_vs_baseline": round(fps_track / base_track, 3),
        "sync_fps": round(fps_sync, 3),
        "box_fps": round(fps_box, 3),
        "box_vs_baseline": round(fps_box / base_box, 3),
        "degraded_fps": degraded.get("tracking_ba_fps"),
        "degraded_ate_m": degraded.get("ate_rmse_m"),
        "ours_ate_m": accuracy.get("ours_ate_rmse_m"),
        "classical_proxy_ate_m": accuracy.get("classical_proxy_ate_rmse_m"),
        "closure_ms_median": loop_stats.get("closure_ms_median"),
        "closure_ms_max": loop_stats.get("closure_ms_max"),
        "closure_overlap_added_ms": loop_stats.get(
            "deferred_overlap", {}).get("added_ms_per_closure"),
        "closure_recall": _acc(loop_stats, "recall"),
        "closure_episode_recall": _acc(loop_stats, "episode_recall"),
        "closure_fp": _acc(loop_stats, "false_positives"),
        "flagship_closure_ms_median":
            loop_flagship.get("closure_ms_median"),
        "flagship_closure_ms_max": loop_flagship.get("closure_ms_max"),
        "flagship_recall": _acc(loop_flagship, "recall"),
        "flagship_fp": _acc(loop_flagship, "false_positives"),
        "stage_ms_detect": stages.get("detect_in_step_ms"),
        "stage_ms_track": stages.get("track_only_ms"),
        "baseline_fps": round(base_full, 3),
        "baseline_kind": "pinned-proxy" if pinned is not None else "live",
        "startup_warm_s": round(startup_s, 1),
        "detail": "reports/bench_detail.json",
    }
    line = json.dumps(headline)
    if len(line) >= 1500:
        # degrade gracefully — never lose the whole run's record to a
        # format overflow (the driver tail-parses the LAST line): drop
        # optional fields until the headline fits
        for k in ("flagship_fp", "closure_fp", "stage_ms_detect",
                  "stage_ms_track", "sync_fps", "degraded_ate_m",
                  "box_vs_baseline", "startup_warm_s"):
            headline.pop(k, None)
            line = json.dumps(headline)
            if len(line) < 1500:
                break
        if len(line) >= 1500:  # last resort: the four core fields
            line = json.dumps({k: headline[k] for k in
                               ("metric", "value", "unit", "vs_baseline")})
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
