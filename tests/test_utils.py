"""Parameter registry, checkpoint/resume, profiling, PLY export."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from modular_slam_tpu.utils.params import (
    ParameterRegistry, make_number_parameter, make_choice_parameter,
    ParameterType,
)
from modular_slam_tpu.utils.profiling import FrameTimer


def test_registry_register_and_get():
    r = ParameterRegistry()
    assert r.register_number("a", 5, 0, 10)      # ref bug #2 fixed: True
    assert not r.register_number("a", 5, 0, 10)  # duplicate
    assert r.get("a") == 5


def test_registry_number_range_validation():
    """Reference bug #3 (inverted range check) fixed: in-range accepted,
    out-of-range rejected."""
    r = ParameterRegistry()
    r.register_number("x", 5, 0, 10)
    assert r.set("x", 7)
    assert r.get("x") == 7
    assert not r.set("x", 11)
    assert r.get("x") == 7


def test_registry_choice():
    r = ParameterRegistry()
    assert r.register_choice("mode", "a", ["a", "b"])
    assert r.set("mode", "b") and not r.set("mode", "c")


def test_make_number_parameter_type():
    """Reference bug #4 fixed: number params are typed NUMBER."""
    p = make_number_parameter("k", 1.0, 0, 2)
    assert p.type == ParameterType.NUMBER
    assert make_choice_parameter("c", 1, [1, 2]).type == ParameterType.CHOICE


def test_registry_subscriptions():
    r = ParameterRegistry()
    r.register_number("a", 1, 0, 5)
    seen = []
    r.subscribe_on_new_parameter(lambda p: seen.append(p.key))
    assert seen == ["a"]  # replay
    r.register_number("b", 2, 0, 5)
    assert seen == ["a", "b"]
    changes = []
    r.subscribe_on_change(lambda k, v: changes.append((k, v)))
    r.set("b", 3)
    assert changes == [("b", 3)]


def test_unknown_key():
    r = ParameterRegistry()
    assert not r.set("nope", 1)
    with pytest.raises(KeyError):
        r.get("nope")


def test_engine_runtime_params_rebuild():
    from modular_slam_tpu.engine import SlamSystem
    from modular_slam_tpu.config import SlamConfig
    from tests.test_engine_tracking import _small_cfg

    s = SlamSystem(_small_cfg(), enable_backend=False)
    assert s.params.get("min_matched_points") == 10
    assert s.params.set("min_matched_points", 25)
    assert s.cfg.tracker.min_matched_points == 25
    assert not s.params.set("min_matched_points", -1)


def test_frame_timer():
    t = FrameTimer()
    with t.stage("detect"):
        pass
    t.add("detect", 0.01)
    s = t.summary()
    assert s["detect"]["n"] == 2
    assert "mean_ms" in s["detect"]


def test_checkpoint_roundtrip(tmp_path):
    from modular_slam_tpu.engine import SlamSystem, SlamResult
    from modular_slam_tpu.eval.synthetic import PlaneSceneGenerator
    from modular_slam_tpu.utils.checkpoint import save_checkpoint, load_checkpoint
    from tests.test_engine_tracking import _small_cfg

    cfg = _small_cfg()
    gen = PlaneSceneGenerator(cfg.camera, seed=51)
    poses = gen.trajectory(5, step_t=(0.05, 0.0, 0.0))
    frames = list(gen.sequence(poses))

    s1 = SlamSystem(cfg, enable_backend=False)
    for f in frames[:3]:
        s1.process(*f)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, s1)

    s2 = SlamSystem(cfg, enable_backend=False)
    load_checkpoint(path, s2)
    np.testing.assert_array_equal(np.array(s1.arena.kf_q),
                                  np.array(s2.arena.kf_q))
    assert int(s2.arena.n_lm) == int(s1.arena.n_lm)
    assert len(s2.trajectory) == 3

    # resumed run continues tracking identically to an uninterrupted run
    for f in frames[3:]:
        assert s2.process(*f) == SlamResult.SUCCESS
    for f in frames[3:]:
        s1.process(*f)
    t1 = np.array(s1.state.pose.t)
    t2 = np.array(s2.state.pose.t)
    np.testing.assert_allclose(t1, t2, atol=1e-5)


def test_checkpoint_roundtrip_through_loop_closure(tmp_path):
    """VERDICT r1 item 10: a run containing a loop closure checkpoints and
    resumes completely — loop counters, pose-graph edges, BoW database,
    AND live-tuned runtime parameter values survive the round trip."""
    import numpy as np
    from modular_slam_tpu.eval.synthetic import PlaneSceneGenerator
    from modular_slam_tpu.models.pipelines import full_slam_pipeline
    from modular_slam_tpu.utils.checkpoint import (
        save_checkpoint, load_checkpoint)
    from tests.test_loop_e2e import _cfg, LAP_FRAMES, RADIUS, DEPTH_NOISE

    cfg = _cfg()
    gen = PlaneSceneGenerator(cfg.camera, seed=3, depth_noise=DEPTH_NOISE)
    poses = gen.loop_trajectory(LAP_FRAMES, radius=RADIUS) * 2
    frames = list(gen.sequence(poses))

    s1 = full_slam_pipeline(cfg)
    s1.run(iter(frames), chunk=8)
    assert s1.n_loop_closures >= 1, "scenario must contain a closure"
    # live-tune a runtime parameter before checkpointing
    assert s1.params.set("lba_max_num_iterations", 7)
    assert s1.cfg.backend.max_iterations == 7

    path = str(tmp_path / "loop_ckpt.npz")
    save_checkpoint(path, s1)

    s2 = full_slam_pipeline(_cfg())
    load_checkpoint(path, s2)
    assert s2.n_loop_closures == s1.n_loop_closures
    assert s2.n_relocalizations == s1.n_relocalizations
    assert s2._loop.n_global_ba == s1._loop.n_global_ba
    assert s2._kf_since_ba == s1._kf_since_ba
    assert s2.params.get("lba_max_num_iterations") == 7
    assert s2.cfg.backend.max_iterations == 7  # param write-back re-applied
    assert s2._loop._n_edges == s1._loop._n_edges
    # closure-cooldown state survives (round 5): a resumed run must not
    # re-fire a closure the cooldown was suppressing
    assert s2._loop._kf_counter == s1._loop._kf_counter
    assert s2._loop._last_closure_at == s1._loop._last_closure_at
    np.testing.assert_array_equal(np.asarray(s2._loop.db.hists),
                                  np.asarray(s1._loop.db.hists))
    np.testing.assert_array_equal(np.asarray(s2._loop.edges.i),
                                  np.asarray(s1._loop.edges.i))
    # the resumed system keeps tracking from where it left off
    for rgb, depth, ts in frames[:4]:
        s2.process(rgb, depth, ts + 10.0)
    assert bool(s2.results[-1].tracking_ok)


def test_checkpoint_capacity_mismatch(tmp_path):
    from modular_slam_tpu.engine import SlamSystem
    from modular_slam_tpu.utils.checkpoint import save_checkpoint, load_checkpoint
    from modular_slam_tpu.config import MapConfig
    import dataclasses
    from tests.test_engine_tracking import _small_cfg

    cfg = _small_cfg()
    s1 = SlamSystem(cfg, enable_backend=False)
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, s1)
    cfg2 = dataclasses.replace(cfg, map=MapConfig(max_keyframes=8,
                                                  max_landmarks=64,
                                                  max_observations=128))
    s2 = SlamSystem(cfg2, enable_backend=False)
    with pytest.raises(ValueError):
        load_checkpoint(path, s2)


def test_ply_export(tmp_path):
    from modular_slam_tpu.eval.ply import export_map_ply
    from modular_slam_tpu.map import empty_arena, add_keyframe, add_landmarks
    from modular_slam_tpu.config import MapConfig
    from modular_slam_tpu.geometry.se3 import identity_pose

    arena = empty_arena(MapConfig(max_keyframes=4, max_landmarks=16,
                                  max_observations=32, descriptor_bits=16))
    arena, _ = add_keyframe(arena, identity_pose(), jnp.float32(0))
    arena, _ = add_landmarks(arena, jnp.ones((5, 3)),
                             jnp.ones((5, 16), jnp.int8),
                             jnp.ones(5, bool))
    path = str(tmp_path / "map.ply")
    n = export_map_ply(path, arena)
    assert n == 5 + 5  # 5 landmarks + 1 kf x (center + 4 corners)
    txt = open(path).read()
    assert txt.startswith("ply")
    assert f"element vertex {n}" in txt


def test_eval_report_outputs(tmp_path):
    from modular_slam_tpu.eval.report import (
        write_ate_csv, plot_trajectories, render_observation_overlay,
        render_depth_colormap,
    )

    est = np.zeros((20, 8))
    est[:, 0] = np.arange(20) / 30.0
    est[:, 1] = np.linspace(0, 1, 20)
    est[:, 7] = 1.0
    gt = est.copy()
    gt[:, 1] += 0.01

    paths = plot_trajectories(est, gt, str(tmp_path), name="t")
    assert os.path.exists(paths["xyz"]) and os.path.exists(paths["topdown"])

    from modular_slam_tpu.eval.ate import ate_rmse
    write_ate_csv(str(tmp_path / "ate.csv"), {"seq": ate_rmse(est, gt)})
    rows = open(tmp_path / "ate.csv").read().strip().split("\n")
    assert len(rows) == 2 and rows[0].startswith("sequence,rmse")

    rgb = np.zeros((40, 60, 3), np.uint8)
    kp = np.array([[10.0, 10.0], [30.0, 20.0]])
    lm = kp + 3.0
    out = render_observation_overlay(rgb, kp, lm,
                                     path=str(tmp_path / "ovl.png"))
    assert out.shape == rgb.shape
    assert os.path.exists(tmp_path / "ovl.png")
    assert (out != 0).any()

    d = np.random.default_rng(0).uniform(0, 5, (40, 60)).astype(np.float32)
    cm = render_depth_colormap(d, path=str(tmp_path / "d.png"))
    assert cm.shape == (40, 60, 3)


def test_checkpoint_restores_vocab_on_mismatch(tmp_path):
    """Advisor round-2 finding: db histograms scored against a different
    codebook silently break loop detection.  The checkpoint carries the
    vocab; a system constructed with a DIFFERENT codebook gets the saved
    one swapped in on load."""
    import numpy as np
    from modular_slam_tpu.loop.vocab import make_vocab
    from modular_slam_tpu.models.pipelines import full_slam_pipeline
    from modular_slam_tpu.utils.checkpoint import (
        save_checkpoint, load_checkpoint)
    from tests.test_loop_e2e import _cfg

    cfg = _cfg()
    s1 = full_slam_pipeline(cfg)
    path = str(tmp_path / "vocab_ckpt.npz")
    save_checkpoint(path, s1)

    s2 = full_slam_pipeline(_cfg())
    # simulate an install whose packaged vocab differs (e.g. the npz
    # artifact is absent and the random-projection fallback fired)
    s2._loop.set_vocab(make_vocab(cfg.loop.vocab_size, seed=123))
    assert not np.array_equal(np.asarray(s2._loop._vocab),
                              np.asarray(s1._loop._vocab))
    load_checkpoint(path, s2)
    np.testing.assert_array_equal(np.asarray(s2._loop._vocab),
                                  np.asarray(s1._loop._vocab))


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it itself, so no
    directory is set in code."""
    import jax

    from modular_slam_tpu.utils import compile_cache_dir, setup_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache_dir("gpu") is None
    assert compile_cache_dir("cpu") is None
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_entry_size_bytes",
             "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_enable_xla_caches")
    saved = {n: getattr(jax.config, n) for n in names}
    try:
        setup_compile_cache()
        assert jax.config.jax_compilation_cache_dir == saved[names[0]]
    finally:
        for n, v in saved.items():
            jax.config.update(n, v)


def test_compile_cache_fixed_path_otherwise(monkeypatch):
    from modular_slam_tpu.utils import compile_cache_dir

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                        ".jax_cache"))
    assert compile_cache_dir("gpu") == os.path.join(root, "gpu")
    cpu = compile_cache_dir("cpu")
    assert os.path.dirname(cpu) == root
    assert os.path.basename(cpu).startswith("cpu-")
    assert compile_cache_dir("gpu") == compile_cache_dir("gpu")


def test_device_busy_ns_on_recorded_h100_trace(tmp_path):
    """The trace reduction on a recorded profile: three calls of a small
    jitted matmul+tanh+reduce on an NVIDIA H100 (JAX 0.9.0), four
    kernels each on one compute stream."""
    import shutil

    from modular_slam_tpu.utils.profiling import device_busy_ns

    src = os.path.join(os.path.dirname(__file__), "data",
                       "h100_matmul_trace.xplane.pb")
    run = tmp_path / "plugins" / "profile" / "run"
    run.mkdir(parents=True)
    shutil.copy(src, run / "host.xplane.pb")
    busy, per_name = device_busy_ns(str(tmp_path))
    assert busy == 43712
    assert per_name["gemm_fusion_dot_general_1"] == 27488
    assert sum(per_name.values()) >= busy   # union never exceeds the sum
    with pytest.raises(ValueError, match="no plane"):
        device_busy_ns(str(tmp_path), plane_prefix="/device:GPU:7")
