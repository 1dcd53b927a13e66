"""Component registry — the plugin system, Python-style.

The reference loads components from shared libraries via
boost::dll::import_alias (plugin_loader.hpp:19-25) and assembles them
with a fluent builder (slam_builder.hpp:93-177).  This rebuild keeps
the same extension contract — named factories per component kind — as a
plain registry: register a factory under ("detector", "my_impl") and any
pipeline config can reference it by name.  Third-party packages can
register via normal imports or setuptools entry points
("modular_slam_tpu.plugins" group).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

_REGISTRY: Dict[Tuple[str, str], Callable[..., Any]] = {}

KINDS = ("detector", "matcher", "pnp", "map", "backend", "loop_detector",
         "relocalizer", "data_provider")


def register(kind: str, name: str):
    """Decorator: @register("detector", "orb")"""
    if kind not in KINDS:
        raise ValueError(f"unknown component kind {kind!r}; one of {KINDS}")

    def deco(factory):
        _REGISTRY[(kind, name)] = factory
        return factory

    return deco


def create(kind: str, name: str, *args, **kwargs):
    key = (kind, name)
    if key not in _REGISTRY:
        raise KeyError(
            f"no {kind} named {name!r}; available: {available(kind)}")
    return _REGISTRY[key](*args, **kwargs)


def available(kind: str) -> List[str]:
    return sorted(n for (k, n) in _REGISTRY if k == kind)


def load_entry_point_plugins() -> int:
    """Load third-party plugins from the 'modular_slam_tpu.plugins'
    entry-point group (each entry point is a callable invoked once to
    perform its register() calls).  Returns the number loaded."""
    try:
        from importlib.metadata import entry_points
    except ImportError:  # pragma: no cover
        return 0
    count = 0
    try:
        eps = entry_points(group="modular_slam_tpu.plugins")
    except TypeError:  # pragma: no cover - older API
        eps = entry_points().get("modular_slam_tpu.plugins", [])
    for ep in eps:
        ep.load()()
        count += 1
    return count


# ---------------------------------------------------------------------------
# built-in components
# ---------------------------------------------------------------------------


def _register_builtins() -> None:
    from modular_slam_tpu.ops.detector import detect
    from modular_slam_tpu.ops.match import match_descriptors
    from modular_slam_tpu.ops.match_pallas import match_descriptors_fastest
    from modular_slam_tpu.ops.pnp import ransac_pnp
    from modular_slam_tpu.io.tum import TumRgbdDataset

    @register("detector", "orb_grid")
    def _orb(cfg):
        return lambda gray, depth: detect(gray, depth, cfg.detector)

    @register("matcher", "hamming_2nn")
    def _matcher(cfg):
        # fused kernel on the GPU, plain formulation on the CPU
        return lambda q, qv, t, tv: match_descriptors_fastest(
            q, qv, t, tv, cfg.matcher)

    @register("matcher", "hamming_2nn_xla")
    def _matcher_xla(cfg):
        return lambda q, qv, t, tv: match_descriptors(q, qv, t, tv,
                                                      cfg.matcher)

    @register("pnp", "ransac_3p")
    def _pnp(cfg):
        from modular_slam_tpu.geometry.camera import camera_from_config

        cam = camera_from_config(cfg.camera)
        return lambda pw, uv, pc, v, init, key: ransac_pnp(
            cam, pw, uv, pc, v, init, key, cfg.pnp)

    @register("data_provider", "tum_files")
    def _tum(cfg, root):
        return TumRgbdDataset(root, cfg.camera)

    @register("data_provider", "realsense")
    def _realsense(cfg, root=None, **kw):
        # live camera; raises clearly when the SDK is absent (io/camera.py).
        # NB: the device reports its own intrinsics/depth scale into
        # provider.camera — rebuild the pipeline config from it before
        # constructing camera-dependent components (e.g.
        # cfg.replace(camera=provider.camera)), or PnP/BA would run with
        # the TUM preset intrinsics.
        from modular_slam_tpu.io.camera import LiveRgbdCamera

        return LiveRgbdCamera(width=cfg.camera.width,
                              height=cfg.camera.height, **kw)


_register_builtins()
