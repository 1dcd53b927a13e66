"""Guards for the repo-root tools (advisor r4 medium).

``tools/pin_baseline.py`` and ``tools/detect_bench.py`` consume
``bench._sequence``; when its return arity changed (2 -> 3 values in
round 4) both tools crashed on launch with ValueError and nobody
noticed until the advisor read them.  These tests pin the contract:

1. ``bench._sequence`` returns (cfg, frames, gt_poses);
2. every ``*._sequence(...)`` tuple-unpack call site under ``tools/``
   and in ``bench.py`` unpacks exactly that many values.

AST-based so the check costs milliseconds and needs no device/OpenCV run.
"""

import ast
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SEQUENCE_ARITY = 3  # (cfg, frames, gt_poses)


def test_bench_sequence_returns_cfg_frames_poses():
    sys.path.insert(0, str(REPO))
    import bench

    out = bench._sequence("plane")
    assert isinstance(out, tuple) and len(out) == _SEQUENCE_ARITY, (
        "bench._sequence contract changed — update _SEQUENCE_ARITY here "
        "AND every unpack site flagged by test_tool_unpack_sites_match"
    )


def _unpack_sites(path: Path):
    """Yield (lineno, n_targets) for every ``a, b, ... = X._sequence(...)``
    or ``a, b = _sequence(...)`` assignment in the file."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        call = node.value
        if not isinstance(call, ast.Call):
            continue
        fn = call.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None)
        if name != "_sequence":
            continue
        tgt = node.targets[0]
        if isinstance(tgt, ast.Tuple):
            yield node.lineno, len(tgt.elts)


def test_tool_unpack_sites_match():
    files = sorted((REPO / "tools").glob("*.py")) + [REPO / "bench.py"]
    sites = [(f.name, ln, n) for f in files for ln, n in _unpack_sites(f)]
    assert sites, "expected at least one _sequence unpack site"
    bad = [s for s in sites if s[2] != _SEQUENCE_ARITY]
    assert not bad, f"unpack arity != {_SEQUENCE_ARITY} at: {bad}"


def test_tools_importable():
    """Every tool must at least parse and compile (catches syntax rot)."""
    import py_compile

    for f in sorted((REPO / "tools").glob("*.py")):
        py_compile.compile(str(f), doraise=True)
