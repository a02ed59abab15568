"""The port imports no JAX, and its config mirrors the reference's."""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from mr_slam_torch.runtime import config as tcfg
from mr_slam_tpu.runtime import config as jcfg

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_without_jax():
    """Every module of mr_slam_torch imports with `jax` unimportable, and
    none of them pulls in the reference package."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        sys.modules["jax"] = None  # any `import jax` now raises
        import mr_slam_torch
        names = [m.name for m in pkgutil.walk_packages(
            mr_slam_torch.__path__, "mr_slam_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules if m.startswith(("mr_slam_tpu", "jax", "flax", "optax"))
               and sys.modules[m] is not None]
        assert not bad, bad
        # plots import matplotlib when they draw (the card has none)
        assert "matplotlib" not in sys.modules
        print(len(names), *names)
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    walked = out.stdout.split()
    assert int(walked[0]) >= 30  # every slice module was walked
    assert set(STREAMING_MODULES) <= set(walked[1:])
    assert set(PLACE_RECOGNITION_MODULES) <= set(walked[1:])
    assert set(FRONTEND_MODULES) <= set(walked[1:])
    assert set(CLOSURE_MODULES) <= set(walked[1:])
    assert set(MULTIPROCESS_MODULES) <= set(walked[1:])


# the streaming slice: session, store, TF, checkpoint, artifacts, replay
STREAMING_MODULES = [
    "mr_slam_torch.geometry.tf_tree", "mr_slam_torch.parallel.store",
    "mr_slam_torch.runtime.online", "mr_slam_torch.runtime.checkpoint",
    "mr_slam_torch.runtime.persistence", "mr_slam_torch.eval.g2o", "mr_slam_torch.eval.pcd",
    "mr_slam_torch.datasets.loaders", "mr_slam_torch.datasets.replay",
    "mr_slam_torch.datasets.sequence_artifact",
]


# place recognition: the descriptor families, the network, the harness
PLACE_RECOGNITION_MODULES = [
    "mr_slam_torch.loop.ring", "mr_slam_torch.loop.disco", "mr_slam_torch.loop.disco_net",
    "mr_slam_torch.loop.m2dp", "mr_slam_torch.loop.fast_histogram",
    "mr_slam_torch.eval.recall_harness",
]


# the other front-ends: preprocessing, LOAM features, FAST-LIO-style IEKF
FRONTEND_MODULES = [
    "mr_slam_torch.frontend.preprocess", "mr_slam_torch.frontend.lio",
    "mr_slam_torch.frontend.feature_odometry", "mr_slam_torch.ops.features",
]


# the closing slice: the eval tools and the port's example
CLOSURE_MODULES = [
    "mr_slam_torch.eval.graphgen", "mr_slam_torch.eval.reference_solver",
    "mr_slam_torch.eval.visualize", "mr_slam_torch.examples.demo_synthetic",
]


# the multi-process runtime: meshes, edge-sharded and decentralized PGO,
# sharded terrain features, the worker and the examples that drive it
MULTIPROCESS_MODULES = [
    "mr_slam_torch.parallel.mesh", "mr_slam_torch.parallel.multihost",
    "mr_slam_torch.backend.distributed", "mr_slam_torch.backend.gauss_seidel",
    "mr_slam_torch.mapping.sharded_elevation", "mr_slam_torch.examples.multihost_worker",
    "mr_slam_torch.examples.bench_multiprocess", "mr_slam_torch.examples.bench_scaling",
    "mr_slam_torch.examples.run_pgo_g2o",
]


def test_every_reference_module_has_a_port_file():
    """Each module of the reference package has a file of the same path
    in the port, except those whose counterpart has another name."""
    renamed = {"ops/pallas_vgicp.py": "ops/hopper_vgicp.py",
               "ops/pallas_stencil.py": "ops/hopper_stencil.py",
               "native/__init__.py": "native.py"}
    ref = ROOT / "mr_slam_tpu"
    missing = []
    for path in sorted(ref.rglob("*.py")):
        rel = path.relative_to(ref).as_posix()
        if not (ROOT / "mr_slam_torch" / renamed.get(rel, rel)).exists():
            missing.append(rel)
    assert not missing, missing


def test_reference_solver_shares_no_code_with_chordal():
    """The trusted solver's independence is its point: it imports
    nothing of `backend/chordal`."""
    text = (ROOT / "mr_slam_torch" / "eval" / "reference_solver.py").read_text()
    assert "chordal" not in _imported_modules(ROOT / "mr_slam_torch" / "eval" /
                                              "reference_solver.py")
    assert "import chordal" not in text and "chordal import" not in text


def _imported_modules(path: Path) -> set[str]:
    import ast

    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_chip_smoke_imports_no_jax():
    """The card's smoke run imports neither JAX nor the reference: no
    import statement names them, and the script imports with `jax`
    unimportable."""
    bad = [m for m in _imported_modules(ROOT / "chip_smoke.py")
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "mr_slam_tpu")]
    assert not bad, bad
    code = 'import sys; sys.modules["jax"] = None; import chip_smoke; print("ok")'
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_s2m_chaos_imports_no_jax():
    """The card-side diagnostic of scan2map's rounding spread imports
    neither JAX nor the reference."""
    bad = [m for m in _imported_modules(ROOT / "s2m_chaos.py")
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "mr_slam_tpu")]
    assert not bad, bad
    code = 'import sys; sys.modules["jax"] = None; import s2m_chaos; print("ok")'
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_native_sources_are_the_ports_own():
    """The scan log is the port's copy: it names neither JAX nor the
    reference package, and `native.py` builds it from the port's tree."""
    from mr_slam_torch import native

    src = native._SCANLOG_SRC
    assert src.resolve().is_relative_to(ROOT / "mr_slam_torch"), src
    text = src.read_text()
    assert "jax" not in text.lower() and "mr_slam_tpu" not in text
    assert "mrslam_scanlog_next" in text


def test_port_reads_no_file_of_the_reference():
    """The native solver and the descriptor kd-tree are built from the
    port's own copies of the reference's sources, and no
    string of the port outside a docstring names the reference package
    (a path under it, or the package as a path component)."""
    import ast

    from mr_slam_torch import native

    pkg = ROOT / "mr_slam_torch"
    for src, name in ((native._SRC, "maxclique.cpp"), (native._KDTREE_SRC, "kdtree.cpp")):
        assert src.resolve().is_relative_to(pkg), src
        assert src.read_bytes() == (ROOT / "mr_slam_tpu" / "native" / name).read_bytes()
    bad = []
    files = sorted(pkg.rglob("*.py"))
    for path in files:
        tree = ast.parse(path.read_text())
        docs = set()
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docs and "mr_slam_tpu" in node.value:
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno}: {node.value!r}")
    assert len(files) >= 20
    assert not bad, bad


CONFIGS = [
    "OdometryCfg", "KeyframeCfg", "LoopCfg", "PGOCfg", "ElevationCfg",
    "SchedulerCfg", "RobotOverlay", "SlamConfig",
]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_fields_and_defaults_match(name):
    def spec(cls):
        out = []
        for f in dataclasses.fields(cls):
            default = f.default
            if f.default_factory is not dataclasses.MISSING:
                default = dataclasses.asdict(f.default_factory())
            out.append((f.name, default))
        return out

    assert spec(getattr(tcfg, name)) == spec(getattr(jcfg, name))


def test_config_json_roundtrip_matches_reference():
    cfg = tcfg.SlamConfig(n_robots=3, loops=tcfg.LoopCfg(dist_thresh=0.3))
    assert cfg.to_json() == jcfg.SlamConfig(
        n_robots=3, loops=jcfg.LoopCfg(dist_thresh=0.3)
    ).to_json()
    assert tcfg.SlamConfig.from_json(cfg.to_json()) == cfg
