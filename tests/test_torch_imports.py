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
        bad = [m for m in sys.modules if m.startswith(("mr_slam_tpu", "jax", "flax"))
               and sys.modules[m] is not None]
        assert not bad, bad
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


# the streaming slice: session, store, TF, checkpoint, artifacts, replay
STREAMING_MODULES = [
    "mr_slam_torch.geometry.tf_tree", "mr_slam_torch.parallel.store",
    "mr_slam_torch.runtime.online", "mr_slam_torch.runtime.checkpoint",
    "mr_slam_torch.runtime.persistence", "mr_slam_torch.eval.g2o", "mr_slam_torch.eval.pcd",
    "mr_slam_torch.datasets.loaders", "mr_slam_torch.datasets.replay",
    "mr_slam_torch.datasets.sequence_artifact",
]


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
    """The native solver is built from the port's own source, and no
    string of the port outside a docstring names the reference package
    (a path under it, or the package as a path component)."""
    import ast

    from mr_slam_torch import native

    pkg = ROOT / "mr_slam_torch"
    assert native._SRC.resolve().is_relative_to(pkg), native._SRC
    assert native._SRC.read_bytes() == (ROOT / "mr_slam_tpu" / "native" / "maxclique.cpp").read_bytes()
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
