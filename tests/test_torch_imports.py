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
        print(len(names))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every slice module was walked


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
