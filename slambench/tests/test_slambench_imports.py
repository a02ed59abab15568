"""Nothing the benchmark loads is JAX or the JAX package, compared by
whole top-level module name, and the reference loads nothing of the
program."""
import subprocess
import sys

from helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "mr_slam_tpu"}


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sys.modules))"],
                         cwd=ROOT, capture_output=True, text=True, check=True).stdout
    return {m.split(".")[0] for m in out.split()}


def test_harness_loads_no_jax():
    mods = _top_level("from slambench import harness, drive, judge, trace, traffic, roofline\n"
                      "from slambench.reference import stages\n"
                      "import mr_slam_torch.runtime.online")
    assert not mods & FORBIDDEN
    assert "mr_slam_torch" in mods  # the system under test, compared whole


def test_reference_loads_nothing_of_the_program():
    mods = _top_level("from slambench.reference import stages")
    assert not mods & (FORBIDDEN | {"mr_slam_torch"})


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch):
    import types

    import pytest

    from helpers import run

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit, match="jax"):
        run("os64-scan2map-drive", seconds=2.0)


def test_no_card_no_result(tmp_path):
    import shutil

    for root in (ROOT, tmp_path):  # the checkout, and the benchmark's files alone
        if root is tmp_path:
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(ROOT / "slambench", tmp_path / "slambench",
                            ignore=shutil.ignore_patterns("__pycache__"))
        p = subprocess.run([sys.executable, "slambench/run.py", "--workload", "os64-scan2map-walk",
                            "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                           cwd=root, capture_output=True, text=True)
        assert p.returncode != 0 and p.stdout == ""
