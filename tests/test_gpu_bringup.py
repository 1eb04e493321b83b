"""What keeps the GPU path honest when no GPU is present: the on-card
scripts refuse to run (no fallback to the CPU, no result line), no package
module depends on a removed kernel route, and the removed backends are
rejected by name."""

import json
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest

import ljmd_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every package module except the CLI's ``__main__`` (importing it runs it)
MODULES = sorted(
    m.name for m in pkgutil.walk_packages(ljmd_tpu.__path__, prefix="ljmd_tpu.")
    if not m.name.endswith("__main__")
)


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_ok_line(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            continue
    return False


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_card_scripts_fail_without_gpu(script):
    proc = _run([script], REPO)
    assert proc.returncode != 0, proc.stdout
    assert not _has_ok_line(proc.stdout)
    assert "needs a GPU" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo the
    script cannot import the package, and must fail without an ok line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert not _has_ok_line(proc.stdout)


@pytest.fixture(scope="module")
def imports_pulling_pallas():
    """Import every package module in order in a fresh CPU interpreter and
    record, per module, whether its import brought Pallas into the process."""
    code = (
        "import importlib, json, sys\n"
        "out = {}\n"
        "for name in sys.argv[1:]:\n"
        "    importlib.import_module(name)\n"
        "    out[name] = any(m.startswith('jax.experimental.pallas') for m in sys.modules)\n"
        "print(json.dumps(out))\n"
    )
    proc = _run(["-c", code, *MODULES], REPO)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_pallas(module, imports_pulling_pallas):
    """Every package module imports on the CPU without pulling in Pallas,
    and its source names no Pallas kernel."""
    import importlib.util

    assert imports_pulling_pallas[module] is False
    src = open(importlib.util.find_spec(module).origin).read()
    assert "pallas" not in src.lower()


@pytest.mark.parametrize("backend", ["pallas", "zsort"])
def test_removed_backends_are_rejected(backend):
    from ljmd_tpu.cli import main
    from ljmd_tpu.config import config_from_density
    from ljmd_tpu.models.engine import make_engine
    from ljmd_tpu.models.forces import make_force_fn

    with pytest.raises(SystemExit):
        main(["simulate", "--backend", backend])
    cfg = config_from_density(num_cells=2, density=0.7)
    with pytest.raises(ValueError, match="unknown"):
        make_engine(cfg, backend)
    with pytest.raises(ValueError, match="unknown"):
        make_force_fn(cfg, backend)


def test_graft_entry_prints_platform(capsys):
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as g
    finally:
        sys.path.remove(REPO)
    fn, args = g.entry()
    assert "platform=cpu" in capsys.readouterr().out
    assert len(args) == 4 and args[0].shape == (4000, 3)
