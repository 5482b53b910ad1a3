"""The port stands alone: importing every module of ``repro_torch`` pulls
in neither JAX nor anything of the ``repro`` package."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
assert not bad, bad
print(len(names))
"""


def test_importing_every_module_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20       # every module was walked


def test_no_source_names_jax_or_repro():
    """Static twin of the probe: also covers imports inside functions."""
    for path in (SRC / "repro_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                root = m.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (path, m)


_ONE = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
assert not bad, bad
"""


@pytest.mark.parametrize("module", ["repro_torch.distributed.sharding", "repro_torch.launch.mesh",
                                    "repro_torch.launch.hlo_analysis",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.core.allocator",
                                    "repro_torch.core.templates",
                                    "repro_torch.simulator.sim",
                                    "repro_torch.runtime.cluster",
                                    "repro_torch.control",
                                    "repro_torch.obs"])
def test_distributed_and_dryrun_modules_load_no_jax_and_no_repro(module):
    """The meshes, the sharding layer, the dry-run, the control plane's
    allocator and template generator, the simulator, the epoch runtime, the
    control loop and the observability layer, each alone in a fresh process
    (the dry-run's counterpart in the JAX package forces 512 host devices on
    JAX at import; the control plane's counterparts are numpy modules the
    port keeps its own copies of)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _ONE, module], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
