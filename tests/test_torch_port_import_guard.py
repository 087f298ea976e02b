"""The port imports neither JAX nor the JAX package.

The machine that runs the port on the card has no JAX, so every module
of `opendcvc_tpu_torch` must import without it.  One subprocess, with
`sys.modules["jax"]` and `sys.modules["opendcvc_tpu"]` set to None (any
import of either, or of a module under them, then raises ImportError),
imports each module of the package found on disk, and reports each
module's error, if any; each module is its own test case.  The package
imports no JAX-free module of the JAX package either: it keeps its own
copies.
"""

import json
import os
import subprocess
import sys

import pytest

from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "opendcvc_tpu_torch"


def _modules():
    """Every module of the package, by the .py files on disk."""
    out = []
    base = os.path.join(ROOT, PACKAGE)
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames
                             if not d.startswith(("_", ".")))
        rel = os.path.relpath(dirpath, ROOT).replace(os.sep, ".")
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            stem = name[:-3]
            out.append(rel if stem == "__init__" else f"{rel}.{stem}")
    return out


MODULES = _modules()

_CHILD = r"""
import importlib, json, sys, traceback
sys.modules["jax"] = None
sys.modules["opendcvc_tpu"] = None
errors = {}
for name in json.loads(sys.argv[1]):
    try:
        importlib.import_module(name)
        errors[name] = None
    except BaseException:
        errors[name] = traceback.format_exc(limit=3)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                       "opendcvc_tpu")
                and sys.modules[m] is not None)
print(json.dumps({"errors": errors, "leaked": leaked}))
"""


@pytest.fixture(scope="module")
def imported():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run(
        [sys.executable, "-S", "-c", _CHILD, json.dumps(MODULES)],
        cwd=ROOT, env=dict(env, PYTHONPATH=ROOT + os.pathsep
                           + os.pathsep.join(p for p in sys.path if p)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_package_modules_found():
    assert f"{PACKAGE}.models.dmc_dc" in MODULES
    assert f"{PACKAGE}.family_bench" in MODULES
    assert f"{PACKAGE}.utils.transfer" in MODULES
    assert len(MODULES) > 40


@pytest.mark.parametrize("module", MODULES)
def test_imports_without_jax(imported, module):
    assert imported["errors"][module] is None, imported["errors"][module]


def test_no_jax_module_loaded(imported):
    assert imported["leaked"] == []


def test_entropy_imports_nothing_from_models():
    """The device coder sits below the codecs: importing
    `entropy.device_rans` loads no module of `models`."""
    child = ("import json, sys; import opendcvc_tpu_torch.entropy."
             "device_rans; print(json.dumps(sorted(m for m in sys.modules "
             f"if m.startswith('{PACKAGE}.models'))))")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run(
        [sys.executable, "-S", "-c", child], cwd=ROOT,
        env=dict(env, PYTHONPATH=ROOT + os.pathsep
                 + os.pathsep.join(p for p in sys.path if p)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
