"""The port's runtime knobs against the JAX package's, on the CPU.

  * OPENDCVC_TPU_RANS_THREADS: the host coder's worker thread, forced off
    by "0", "false" or "False" and on by any other value, unset the
    core count's choice: the port's `entropy/rans.py::_threaded_default`
    and its coders follow the JAX package's parse for every spelling;
  * OPENDCVC_TPU_BUILD_DIR: the g++ builds (the host coder, the kernels'
    host shim) and the nvcc build (here with a stand-in compiler that
    writes its output, since this machine has no nvcc) land in that
    directory, read when a build happens; unset, in the package's
    `_build/`, as the JAX package's `native/build.py` does.
"""

import os
import stat

import pytest

from opendcvc_tpu.entropy import rans as JR
from opendcvc_tpu.native import build as JB
from opendcvc_tpu_torch.entropy import rans as PR
from opendcvc_tpu_torch.ops import _build
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)


@pytest.mark.parametrize("value", [None, "0", "false", "False", "1", "no",
                                   "true"])
def test_rans_threads(value, monkeypatch):
    """The port's default equals the JAX package's for each spelling, and
    a coder built without `threaded` takes it."""
    if value is None:
        monkeypatch.delenv("OPENDCVC_TPU_RANS_THREADS", raising=False)
    else:
        monkeypatch.setenv("OPENDCVC_TPU_RANS_THREADS", value)
    want = JR._threaded_default()
    assert PR._threaded_default() == want
    if value is not None:
        assert want == (value not in ("0", "false", "False"))
    assert PR.RansEncoder().threaded == want
    assert PR.RansDecoder().threaded == want


def _fake_nvcc(tmp_path):
    """A stand-in compiler that writes the file after `-o`."""
    path = tmp_path / "nvcc"
    path.write_text('#!/bin/sh\nwhile [ "$#" -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then echo built > "$2"; fi\n'
                    '  shift\ndone\n')
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_dir(tmp_path, monkeypatch):
    """Set after import, OPENDCVC_TPU_BUILD_DIR takes every build, and
    the JAX package reads it alike; each library's name is the package's
    own."""
    out = tmp_path / "builds"
    monkeypatch.setenv("OPENDCVC_TPU_BUILD_DIR", str(out))
    monkeypatch.setattr(_build, "_HOST_RANS", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    assert JB._build_dir() == str(out)
    _build.load_host_rans()
    _build.load_host_shim()
    kernels = _build.build_kernels()
    names = sorted(os.listdir(out))
    assert any(n.startswith("librans_host_") for n in names), names
    assert any(n.startswith("liblane_rans_host_") for n in names), names
    assert kernels and all(os.path.dirname(p) == str(out)
                           for p in kernels.values())
    assert all(os.path.exists(p) for p in kernels.values())
    assert not any(".tmp" in n for n in names), names


def test_build_dir_default(monkeypatch):
    """Unset (or empty), the builds go to the package's _build/."""
    monkeypatch.delenv("OPENDCVC_TPU_BUILD_DIR", raising=False)
    assert _build._build_dir() == _build.BUILD_DIR
    monkeypatch.setenv("OPENDCVC_TPU_BUILD_DIR", "")
    assert _build._build_dir() == _build.BUILD_DIR
    assert os.path.basename(_build.BUILD_DIR) == "_build"
