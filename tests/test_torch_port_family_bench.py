"""`python -m opendcvc_tpu_torch.family_bench` on the CPU against the JAX
package's `tools/family_bench.py` (FAM_PLATFORM=cpu, 64x64, 2 frames).

Both tools code the same frames with the same weights: the JAX tool's
DMCDC.init_params is made to load the port's init (seed 0) carried to
the JAX layout, so the two dc rows' bpp must be equal; the JAX codec
codes with its plain coder (OPENDCVC_TPU_FORCE_PY_RANS=1).  Held: the
frames equal the JAX tool's; the result's keys and the dc row's keys are
the JAX tool's; bpp equal; an unported codec raises NotImplementedError
with its ROADMAP item; the default output is not the JAX tool's file.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from opendcvc_tpu.models import dmc_dc as JDC
from opendcvc_tpu_torch import family_bench
from opendcvc_tpu_torch.models.dmc_dc import DMCDC
from opendcvc_tpu_torch.utils.params import to_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"FAM_PLATFORM": "cpu", "FAM_H": "64", "FAM_W": "64",
         "FAM_FRAMES": "2"}


def _jax_tool():
    """tools/family_bench.py as a module (it reads FAM_PLATFORM when it is
    imported, so it is imported without it; the tests' JAX runs on the
    CPU already)."""
    spec = importlib.util.spec_from_file_location(
        "jax_family_bench", os.path.join(ROOT, "tools", "family_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small_env(monkeypatch):
    monkeypatch.delenv("FAM_CODECS", raising=False)
    monkeypatch.delenv("FAM_PLATFORM", raising=False)
    tool = _jax_tool()
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    return tool


@pytest.fixture(scope="module")
def port_tree():
    return DMCDC(device="cpu").init_params(seed=0)


def test_frames_equal_jax_tool(small_env):
    want = small_env._frames(64, 64, 2, seed=3)
    got = family_bench._frames(64, 64, 2, torch.device("cpu"), seed=3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dc_row_matches_jax_tool(small_env, port_tree, monkeypatch,
                                 tmp_path):
    tree = to_jax(port_tree)

    def init_params(self, seed=0):
        self.load_params(tree)
        return self.params

    monkeypatch.setattr(JDC.DMCDC, "init_params", init_params)
    monkeypatch.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
    monkeypatch.setenv("FAM_CODECS", "dc")
    monkeypatch.setattr(sys, "argv", ["family_bench.py",
                                      str(tmp_path / "jax.json")])
    small_env.main()
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    got = family_bench.main([str(tmp_path / "port.json")])
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == got
    assert set(got) == set(want)
    assert got["platform"] == want["platform"] == "cpu"
    assert got["host_ec"] is True
    assert list(got["codecs"]) == list(want["codecs"]) == ["dc"]
    row, ref = got["codecs"]["dc"], want["codecs"]["dc"]
    assert list(row) == list(ref)
    assert (row["h"], row["w"], row["frames"]) == (64, 64, 2)
    print(f"port dc row {row}; JAX tool's {ref}")
    assert row["bpp"] == ref["bpp"] > 0
    assert row["enc_fps"] > 0 and row["dec_fps"] > 0


@pytest.mark.parametrize("codec,item", sorted(family_bench.UNPORTED.items()))
def test_unported_codec_raises(small_env, monkeypatch, codec, item,
                               tmp_path):
    monkeypatch.setenv("FAM_CODECS", f"dc,{codec}")
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        family_bench.main([str(tmp_path / "o.json")])
    assert not (tmp_path / "o.json").exists()


def test_default_output_is_not_the_jax_tools(small_env, monkeypatch,
                                             tmp_path):
    monkeypatch.setenv("FAM_FRAMES", "1")
    monkeypatch.chdir(tmp_path)
    family_bench.main([])
    assert (tmp_path / family_bench.DEFAULT_OUT).exists()
    assert "family_bench_r5" not in family_bench.DEFAULT_OUT
    assert not os.path.exists(os.path.join(ROOT, "docs",
                                           family_bench.DEFAULT_OUT))


def test_cuda_default_raises_without_cuda(small_env, monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    monkeypatch.delenv("FAM_PLATFORM")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        family_bench.main([str(tmp_path / "o.json")])
