"""`python -m opendcvc_tpu_torch.family_bench` on the CPU against the JAX
package's `tools/family_bench.py` (FAM_PLATFORM=cpu, 64x64, 2 frames).

Both tools code the same frames with the same weights: the JAX tool's
init_params of each codec (DMCTCM, DMCHEM, DMCDC, EVC, DCVCNet) is made
to load the port's init (seed 0) carried to the JAX layout, so each row's
bpp must be equal (HEM's anchors spread by both tools after that init);
the JAX codecs code with their plain coder (OPENDCVC_TPU_FORCE_PY_RANS=1).
The dcvc row runs at FAM_DCVC_HW=64.  Held: the frames equal the JAX
tool's; the result's keys and each row's keys are the JAX tool's; bpp
equal; the default codecs are the JAX tool's, in its order; an unknown
codec raises ValueError; the default output is not the JAX tool's file.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from opendcvc_tpu.models import dcvc as JDCVC
from opendcvc_tpu.models import dmc_dc as JDC
from opendcvc_tpu.models import dmc_hem as JHEM
from opendcvc_tpu.models import dmc_tcm as JTCM
from opendcvc_tpu.models import evc as JEVC
from opendcvc_tpu_torch import family_bench
from opendcvc_tpu_torch.models.dcvc import DCVCNet
from opendcvc_tpu_torch.models.dmc_dc import DMCDC
from opendcvc_tpu_torch.models.dmc_hem import DMCHEM
from opendcvc_tpu_torch.models.dmc_tcm import DMCTCM
from opendcvc_tpu_torch.models.evc import EVC
from opendcvc_tpu_torch.utils.params import to_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"FAM_PLATFORM": "cpu", "FAM_H": "64", "FAM_W": "64",
         "FAM_FRAMES": "2", "FAM_DCVC_HW": "64"}


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
    for k in ("FAM_CODECS", "FAM_PLATFORM", "FAM_DCVC_HW"):
        monkeypatch.delenv(k, raising=False)
    tool = _jax_tool()
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    return tool


#: row -> (the JAX codec class, the port's codec class)
CODECS = {"dc": (JDC.DMCDC, DMCDC), "hem": (JHEM.DMCHEM, DMCHEM),
          "tcm": (JTCM.DMCTCM, DMCTCM), "evc": (JEVC.EVC, EVC),
          "dcvc": (JDCVC.DCVCNet, DCVCNet)}


@pytest.fixture(scope="module")
def port_trees():
    return {name: cls(device="cpu").init_params(seed=0)
            for name, (_, cls) in CODECS.items()}


def _frames_equal(tool, seed):
    want = tool._frames(64, 64, 2, seed=seed)
    got = family_bench._frames(64, 64, 2, torch.device("cpu"), seed=seed)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_frames_equal_jax_tool(small_env):
    _frames_equal(small_env, 3)


@pytest.mark.parametrize("seed", [1, 2, 4, 5],
                         ids=["tcm", "hem", "evc", "dcvc"])
def test_tcm_hem_frames_equal_jax_tool(small_env, seed):
    _frames_equal(small_env, seed)


def _row_matches_jax_tool(name, small_env, port_trees, monkeypatch,
                          tmp_path):
    """The `name` row of both tools on the port's weights."""
    def init_params(self, seed=0):
        self.load_params(to_jax(port_trees[name]))
        return self.params

    monkeypatch.setattr(CODECS[name][0], "init_params", init_params)
    monkeypatch.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
    monkeypatch.setenv("FAM_CODECS", name)
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
    assert list(got["codecs"]) == list(want["codecs"]) == [name]
    row, ref = got["codecs"][name], want["codecs"][name]
    assert list(row) == list(ref)
    assert (row["h"], row["w"], row["frames"]) == \
        (ref["h"], ref["w"], ref["frames"]) == (64, 64, 2)
    print(f"port {name} row {row}; JAX tool's {ref}")
    assert row["bpp"] == ref["bpp"] > 0
    assert row["enc_fps"] > 0 and row["dec_fps"] > 0


def test_dc_row_matches_jax_tool(small_env, port_trees, monkeypatch,
                                 tmp_path):
    _row_matches_jax_tool("dc", small_env, port_trees, monkeypatch,
                          tmp_path)


def test_hem_row_matches_jax_tool(small_env, port_trees, monkeypatch,
                                  tmp_path):
    """At the spread anchors' rung get_interpolated_q_scales(4)[1]."""
    _row_matches_jax_tool("hem", small_env, port_trees, monkeypatch,
                          tmp_path)


def test_tcm_row_matches_jax_tool(small_env, port_trees, monkeypatch,
                                  tmp_path):
    _row_matches_jax_tool("tcm", small_env, port_trees, monkeypatch,
                          tmp_path)


def test_evc_row_matches_jax_tool(small_env, port_trees, monkeypatch,
                                  tmp_path):
    """EVC (EVC_LL's widths) at q_scale 1.0."""
    _row_matches_jax_tool("evc", small_env, port_trees, monkeypatch,
                          tmp_path)


def test_dcvc_row_matches_jax_tool(small_env, port_trees, monkeypatch,
                                   tmp_path):
    """At FAM_DCVC_HW square, every P-frame against the raw frame 0;
    bpp counts the four strings."""
    _row_matches_jax_tool("dcvc", small_env, port_trees, monkeypatch,
                          tmp_path)


def test_default_codecs_are_the_jax_tools(small_env):
    """FAM_CODECS' default: the JAX tool's "tcm,hem,dc,evc,dcvc"."""
    assert list(family_bench.BENCHES) == ["tcm", "hem", "dc", "evc",
                                          "dcvc"]
    assert list(family_bench.BENCHES) == list(small_env.BENCHES)
    assert not hasattr(family_bench, "UNPORTED")


@pytest.mark.parametrize("codec", ["dmc", "fm"])
def test_unknown_codec_raises(small_env, monkeypatch, codec, tmp_path):
    monkeypatch.setenv("FAM_CODECS", f"dc,{codec}")
    with pytest.raises(ValueError, match=f"unknown codec '{codec}'"):
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
