"""Streams the port wrote on an H100, decoded on the CPU by the JAX package
and by the port.

`tests/data/h100/` holds what `chip_smoke.py` phase 13 wrote on the card
(its README names the card and the torch version): one 64x64 frame
(`x.npy`, the port's `synthetic_images(1, 64, seed=0)`) coded at qp 30
with the committed trained checkpoint `docs/dmci_tiny_rd.msgpack` (DMCI
at the JAX package's TINY_KW widths) through host EC (`host.bin`, the
C++ rANS coder) and device EC (`device.bin`, kernel K1's "tpu-lane"
container), and the card's decoder output of each (`*_x_hat.npy`).
Held, for each stream: the JAX package's DMCI and the port's DMCI on the
CPU decode it to within 1e-3 of the card's x_hat (chip_smoke phase 5's
limit between the GPU and the CPU).  Printed: whether the port's CPU
encode of the same frame writes the same bytes (float32 convolutions on
cuDNN and on the CPU sum in different orders, so a value at a rounding
boundary may round apart; the CPU's x_hat is held within the same 1e-3).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from opendcvc_tpu.eval.rd_evidence import TINY_KW
from opendcvc_tpu.models import dmci as JDMCI
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch.models import dmci as PDMCI
from opendcvc_tpu_torch.utils import checkpoint as PCK
from opendcvc_tpu_torch.utils.params import from_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
DATA = os.path.join(ROOT, "tests", "data", "h100")
CKPT = os.path.join(ROOT, "docs", "dmci_tiny_rd.msgpack")
MODES = {"host": False, "device": True}
# GPU vs CPU agreement of the decoded frame (chip_smoke phase 5)
ATOL = 1e-3


@pytest.fixture(scope="module")
def fixture():
    with open(os.path.join(DATA, "meta.json")) as f:
        meta = json.load(f)
    out = {"meta": meta, "x": np.load(os.path.join(DATA, "x.npy"))}
    for mode in MODES:
        with open(os.path.join(DATA, f"{mode}.bin"), "rb") as f:
            out[mode] = f.read()
        out[f"{mode}_x_hat"] = np.load(os.path.join(DATA,
                                                    f"{mode}_x_hat.npy"))
    return out


def _sps(meta):
    return {"height": meta["size"], "width": meta["size"], "ec_part": 0}


def _port(device_ec):
    net = PDMCI.DMCI(device="cpu", device_ec=device_ec, **TINY_KW)
    net.load_params(from_jax(PCK.load_params(CKPT)))
    net.update()
    return net


def _jax(device_ec):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENDCVC_TPU_DEVICE_EC", "1" if device_ec else "0")
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        net = JDMCI.DMCI(**TINY_KW)
        net.load_params(JCK.load_params(CKPT))
        net.update()
    assert net.device_ec == device_ec
    return net


def test_fixture_is_the_committed_checkpoints(fixture):
    meta = fixture["meta"]
    assert meta["dmci"] == TINY_KW
    assert meta["checkpoint"] == "docs/dmci_tiny_rd.msgpack"
    assert fixture["x"].shape == (1, meta["size"], meta["size"], 3)
    assert "H100" in meta["card"]
    assert {m: len(fixture[m]) for m in MODES} == meta["bytes"]


@pytest.mark.parametrize("mode", list(MODES))
def test_jax_decodes_the_h100_stream(fixture, mode):
    meta = fixture["meta"]
    x_hat = _jax(MODES[mode]).decompress(fixture[mode], _sps(meta),
                                         meta["qp"])["x_hat"]
    np.testing.assert_allclose(np.asarray(x_hat, np.float32),
                               fixture[f"{mode}_x_hat"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_port_decodes_the_h100_stream_on_the_cpu(fixture, mode):
    meta = fixture["meta"]
    x_hat = _port(MODES[mode]).decompress(fixture[mode], _sps(meta),
                                          meta["qp"])["x_hat"]
    np.testing.assert_allclose(x_hat.numpy(), fixture[f"{mode}_x_hat"],
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_cpu_encode_beside_the_h100_stream(fixture, mode):
    meta = fixture["meta"]
    out = _port(MODES[mode]).compress(fixture["x"], meta["qp"])
    same = out["bit_stream"] == fixture[mode]
    print(f"{mode} EC: the CPU's stream ({len(out['bit_stream'])} B) is "
          f"{'' if same else 'not '}the H100's ({len(fixture[mode])} B)")
    np.testing.assert_allclose(out["x_hat"].numpy(), fixture[f"{mode}_x_hat"],
                               rtol=0, atol=ATOL)
