"""Skip compaction (OPENDCVC_TPU_EC_SKIP_COMPACT=1) in the port's device-EC
DMC and DMCI against the JAX package (CPU, float32).

Default widths on 96x96 frames (a y plane of 9 steps a lane on 256 lanes)
from numpy (default_rng), the JAX package's init_params(seed=0) weights
carried across, qp 21, the recipe of tests/test_device_rans.py's
compaction test:
  * first rung: OPENDCVC_TPU_EC_SKIP_FRAC 0.25, force_zero_thres 0.3, so
    kyc = 8 < k_y = 9 (DMC: K = 2 + 2 x 8 = 18; DMCI: 2 + 4 x 8 = 34);
  * overflow: frac 0.01, force_zero_thres 1e-6, so nearly every symbol
    survives, the first rung (8) overflows and the ladder regrows to
    kyc = k_y = 9.
Held: the port decodes the JAX package's stream to the JAX decoder's
x_hat (and DMC's feature) within 1e-4 * max|ref|, as
tests/test_torch_port_codec.py holds the codecs; the port writes the JAX
package's bytes (so each side decodes the other's stream); the port's GOP
streams equal its per-frame streams and its GOP decode its per-frame
decode, its intra batch its single frames; the compaction helpers equal
the JAX package's on random planes, overflow included.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.entropy import device_rans as JD
from opendcvc_tpu.models import dmc as JDMC
from opendcvc_tpu.models import dmci as JDMCI
from opendcvc_tpu_torch.entropy import device_rans as PD
from opendcvc_tpu_torch.models import dmc as PDMC
from opendcvc_tpu_torch.models import dmci as PDMCI
from opendcvc_tpu_torch.ops.lane_rans import DEC_SKIP
from opendcvc_tpu_torch.utils import trace
from opendcvc_tpu_torch.utils.params import from_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

H = W = 96
QP = 21
SPS = {"sps_id": 0, "height": H, "width": W, "ec_part": 0, "use_ada_i": 0}
K_Y = 9
# (OPENDCVC_TPU_EC_SKIP_FRAC, force_zero_thres, the kyc the stream records)
CASES = {"first_rung": (0.25, 0.3, 8), "overflow": (0.01, 1e-6, K_Y)}


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))


@pytest.fixture
def compaction(monkeypatch):
    """Device EC with skip compaction at a survivor fraction: both
    packages read the knobs from the environment."""
    def set_frac(frac):
        monkeypatch.setenv("OPENDCVC_TPU_DEVICE_EC", "1")
        monkeypatch.setenv("OPENDCVC_TPU_EC_SKIP_COMPACT", "1")
        monkeypatch.setenv("OPENDCVC_TPU_EC_SKIP_FRAC", str(frac))
    return set_frac


def _frames(n=4):
    rng = np.random.default_rng(11)
    x0 = rng.random((1, H, W, 3), dtype=np.float32)
    out, prev = [], x0
    for _ in range(n):
        prev = np.clip(prev + rng.normal(0, 0.03, prev.shape)
                       .astype(np.float32), 0, 1)
        out.append(prev)
    return x0, out


@pytest.fixture(scope="module")
def jax_params():
    os.environ["OPENDCVC_TPU_DEVICE_EC"] = "1"
    try:
        return {"p": JDMC.DMC().init_params(seed=0),
                "i": JDMCI.DMCI().init_params(seed=0)}
    finally:
        os.environ.pop("OPENDCVC_TPU_DEVICE_EC")


def _jax_dmc(params, fz, x0):
    net = JDMC.DMC()
    net.load_params(params)
    net.update(force_zero_thres=fz)
    net.add_ref_frame(None, jnp.asarray(x0))
    return net


def _port_dmc(params, fz, x0):
    net = PDMC.DMC(device="cpu", device_ec=True)
    net.load_params(params)
    net.update(force_zero_thres=fz)
    net.add_ref_frame(None, torch.from_numpy(x0))
    return net


def _reruns():
    """The device-EC ladders' reruns so far (the trace's `ec.rerun`)."""
    return trace.counters().get("ec.rerun", 0)


@pytest.mark.parametrize("case", list(CASES))
def test_dmc_streams_cross(case, jax_params, compaction):
    """A P-frame: the JAX stream records the rung and decodes in the port
    to the JAX decoder's x_hat and feature; the port's stream is the JAX
    package's, byte for byte."""
    frac, fz, kyc = CASES[case]
    compaction(frac)
    x0, (x1, *_) = _frames(1)
    stream = _jax_dmc(jax_params["p"], fz, x0).compress(
        jnp.asarray(x1), QP)["bit_stream"]
    meta = JD.parse_frame(stream)[0]
    assert (meta["kyc"], meta["K"]) == (kyc, 2 + 2 * kyc), meta
    jdec = _jax_dmc(jax_params["p"], fz, x0)
    want = np.asarray(jdec.decompress(stream, SPS, QP)["x_hat"])

    params = from_jax(jax_params["p"])
    pdec = _port_dmc(params, fz, x0)
    _close(pdec.decompress(stream, SPS, QP)["x_hat"], want)
    _close(pdec.dpb[0].feature.permute(0, 2, 3, 1), jdec.dpb[0].feature)

    penc = _port_dmc(params, fz, x0)
    assert penc._plan_device_ec(H, W).kyc == min(kyc, 8)
    r0 = _reruns()
    assert penc.compress(x1, QP)["bit_stream"] == stream
    assert _reruns() - r0 == (1 if case == "overflow" else 0)


def test_dmc_gop_equals_per_frame(jax_params, compaction):
    """With kyc > 0: a GOP chunk of 3 writes the per-frame streams, and
    decompress_gop gives the per-frame decode and final feature."""
    frac, fz, _ = CASES["first_rung"]
    compaction(frac)
    params = from_jax(jax_params["p"])
    x0, frames = _frames(4)
    single = _port_dmc(params, fz, x0)
    per = [single.compress(x, QP)["bit_stream"] for x in frames]
    gop = _port_dmc(params, fz, x0)
    got = [gop.compress(frames[0], QP)["bit_stream"]] + gop.compress_gop(
        frames[1:], [QP] * 3)["bit_streams"]
    assert got == per
    assert all(PD.parse_frame(s)[0]["kyc"] == 8 for s in per)
    assert torch.equal(gop.dpb[0].feature, single.dpb[0].feature)

    dec_per, dec_gop = _port_dmc(params, fz, x0), _port_dmc(params, fz, x0)
    x_per = [dec_per.decompress(s, SPS, QP)["x_hat"] for s in per]
    dec_gop.decompress(per[0], SPS, QP)
    x_gop = dec_gop.decompress_gop(per[1:], SPS, [QP] * 3)["x_hat"]
    for t in range(3):
        assert torch.equal(x_gop[t], x_per[t + 1])
    assert torch.equal(dec_gop.dpb[0].feature, dec_per.dpb[0].feature)
    assert torch.equal(dec_per.dpb[0].feature, single.dpb[0].feature)


def _jax_dmci(params, fz):
    net = JDMCI.DMCI()
    net.load_params(params)
    net.update(force_zero_thres=fz)
    return net


def _port_dmci(params, fz):
    net = PDMCI.DMCI(device="cpu", device_ec=True)
    net.load_params(params)
    net.update(force_zero_thres=fz)
    return net


@pytest.mark.parametrize("case", list(CASES))
def test_dmci_streams_cross(case, jax_params, compaction):
    """An I-frame, as test_dmc_streams_cross: four compacted quarters."""
    frac, fz, kyc = CASES[case]
    compaction(frac)
    x0, _ = _frames(0)
    stream = _jax_dmci(jax_params["i"], fz).compress(
        jnp.asarray(x0), QP)["bit_stream"]
    meta = JD.parse_frame(stream)[0]
    assert (meta["kyc"], meta["K"]) == (kyc, 2 + 4 * kyc), meta
    want = _jax_dmci(jax_params["i"], fz).decompress(stream, SPS,
                                                     QP)["x_hat"]
    params = from_jax(jax_params["i"])
    _close(_port_dmci(params, fz).decompress(stream, SPS, QP)["x_hat"], want)
    penc = _port_dmci(params, fz)
    r0 = _reruns()
    assert penc.compress(x0, QP)["bit_stream"] == stream
    assert _reruns() - r0 == (1 if case == "overflow" else 0)


def test_dmci_batch_equals_single(jax_params, compaction):
    """With kyc > 0: compress_batch writes compress's streams and x_hats,
    decompress_batch gives decompress's x_hats."""
    frac, fz, _ = CASES["first_rung"]
    compaction(frac)
    net = _port_dmci(from_jax(jax_params["i"]), fz)
    x0, frames = _frames(1)
    xs = [x0, frames[0]]
    single = [net.compress(x, QP) for x in xs]
    batch = net.compress_batch(xs, QP)
    assert batch["bit_streams"] == [s["bit_stream"] for s in single]
    assert all(PD.parse_frame(s["bit_stream"])[0]["kyc"] == 8
               for s in single)
    for t, s in enumerate(single):
        assert torch.equal(batch["x_hat"][t], s["x_hat"])
    dec = net.decompress_batch(batch["bit_streams"], SPS, QP)["x_hat"]
    for t, s in enumerate(single):
        assert torch.equal(dec[t], net.decompress(s["bit_stream"], SPS,
                                                  QP)["x_hat"])
        assert torch.equal(dec[t], s["x_hat"])


def _jax_skip(rows):
    """The port's compacted row ids with the kernels' skip row read as the
    JAX package's SKIP_ROW."""
    return torch.where(rows == DEC_SKIP, JD.SKIP_ROW, rows)


@pytest.mark.parametrize("n_c", [700, 64, 4096], ids=["fits", "overflow",
                                                      "longer_than_plane"])
def test_compaction_helpers_match_jax(n_c):
    """compact_skip_enc / compact_skip_dec / expand_compact_syms on a
    random 2000-symbol plane with 30 % survivors (~600): the JAX
    package's outputs exactly (the tail slots' row, the kernels' DEC_SKIP
    in the port, read as the JAX package's SKIP_ROW), the survivor count
    with overflow too, and the round trip gives the kept symbols with
    zeros elsewhere."""
    rng = np.random.default_rng(5)
    n = 2000
    sym = rng.integers(-20, 20, n).astype(np.int32)
    rows = rng.integers(0, 128, n).astype(np.int32)
    keep = rng.random(n) < 0.3
    j = JD.compact_skip_enc(jnp.asarray(sym), jnp.asarray(rows),
                            jnp.asarray(keep), n_c)
    p = PD.compact_skip_enc(torch.from_numpy(sym), torch.from_numpy(rows),
                            torch.from_numpy(keep), n_c)
    p = (p[0], _jax_skip(p[1]), p[2])
    for a, b in zip(p, j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jr, jo = JD.compact_skip_dec(jnp.asarray(rows), jnp.asarray(keep), n_c)
    pr, po = PD.compact_skip_dec(torch.from_numpy(rows),
                                 torch.from_numpy(keep), n_c)
    np.testing.assert_array_equal(_jax_skip(pr).numpy(), np.asarray(jr))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    full = PD.expand_compact_syms(p[0], po, n).numpy()
    np.testing.assert_array_equal(
        full, np.asarray(JD.expand_compact_syms(j[0], jo, n)))
    m = int(keep.sum())
    if m <= n_c:
        np.testing.assert_array_equal(full, np.where(keep, sym, 0))
