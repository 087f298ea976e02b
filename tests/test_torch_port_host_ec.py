"""Port host-EC path (C++ rANS coder on the host) against the JAX package.

CPU, float32, default widths on 64x64 frames, weights from the JAX
package's `init_params(seed)` carried across, inputs from numpy
(default_rng).  The JAX codecs run their host-EC path
(OPENDCVC_TPU_DEVICE_EC unset) with their plain Python coder
(OPENDCVC_TPU_FORCE_PY_RANS set while `update()` builds it), which the
JAX package's own tests hold byte-identical to its native coder.  Held:
  * the port's native coder writes the bytes of its plain version and of
    the JAX package's coder, in one- and two-coder mode, interleaved and
    planar z, with symbols past every row's support (escapes); threaded
    and unthreaded alike; each decodes the others' streams;
  * the registered CDF tables and group indexes equal the JAX package's;
  * DMCI and DMC (4 P-frames at the harness's QP shifts 29/21/25/21) write
    the JAX package's host-EC streams byte for byte, with
    force_zero_thres in {None, 0.12} and one or two coders; the port
    decodes its own streams exactly (x_hat, feature chain) and each
    package decodes the other's;
  * host EC and device EC in the port give the same encoder outputs and
    decoded frames;
  * a host coder that cannot be built raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.entropy.coder import EntropyCoder as JEntropyCoder
from opendcvc_tpu.models import dmc as JDMC
from opendcvc_tpu.models import dmci as JDMCI
from opendcvc_tpu_torch.entropy import models as PM
from opendcvc_tpu_torch.entropy import rans_py as PR
from opendcvc_tpu_torch.entropy.coder import EntropyCoder
from opendcvc_tpu_torch.entropy.rans import RansDecoder, RansEncoder
from opendcvc_tpu_torch.models import dmc as PDMC
from opendcvc_tpu_torch.models import dmci as PDMCI
from opendcvc_tpu_torch.ops import _build
from opendcvc_tpu_torch.utils.params import from_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

H = W = 64
QP = 21
FA_IDX = [1, 0, 2, 0]          # the harness's index_map for frames 1..4
FZS = [None, 0.12]
TWOS = [False, True]
Z_QPS, Z_C, Z_QP = 3, 16, 2    # coder tests: z rows of 3 qps x 16 channels
N_Y, N_Z = 1000, Z_C * 24


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _sps(two):
    return {"height": H, "width": W, "ec_part": int(two)}


# ---------------------------------------------------------------------------
# the coder alone
# ---------------------------------------------------------------------------

def _tables():
    """(y rows, z rows) cdf_info: the gaussian scale rows and a seeded
    bit estimator's."""
    gen = torch.Generator().manual_seed(5)
    z = PM.BitEstimator(Z_QPS, Z_C).update(
        PM.bit_estimator_init(gen, Z_QPS, Z_C))
    return PM.GaussianEncoder().update(), z


def _symbols(seed):
    """y symbols in +-20 and z in +-30: both past every row's support."""
    rng = np.random.default_rng(seed)
    y_sym = rng.integers(-20, 21, N_Y)
    y_idx = rng.integers(0, 128, N_Y).astype(np.uint8)
    packed = (y_sym * 256 + y_idx).astype(np.int16)
    z = rng.integers(-30, 31, N_Z).astype(np.int8)
    return packed, y_sym.astype(np.int8), y_idx, z


def _z_args(interleaved):
    per_channel = Z_C if interleaved else N_Z // Z_C
    return Z_QP * Z_C, per_channel, int(interleaved), 0


def _encode(enc, two, interleaved, packed, z):
    """Code y (first half), z, y (second half) with a native RansEncoder
    or the plain PyEncoderPair."""
    for rows in _tables():
        enc.add_cdf(*rows)
    plain = isinstance(enc, PR.PyEncoderPair)
    (enc.set_two if plain else enc.set_use_two_encoders)(two)
    enc.reset()
    enc.encode_y(packed[:N_Y // 2], 0)
    enc.encode_z(z, 1, *_z_args(interleaved))
    enc.encode_y(packed[N_Y // 2:], 0)
    enc.flush()
    return enc.get_stream() if plain else enc.get_encoded_stream()


def _decode(dec, two, interleaved, stream, y_idx):
    for rows in _tables():
        dec.add_cdf(*rows, build_lut=True)
    plain = isinstance(dec, PR.PyDecoderPair)
    (dec.set_two if plain else dec.set_use_two_decoders)(two)
    dec.set_stream(stream)
    get = dec.get_decoded if plain else dec.get_decoded_tensor
    out = []
    dec.decode_y(y_idx[:N_Y // 2], 0)
    out.append(np.asarray(get(), np.int8))
    dec.decode_z(N_Z, 1, *_z_args(interleaved))
    out.append(np.asarray(get(), np.int8))
    dec.decode_y(y_idx[N_Y // 2:], 0)
    out.append(np.asarray(get(), np.int8))
    return out


@pytest.mark.parametrize("two", TWOS, ids=["one_coder", "two_coders"])
@pytest.mark.parametrize("interleaved", [False, True],
                         ids=["planar_z", "interleaved_z"])
def test_native_coder_matches_plain(two, interleaved):
    packed, y_sym, y_idx, z = _symbols(seed=1 + 2 * two + interleaved)
    want = [y_sym[:N_Y // 2], z, y_sym[N_Y // 2:]]
    streams = {
        "plain": _encode(PR.PyEncoderPair(), two, interleaved, packed, z),
        "native": _encode(RansEncoder(threaded=False), two, interleaved,
                          packed, z),
        "threaded": _encode(RansEncoder(threaded=True), two, interleaved,
                            packed, z),
    }
    assert streams["native"] == streams["plain"]
    assert streams["threaded"] == streams["plain"]
    for dec in (PR.PyDecoderPair(), RansDecoder(threaded=False),
                RansDecoder(threaded=True)):
        for got, ref in zip(_decode(dec, two, interleaved, streams["plain"],
                                    y_idx), want):
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("two", TWOS, ids=["one_coder", "two_coders"])
def test_coder_matches_jax_coder(two, monkeypatch):
    """EntropyCoder against the JAX package's (its plain coder): the same
    bytes, and each decodes the other's stream."""
    monkeypatch.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
    coders = {"port": EntropyCoder(), "jax": JEntropyCoder()}
    assert not coders["jax"].encoder._native
    packed, y_sym, y_idx, z = _symbols(seed=9)
    streams = {}
    for name, ec in coders.items():
        y_rows, z_rows = _tables()
        assert ec.add_cdf(*y_rows, build_lut=True) == 0
        assert ec.add_cdf(*z_rows) == 1
        ec.set_use_two_entropy_coders(two)
        ec.reset()
        ec.encode_z(z, 1, Z_QP * Z_C, Z_C)
        ec.encode_y(packed, 0)
        ec.flush()
        streams[name] = ec.get_encoded_stream()
    assert streams["port"] == streams["jax"]
    for name, ec in coders.items():
        other = streams["jax" if name == "port" else "port"]
        ec.set_stream(other)
        ec.decode_z(N_Z, 1, Z_QP * Z_C, Z_C)
        np.testing.assert_array_equal(ec.get_decoded_tensor(), z)
        np.testing.assert_array_equal(ec.decode_and_get_y(y_idx, 0), y_sym)


def test_coder_refuses_rows_past_its_group():
    """Row ids are checked before a pointer reaches the C++ coder."""
    enc, dec = RansEncoder(threaded=False), RansDecoder(threaded=False)
    y_rows, z_rows = _tables()
    for c in (enc, dec):
        c.add_cdf(*y_rows)
        c.add_cdf(*z_rows)
    with pytest.raises(IndexError):
        enc.encode_y(np.array([5 * 256 + 128], np.int16), 0)
    with pytest.raises(IndexError):
        enc.encode_z(np.zeros(Z_C, np.int8), 1, Z_QPS * Z_C, Z_C, True)
    with pytest.raises(IndexError):
        enc.encode_y(np.zeros(4, np.int16), 2)
    with pytest.raises(IndexError):
        dec.decode_y(np.array([200], np.uint8), 0)
    with pytest.raises(ValueError):
        dec.set_stream(b"\x00\x01")


# ---------------------------------------------------------------------------
# the codecs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    return {"i": JDMCI.DMCI().init_params(seed=0),
            "p": JDMC.DMC().init_params(seed=1)}


def _jax_codec(cls, params, fz):
    """A JAX codec on its host-EC path, coding with its plain coder."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("OPENDCVC_TPU_DEVICE_EC", raising=False)
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        net = cls()
        net.load_params(params)
        net.update(force_zero_thres=fz)
    assert not net.device_ec and not net.entropy_coder.encoder._native
    return net


def _port_codec(cls, params, fz, device_ec=False):
    net = cls(device="cpu", device_ec=device_ec)
    net.load_params(from_jax(params))
    net.update(force_zero_thres=fz)
    return net


def _frames():
    rng = np.random.default_rng(0)
    x0 = rng.random((1, H, W, 3), dtype=np.float32)
    frames = []
    prev = x0
    for _ in range(4):
        prev = np.clip(prev + rng.normal(0, 0.02, prev.shape)
                       .astype(np.float32), 0, 1)
        frames.append(prev)
    return x0, frames


def _run_intra(ji, pi, x0, two):
    sps = _sps(two)
    for net in (ji, pi):
        net.set_use_two_entropy_coders(two)
    js = ji.compress(jnp.asarray(x0), QP)["bit_stream"]
    pe = pi.compress(x0, QP)
    ps = pe["bit_stream"]
    return {"jax_stream": js, "port_stream": ps,
            "port_x": pe["x_hat"].numpy(),
            "port_dec": pi.decompress(ps, sps, QP)["x_hat"].numpy(),
            "port_dec_jax": pi.decompress(js, sps, QP)["x_hat"].numpy(),
            "jax_dec_port": np.asarray(ji.decompress(ps, sps, QP)["x_hat"])}


def _run_p(jax_p, ref, frames, fz, two):
    """4 P-frames at the harness's QP shifts through each package's
    encoder and three decoders (port of port, port of JAX, JAX of port)."""
    nets = {"jax_enc": _jax_codec(JDMC.DMC, jax_p, fz),
            "jax_dec": _jax_codec(JDMC.DMC, jax_p, fz),
            "port_enc": _port_codec(PDMC.DMC, jax_p, fz),
            "port_dec": _port_codec(PDMC.DMC, jax_p, fz),
            "port_dec_jax": _port_codec(PDMC.DMC, jax_p, fz)}
    for name, net in nets.items():
        net.set_use_two_entropy_coders(two)
        net.add_ref_frame(None, jnp.asarray(ref) if name.startswith("jax")
                          else ref)
    out = {k: [] for k in ("qp", "jax_stream", "port_stream", "jax_feat",
                           "port_feat", "port_dec_feat", "port_dec_x",
                           "port_dec_jax_x", "jax_dec_port_x")}
    for fa_idx, x in zip(FA_IDX, frames):
        qp = nets["port_enc"].shift_qp(QP, fa_idx)
        js = nets["jax_enc"].compress(jnp.asarray(x), qp)["bit_stream"]
        ps = nets["port_enc"].compress(x, qp)["bit_stream"]
        out["qp"].append(qp)
        out["jax_stream"].append(js)
        out["port_stream"].append(ps)
        out["jax_feat"].append(np.asarray(nets["jax_enc"].dpb[0].feature))
        out["port_feat"].append(_nhwc(nets["port_enc"].dpb[0].feature))
        out["port_dec_x"].append(nets["port_dec"].decompress(
            ps, _sps(two), qp)["x_hat"].numpy())
        out["port_dec_feat"].append(_nhwc(nets["port_dec"].dpb[0].feature))
        out["port_dec_jax_x"].append(nets["port_dec_jax"].decompress(
            js, _sps(two), qp)["x_hat"].numpy())
        out["jax_dec_port_x"].append(np.asarray(nets["jax_dec"].decompress(
            ps, _sps(two), qp)["x_hat"]))
    return out


@pytest.fixture(scope="module", params=FZS, ids=["fz_none", "fz_0.12"])
def run(request, jax_params):
    """For one force_zero_thres, with one and with two coders: an I-frame
    and 4 P-frames through both packages' host-EC paths, each side's
    streams decoded by both."""
    fz = request.param
    x0, frames = _frames()
    ji = _jax_codec(JDMCI.DMCI, jax_params["i"], fz)
    pi = _port_codec(PDMCI.DMCI, jax_params["i"], fz)
    out = {}
    for two in TWOS:
        out[("i", two)] = _run_intra(ji, pi, x0, two)
        out[("p", two)] = _run_p(jax_params["p"], out[("i", two)]["port_x"],
                                 frames, fz, two)
    return out


@pytest.mark.parametrize("two", TWOS, ids=["one_coder", "two_coders"])
def test_dmci_host_stream_matches_jax(run, two):
    r = run[("i", two)]
    assert r["port_stream"] == r["jax_stream"]


@pytest.mark.parametrize("two", TWOS, ids=["one_coder", "two_coders"])
def test_dmci_host_roundtrip_exact(run, two):
    r = run[("i", two)]
    np.testing.assert_array_equal(r["port_dec"], r["port_x"])


@pytest.mark.parametrize("two", TWOS, ids=["one_coder", "two_coders"])
def test_dmci_host_cross_decode(run, two):
    r = run[("i", two)]
    np.testing.assert_array_equal(r["port_dec_jax"], r["port_x"])
    _close(r["jax_dec_port"], r["port_x"])


@pytest.mark.parametrize("two", TWOS, ids=["one_coder", "two_coders"])
def test_dmc_host_streams_match_jax(run, two):
    p = run[("p", two)]
    assert p["qp"] == [29, 21, 25, 21]
    for i, (a, b) in enumerate(zip(p["port_stream"], p["jax_stream"])):
        assert a == b, f"P-frame {i}"


@pytest.mark.parametrize("two", TWOS, ids=["one_coder", "two_coders"])
def test_dmc_host_feature_chain_exact(run, two):
    p = run[("p", two)]
    for i, (enc, dec) in enumerate(zip(p["port_feat"], p["port_dec_feat"])):
        np.testing.assert_array_equal(dec, enc, err_msg=f"P-frame {i}")
    for got, ref in zip(p["port_feat"], p["jax_feat"]):
        _close(got, ref)


@pytest.mark.parametrize("two", TWOS, ids=["one_coder", "two_coders"])
def test_dmc_host_cross_decode(run, two):
    p = run[("p", two)]
    for i, (port_x, port_on_jax, jax_on_port) in enumerate(zip(
            p["port_dec_x"], p["port_dec_jax_x"], p["jax_dec_port_x"])):
        np.testing.assert_array_equal(port_on_jax, port_x,
                                      err_msg=f"P-frame {i}")
        _close(jax_on_port, port_x)


@pytest.mark.parametrize("fz", FZS, ids=["fz_none", "fz_0.12"])
def test_host_and_device_ec_agree(jax_params, fz):
    """One set of weights in the port: the host-EC and device-EC paths give
    the same encoder x_hat and features and the same decoded frames."""
    x0, frames = _frames()
    sps = _sps(False)
    out = {}
    for device_ec in (False, True):
        i_net = _port_codec(PDMCI.DMCI, jax_params["i"], fz, device_ec)
        enc = i_net.compress(x0, QP)
        i_dec = i_net.decompress(enc["bit_stream"], sps, QP)["x_hat"]
        p_enc = _port_codec(PDMC.DMC, jax_params["p"], fz, device_ec)
        p_dec = _port_codec(PDMC.DMC, jax_params["p"], fz, device_ec)
        for net in (p_enc, p_dec):
            net.add_ref_frame(None, enc["x_hat"])
        feats, xs = [], []
        for x in frames[:2]:
            s = p_enc.compress(x, QP)["bit_stream"]
            feats.append(p_enc.dpb[0].feature)
            xs.append(p_dec.decompress(s, sps, QP)["x_hat"])
        out[device_ec] = [enc["x_hat"], i_dec] + feats + xs
        assert torch.equal(i_dec, enc["x_hat"])
    for host, device in zip(out[False], out[True]):
        assert torch.equal(host, device)


@pytest.mark.parametrize("compiler", ["false", "/nonexistent/g++"],
                         ids=["compiler_fails", "no_compiler"])
def test_host_coder_build_failure_raises(compiler, monkeypatch, tmp_path):
    """No quiet fallback: a host coder that does not build raises, from
    the coder and from a host-EC codec's update()."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_HOST_RANS", {})
    monkeypatch.setattr(_build, "CXX", compiler)
    with pytest.raises(RuntimeError, match="rans_host build failed"):
        RansEncoder()
    net = PDMCI.DMCI(N=8, z_channel=8, enc_dec_ch=8, device="cpu")
    net.init_params(seed=0)
    with pytest.raises(RuntimeError, match="rans_host build failed"):
        net.update()
    assert not list(tmp_path.glob("*.so"))


def test_registered_tables_match_jax(jax_params):
    """Host-EC update(): the gaussian rows are group 0 (with the decoder's
    lookup table) and the z rows group 1, as in the JAX package, and the
    rows are the JAX package's."""
    for j_cls, p_cls, key in ((JDMCI.DMCI, PDMCI.DMCI, "i"),
                              (JDMC.DMC, PDMC.DMC, "p")):
        j = _jax_codec(j_cls, jax_params[key], 0.12)
        p = _port_codec(p_cls, jax_params[key], 0.12)
        for model in ("gaussian_encoder", "bit_estimator_z"):
            jm, pm = getattr(j, model), getattr(p, model)
            assert pm.cdf_group_index == jm.cdf_group_index
            assert pm.entropy_coder is p.entropy_coder
            for a, b in zip(pm.cdf_info, jm.cdf_info):
                np.testing.assert_array_equal(a, b)
        assert p.enc_table is None and p.dec_table is None
