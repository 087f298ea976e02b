"""Port DMCI/DMC device-EC codecs against the JAX package (CPU, float32).

Default widths on 64x64 frames, weights from the JAX package's
`init_params(seed)` carried across, inputs from numpy (default_rng), with
force_zero_thres in {None, 0.12}.  Held:
  * per-stage floats within atol = 1e-4 * max|ref| (the conv accumulation
    order differs between XLA:CPU and ATen, over 20-40 stacked blocks);
  * the port's "tpu-lane" container is byte-identical to the JAX
    package's device-EC container (these inputs put no symbol at a
    rounding boundary);
  * the port's decoder reproduces the port encoder's x_hat and feature
    chain exactly over 4 P-frames, the last one after a periodic refresh
    (`prepare_feature_adaptor_i` on the encoder, `reset_ref_feature` on
    the decoder);
  * the port decodes the JAX package's containers and the JAX package
    decodes the port's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.models import dmc as JDMC
from opendcvc_tpu.models import dmci as JDMCI
from opendcvc_tpu_torch.models import dmc as PDMC
from opendcvc_tpu_torch.models import dmci as PDMCI
from opendcvc_tpu_torch.utils.params import from_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

H = W = 64
QP = 21
SPS = {"height": H, "width": W}
FZS = [None, 0.12]


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2),
                                      order="C"))


@pytest.fixture(scope="module")
def jax_params():
    """JAX inits (device-EC flag read by the JAX constructors)."""
    prev = os.environ.get("OPENDCVC_TPU_DEVICE_EC")
    os.environ["OPENDCVC_TPU_DEVICE_EC"] = "1"
    try:
        i_net, p_net = JDMCI.DMCI(), JDMC.DMC()
    finally:
        if prev is None:
            os.environ.pop("OPENDCVC_TPU_DEVICE_EC")
        else:
            os.environ["OPENDCVC_TPU_DEVICE_EC"] = prev
    return {"i": i_net.init_params(seed=0), "p": p_net.init_params(seed=1)}


def _jax_codec(cls, params, fz):
    prev = os.environ.get("OPENDCVC_TPU_DEVICE_EC")
    os.environ["OPENDCVC_TPU_DEVICE_EC"] = "1"
    try:
        net = cls()
    finally:
        if prev is None:
            os.environ.pop("OPENDCVC_TPU_DEVICE_EC")
        else:
            os.environ["OPENDCVC_TPU_DEVICE_EC"] = prev
    net.load_params(params)
    net.update(force_zero_thres=fz)
    assert net.device_ec
    return net


def _port_codec(cls, params, fz):
    net = cls(device="cpu", device_ec=True)
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


@pytest.fixture(scope="module", params=FZS, ids=["fz_none", "fz_0.12"])
def run(request, jax_params):
    """Code one I-frame and 4 P-frames with both packages, decode each
    side's streams with both packages; keep everything the tests hold."""
    fz = request.param
    x0, frames = _frames()
    out = {"fz": fz}

    ji = _jax_codec(JDMCI.DMCI, jax_params["i"], fz)
    pi = _port_codec(PDMCI.DMCI, jax_params["i"], fz)
    je, pe = ji.compress(jnp.asarray(x0), QP), pi.compress(x0, QP)
    out["i"] = {
        "jax_stream": je["bit_stream"], "port_stream": pe["bit_stream"],
        "jax_x": np.asarray(je["x_hat"]), "port_x": pe["x_hat"].numpy(),
        "port_dec": pi.decompress(pe["bit_stream"], SPS, QP)["x_hat"]
        .numpy(),
        "port_dec_jax": pi.decompress(je["bit_stream"], SPS, QP)["x_hat"]
        .numpy(),
        "jax_dec_port": np.asarray(
            ji.decompress(pe["bit_stream"], SPS, QP)["x_hat"]),
    }

    # P-frames: every codec starts from the same pixel reference
    ref = out["i"]["port_x"]
    nets = {"jax_enc": _jax_codec(JDMC.DMC, jax_params["p"], fz),
            "jax_dec": _jax_codec(JDMC.DMC, jax_params["p"], fz),
            "port_enc": _port_codec(PDMC.DMC, jax_params["p"], fz),
            "port_dec": _port_codec(PDMC.DMC, jax_params["p"], fz),
            "port_dec_jax": _port_codec(PDMC.DMC, jax_params["p"], fz)}
    for name, net in nets.items():
        net.add_ref_frame(None, jnp.asarray(ref) if name.startswith("jax")
                          else ref)
    p = {k: [] for k in ("jax_stream", "port_stream", "jax_feat",
                         "port_feat", "port_dec_feat", "port_dec_x",
                         "port_dec_jax_x", "jax_dec_port_x")}
    for i, x in enumerate(frames):
        if i == len(frames) - 1:   # periodic refresh through the pixels
            for name, net in nets.items():
                if name.endswith("enc"):
                    net.prepare_feature_adaptor_i(QP)
                else:
                    net.reset_ref_feature()
        js = nets["jax_enc"].compress(jnp.asarray(x), QP)["bit_stream"]
        ps = nets["port_enc"].compress(x, QP)["bit_stream"]
        p["jax_stream"].append(js)
        p["port_stream"].append(ps)
        p["jax_feat"].append(np.asarray(nets["jax_enc"].dpb[0].feature))
        p["port_feat"].append(_nhwc(nets["port_enc"].dpb[0].feature))
        p["port_dec_x"].append(
            nets["port_dec"].decompress(ps, SPS, QP)["x_hat"].numpy())
        p["port_dec_feat"].append(_nhwc(nets["port_dec"].dpb[0].feature))
        p["port_dec_jax_x"].append(
            nets["port_dec_jax"].decompress(js, SPS, QP)["x_hat"].numpy())
        p["jax_dec_port_x"].append(np.asarray(
            nets["jax_dec"].decompress(ps, SPS, QP)["x_hat"]))
    out["p"] = p

    # P-frame stages on the first frame's inputs, fed identical tensors
    jp, pp = jax_params["p"], nets["port_enc"].params
    feat = np.asarray(JDMC._stage_adaptor_i(jp, jnp.asarray(ref)))
    out["p_stages"] = [(_nhwc(PDMC._stage_adaptor_i(pp, _nchw(ref))), feat)]
    jx1, jctx_t = JDMC._stage_fe_part1(jp, jnp.asarray(feat), QP)
    px1, _ = PDMC._stage_fe_part1(pp, _nchw(feat), QP)
    jctx = JDMC._stage_fe_part2(jp, jx1)
    jy, jz_hat, _ = JDMC._stage_encode_y(jp, jnp.asarray(frames[0]),
                                         jctx, QP)
    py, _, _ = PDMC._stage_encode_y(pp, _nchw(frames[0]), _nchw(jctx), QP)
    jprior = JDMC._stage_prior(jp, jz_hat, jctx_t)
    pprior = PDMC._stage_prior(pp, _nchw(jz_hat), _nchw(jctx_t))
    jfeat = JDMC._stage_feature(jp, jy, jctx, QP)
    pfeat = PDMC._stage_feature(pp, _nchw(jy), _nchw(jctx), QP)
    jrec = JDMC._stage_recon_x(jp, jfeat, QP)
    prec = PDMC._stage_recon_x(pp, _nchw(jfeat), QP)
    out["p_stages"] += [(_nhwc(px1), jx1), (_nhwc(py), jy),
                        (_nhwc(pprior), jprior), (_nhwc(pfeat), jfeat),
                        (_nhwc(prec), jrec)]

    # intra stages, fed identical tensors
    ip = pi.params
    jy, jz_hat, jz = JDMCI._stage_enc_front(jax_params["i"],
                                            jnp.asarray(x0), QP)
    py, _, pz = PDMCI._stage_enc_front(ip, _nchw(x0), QP)
    jpr = JDMCI._stage_prior(jax_params["i"], jz_hat, 4, 4)
    ppr = PDMCI._stage_prior(ip, _nchw(jz_hat), 4, 4)
    out["i_stages"] = [(_nhwc(py), jy)] + \
        [(_nhwc(g), r) for g, r in zip(ppr, jpr)]
    out["i_z"] = (_nhwc(pz), np.asarray(jz))
    return out


def test_dmci_stages_match_jax(run):
    for got, ref in run["i_stages"]:
        _close(got, ref)
    np.testing.assert_array_equal(*run["i_z"])


def test_dmci_container_matches_jax(run):
    assert run["i"]["port_stream"] == run["i"]["jax_stream"]


def test_dmci_port_roundtrip_exact(run):
    np.testing.assert_array_equal(run["i"]["port_dec"], run["i"]["port_x"])
    _close(run["i"]["port_x"], run["i"]["jax_x"])


def test_dmci_cross_decode(run):
    _close(run["i"]["port_dec_jax"], run["i"]["jax_x"])
    _close(run["i"]["jax_dec_port"], run["i"]["port_x"])


def test_dmc_stages_match_jax(run):
    for got, ref in run["p_stages"]:
        _close(got, ref)


def test_dmc_containers_match_jax(run):
    p = run["p"]
    for i, (a, b) in enumerate(zip(p["port_stream"], p["jax_stream"])):
        assert a == b, f"P-frame {i}"


def test_dmc_port_feature_chain_exact(run):
    p = run["p"]
    for i, (enc, dec) in enumerate(zip(p["port_feat"], p["port_dec_feat"])):
        np.testing.assert_array_equal(dec, enc, err_msg=f"P-frame {i}")
    for got, ref in zip(p["port_feat"], p["jax_feat"]):
        _close(got, ref)


def test_dmc_cross_decode(run):
    p = run["p"]
    for port_x, port_on_jax, jax_on_port in zip(
            p["port_dec_x"], p["port_dec_jax_x"], p["jax_dec_port_x"]):
        _close(port_on_jax, port_x)
        _close(jax_on_port, port_x)


def test_weight_bridge_covers_port_init(jax_params):
    """The JAX trees convert to exactly the port's own init layout."""
    gen = torch.Generator().manual_seed(0)
    for jax_tree, port_tree in ((jax_params["i"], PDMCI.dmci_init(gen)),
                                (jax_params["p"], PDMC.dmc_init(gen))):
        conv = from_jax(jax_tree)

        def walk(a, b, path):
            if isinstance(b, dict):
                assert sorted(a) == sorted(b), path
                for k in b:
                    walk(a[k], b[k], f"{path}/{k}")
            elif isinstance(b, list):
                assert len(a) == len(b), path
                for i, (x, y) in enumerate(zip(a, b)):
                    walk(x, y, f"{path}/{i}")
            else:
                assert a.shape == b.shape and a.dtype == b.dtype, path
        walk(conv, port_tree, "")


def test_codec_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PDMC.DMC()
    with pytest.raises(RuntimeError, match="CUDA"):
        PDMCI.DMCI()
    assert PDMC.DMC(device="cpu").device.type == "cpu"


def test_dmci_staging_ladder_matches_jax(jax_params, monkeypatch):
    """A first rung too small for the frame: the port regrows, remembers
    the settled rate, and writes the JAX package's container; a second
    launch at the learned rate writes the same stream without a rerun."""
    monkeypatch.setenv("OPENDCVC_TPU_EC_BPS", "0.05")
    ji = _jax_codec(JDMCI.DMCI, jax_params["i"], None)
    pi = PDMCI.DMCI(device="cpu", device_ec=True, bytes_per_symbol=0.05)
    pi.load_params(from_jax(jax_params["i"]))
    pi.update()
    x0, _ = _frames()
    ps = pi.compress(x0, QP)["bit_stream"]
    reruns = pi._ec_rerun_count
    assert reruns > 0 and pi._ec_learned
    assert ps == ji.compress(jnp.asarray(x0), QP)["bit_stream"]
    assert pi.compress(x0, QP)["bit_stream"] == ps
    assert pi._ec_rerun_count == reruns
    np.testing.assert_array_equal(
        pi.decompress(ps, SPS, QP)["x_hat"].numpy(),
        pi.compress(x0, QP)["x_hat"].numpy())
