"""The port's DCVC-FM ops, blocks, pass stages and CDF tables against the
JAX package (CPU, float32).

Inputs come from numpy (default_rng), weights from the JAX package's own
init functions carried across with `utils/params.py`.  Float outputs must
agree within atol = 1e-5 * max|ref| (XLA:CPU and ATen accumulate
convolutions, and round tanh / log / exp, differently); integer outputs
(CDF indexes, packed symbols, quantized planes) must be equal.  Held:
  * `flow_warp` (zero flow, integer and fractional shifts, flows past
    every border) and `bilinear_resize_2x` up (a wide and a tall input)
    and down;
  * SpyNet, a DCB4, UNet2, the DMCIFM UNet, `offset_diversity` on a
    non-square frame and `get_curr_q` at qp 0 / 31 / 63;
  * `make_pass_stages` (4 and 2 parts, video and qstep variants);
  * the GaussianEncoder tables of DMCFM (Laplace, 256 levels in [0.01,
    64]) and DMCIFM (Gaussian, 256 in [0.11, 64]), DCVC-RT's unchanged
    Gaussian-128, and FM's BitEstimator z tables (support 50, one and 64
    QP banks);
  * the FM stream syntax (`utils/stream_helper_fm.py`): SPS, I/P and
    NAL_Ps records byte-identical to the JAX package's, read back, and
    out-of-range fields raising ValueError;
  * the FM codecs' options: device EC and OPENDCVC_TPU_DEVICE_EC select
    the coder, bfloat16 builds, float16 raises, and without CUDA the
    default device raises in both FM codecs and in the FM harness.
The JAX side runs once, in a module-scoped fixture.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.entropy import models as JM
from opendcvc_tpu.layers import blocks_fm as JFM
from opendcvc_tpu.models import dmc_fm as JDMC
from opendcvc_tpu.models import prior_stages as JPS
from opendcvc_tpu.ops import warp as JW
from opendcvc_tpu.utils import stream_helper_fm as JSF
from opendcvc_tpu_torch.entropy import models as PM
from opendcvc_tpu_torch.eval import fm_harness as PH
from opendcvc_tpu_torch.layers import blocks_fm as PFM
from opendcvc_tpu_torch.models import dmc_fm as PDMC
from opendcvc_tpu_torch.models import dmci_fm as PDMCI
from opendcvc_tpu_torch.models import prior_stages as PPS
from opendcvc_tpu_torch.ops import warp as PW
from opendcvc_tpu_torch.utils import stream_helper_fm as PSF
from opendcvc_tpu_torch.utils.params import from_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)


def _nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2),
                                      order="C"))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _rand(seed, shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def _key(i):
    return jax.random.PRNGKey(100 + i)


# ---------------------------------------------------------------------------
# cases: name -> fn() -> list of (port output NHWC, JAX output, exact)
# ---------------------------------------------------------------------------

def _warp_flows(h, w):
    """Zero flow, integer shifts, fractional shifts and flows far past
    every border."""
    zero = np.zeros((1, h, w, 2), np.float32)
    shift = zero.copy()
    shift[..., 0], shift[..., 1] = 1.0, -2.0
    frac = zero.copy()
    frac[..., 0], frac[..., 1] = 0.25, 1.75
    wild = _rand(3, (1, h, w, 2), -3.0 * max(h, w), 3.0 * max(h, w))
    return {"zero": zero, "integer": shift, "fractional": frac,
            "past_borders": wild, "random": _rand(4, (1, h, w, 2), -4, 4)}


def _case_flow_warp():
    im = _rand(1, (2, 12, 20, 5))
    out = []
    for flow in _warp_flows(12, 20).values():
        flow = np.concatenate([flow, flow[:, ::-1]])
        out.append((_nhwc(PW.flow_warp(_nchw(im), _nchw(flow))),
                    JW.flow_warp(jnp.asarray(im), jnp.asarray(flow)), False))
    return out


def _case_flow_warp_identity_exact():
    """Zero flow and whole-pixel shifts sample pixels with weight 1."""
    im = _rand(2, (1, 9, 14, 3))
    flows = _warp_flows(9, 14)
    got = PW.flow_warp(_nchw(im), _nchw(flows["zero"]))
    shifted = PW.flow_warp(_nchw(im), _nchw(flows["integer"]))
    rows = np.clip(np.arange(9) - 2, 0, 8)
    cols = np.clip(np.arange(14) + 1, 0, 13)
    return [(_nhwc(got), im, True),
            (_nhwc(shifted), im[:, rows][:, :, cols], True)]


def _case_resize():
    x = _rand(5, (1, 6, 10, 4), -3, 3)
    tall = _rand(9, (1, 10, 6, 4), -3, 3)
    one = _rand(6, (1, 1, 1, 2))
    return [(_nhwc(PW.bilinear_resize_2x(_nchw(x), up=True)),
             JW.bilinear_resize_2x(jnp.asarray(x), up=True), False),
            (_nhwc(PW.bilinear_resize_2x(_nchw(tall), up=True)),
             JW.bilinear_resize_2x(jnp.asarray(tall), up=True), False),
            (_nhwc(PW.bilinear_resize_2x(_nchw(one), up=True)),
             JW.bilinear_resize_2x(jnp.asarray(one), up=True), False),
            (_nhwc(PW.bilinear_resize_2x(_nchw(x), up=False)),
             JW.bilinear_resize_2x(jnp.asarray(x), up=False), False)]


def _case_spynet():
    p = JFM.spynet_init(_key(0))
    im1, im2 = _rand(7, (1, 32, 48, 3), 0, 1), _rand(8, (1, 32, 48, 3), 0, 1)
    return [(_nhwc(PFM.spynet_apply(from_jax(p), _nchw(im1), _nchw(im2))),
             JFM.spynet_apply(p, jnp.asarray(im1), jnp.asarray(im2)),
             False)]


def _case_dcb4():
    p = JFM.dcb4_init(_key(1), 24, 16)
    x = _rand(9, (1, 6, 10, 24))
    return [(_nhwc(PFM.dcb4_apply(from_jax(p), _nchw(x))),
             JFM.dcb4_apply(p, jnp.asarray(x)), False)]


def _case_unet2():
    p = JFM.unet2_init(_key(2), 16, 16)
    x = _rand(10, (1, 8, 12, 16))
    return [(_nhwc(PFM.unet2_apply(from_jax(p), _nchw(x))),
             JFM.unet2_apply(p, jnp.asarray(x)), False)]


def _case_unet():
    p = JFM.unet_init(_key(3), 16, 16)
    x = _rand(11, (1, 8, 12, 16))
    return [(_nhwc(PFM.unet_apply(from_jax(p), _nchw(x))),
             JFM.unet_apply(p, jnp.asarray(x)), False)]


def _case_dcb3_rbs2():
    p3, pr = JFM.dcb3_init(_key(4), 12, 20), JFM.rbs2_init(_key(5), 3, 12)
    x, f = _rand(12, (1, 6, 10, 12)), _rand(13, (1, 12, 20, 3))
    return [(_nhwc(PFM.dcb3_apply(from_jax(p3), _nchw(x))),
             JFM.dcb3_apply(p3, jnp.asarray(x)), False),
            (_nhwc(PFM.rbs2_apply(from_jax(pr), _nchw(f))),
             JFM.rbs2_apply(pr, jnp.asarray(f)), False)]


def _case_offset_diversity():
    """A non-square frame, so a transposed axis or an (x, y) swap in the
    unit layout shows."""
    keys = jax.random.split(_key(6), 4)
    from opendcvc_tpu.layers.blocks import conv_init
    c = JDMC.G_CH_1X
    p = {"align": {"off1": conv_init(keys[0], c + 5, JDMC.G_CH_2X, 3),
                   "off2": conv_init(keys[1], JDMC.G_CH_2X, JDMC.G_CH_2X, 3),
                   "off3": conv_init(keys[2], JDMC.G_CH_2X, 96, 3),
                   "fusion": conv_init(keys[3], c * 2, c, 1, groups=16)}}
    h, w = 8, 14
    x = _rand(14, (1, h, w, c))
    aux = _rand(15, (1, h, w, c + 5))
    flow = _rand(16, (1, h, w, 2), -3, 3)
    got = PDMC.offset_diversity(from_jax(p), _nchw(x), _nchw(aux),
                                _nchw(flow))
    want = JDMC.offset_diversity(p, jnp.asarray(x), jnp.asarray(aux),
                                 jnp.asarray(flow))
    return [(_nhwc(got), want, False)]


def _case_get_curr_q():
    anchors = np.array([0.37, 2.9], np.float32)
    return [(PDMC.get_curr_q(torch.from_numpy(anchors), qp).numpy(),
             JDMC.get_curr_q(jnp.asarray(anchors), jnp.int32(qp)), False)
            for qp in (0, 31, 63)]


def _stage_inputs(seed, c=16, h=6, w=10):
    y = _rand(seed, (1, h, w, c), -6, 6)
    params = np.concatenate([_rand(seed + 1, (1, h, w, c), 0.2, 3),
                             _rand(seed + 2, (1, h, w, c), 0.001, 80),
                             _rand(seed + 3, (1, h, w, c), -2, 2)], -1)
    return y, params


def _case_pass_stages():
    """Every stage of make_pass_stages on the same inputs: the packed
    symbols and CDF indexes equal, the float planes within tolerance."""
    out = []
    for nparts, cfg_ge in ((4, "laplace"), (4, "gaussian"), (2, "laplace")):
        ge = PM.GaussianEncoder(distribution=cfg_ge, scale_levels=256,
                                scale_max=64.0, support=50)
        cfg = PDMCI.gaussian_cfg(ge)
        ps, js = PPS.make_pass_stages(cfg, nparts), \
            JPS.make_pass_stages(cfg, nparts)
        y, params = _stage_inputs(20 + nparts)
        scales, means = params[..., 16:32], params[..., 32:]
        p_div, p_pk, p_sf = ps["enc_pass0_video"](_nchw(y), _nchw(params))
        j_div, j_pk, j_sf = js["enc_pass0_video"](jnp.asarray(y),
                                                  jnp.asarray(params))
        out += [(_nhwc(p_div), j_div, False), (_nhwc(p_pk), j_pk, True),
                (_nhwc(p_sf), j_sf, False)]
        p_pk1, p_sf1 = ps["enc_pass_k"](p_div, _nchw(scales), _nchw(means),
                                        p_sf, 1)
        j_pk1, j_sf1 = js["enc_pass_k"](j_div, jnp.asarray(scales),
                                        jnp.asarray(means), j_sf, 1)
        out += [(_nhwc(p_pk1), j_pk1, True), (_nhwc(p_sf1), j_sf1, False)]
        out.append((_nhwc(ps["dec_index0_video"](_nchw(params))),
                    js["dec_index0_video"](jnp.asarray(params)), True))
        out.append((_nhwc(ps["dec_index_k"](_nchw(scales), 1)),
                    js["dec_index_k"](jnp.asarray(scales), 1), True))
        q = _rand(30, (1, 6, 10, 16 // nparts), -5, 5).round()
        r0 = ps["dec_restore0_video"](_nchw(q), _nchw(params))
        out.append((_nhwc(r0), js["dec_restore0_video"](
            jnp.asarray(q), jnp.asarray(params)), False))
        out.append((_nhwc(ps["dec_restore_acc"](_nchw(q), _nchw(means), r0,
                                                1)),
                    js["dec_restore_acc"](jnp.asarray(q), jnp.asarray(means),
                                          js["dec_restore0_video"](
                                              jnp.asarray(q),
                                              jnp.asarray(params)), 1),
                    False))
        out.append((_nhwc(ps["finalize_video"](p_sf1, _nchw(params))),
                    js["finalize_video"](j_sf1, jnp.asarray(params)), False))
        q_step = _rand(31, (1, 6, 10, 16), 0.3, 2)
        p_q = ps["enc_pass0_qstep"](_nchw(y), _nchw(q_step), _nchw(scales),
                                    _nchw(means))
        j_q = js["enc_pass0_qstep"](jnp.asarray(y), jnp.asarray(q_step),
                                    jnp.asarray(scales), jnp.asarray(means))
        out += [(_nhwc(p_q[0]), j_q[0], False), (_nhwc(p_q[1]), j_q[1], True)]
        out.append((_nhwc(ps["finalize_qstep"](p_sf, p_sf1, _nchw(q_step),
                                               1.5)),
                    js["finalize_qstep"](j_sf, j_sf1, jnp.asarray(q_step),
                                         1.5), False))
    return out


CASES = {
    "flow_warp": _case_flow_warp,
    "flow_warp_identity_exact": _case_flow_warp_identity_exact,
    "bilinear_resize_2x": _case_resize,
    "spynet": _case_spynet,
    "dcb4": _case_dcb4,
    "unet2": _case_unet2,
    "unet": _case_unet,
    "dcb3_rbs2": _case_dcb3_rbs2,
    "offset_diversity": _case_offset_diversity,
    "get_curr_q": _case_get_curr_q,
    "pass_stages": _case_pass_stages,
}


@pytest.fixture(scope="module")
def results():
    return {name: fn() for name, fn in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_fm_op_matches_jax(results, name):
    for i, (got, want, exact) in enumerate(results[name]):
        want = np.asarray(want)
        got = np.asarray(got)
        assert got.shape == want.shape, (name, i)
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {i}")
        else:
            want = want.astype(np.float32)
            np.testing.assert_allclose(
                got.astype(np.float32), want, rtol=0,
                atol=1e-5 * max(float(np.abs(want).max()), 1e-30),
                err_msg=f"{name} {i}")


# ---------------------------------------------------------------------------
# CDF tables
# ---------------------------------------------------------------------------

class _Registry:
    """Stands in for an entropy coder: update() only registers rows."""

    def add_cdf(self, *args, **kwargs):
        return 0


GAUSSIAN_ENCODERS = {
    "dmcfm_laplace_256": dict(distribution="laplace", scale_min=0.01,
                              scale_max=64.0, scale_levels=256, support=50),
    "dmcifm_gaussian_256": dict(distribution="gaussian", scale_min=0.11,
                                scale_max=64.0, scale_levels=256,
                                support=50),
    "rt_gaussian_128": {},
    # the port's defaults whatever the distribution (the JAX package's
    # Laplace default scale_min is 0.01; every FM caller passes its own)
    "laplace_rt_range": dict(distribution="laplace", scale_min=0.11,
                             scale_max=16.0, scale_levels=128),
}


@pytest.mark.parametrize("name", list(GAUSSIAN_ENCODERS))
def test_gaussian_encoder_tables_match_jax(name):
    kw = GAUSSIAN_ENCODERS[name]
    port, jax_ge = PM.GaussianEncoder(**kw), JM.GaussianEncoder(**kw)
    got = port.update()
    jax_ge.update(_Registry())
    for a, b in zip(got, jax_ge.cdf_info):
        np.testing.assert_array_equal(a, b)
    for attr in ("SCALE_MIN", "SCALE_MAX", "SCALE_LEVELS", "log_scale_min",
                 "log_step_recip"):
        assert getattr(port, attr) == getattr(jax_ge, attr), attr
    if not kw or name == "laplace_rt_range":
        # DCVC-RT's range: the class constants its codecs index with, and
        # the defaults of either distribution
        default = PM.GaussianEncoder(kw.get("distribution", "gaussian"))
        assert (port.SCALE_MIN, port.SCALE_MAX, port.SCALE_LEVELS) == \
            (default.SCALE_MIN, default.SCALE_MAX, default.SCALE_LEVELS) \
            == (0.11, 16.0, 128)


@pytest.mark.parametrize("qp_num", [1, 64])
def test_fm_bit_estimator_tables_match_jax(qp_num):
    gen = torch.Generator().manual_seed(qp_num)
    params = PM.bit_estimator_init(gen, qp_num, 64)
    got = PM.BitEstimator(qp_num, 64, support=50).update(params)
    jax_be = JM.BitEstimator(qp_num, 64, support=50)
    jax_be.update({k: {n: v.numpy() for n, v in layer.items()}
                   for k, layer in params.items()}, _Registry())
    for a, b in zip(got, jax_be.cdf_info):
        np.testing.assert_array_equal(a, b)


def test_gaussian_encoder_refuses_unknown_distribution():
    with pytest.raises(ValueError):
        PM.GaussianEncoder(distribution="logistic")


# ---------------------------------------------------------------------------
# FM stream syntax
# ---------------------------------------------------------------------------

# (height, width, qp, fa_idx, I-frame, payload bytes): payloads of 1-,
# 2- and 4-byte adaptive lengths, an SPS reused and a new one
RECORDS = [(1080, 1920, 21, 0, True, 100), (1080, 1920, 29, 1, False, 300),
           (64, 64, 63, 3, False, 20000), (1080, 1920, 21, 0, False, 5)]


def _fm_stream(S, payloads):
    f, helper, ids = io.BytesIO(), S.SPSHelper(), []
    for (h, w, qp, fa, is_i, _), data in zip(RECORDS, payloads):
        sps = {"sps_id": -1, "height": h, "width": w, "qp": qp,
               "fa_idx": fa}
        sps["sps_id"], new = helper.get_sps_id(sps)
        if new:
            S.write_sps(f, sps)
        S.write_ip(f, is_i, sps["sps_id"], data)
        ids.append(sps["sps_id"])
    S.write_p_frames(f, ids[1:], payloads[0])
    return f.getvalue(), ids


def test_fm_stream_syntax_matches_jax():
    rng = np.random.default_rng(3)
    payloads = [rng.integers(0, 256, r[5]).astype(np.uint8).tobytes()
                for r in RECORDS]
    data, ids = _fm_stream(PSF, payloads)
    assert data == _fm_stream(JSF, payloads)[0]
    assert ids == [0, 1, 2, 0]
    rd, helper = io.BytesIO(data), PSF.SPSHelper()
    for (h, w, qp, fa, is_i, _), sid, want in zip(RECORDS, ids, payloads):
        header = PSF.read_header(rd)
        while header["nal_type"] == PSF.NalType.NAL_SPS:
            helper.add_sps_by_id(PSF.read_sps_remaining(rd,
                                                        header["sps_id"]))
            header = PSF.read_header(rd)
        assert header == {"nal_type": PSF.NalType.NAL_I if is_i
                          else PSF.NalType.NAL_P, "sps_id": sid}
        assert helper.get_sps_by_id(sid) == {
            "sps_id": sid, "height": h, "width": w, "qp": qp, "fa_idx": fa}
        assert PSF.read_ip_remaining(rd) == want
    assert PSF.read_header(rd) == {"nal_type": PSF.NalType.NAL_Ps,
                                   "frame_num": 3, "sps_ids": ids[1:]}
    assert PSF.read_ip_remaining(rd) == payloads[0]
    assert rd.read() == b""


def test_fm_stream_syntax_refuses_out_of_range():
    sps = {"sps_id": 0, "height": 64, "width": 64, "qp": 21, "fa_idx": 0}
    for key, bad in (("sps_id", 16), ("qp", 64), ("fa_idx", 4)):
        with pytest.raises(ValueError):
            PSF.write_sps(io.BytesIO(), dict(sps, **{key: bad}))
    with pytest.raises(ValueError):
        PSF.write_p_frames(io.BytesIO(), list(range(17)), b"x")
    with pytest.raises(ValueError):
        PSF.read_ip_remaining(io.BytesIO(b"\x05abc"))
    helper = PSF.SPSHelper()
    for qp in range(16):
        helper.get_sps_id(dict(sps, qp=qp))
    with pytest.raises(ValueError):
        helper.get_sps_id(dict(sps, qp=40))


# ---------------------------------------------------------------------------
# no silent fallback
# ---------------------------------------------------------------------------

CODECS = {"DMCIFM": PDMCI.DMCIFM, "DMCFM": PDMC.DMCFM}


@pytest.mark.parametrize("codec", list(CODECS))
def test_fm_device_ec_refused(codec, monkeypatch):
    """FM device EC is ported: device_ec=True and OPENDCVC_TPU_DEVICE_EC=1
    select it, =0 (or unset) selects host EC, and an explicit device_ec
    wins over the environment."""
    monkeypatch.delenv("OPENDCVC_TPU_DEVICE_EC", raising=False)
    assert CODECS[codec](device="cpu", device_ec=True).device_ec
    assert not CODECS[codec](device="cpu").device_ec
    monkeypatch.setenv("OPENDCVC_TPU_DEVICE_EC", "1")
    assert CODECS[codec](device="cpu").device_ec
    assert not CODECS[codec](device="cpu", device_ec=False).device_ec
    monkeypatch.setenv("OPENDCVC_TPU_DEVICE_EC", "0")
    assert not CODECS[codec](device="cpu").device_ec


@pytest.mark.parametrize("codec", list(CODECS))
def test_fm_bfloat16_refused(codec, monkeypatch):
    """FM bfloat16 is ported: a bfloat16 codec builds, and a dtype the
    port does not run (float16) raises.  The name is the one this test
    had while FM refused bfloat16; it is kept so the test stays the same
    test."""
    monkeypatch.delenv("OPENDCVC_TPU_DEVICE_EC", raising=False)
    assert CODECS[codec](device="cpu", dtype=torch.bfloat16).dtype == \
        torch.bfloat16
    with pytest.raises(NotImplementedError, match="float16"):
        CODECS[codec](device="cpu", dtype=torch.float16)


@pytest.mark.parametrize("codec", list(CODECS))
def test_fm_cuda_default_raises_without_cuda(codec, monkeypatch):
    monkeypatch.delenv("OPENDCVC_TPU_DEVICE_EC", raising=False)
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CODECS[codec]()


def test_fm_harness_refuses_device_ec_and_missing_cuda(tmp_path,
                                                       monkeypatch):
    """Under OPENDCVC_TPU_DEVICE_EC=1 the harness builds both codecs on
    device EC (here on the CPU, an empty config); without CUDA the default
    --device raises before any work.  The name is the one this test had
    while the harness refused FM device EC; it is kept so the test stays
    the same test."""
    cfg = tmp_path / "c.json"
    cfg.write_text('{"root_path": ".", "test_classes": {}}')
    argv = ["--test_config", str(cfg), "--output_path",
            str(tmp_path / "o.json"), "--rate_num", "1", "--qp_i", "21"]
    built = []
    build = PH.build_nets

    def recording(args):
        nets = build(args)
        built.extend(net.device_ec for net in nets)
        return nets

    monkeypatch.setattr(PH, "build_nets", recording)
    monkeypatch.setenv("OPENDCVC_TPU_DEVICE_EC", "1")
    PH.main(argv + ["--device", "cpu"])
    assert built == [True, True]
    (tmp_path / "o.json").unlink()
    monkeypatch.delenv("OPENDCVC_TPU_DEVICE_EC")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PH.main(argv)
    assert not (tmp_path / "o.json").exists()
