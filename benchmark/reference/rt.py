"""Plain reference of DCVC-RT (Jia et al., CVPR 2025): the intra codec
DMCI and the P-frame codec DMC, NCHW, in the configuration's precision.

A frozen copy of the measured package's `models/dmci.py` and
`models/dmc.py` stages, without entropy coding: the encoder's
quantization decides every symbol, and the decoder rebuilds a frame from
the same symbols, so the encoder's own y_hat, feature and reconstruction
are what any decoder of its streams must give.  `encode_sequence` codes
one intra period and returns each frame's reconstruction.

In bfloat16 the activations are bfloat16 from the frames on: each frame
is cast to it where the measured package casts its input, each
convolution casts its float32 weight and bias to the activations' type
(`nn.conv_apply`, round to nearest even, as the package's load-time cast
of its float32 leaves gives them) and each qp bank its row (`nn.q_vec`);
quantization rounds in float32 as the package does.  The float32 path
casts nothing.
"""

import math

import torch

from . import nn as N
from .nn import pin_precision  # noqa: F401

# DMC widths (published DCVC-RT)
CH_SRC_D = 3 * 8 * 8
CH_RECON = 320
CH_Y = 128
CH_Z = 128
CH_D = 256
QP_SHIFT = [0, 8, 4]
EXTRA_QP = max(QP_SHIFT)
# DMCI widths
CH_ENC_DEC = 368
N_I = 256
Z_I = 128


def _ladder(n):
    return torch.exp(torch.linspace(math.log(4.0), math.log(0.4), n))[:, None]


def dmc_init(gen, qp_num=N.QP_NUM):
    dcb = N.depth_conv_block_init
    p = {}
    p["feature_adaptor_i"] = dcb(gen, CH_SRC_D, CH_D)
    p["feature_adaptor_p"] = N.conv_init(gen, CH_D, CH_D, 1)
    p["fe_conv1"] = [dcb(gen, CH_D, CH_D) for _ in range(2)]
    p["fe_conv2"] = [dcb(gen, CH_D, CH_D) for _ in range(4)]
    p["enc_conv1"] = N.conv_init(gen, CH_SRC_D, CH_D, 1)
    p["enc_conv2"] = [dcb(gen, CH_D * 2, CH_D), dcb(gen, CH_D, CH_D)]
    p["enc_conv3"] = dcb(gen, CH_D, CH_D)
    p["enc_down"] = N.conv_init(gen, CH_D, CH_Y, 3)
    p["hyper_enc"] = [dcb(gen, CH_Y, CH_Z),
                      N.res_block_stride2_init(gen, CH_Z, CH_Z),
                      N.res_block_stride2_init(gen, CH_Z, CH_Z)]
    p["hyper_dec"] = [N.res_block_upsample_init(gen, CH_Z, CH_Z),
                      N.res_block_upsample_init(gen, CH_Z, CH_Z),
                      dcb(gen, CH_Z, CH_Y)]
    p["temporal_prior"] = N.res_block_stride2_init(gen, CH_D, CH_Y * 2)
    p["y_prior_fusion"] = [dcb(gen, CH_Y * 3, CH_Y * 3) for _ in range(3)] \
        + [N.conv_init(gen, CH_Y * 3, CH_Y * 3, 1)]
    p["y_spatial_prior"] = [dcb(gen, CH_Y * 4, CH_Y * 3),
                            dcb(gen, CH_Y * 3, CH_Y * 3),
                            N.conv_init(gen, CH_Y * 3, CH_Y * 2, 1)]
    p["dec_up"] = N.subpel_conv2x_init(gen, CH_Y, CH_D, 3)
    p["dec_conv1"] = [dcb(gen, CH_D * 2, CH_D), dcb(gen, CH_D, CH_D),
                      dcb(gen, CH_D, CH_D)]
    p["dec_conv2"] = N.conv_init(gen, CH_D, CH_D, 1)
    p["recon_conv"] = [dcb(gen, CH_D, CH_RECON)] \
        + [dcb(gen, CH_RECON, CH_RECON) for _ in range(3)]
    p["recon_head"] = N.conv_init(gen, CH_RECON, CH_SRC_D, 1)
    n_qp = qp_num + EXTRA_QP
    ladder = _ladder(n_qp).to(gen.device)
    p["q_encoder"] = torch.ones((n_qp, CH_D), device=gen.device) * ladder
    p["q_decoder"] = torch.ones((n_qp, CH_D), device=gen.device) / ladder
    p["q_feature"] = torch.ones((n_qp, CH_D), device=gen.device)
    p["q_recon"] = torch.ones((n_qp, CH_RECON), device=gen.device)
    p["bit_estimator_z"] = N.bit_estimator_init(gen, n_qp, CH_Z)
    return p


def dmci_init(gen, qp_num=N.QP_NUM):
    dcb = N.depth_conv_block_init
    ch, n, z = CH_ENC_DEC, N_I, Z_I
    p = {}
    p["enc1"] = dcb(gen, CH_SRC_D, ch)
    p["enc2"] = [dcb(gen, ch, ch) for _ in range(6)]
    p["enc_down"] = N.conv_init(gen, ch, n, 3)
    p["hyper_enc"] = [dcb(gen, n, z), N.res_block_stride2_init(gen, z, z),
                      N.res_block_stride2_init(gen, z, z)]
    p["hyper_dec"] = [N.res_block_upsample_init(gen, z, z),
                      N.res_block_upsample_init(gen, z, z), dcb(gen, z, n)]
    p["y_prior_fusion"] = [dcb(gen, n, n * 2), dcb(gen, n * 2, n * 2),
                           dcb(gen, n * 2, n * 2),
                           N.conv_init(gen, n * 2, n * 2 + 2, 1)]
    p["reduction"] = N.conv_init(gen, n * 2 + 2, n, 1)
    for k in (1, 2, 3):
        p[f"adaptor_{k}"] = dcb(gen, n * 2, n * 2, force_adaptor=True)
    p["y_spatial_prior"] = [dcb(gen, n * 2, n * 2) for _ in range(3)] \
        + [N.conv_init(gen, n * 2, n * 2, 1)]
    p["dec1_up"] = N.res_block_upsample_init(gen, n, ch)
    p["dec1"] = [dcb(gen, ch, ch) for _ in range(12)]
    p["dec2"] = dcb(gen, ch, CH_SRC_D)
    ladder = _ladder(qp_num).to(gen.device)
    p["q_scale_enc"] = torch.ones((qp_num, ch), device=gen.device) * ladder
    p["q_scale_dec"] = torch.ones((qp_num, ch), device=gen.device) / ladder
    p["bit_estimator_z"] = N.bit_estimator_init(gen, qp_num, z)
    return p


# ---------------------------------------------------------------------------
# DMC stages
# ---------------------------------------------------------------------------

def _hyper_enc(p, y_pad):
    h = N.depth_conv_block_apply(p["hyper_enc"][0], y_pad)
    h = N.res_block_stride2_apply(p["hyper_enc"][1], h)
    return N.res_block_stride2_apply(p["hyper_enc"][2], h)


def _hyper_dec(p, z_hat):
    h = N.res_block_upsample_apply(p["hyper_dec"][0], z_hat)
    h = N.res_block_upsample_apply(p["hyper_dec"][1], h)
    return N.depth_conv_block_apply(p["hyper_dec"][2], h)


def p_adapt(p, frame=None, feature=None):
    """The reference's adapted feature: from a pixel frame (NCHW) after an
    I-frame, else from the propagated feature."""
    if feature is None:
        return N.depth_conv_block_apply(p["feature_adaptor_i"],
                                        N.F.pixel_unshuffle(frame, 8))
    return N.conv_apply(p["feature_adaptor_p"], feature)


def p_context(p, feature, qp):
    x1 = N.dcb_seq(p["fe_conv1"], feature)
    ctx_t = x1 * N.q_vec(p["q_feature"], qp, x1.dtype)
    return x1, ctx_t, N.dcb_seq(p["fe_conv2"], x1)


def p_encode_y(p, x, ctx, qp):
    feat = N.conv_apply(p["enc_conv1"], N.F.pixel_unshuffle(x, 8))
    feat = N.depth_conv_block_apply(p["enc_conv2"][0],
                                    torch.cat((feat, ctx), dim=1))
    feat = N.depth_conv_block_apply(p["enc_conv2"][1], feat)
    feat = N.depth_conv_block_apply(
        p["enc_conv3"], feat, quant_step=N.q_vec(p["q_encoder"], qp,
                                                 feat.dtype))
    y = N.conv_apply(p["enc_down"], feat, stride=2, padding=1)
    z = _hyper_enc(p, N.pad_for_y(y))
    z_hat, z_int8 = N.round_and_to_int8(z)
    return y, z_hat.to(x.dtype), z_int8


def p_prior(p, z_hat, ctx_t):
    hier = _hyper_dec(p, z_hat)
    temporal = N.res_block_stride2_apply(p["temporal_prior"], ctx_t)
    hier = hier[:, :, :temporal.shape[2], :temporal.shape[3]]
    fused = N.dcb_seq(p["y_prior_fusion"][:3],
                      torch.cat((hier, temporal), dim=1))
    return N.conv_apply(p["y_prior_fusion"][3], fused)


def p_spatial(p, y_hat_0, params_prior):
    h = torch.cat((y_hat_0, params_prior), dim=1)
    h = N.depth_conv_block_apply(p["y_spatial_prior"][0], h)
    h = N.depth_conv_block_apply(p["y_spatial_prior"][1], h)
    out = N.conv_apply(p["y_spatial_prior"][2], h)
    c = out.shape[1] // 2
    return out[:, :c], out[:, c:]


def p_quantize(p, y, params_prior, fz):
    """Both checkerboard passes: ((symbols, masked scales) of y0, of y1)
    and the dequantized latent."""
    q_dec, scales, means = N.separate_prior_video(params_prior)
    y = y * (1.0 / q_dec)
    m0, _ = N.masks_of(y, 2)
    y_q0, y_hat_0 = N.process_with_mask(y, scales, means, m0, fz)
    scales1, means1 = p_spatial(p, y_hat_0, params_prior)
    _, m1 = N.masks_of(y, 2)
    y_q1, y_hat_1 = N.process_with_mask(y, scales1, means1, m1, fz)
    return ((y_q0, scales * m0), (y_q1, scales1 * m1)), \
        (y_hat_0 + y_hat_1) * q_dec


def p_feature(p, y_hat, ctx, qp):
    feat = N.subpel_conv2x_apply(p["dec_up"], y_hat, padding=1)
    feat = torch.cat((feat, ctx), dim=1)
    for bp in p["dec_conv1"]:
        feat = N.depth_conv_block_apply(bp, feat)
    feat = N.conv_apply(p["dec_conv2"], feat)
    return feat * N.q_vec(p["q_decoder"], qp, feat.dtype)


def p_recon(p, feature, qp):
    out = N.dcb_seq(p["recon_conv"][:3], feature)
    out = N.depth_conv_block_apply(p["recon_conv"][3], out,
                                   quant_step=N.q_vec(p["q_recon"], qp,
                                                      out.dtype))
    return N.pixel_shuffle_clamp(N.conv_apply(p["recon_head"], out), 8)


def p_frame(p, x, adapted, qp, fz):
    """One P-frame through the encoder: (next feature, reconstruction
    NCHW, (z, (symbols, masked scales) of y0, of y1))."""
    _, ctx_t, ctx = p_context(p, adapted, qp)
    y, z_hat, z_int8 = p_encode_y(p, x, ctx, qp)
    params_prior = p_prior(p, z_hat, ctx_t)
    y_q, y_hat = p_quantize(p, y, params_prior, fz)
    feature = p_feature(p, y_hat, ctx, qp)
    return feature, p_recon(p, feature, qp), (z_int8,) + y_q


# ---------------------------------------------------------------------------
# DMCI stages
# ---------------------------------------------------------------------------

def i_front(p, x, qp):
    """DMCI's encoder side: frame -> (y, z_hat, z as int8)."""
    out = N.depth_conv_block_apply(p["enc1"], N.F.pixel_unshuffle(x, 8),
                                   quant_step=N.q_vec(p["q_scale_enc"], qp,
                                                      x.dtype))
    out = N.dcb_seq(p["enc2"], out)
    y = N.conv_apply(p["enc_down"], out, stride=2, padding=1)
    z = _hyper_enc(p, N.pad_for_y(y))
    z_hat, z_int8 = N.round_and_to_int8(z)
    return y, z_hat.to(x.dtype), z_int8


def i_back(p, y, z_hat, qp, fz):
    """DMCI's shared side: the prior from z_hat, the four quadtree passes
    over y and the reconstruction: (reconstruction NCHW, (symbols, masked
    scales) of each pass)."""
    params = N.dcb_seq(p["y_prior_fusion"][:3], _hyper_dec(p, z_hat))
    params = N.conv_apply(p["y_prior_fusion"][3], params)
    params = params[:, :, :y.shape[2], :y.shape[3]]
    q_enc, q_dec, scales, means = N.separate_prior_image(params)
    reduced = N.conv_apply(p["reduction"], params)
    y_s = y * q_enc
    masks = N.masks_of(y_s, 4)
    so_far, syms = None, []
    for k in range(4):
        if k > 0:
            h = N.depth_conv_block_apply(p[f"adaptor_{k}"],
                                         torch.cat((so_far, reduced), dim=1))
            h = N.dcb_seq(p["y_spatial_prior"][:3], h)
            out = N.conv_apply(p["y_spatial_prior"][3], h)
            c = out.shape[1] // 2
            scales, means = out[:, :c], out[:, c:]
        y_q, y_hat_k = N.process_with_mask(y_s, scales, means, masks[k], fz)
        syms.append((y_q, scales * masks[k]))
        so_far = y_hat_k if so_far is None else so_far + y_hat_k
    return i_recon(p, so_far * q_dec, qp), tuple(syms)


def i_frame(p, x, qp, fz):
    """One I-frame through the encoder: (reconstruction NCHW, (z, (symbols,
    masked scales) of y0..y3))."""
    y, z_hat, z_int8 = i_front(p, x, qp)
    x_hat, syms = i_back(p, y, z_hat, qp, fz)
    return x_hat, (z_int8,) + syms


def i_recon(p, y_hat, qp):
    q_dec = N.q_vec(p["q_scale_dec"], qp, y_hat.dtype)
    out = N.res_block_upsample_apply(p["dec1_up"], y_hat)
    out = N.dcb_seq(p["dec1"][:-1], out)
    out = N.depth_conv_block_apply(p["dec1"][-1], out, quant_step=q_dec)
    out = N.depth_conv_block_apply(p["dec2"], out)
    return torch.clamp(N.F.pixel_shuffle(out, 8), 0.0, 1.0)


# ---------------------------------------------------------------------------
# a period
# ---------------------------------------------------------------------------

def encode_sequence(p_i, p_p, frames, qp, fz, keep=None, symbols=False,
                    dtype=torch.float32, features=None):
    """Code frames[0] as an I-frame and the rest as P-frames, each
    predicted from the last; frames are NHWC on the device, cast to
    `dtype`, the activations' type.  Returns {t: reconstruction NHWC}
    (with `symbols`, {t: the frame's symbols}) for each t in `keep` (all
    when None), computed one frame at a time.  `features`, a dict keyed
    by P-frame positions, gets the propagated feature (NCHW) each of those
    frames leaves."""
    out = {}
    x_hat, syms = i_frame(p_i, N.to_nchw(frames[0].to(dtype)), qp, fz)
    ref_frame, feature = x_hat, None
    if keep is None or 0 in keep:
        out[0] = syms if symbols else N.to_nhwc(x_hat)
    for t in range(1, len(frames)):
        adapted = p_adapt(p_p, frame=ref_frame, feature=feature)
        feature, x_hat, syms = p_frame(p_p, N.to_nchw(frames[t].to(dtype)),
                                       adapted, qp, fz)
        if keep is None or t in keep:
            out[t] = syms if symbols else N.to_nhwc(x_hat)
        if features is not None and t in features:
            features[t] = feature
    return out


INIT = {"intra": dmci_init, "inter": dmc_init}


def reference_sequence(weights, frames, cfg, workload, keep=None,
                       features=None):
    """The reconstructions of one intra period of `frames` at the
    configuration's qp and force_zero_thres (DCVC-RT codes every P-frame
    at one qp, and the cells refresh no feature inside a period); with
    `features`, the propagated features at its positions too."""
    return encode_sequence(weights["intra"], weights["inter"], frames,
                           cfg["qp"], cfg.get("force_zero_thres"), keep,
                           dtype=N.dtype_of(cfg), features=features)


def reference_symbols(weights, frames, cfg, workload, keep=None):
    """{t: (z as int8, [(symbols, masked scales) of each y pass])} of one
    intra period (the I-frame has 4 passes, a P-frame 2)."""
    return encode_sequence(weights["intra"], weights["inter"], frames,
                           cfg["qp"], cfg.get("force_zero_thres"), keep,
                           symbols=True, dtype=N.dtype_of(cfg))


def _meta(*shape):
    return torch.zeros(shape, device="meta")


def _p_flops(w, cfg, h, wd, decode, first=False):
    """A P-frame; `first`: the first after an I-frame, whose feature
    adaptor starts from the decoded frame."""
    p, qp = w["inter"], cfg["qp"]
    if first:
        adapted = p_adapt(p, frame=_meta(1, 3, h, wd))
    else:
        adapted = p_adapt(p, feature=_meta(1, CH_D, h // 8, wd // 8))
    _, ctx_t, ctx = p_context(p, adapted, qp)
    if decode:
        zh, zw = N.downsampled_shape(h, wd, 64)
        params = p_prior(p, _meta(1, CH_Z, zh, zw), ctx_t)
        p_spatial(p, _meta(1, CH_Y, h // 16, wd // 16), params)
        p_recon(p, p_feature(p, _meta(1, CH_Y, h // 16, wd // 16), ctx, qp),
                qp)
    else:
        y, z_hat, _ = p_encode_y(p, _meta(1, 3, h, wd), ctx, qp)
        _, y_hat = p_quantize(p, y, p_prior(p, z_hat, ctx_t), None)
        p_feature(p, y_hat, ctx, qp)


def _i_flops(w, cfg, h, wd, decode):
    p, qp = w["intra"], cfg["qp"]
    if decode:
        zh, zw = N.downsampled_shape(h, wd, 64)
        i_back(p, _meta(1, N_I, h // 16, wd // 16), _meta(1, Z_I, zh, zw),
               qp, None)
    else:
        i_frame(p, _meta(1, 3, h, wd), qp, None)


# what an encoder and a decoder of each frame kind compute (counts/flops.py)
FLOP_WORK = {
    "intra": {"enc": lambda w, c, h, wd: _i_flops(w, c, h, wd, False),
              "dec": lambda w, c, h, wd: _i_flops(w, c, h, wd, True)},
    "inter": {"enc": lambda w, c, h, wd: _p_flops(w, c, h, wd, False),
              "dec": lambda w, c, h, wd: _p_flops(w, c, h, wd, True)},
    "inter_first": {
        "enc": lambda w, c, h, wd: _p_flops(w, c, h, wd, False, True),
        "dec": lambda w, c, h, wd: _p_flops(w, c, h, wd, True, True)},
}
