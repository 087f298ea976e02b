"""Plain reference of DCVC-HEM (Li, Li, Lu, ACM MM 2022, Hybrid
Spatial-Temporal Entropy Modelling for Neural Video Compression): the
intra codec IntraNoAR and the P-frame codec DMCHEM, float32, NCHW.

A frozen copy of the measured package's `models/intra_no_ar.py` and
`models/dmc_hem.py` stages (and the two-part checkerboard passes of
`models/prior_stages.py`), without entropy coding: the encoder's
quantization decides every symbol, so its y_hat, DPB and reconstruction
are what any decoder of its streams must give.  `reference_sequence`
codes one intra period as HEM's `test_video.py` does: an IntraNoAR
I-frame, then DMCHEM P-frames from a DPB that starts as the I-frame's
reconstruction with no feature and no latent references.

Departures from the published DCVC-HEM code (github.com/microsoft/DCVC,
DCVC-family/DCVC-HEM), all the measured package's too:
  * no arithmetic coder: symbols are rounded (half to even) and clamped
    to the int8 range, as the codec rounds them before coding;
  * the rate of each latent is max(q_basic, 0.5) x q_scale, q_scale a
    rung of the log-spaced ladder between the extreme anchors
    (`rung`, the package's `get_interpolated_q_scales`), taken as a
    float32; IntraNoAR's rung is drawn from its own anchors the same
    way;
  * the latent references ref_y / ref_mv_y are zeros before the first
    P-frame (the published code switches to a prior without them);
  * LeakyReLU multiplies by its slope rounded to float32, and every
    convolution adds its bias after its own rounding.
"""

import numpy as np
import torch

from . import hem_blocks as B
from . import nn as N
from .nn import conv_apply, conv_init, pin_precision  # noqa: F401

# IntraNoAR width (published)
N_I = 192
# DMCHEM widths (published channel_mv, channel_N, channel_M)
CH_MV = 64
CH_N = 64
CH_M = 96
ANCHORS = 4


def intra_no_ar_init(gen):
    p = {}
    p["enc"] = B.enc_tower_init(gen, 3, N_I)
    p["dec"] = B.dec_tower_init(gen, 16, N_I)
    p["refine_unet"] = B.unet_init(gen, 16, 16)
    p["refine_head"] = conv_init(gen, 16, 3, 3)
    p["hyper_enc"] = B.hyper_enc_init(gen, N_I, N_I)
    p["hyper_dec"] = B.hyper_dec_init(gen, N_I, N_I)
    p["y_prior_fusion"] = B.stack_init(gen, [N_I * 2, N_I * 3, N_I * 3,
                                             N_I * 3])
    p["y_spatial_prior"] = B.stack_init(gen, [N_I * 4, N_I * 3, N_I * 3,
                                              N_I * 2])
    p["q_basic"] = torch.ones((N_I,), device=gen.device)
    p["q_scale"] = torch.ones((ANCHORS,), device=gen.device)
    p["bit_estimator_z"] = N.bit_estimator_init(gen, 1, N_I)
    return p


def dmc_hem_init(gen):
    rb = B.res_block_init
    p = {}
    p["optic_flow"] = B.spynet_init(gen)
    p["mv_encoder"] = B.enc_tower_init(gen, 2, CH_MV)
    p["mv_decoder"] = B.dec_tower_init(gen, 2, CH_MV)
    p["mv_hyper_enc"] = B.hyper_enc_init(gen, CH_MV, CH_N)
    p["mv_hyper_dec"] = B.hyper_dec_init(gen, CH_MV, CH_N)
    p["mv_y_prior_fusion"] = B.stack_init(gen, [CH_MV * 3] * 4)
    p["mv_y_spatial_prior"] = B.stack_init(gen, [CH_MV * 4, CH_MV * 3,
                                                 CH_MV * 3, CH_MV * 2])
    p["feature_adaptor_I"] = conv_init(gen, 3, CH_N, 3)
    p["feature_adaptor_P"] = conv_init(gen, CH_N, CH_N, 1)
    p["feature_extractor"] = {
        "c1": conv_init(gen, CH_N, CH_N, 3), "r1": rb(gen, CH_N),
        "c2": conv_init(gen, CH_N, CH_N, 3), "r2": rb(gen, CH_N),
        "c3": conv_init(gen, CH_N, CH_N, 3), "r3": rb(gen, CH_N)}
    p["ctx_fusion"] = {
        "c3_up": conv_init(gen, CH_N, CH_N * 4, 3), "r3_up": rb(gen, CH_N),
        "c3_out": conv_init(gen, CH_N, CH_N, 3), "r3_out": rb(gen, CH_N),
        "c2_up": conv_init(gen, CH_N * 2, CH_N * 4, 3),
        "r2_up": rb(gen, CH_N),
        "c2_out": conv_init(gen, CH_N * 2, CH_N, 3), "r2_out": rb(gen, CH_N),
        "c1_out": conv_init(gen, CH_N * 2, CH_N, 3), "r1_out": rb(gen, CH_N)}
    p["ctx_enc"] = {
        "c1": conv_init(gen, CH_N + 3, CH_N, 3),
        "r1": rb(gen, CH_N * 2, bottleneck=True),
        "c2": conv_init(gen, CH_N * 2, CH_N, 3),
        "r2": rb(gen, CH_N * 2, bottleneck=True),
        "c3": conv_init(gen, CH_N * 2, CH_N, 3),
        "c4": conv_init(gen, CH_N, CH_M, 3)}
    p["hyper_enc"] = B.stack_init(gen, [CH_M, CH_N, CH_N, CH_N])
    p["hyper_dec"] = B.hyper_dec_init(gen, CH_M, CH_N)
    p["temporal_prior"] = {"c1": conv_init(gen, CH_N, CH_M * 3 // 2, 3),
                           "c2": conv_init(gen, CH_M * 3 // 2, CH_M * 2, 3)}
    p["y_prior_fusion"] = B.stack_init(gen, [CH_M * 5, CH_M * 4, CH_M * 3,
                                             CH_M * 3])
    p["y_spatial_prior"] = B.stack_init(gen, [CH_M * 4, CH_M * 3, CH_M * 3,
                                              CH_M * 2])
    p["ctx_dec"] = {
        "up1": conv_init(gen, CH_M, CH_N * 4, 3),
        "up2": conv_init(gen, CH_N, CH_N * 4, 3),
        "r1": rb(gen, CH_N * 2, bottleneck=True),
        "up3": conv_init(gen, CH_N * 2, CH_N * 4, 3),
        "r2": rb(gen, CH_N * 2, bottleneck=True),
        "up4": conv_init(gen, CH_N * 2, 32 * 4, 3)}
    p["recon"] = {"first": conv_init(gen, CH_N + 32, CH_N, 3),
                  "unet1": B.unet_init(gen, CH_N, CH_N),
                  "unet2": B.unet_init(gen, CH_N, CH_N),
                  "head": conv_init(gen, CH_N, 3, 3)}
    for name, c in (("mv_y", CH_MV), ("y", CH_M)):
        p[f"{name}_q_basic"] = torch.ones((c,), device=gen.device)
        p[f"{name}_q_scale"] = torch.ones((ANCHORS,), device=gen.device)
    p["bit_estimator_z"] = N.bit_estimator_init(gen, 1, CH_N)
    p["bit_estimator_z_mv"] = N.bit_estimator_init(gen, 1, CH_N)
    return p


INIT = {"intra": intra_no_ar_init, "inter": dmc_hem_init}


# ---------------------------------------------------------------------------
# the continuous rate and the two checkerboard passes
# ---------------------------------------------------------------------------

def rung(anchors, num, index):
    """Rung `index` of the `num`-point ladder log-spaced from the largest
    anchor down to the smallest (the largest where they are equal)."""
    a = anchors.detach().cpu().numpy().reshape(-1)
    lo, hi = float(a.min()), float(a.max())
    if lo >= hi:
        return hi
    return float(np.exp(np.linspace(np.log(hi), np.log(lo), num))[index])


def rate(basic, q_scale, dtype):
    """max(basic, 0.5) x q_scale (as a float32) as (1, C, 1, 1)."""
    q = torch.clamp_min(basic, 0.5) * float(np.float32(q_scale))
    return q[None, :, None, None].to(dtype)


def rates(cfg, weights):
    """(IntraNoAR's q_scale, DMCHEM's (mv, y) q_scales) at the
    configuration's rung."""
    num, idx = cfg["rate"]["num"], cfg["rate"]["index"]
    p = weights["inter"]
    return (rung(weights["intra"]["q_scale"], num, idx),
            (rung(p["mv_y_q_scale"], num, idx),
             rung(p["y_q_scale"], num, idx)))


def prior_chunks(fused):
    c = fused.shape[1] // 3
    return (torch.clamp_min(fused[:, :c], 0.5), fused[:, c:2 * c],
            fused[:, 2 * c:])


def spatial(plist, y_hat_0, means, scales, q_step):
    """Pass 1's (scales, means) from the conv stack over pass 0's y_hat
    and the prior (its output quarters: scales, means, scales, means)."""
    out = B.stack_apply(plist, torch.cat((y_hat_0, means, scales, q_step),
                                         dim=1))
    q = out.shape[1] // 4
    return (torch.cat((out[:, :q], out[:, 2 * q:3 * q]), dim=1),
            torch.cat((out[:, q:2 * q], out[:, 3 * q:]), dim=1))


def two_passes(y, prior, plist, outer_q):
    """The encoder's two passes of a latent: (the two symbol planes,
    y_hat)."""
    q_step, scales, means = prior
    y_div = y / q_step
    masks = N.masks_of(y_div, 2)
    y_q0, y_hat_0 = N.process_with_mask(y_div, scales, means, masks[0])
    scales1, means1 = spatial(plist, y_hat_0, means, scales, q_step)
    y_q1, y_hat_1 = N.process_with_mask(y_div, scales1, means1, masks[1])
    return [y_q0, y_q1], (y_hat_0 + y_hat_1) * q_step * outer_q


# ---------------------------------------------------------------------------
# IntraNoAR
# ---------------------------------------------------------------------------

def i_prior(p, z_hat):
    params = B.hyper_dec_apply(p["hyper_dec"], z_hat)
    return prior_chunks(B.stack_apply(p["y_prior_fusion"], params))


def i_recon(p, y_hat, q):
    out = B.dec_tower_apply(p["dec"], y_hat * q)
    out = conv_apply(p["refine_head"], B.unet_apply(p["refine_unet"], out),
                     padding=1)
    return torch.clamp(out, 0.0, 1.0)


def i_frame(p, x, q_scale):
    """(reconstruction NCHW, [z, y pass 0, y pass 1] symbols)."""
    q = rate(p["q_basic"], q_scale, x.dtype)
    y = B.enc_tower_apply(p["enc"], x) / q
    z_hat, z_int8 = N.round_and_to_int8(B.hyper_enc_apply(p["hyper_enc"],
                                                           y))
    one = torch.ones((), dtype=x.dtype, device=x.device)
    syms, y_hat = two_passes(y, i_prior(p, z_hat.to(x.dtype)),
                             p["y_spatial_prior"], one)
    return i_recon(p, y_hat, q), [z_int8] + syms


# ---------------------------------------------------------------------------
# DMCHEM
# ---------------------------------------------------------------------------

def _or_zeros(ref, like, channels):
    if ref is not None:
        return ref
    return torch.zeros((1, channels) + tuple(like.shape[2:]),
                       dtype=like.dtype, device=like.device)


def mv_encode(p, x, ref_frame, mv_q):
    est_mv = B.spynet_apply(p["optic_flow"], x, ref_frame)
    mv_y = B.enc_tower_apply(p["mv_encoder"], est_mv) / mv_q
    mv_z_hat, mv_z_int8 = N.round_and_to_int8(
        B.hyper_enc_apply(p["mv_hyper_enc"], mv_y))
    return mv_y, mv_z_hat.to(x.dtype), mv_z_int8


def mv_prior(p, mv_z_hat, ref_mv_y):
    prm = B.hyper_dec_apply(p["mv_hyper_dec"], mv_z_hat)
    prm = torch.cat((prm, _or_zeros(ref_mv_y, prm, CH_MV)), dim=1)
    return prior_chunks(B.stack_apply(p["mv_y_prior_fusion"], prm))


def motion_comp(p, mv_hat, ref_frame, ref_feature):
    """The contexts (c1, c2, c3) of the reference's features warped by
    the decoded flow at full, half and quarter size, then fused."""
    if ref_feature is None:
        feature = conv_apply(p["feature_adaptor_I"], ref_frame, padding=1)
    else:
        feature = conv_apply(p["feature_adaptor_P"], ref_feature)
    fe = p["feature_extractor"]
    f1 = B.res_block_apply(fe["r1"], conv_apply(fe["c1"], feature,
                                                padding=1))
    f2 = B.res_block_apply(fe["r2"], conv_apply(fe["c2"], f1, stride=2,
                                                padding=1))
    f3 = B.res_block_apply(fe["r3"], conv_apply(fe["c3"], f2, stride=2,
                                                padding=1))
    mv2 = B.bilinear_resize_2x(mv_hat, up=False) / 2
    mv3 = B.bilinear_resize_2x(mv2, up=False) / 2
    c1 = B.flow_warp(f1, mv_hat)
    c2 = B.flow_warp(f2, mv2)
    c3 = B.flow_warp(f3, mv3)
    f = p["ctx_fusion"]
    c3_up = B.res_block_apply(f["r3_up"], B.d2s(
        conv_apply(f["c3_up"], c3, padding=1)))
    c3_out = B.res_block_apply(f["r3_out"],
                               conv_apply(f["c3_out"], c3, padding=1))
    cat32 = torch.cat((c3_up, c2), dim=1)
    c2_up = B.res_block_apply(f["r2_up"], B.d2s(
        conv_apply(f["c2_up"], cat32, padding=1)))
    c2_out = B.res_block_apply(f["r2_out"],
                               conv_apply(f["c2_out"], cat32, padding=1))
    c1_out = B.res_block_apply(
        f["r1_out"], conv_apply(f["c1_out"], torch.cat((c2_up, c1), dim=1),
                                padding=1))
    return c1 + c1_out, c2 + c2_out, c3 + c3_out


def ctx_encode(p, x, c1, c2, c3, y_q):
    e = p["ctx_enc"]
    feat = conv_apply(e["c1"], torch.cat((x, c1), dim=1), stride=2,
                      padding=1)
    feat = B.res_block_apply(e["r1"], torch.cat((feat, c2), dim=1),
                             slope=0.1, end_with_relu=True)
    feat = conv_apply(e["c2"], feat, stride=2, padding=1)
    feat = B.res_block_apply(e["r2"], torch.cat((feat, c3), dim=1),
                             slope=0.1, end_with_relu=True)
    feat = conv_apply(e["c3"], feat, stride=2, padding=1)
    y = conv_apply(e["c4"], feat, stride=2, padding=1) / y_q
    he = p["hyper_enc"]
    z = conv_apply(he[0], y, padding=1)
    z = conv_apply(he[1], B.lrelu(z, 0.01), stride=2, padding=1)
    z = conv_apply(he[2], B.lrelu(z, 0.01), stride=2, padding=1)
    z_hat, z_int8 = N.round_and_to_int8(z)
    return y, z_hat.to(x.dtype), z_int8


def ctx_prior(p, z_hat, c3, ref_y):
    hier = B.hyper_dec_apply(p["hyper_dec"], z_hat)
    tp = p["temporal_prior"]
    temporal = B.lrelu(conv_apply(tp["c1"], c3, stride=2, padding=1), 0.1)
    temporal = conv_apply(tp["c2"], temporal, stride=2, padding=1)
    params = torch.cat((temporal, hier, _or_zeros(ref_y, hier, CH_M)), dim=1)
    return prior_chunks(B.stack_apply(p["y_prior_fusion"], params))


def recon(p, y_hat, c1, c2, c3):
    """(next ref_feature, reconstruction NCHW)."""
    d = p["ctx_dec"]
    feat = B.d2s(conv_apply(d["up1"], y_hat, padding=1))
    feat = B.d2s(conv_apply(d["up2"], feat, padding=1))
    feat = B.res_block_apply(d["r1"], torch.cat((feat, c3), dim=1),
                             slope=0.1, end_with_relu=True)
    feat = B.d2s(conv_apply(d["up3"], feat, padding=1))
    feat = B.res_block_apply(d["r2"], torch.cat((feat, c2), dim=1),
                             slope=0.1, end_with_relu=True)
    res = B.d2s(conv_apply(d["up4"], feat, padding=1))
    r = p["recon"]
    feat = conv_apply(r["first"], torch.cat((res, c1), dim=1), padding=1)
    feat = B.unet_apply(r["unet2"], B.unet_apply(r["unet1"], feat))
    x_hat = conv_apply(r["head"], feat, padding=1)
    return feat, torch.clamp(x_hat, 0.0, 1.0)


def p_frame(p, x, dpb, mv_q_scale, y_q_scale):
    """One P-frame through the encoder: the next DPB ("ref_frame" the
    reconstruction, NCHW here)."""
    mv_q = rate(p["mv_y_q_basic"], mv_q_scale, x.dtype)
    y_q = rate(p["y_q_basic"], y_q_scale, x.dtype)
    ref_frame = dpb["ref_frame"]
    mv_y, mv_z_hat, _ = mv_encode(p, x, ref_frame, mv_q)
    _, mv_y_hat = two_passes(mv_y, mv_prior(p, mv_z_hat, dpb["ref_mv_y"]),
                             p["mv_y_spatial_prior"], mv_q)
    mv_hat = B.dec_tower_apply(p["mv_decoder"], mv_y_hat)
    c1, c2, c3 = motion_comp(p, mv_hat, ref_frame, dpb["ref_feature"])
    y, z_hat, _ = ctx_encode(p, x, c1, c2, c3, y_q)
    _, y_hat = two_passes(y, ctx_prior(p, z_hat, c3, dpb["ref_y"]),
                          p["y_spatial_prior"], y_q)
    feature, x_hat = recon(p, y_hat, c1, c2, c3)
    return {"ref_frame": x_hat, "ref_feature": feature, "ref_y": y_hat,
            "ref_mv_y": mv_y_hat}


def fresh_dpb(x_hat):
    """The DPB an intra period's first P-frame starts from."""
    return {"ref_frame": x_hat, "ref_feature": None, "ref_y": None,
            "ref_mv_y": None}


def reference_sequence(weights, frames, cfg, workload, keep=None):
    """{t: reconstruction NHWC} of one intra period of `frames` (NHWC on
    the device): IntraNoAR, then DMCHEM frame after frame."""
    q_i, (mv_q, y_q) = rates(cfg, weights)
    x_hat, _ = i_frame(weights["intra"], N.to_nchw(frames[0]), q_i)
    out = {0: N.to_nhwc(x_hat)} if keep is None or 0 in keep else {}
    dpb = fresh_dpb(x_hat)
    for t in range(1, len(frames)):
        dpb = p_frame(weights["inter"], N.to_nchw(frames[t]), dpb, mv_q, y_q)
        if keep is None or t in keep:
            out[t] = N.to_nhwc(dpb["ref_frame"])
    return out


# ---------------------------------------------------------------------------
# the NN work of each frame kind, on meta tensors (counts/flops.py)
# ---------------------------------------------------------------------------

def _meta(*shape):
    return torch.zeros(shape, device="meta")


def _i_flops(w, cfg, h, wd, decode):
    p = w["intra"]
    if not decode:
        i_frame(p, _meta(1, 3, h, wd), 1.0)
        return
    zh, zw = N.downsampled_shape(h, wd, 64)
    prior = i_prior(p, _meta(1, N_I, zh, zw))
    spatial(p["y_spatial_prior"], _meta(1, N_I, h // 16, wd // 16),
            prior[2], prior[1], prior[0])
    i_recon(p, _meta(1, N_I, h // 16, wd // 16), _meta(1, N_I, 1, 1))


def _p_flops(w, cfg, h, wd, decode, first):
    """A P-frame from a full DPB, or (`first`) from the I-frame's
    reconstruction alone."""
    p = w["inter"]
    yh, yw = h // 16, wd // 16
    zh, zw = N.downsampled_shape(h, wd, 64)
    ref = _meta(1, 3, h, wd)
    dpb = fresh_dpb(ref) if first else {
        "ref_frame": ref, "ref_feature": _meta(1, CH_N, h, wd),
        "ref_y": _meta(1, CH_M, yh, yw), "ref_mv_y": _meta(1, CH_MV, yh, yw)}
    if not decode:
        p_frame(p, _meta(1, 3, h, wd), dpb, 1.0, 1.0)
        return
    q_step, scales, means = mv_prior(p, _meta(1, CH_N, zh, zw),
                                     dpb["ref_mv_y"])
    spatial(p["mv_y_spatial_prior"], _meta(1, CH_MV, yh, yw), means, scales,
            q_step)
    mv_hat = B.dec_tower_apply(p["mv_decoder"], _meta(1, CH_MV, yh, yw))
    c1, c2, c3 = motion_comp(p, mv_hat, ref, dpb["ref_feature"])
    q_step, scales, means = ctx_prior(p, _meta(1, CH_N, zh, zw), c3,
                                      dpb["ref_y"])
    spatial(p["y_spatial_prior"], _meta(1, CH_M, yh, yw), means, scales,
            q_step)
    recon(p, _meta(1, CH_M, yh, yw), c1, c2, c3)


FLOP_WORK = {
    "intra": {"enc": lambda w, c, h, wd: _i_flops(w, c, h, wd, False),
              "dec": lambda w, c, h, wd: _i_flops(w, c, h, wd, True)},
    "inter": {"enc": lambda w, c, h, wd: _p_flops(w, c, h, wd, False, False),
              "dec": lambda w, c, h, wd: _p_flops(w, c, h, wd, True, False)},
    "inter_first": {
        "enc": lambda w, c, h, wd: _p_flops(w, c, h, wd, False, True),
        "dec": lambda w, c, h, wd: _p_flops(w, c, h, wd, True, True)},
}
