"""Plain reference of DCVC-FM (Li et al., CVPR 2024): the intra codec
DMCIFM and the P-frame codec DMCFM, float32, NCHW.

A frozen copy of the measured package's `models/dmci_fm.py` and
`models/dmc_fm.py` stages (and the four-part passes of
`models/prior_stages.py`), without entropy coding: the encoder's
quantization decides every symbol, so its y_hat, DPB and reconstruction
are what any decoder of its streams must give.  `reference_sequence`
codes one intra period with the FM harness's frame schedule.
"""

import torch

from . import fm_blocks as B
from . import nn as N
from .nn import conv_apply, conv_init, pin_precision  # noqa: F401

QP_NUM = 64
# DMCIFM widths (published DCVC-FM)
N_I = 256
Z_I = 128
# DMCFM widths
CH_1X, CH_2X, CH_4X, CH_8X, CH_16X = 48, 64, 96, 96, 128
CH_Z = 64
CH_MV = 64
# the FM harness's hierarchical P-frame schedule
INDEX_MAP = [0, 1, 0, 2, 0, 2, 0, 2]
QP_SHIFT = [0, 8, 4, 0]


def dmci_fm_init(gen):
    p = {}
    p["enc1"] = [B.rbs2_init(gen, 3, 128), B.dcb3_init(gen, 128, 128)]
    p["enc2"] = {"rbs1": B.rbs2_init(gen, 128, 192),
                 "dcb1": B.dcb3_init(gen, 192, 192),
                 "rbs2": B.rbs2_init(gen, 192, N_I),
                 "dcb2": B.dcb3_init(gen, N_I, N_I),
                 "down": conv_init(gen, N_I, N_I, 3)}
    p["hyper_enc"] = {"dcb": B.dcb4_init(gen, N_I, Z_I),
                      "c1": conv_init(gen, Z_I, Z_I, 3),
                      "c2": conv_init(gen, Z_I, Z_I, 3)}
    p["hyper_dec"] = [B.res_block_upsample_init(gen, Z_I, Z_I),
                      B.res_block_upsample_init(gen, Z_I, Z_I),
                      B.dcb4_init(gen, Z_I, N_I)]
    p["y_fusion"] = [B.dcb4_init(gen, N_I, N_I * 2),
                     B.dcb4_init(gen, N_I * 2, N_I * 2 + 2)]
    p["reduction"] = conv_init(gen, N_I * 2 + 2, N_I, 1)
    for k in (1, 2, 3):
        p[f"adaptor_{k}"] = B.dcb2_init(gen, N_I * 2, N_I * 2)
    p["y_spatial_prior"] = [B.dcb2_init(gen, N_I * 2, N_I * 2)
                            for _ in range(3)]
    p["dec1"] = {"dcb1": B.dcb3_init(gen, N_I, N_I),
                 "rbu1": B.res_block_upsample_init(gen, N_I, N_I),
                 "dcb2": B.dcb3_init(gen, N_I, N_I),
                 "rbu2": B.res_block_upsample_init(gen, N_I, 192),
                 "dcb3": B.dcb3_init(gen, 192, 192),
                 "rbu3": B.res_block_upsample_init(gen, 192, 128)}
    p["dec2"] = {"dcb": B.dcb3_init(gen, 128, 128),
                 "rbu": B.res_block_upsample_init(gen, 128, 16)}
    p["refine_unet"] = B.unet_init(gen, 16, 16)
    p["refine_head"] = conv_init(gen, 16, 3, 3)
    p["q_scale_enc"] = torch.ones((QP_NUM, 128), device=gen.device)
    p["q_scale_dec"] = torch.ones((QP_NUM, 128), device=gen.device)
    p["bit_estimator_z"] = N.bit_estimator_init(gen, QP_NUM, Z_I)
    return p


def dmc_fm_init(gen):
    dcb, dcb4 = B.dcb_init, B.dcb4_init
    rbu = B.res_block_upsample_init
    p = {}
    p["optic_flow"] = B.spynet_init(gen)
    p["align"] = {"off1": conv_init(gen, CH_1X + 3 + 2, CH_2X, 3),
                  "off2": conv_init(gen, CH_2X, CH_2X, 3),
                  "off3": conv_init(gen, CH_2X, 3 * 16 * 2, 3),
                  "fusion": conv_init(gen, CH_1X * 2, CH_1X, 1, groups=16)}
    p["mv_enc"] = {"enc1_rbs": B.res_block_stride_init(gen, 2, CH_MV),
                   "enc1_dcb": dcb4(gen, CH_MV, CH_MV),
                   "enc2": B.res_block_stride_init(gen, CH_MV, CH_MV),
                   "adaptor_0": dcb4(gen, CH_MV, CH_MV),
                   "adaptor_1": dcb4(gen, CH_MV * 2, CH_MV),
                   "enc3_rbs": B.res_block_stride_init(gen, CH_MV, CH_MV),
                   "enc3_dcb": dcb4(gen, CH_MV, CH_MV),
                   "enc3_down": conv_init(gen, CH_MV, CH_MV, 3)}
    p["mv_dec"] = {"dec1": [dcb4(gen, CH_MV, CH_MV), rbu(gen, CH_MV, CH_MV),
                            dcb4(gen, CH_MV, CH_MV), rbu(gen, CH_MV, CH_MV),
                            dcb4(gen, CH_MV, CH_MV)],
                   "dec2": rbu(gen, CH_MV, CH_MV),
                   "dec3_dcb": dcb4(gen, CH_MV, CH_MV),
                   "dec3_subpel": B.subpel1x1_init(gen, CH_MV, 2)}
    p["mv_hyper_enc"] = {"dcb": dcb4(gen, CH_MV, CH_MV),
                         "c1": conv_init(gen, CH_MV, CH_MV, 3),
                         "c2": conv_init(gen, CH_MV, CH_MV, 3)}
    p["mv_hyper_dec"] = [rbu(gen, CH_MV, CH_MV), rbu(gen, CH_MV, CH_MV),
                         dcb4(gen, CH_MV, CH_MV)]
    p["mv_fusion_adaptor_0"] = dcb(gen, CH_MV, CH_MV * 2)
    p["mv_fusion_adaptor_1"] = dcb(gen, CH_MV * 2, CH_MV * 2)
    p["mv_fusion"] = [dcb(gen, CH_MV * 2, CH_MV * 3),
                      dcb(gen, CH_MV * 3, CH_MV * 3)]
    for k in (1, 2, 3):
        p[f"mv_sp_adaptor_{k}"] = conv_init(gen, CH_MV * 4, CH_MV * 3, 1)
    p["mv_spatial_prior"] = [dcb(gen, CH_MV * 3, CH_MV * 3),
                             dcb(gen, CH_MV * 3, CH_MV * 3),
                             dcb(gen, CH_MV * 3, CH_MV * 2)]
    p["feature_adaptor_I"] = conv_init(gen, 3, CH_1X, 3)
    p["feature_adaptor"] = [conv_init(gen, CH_1X, CH_1X, 1)
                            for _ in range(3)]
    p["feature_extractor"] = {
        "c1": conv_init(gen, CH_1X, CH_1X, 3),
        "r1": B.res_block_init(gen, CH_1X, CH_1X),
        "c2": conv_init(gen, CH_1X, CH_2X, 3),
        "r2": B.res_block_init(gen, CH_2X, CH_2X),
        "c3": conv_init(gen, CH_2X, CH_4X, 3),
        "r3": B.res_block_init(gen, CH_4X, CH_4X)}
    p["ctx_fusion"] = {
        "c3_up": conv_init(gen, CH_4X, CH_2X * 4, 3),
        "r3_up": B.res_block_init(gen, CH_2X, CH_2X),
        "c3_out": conv_init(gen, CH_4X, CH_4X, 3),
        "r3_out": B.res_block_init(gen, CH_4X, CH_4X),
        "c2_up": conv_init(gen, CH_2X * 2, CH_1X * 4, 3),
        "r2_up": B.res_block_init(gen, CH_1X, CH_1X),
        "c2_out": conv_init(gen, CH_2X * 2, CH_2X, 3),
        "r2_out": B.res_block_init(gen, CH_2X, CH_2X),
        "c1_out": conv_init(gen, CH_1X * 2, CH_1X, 3),
        "r1_out": B.res_block_init(gen, CH_1X, CH_1X)}
    p["ctx_enc"] = {"c1": conv_init(gen, CH_1X + 3, CH_2X, 3),
                    "r1": dcb4(gen, CH_2X * 2, CH_2X * 2),
                    "c2": conv_init(gen, CH_2X * 2, CH_4X, 3),
                    "r2": dcb4(gen, CH_4X * 2, CH_4X * 2),
                    "c3": conv_init(gen, CH_4X * 2, CH_8X, 3),
                    "c4": conv_init(gen, CH_8X, CH_16X, 3)}
    p["ctx_dec"] = {"up1": conv_init(gen, CH_16X, CH_8X * 4, 3),
                    "up2": conv_init(gen, CH_8X, CH_4X * 4, 3),
                    "r1": dcb4(gen, CH_4X * 2, CH_4X * 2),
                    "up3": conv_init(gen, CH_4X * 2, CH_2X * 4, 3),
                    "r2": dcb4(gen, CH_2X * 2, CH_2X * 2),
                    "up4": conv_init(gen, CH_2X * 2, 32 * 4, 3)}
    p["recon"] = {"first": conv_init(gen, CH_1X + 32, CH_1X, 3),
                  "unet1": B.unet2_init(gen, CH_1X, CH_1X),
                  "unet2": B.unet2_init(gen, CH_1X, CH_1X),
                  "head": conv_init(gen, CH_1X, 3, 3)}
    p["hyper_enc"] = {"dcb": dcb4(gen, CH_16X, CH_Z),
                      "c1": conv_init(gen, CH_Z, CH_Z, 3),
                      "c2": conv_init(gen, CH_Z, CH_Z, 3)}
    p["hyper_dec"] = [rbu(gen, CH_Z, CH_Z), rbu(gen, CH_Z, CH_Z),
                      dcb4(gen, CH_Z, CH_16X)]
    p["temporal_prior"] = {"c1": conv_init(gen, CH_4X, CH_8X, 3),
                           "c2": conv_init(gen, CH_8X, CH_16X, 3)}
    p["y_fusion_adaptor_0"] = dcb(gen, CH_16X * 2, CH_16X * 3)
    p["y_fusion_adaptor_1"] = dcb(gen, CH_16X * 3, CH_16X * 3)
    p["y_fusion"] = [dcb(gen, CH_16X * 3, CH_16X * 3),
                     dcb(gen, CH_16X * 3, CH_16X * 3)]
    for k in (1, 2, 3):
        p[f"y_sp_adaptor_{k}"] = conv_init(gen, CH_16X * 4, CH_16X * 3, 1)
    p["y_spatial_prior"] = [dcb(gen, CH_16X * 3, CH_16X * 3),
                            dcb(gen, CH_16X * 3, CH_16X * 3),
                            dcb(gen, CH_16X * 3, CH_16X * 2)]
    for name in ("mv_y_q_enc", "mv_y_q_dec", "y_q_enc", "y_q_dec"):
        p[name] = torch.ones((2,), device=gen.device)
    p["bit_estimator_z"] = N.bit_estimator_init(gen, 1, CH_Z)
    p["bit_estimator_z_mv"] = N.bit_estimator_init(gen, 1, CH_MV)
    return p


INIT = {"intra": dmci_fm_init, "inter": dmc_fm_init}


# ---------------------------------------------------------------------------
# four-part quadtree passes (video-style chunk-3 prior and image-style)
# ---------------------------------------------------------------------------

def _pass(y_div, scales, means, so_far, k):
    y_q, y_hat_k = N.process_with_mask(y_div, scales, means,
                                       N.masks_of(y_div, 4)[k])
    return y_q, (y_hat_k if so_far is None else so_far + y_hat_k)


def quantize_4x(y, params_prior, spatial_fn):
    """The encoder's four passes of a latent under a chunk-3 prior: (the
    four symbol planes, y_hat)."""
    q_dec, scales, means = N.separate_prior_video(params_prior)
    y_div = y * (1.0 / q_dec)
    syms, so_far = [], None
    for k in range(4):
        if k > 0:
            scales, means = spatial_fn(k, so_far, params_prior)
        y_q, so_far = _pass(y_div, scales, means, so_far, k)
        syms.append(y_q)
    return syms, so_far * q_dec


# ---------------------------------------------------------------------------
# DMCIFM
# ---------------------------------------------------------------------------

def _hyper_enc(hp, y_pad):
    out = B.dcb4_apply(hp["dcb"], y_pad)
    out = B.lrelu(conv_apply(hp["c1"], out, stride=2, padding=1), 0.01)
    return conv_apply(hp["c2"], out, stride=2, padding=1)


def i_front(p, x, qp):
    q_enc = N.q_vec(p["q_scale_enc"], qp, x.dtype)
    out = B.rbs2_apply(p["enc1"][0], x)
    out = B.dcb3_apply(p["enc1"][1], out) * q_enc
    e = p["enc2"]
    out = B.dcb3_apply(e["dcb1"], B.rbs2_apply(e["rbs1"], out))
    out = B.dcb3_apply(e["dcb2"], B.rbs2_apply(e["rbs2"], out))
    y = conv_apply(e["down"], out, stride=2, padding=1)
    z = _hyper_enc(p["hyper_enc"], N.pad_for_y(y))
    z_hat, z_int8 = N.round_and_to_int8(z)
    return y, z_hat.to(x.dtype), z_int8


def i_back(p, y, z_hat, qp):
    """Prior, the four passes over y (image-style prior) and the
    reconstruction: (reconstruction NCHW, y symbols)."""
    params = B.res_block_upsample_apply(p["hyper_dec"][0], z_hat)
    params = B.res_block_upsample_apply(p["hyper_dec"][1], params)
    params = B.dcb4_apply(p["hyper_dec"][2], params)
    params = B.dcb4_apply(p["y_fusion"][0], params)
    params = B.dcb4_apply(p["y_fusion"][1], params)
    params = params[:, :, :y.shape[2], :y.shape[3]]
    q_enc, q_dec, scales, means = N.separate_prior_image(params)
    reduced = conv_apply(p["reduction"], params)
    y_s = y * q_enc
    syms, so_far = [], None
    for k in range(4):
        if k > 0:
            h = B.dcb2_apply(p[f"adaptor_{k}"],
                             torch.cat((so_far, reduced), dim=1))
            for sp in p["y_spatial_prior"]:
                h = B.dcb2_apply(sp, h)
            c = h.shape[1] // 2
            scales, means = h[:, :c], h[:, c:]
        y_q, so_far = _pass(y_s, scales, means, so_far, k)
        syms.append(y_q)
    y_hat = so_far * q_dec
    q_dec_bank = N.q_vec(p["q_scale_dec"], qp, y_hat.dtype)
    d = p["dec1"]
    out = B.dcb3_apply(d["dcb1"], y_hat)
    out = B.dcb3_apply(d["dcb2"], B.res_block_upsample_apply(d["rbu1"], out))
    out = B.dcb3_apply(d["dcb3"], B.res_block_upsample_apply(d["rbu2"], out))
    out = B.res_block_upsample_apply(d["rbu3"], out) * q_dec_bank
    out = B.dcb3_apply(p["dec2"]["dcb"], out)
    out = B.res_block_upsample_apply(p["dec2"]["rbu"], out)
    out = conv_apply(p["refine_head"], B.unet_apply(p["refine_unet"], out),
                     padding=1)
    return torch.clamp(out, 0.0, 1.0), syms


# ---------------------------------------------------------------------------
# DMCFM
# ---------------------------------------------------------------------------

def curr_q(anchors, q_index):
    log_min = torch.log(anchors[0])
    step = (torch.log(anchors[1]) - log_min) / (QP_NUM - 1)
    return torch.exp(log_min + step * q_index)


def _seq(apply_fn, plist, x):
    for bp in plist:
        x = apply_fn(bp, x)
    return x


def mv_encode(p, x, ref_frame, ref_mv_feature, q_index):
    q = curr_q(p["mv_y_q_enc"], q_index).to(x.dtype)
    est_mv = B.spynet_apply(p["optic_flow"], x, ref_frame)
    e = p["mv_enc"]
    out = B.res_block_stride_apply(e["enc1_rbs"], est_mv)
    out = B.dcb4_apply(e["enc1_dcb"], out) * q
    out = B.res_block_stride_apply(e["enc2"], out)
    if ref_mv_feature is None:
        out = B.dcb4_apply(e["adaptor_0"], out)
    else:
        out = B.dcb4_apply(e["adaptor_1"],
                           torch.cat((out, ref_mv_feature), dim=1))
    out = B.res_block_stride_apply(e["enc3_rbs"], out)
    out = B.dcb4_apply(e["enc3_dcb"], out)
    mv_y = conv_apply(e["enc3_down"], out, stride=2, padding=1)
    mv_z = _hyper_enc(p["mv_hyper_enc"], N.pad_for_y(mv_y))
    mv_z_hat, mv_z_int8 = N.round_and_to_int8(mv_z)
    return mv_y, mv_z_hat.to(x.dtype), mv_z_int8


def mv_prior(p, mv_z_hat, ref_mv_y, y_h, y_w):
    prm = _seq(B.res_block_upsample_apply, p["mv_hyper_dec"][:2], mv_z_hat)
    prm = B.dcb4_apply(p["mv_hyper_dec"][2], prm)[:, :, :y_h, :y_w]
    if ref_mv_y is None:
        prm = B.dcb_apply(p["mv_fusion_adaptor_0"], prm)
    else:
        prm = B.dcb_apply(p["mv_fusion_adaptor_1"],
                          torch.cat((prm, ref_mv_y), dim=1))
    return _seq(B.dcb_apply, p["mv_fusion"], prm)


def _spatial(adaptor_p, prior_list, so_far, common):
    h = conv_apply(adaptor_p, torch.cat((so_far, common), dim=1))
    out = _seq(B.dcb_apply, prior_list, h)
    c = out.shape[1] // 2
    return out[:, :c], out[:, c:]


def mv_spatial(p, k, so_far, common):
    return _spatial(p[f"mv_sp_adaptor_{k}"], p["mv_spatial_prior"], so_far,
                    common)


def y_spatial(p, k, so_far, common):
    return _spatial(p[f"y_sp_adaptor_{k}"], p["y_spatial_prior"], so_far,
                    common)


def mv_decode(p, mv_y_hat, q_index):
    q = curr_q(p["mv_y_q_dec"], q_index).to(mv_y_hat.dtype)
    d = p["mv_dec"]
    feat = B.dcb4_apply(d["dec1"][0], mv_y_hat)
    feat = B.res_block_upsample_apply(d["dec1"][1], feat)
    feat = B.dcb4_apply(d["dec1"][2], feat)
    feat = B.res_block_upsample_apply(d["dec1"][3], feat)
    feat = B.dcb4_apply(d["dec1"][4], feat)
    out = B.res_block_upsample_apply(d["dec2"], feat) * q
    out = B.dcb4_apply(d["dec3_dcb"], out)
    return B.subpel1x1_apply(d["dec3_subpel"], out), feat


def _offset_diversity(p, x, aux, flow, group_num=16, offset_num=2,
                      max_mag=40.0):
    a = p["align"]
    b, c, h, w = x.shape
    out = B.lrelu(conv_apply(a["off1"], aux, stride=2, padding=1), 0.1)
    out = B.lrelu(conv_apply(a["off2"], out, padding=1), 0.1)
    out = B.bilinear_resize_2x(conv_apply(a["off3"], out, padding=1), up=True)
    go = group_num * offset_num
    cg = c // group_num
    offs = max_mag * torch.tanh(out[:, :2 * go]) + flow.repeat(1, go, 1, 1)
    flows = offs.reshape(b * go, 2, h, w)
    mask = torch.sigmoid(out[:, 2 * go:]).reshape(b * go, 1, h, w)
    xg = x.reshape(b, 1, group_num, cg, h, w).expand(
        b, offset_num, group_num, cg, h, w).reshape(b * go, cg, h, w)
    warped = B.flow_warp(xg, flows) * mask
    return conv_apply(a["fusion"], warped.reshape(b, go * cg, h, w),
                      groups=group_num)


def motion_comp(p, mv_hat, ref_frame, ref_feature, fa_idx):
    """Contexts (c1, c2, c3) from the decoded flow and the references."""
    if ref_feature is None:
        feature = conv_apply(p["feature_adaptor_I"], ref_frame, padding=1)
    else:
        feature = conv_apply(p["feature_adaptor"][fa_idx], ref_feature)
    fe = p["feature_extractor"]
    f1 = B.res_block_apply(fe["r1"], conv_apply(fe["c1"], feature,
                                                padding=1))
    f2 = B.res_block_apply(fe["r2"], conv_apply(fe["c2"], f1, stride=2,
                                                padding=1))
    f3 = B.res_block_apply(fe["r3"], conv_apply(fe["c3"], f2, stride=2,
                                                padding=1))
    warpframe = B.flow_warp(ref_frame, mv_hat)
    mv2 = B.bilinear_resize_2x(mv_hat, up=False) / 2
    mv3 = B.bilinear_resize_2x(mv2, up=False) / 2
    c1_init = B.flow_warp(f1, mv_hat)
    aux = torch.cat((c1_init, warpframe, mv_hat), dim=1)
    c1 = _offset_diversity(p, f1, aux, mv_hat)
    c2 = B.flow_warp(f2, mv2)
    c3 = B.flow_warp(f3, mv3)
    f = p["ctx_fusion"]
    c3_up = F_d2s(conv_apply(f["c3_up"], c3, padding=1))
    c3_up = B.res_block_apply(f["r3_up"], c3_up)
    c3_out = B.res_block_apply(f["r3_out"],
                               conv_apply(f["c3_out"], c3, padding=1))
    cat32 = torch.cat((c3_up, c2), dim=1)
    c2_up = F_d2s(conv_apply(f["c2_up"], cat32, padding=1))
    c2_up = B.res_block_apply(f["r2_up"], c2_up)
    c2_out = B.res_block_apply(f["r2_out"],
                               conv_apply(f["c2_out"], cat32, padding=1))
    cat21 = torch.cat((c2_up, c1), dim=1)
    c1_out = B.res_block_apply(f["r1_out"],
                               conv_apply(f["c1_out"], cat21, padding=1))
    return c1 + c1_out, c2 + c2_out, c3 + c3_out


def F_d2s(x):
    return N.F.pixel_shuffle(x, 2)


def ctx_encode(p, x, c1, c2, c3, q_index):
    q = curr_q(p["y_q_enc"], q_index).to(x.dtype)
    e = p["ctx_enc"]
    feat = conv_apply(e["c1"], torch.cat((x, c1), dim=1), stride=2,
                      padding=1)
    feat = B.dcb4_apply(e["r1"], torch.cat((feat, c2), dim=1)) * q
    feat = conv_apply(e["c2"], feat, stride=2, padding=1)
    feat = B.dcb4_apply(e["r2"], torch.cat((feat, c3), dim=1))
    feat = conv_apply(e["c3"], feat, stride=2, padding=1)
    y = conv_apply(e["c4"], feat, stride=2, padding=1)
    z = _hyper_enc(p["hyper_enc"], N.pad_for_y(y))
    z_hat, z_int8 = N.round_and_to_int8(z)
    return y, z_hat.to(x.dtype), z_int8


def ctx_prior(p, z_hat, c3, ref_y, y_h, y_w):
    hier = _seq(B.res_block_upsample_apply, p["hyper_dec"][:2], z_hat)
    hier = B.dcb4_apply(p["hyper_dec"][2], hier)[:, :, :y_h, :y_w]
    tp = p["temporal_prior"]
    temporal = B.lrelu(conv_apply(tp["c1"], c3, stride=2, padding=1), 0.1)
    temporal = conv_apply(tp["c2"], temporal, stride=2, padding=1)
    if ref_y is None:
        params = B.dcb_apply(p["y_fusion_adaptor_0"],
                             torch.cat((temporal, hier), dim=1))
    else:
        params = B.dcb_apply(p["y_fusion_adaptor_1"],
                             torch.cat((temporal, hier, ref_y), dim=1))
    return _seq(B.dcb_apply, p["y_fusion"], params)


def recon(p, y_hat, c1, c2, c3, q_index):
    """(reconstruction NCHW, next ref_feature)."""
    q = curr_q(p["y_q_dec"], q_index).to(y_hat.dtype)
    d = p["ctx_dec"]
    feat = F_d2s(conv_apply(d["up1"], y_hat, padding=1))
    feat = F_d2s(conv_apply(d["up2"], feat, padding=1))
    feat = B.dcb4_apply(d["r1"], torch.cat((feat, c3), dim=1))
    feat = F_d2s(conv_apply(d["up3"], feat, padding=1)) * q
    feat = B.dcb4_apply(d["r2"], torch.cat((feat, c2), dim=1))
    res = F_d2s(conv_apply(d["up4"], feat, padding=1))
    r = p["recon"]
    feat = conv_apply(r["first"], torch.cat((res, c1), dim=1), padding=1)
    feat = B.unet2_apply(r["unet1"], feat)
    feat = B.unet2_apply(r["unet2"], feat)
    x_hat = conv_apply(r["head"], feat, padding=1)
    return torch.clamp(x_hat, 0.0, 1.0), feat


def p_frame(p, x, dpb, q_index, fa_idx):
    """One P-frame through the encoder: the next DPB (its "ref_frame" the
    reconstruction, NCHW here)."""
    ref_frame = dpb["ref_frame"]
    mv_y, mv_z_hat, _ = mv_encode(p, x, ref_frame, dpb["ref_mv_feature"],
                                  q_index)
    mv_params = mv_prior(p, mv_z_hat, dpb["ref_mv_y"], mv_y.shape[2],
                         mv_y.shape[3])
    _, mv_y_hat = quantize_4x(mv_y, mv_params,
                              lambda k, s, c: mv_spatial(p, k, s, c))
    mv_hat, mv_feature = mv_decode(p, mv_y_hat, q_index)
    c1, c2, c3 = motion_comp(p, mv_hat, ref_frame, dpb["ref_feature"],
                             fa_idx)
    y, z_hat, _ = ctx_encode(p, x, c1, c2, c3, q_index)
    params = ctx_prior(p, z_hat, c3, dpb["ref_y"], y.shape[2], y.shape[3])
    _, y_hat = quantize_4x(y, params, lambda k, s, c: y_spatial(p, k, s, c))
    x_hat, feature = recon(p, y_hat, c1, c2, c3, q_index)
    return {"ref_frame": x_hat, "ref_feature": feature,
            "ref_mv_feature": mv_feature, "ref_y": y_hat,
            "ref_mv_y": mv_y_hat}


def _reset(dpb):
    return {"ref_frame": dpb["ref_frame"], "ref_feature": None,
            "ref_mv_feature": None, "ref_y": None, "ref_mv_y": None}


def schedule(t, qp_i, qp_p, reset_interval):
    """(qp, fa_idx as coded in the SPS) of frame t of a period: the FM
    harness's hierarchical QPs and refresh (fa_idx 3: the DPB's features
    and latents dropped, coded with feature adaptor 2)."""
    if t == 0:
        return qp_i, 0
    fa_idx = INDEX_MAP[t % 8]
    if reset_interval > 0 and t % reset_interval == 1:
        fa_idx = 3
    return min(qp_p + QP_SHIFT[fa_idx], 63), fa_idx


def reference_sequence(weights, frames, cfg, workload, keep=None):
    """{t: reconstruction NHWC} of one intra period of `frames` (NHWC on
    the device) under the FM harness's schedule, one frame at a time."""
    out = {}
    x0 = N.to_nchw(frames[0])
    y, z_hat, _ = i_front(weights["intra"], x0, cfg["qp_i"])
    x_hat, _ = i_back(weights["intra"], y, z_hat, cfg["qp_i"])
    dpb = _reset({"ref_frame": x_hat})
    if keep is None or 0 in keep:
        out[0] = N.to_nhwc(x_hat)
    for t in range(1, len(frames)):
        qp, fa_idx = schedule(t, cfg["qp_i"], cfg["qp_p"],
                              cfg["reset_interval"])
        if fa_idx == 3:
            dpb = _reset(dpb)
        dpb = p_frame(weights["inter"], N.to_nchw(frames[t]), dpb, qp,
                      min(fa_idx, 2))
        if keep is None or t in keep:
            out[t] = N.to_nhwc(dpb["ref_frame"])
    return out


def _meta(*shape):
    return torch.zeros(shape, device="meta")


def _i_flops(w, cfg, h, wd, decode):
    p, qp = w["intra"], cfg["qp_i"]
    if decode:
        zh, zw = N.downsampled_shape(h, wd, 64)
        i_back(p, _meta(1, N_I, h // 16, wd // 16), _meta(1, Z_I, zh, zw), qp)
    else:
        y, z_hat, _ = i_front(p, _meta(1, 3, h, wd), qp)
        i_back(p, y, z_hat, qp)


def _p_flops(w, cfg, h, wd, decode, reset):
    """A P-frame from a full DPB, or (`reset`) from a reference frame
    alone (the first P-frame of a period and each refresh)."""
    p, qi = w["inter"], cfg["qp_p"]
    yh, yw = h // 16, wd // 16
    zh, zw = N.downsampled_shape(h, wd, 64)
    ref = _meta(1, 3, h, wd)
    dpb = {"ref_frame": ref, "ref_feature": None, "ref_mv_feature": None,
           "ref_y": None, "ref_mv_y": None} if reset else {
        "ref_frame": ref, "ref_feature": _meta(1, CH_1X, h, wd),
        "ref_mv_feature": _meta(1, CH_MV, h // 4, wd // 4),
        "ref_y": _meta(1, CH_16X, yh, yw), "ref_mv_y": _meta(1, CH_MV, yh, yw)}
    if decode:
        mv_params = mv_prior(p, _meta(1, CH_MV, zh, zw), dpb["ref_mv_y"],
                             yh, yw)
        for k in (1, 2, 3):
            mv_spatial(p, k, _meta(1, CH_MV, yh, yw), mv_params)
        mv_hat, _ = mv_decode(p, _meta(1, CH_MV, yh, yw), qi)
        c1, c2, c3 = motion_comp(p, mv_hat, ref, dpb["ref_feature"], 2)
        params = ctx_prior(p, _meta(1, CH_Z, zh, zw), c3, dpb["ref_y"], yh,
                           yw)
        for k in (1, 2, 3):
            y_spatial(p, k, _meta(1, CH_16X, yh, yw), params)
        recon(p, _meta(1, CH_16X, yh, yw), c1, c2, c3, qi)
    else:
        p_frame(p, _meta(1, 3, h, wd), dpb, qi, 2)


FLOP_WORK = {
    "intra": {"enc": lambda w, c, h, wd: _i_flops(w, c, h, wd, False),
              "dec": lambda w, c, h, wd: _i_flops(w, c, h, wd, True)},
    "inter": {"enc": lambda w, c, h, wd: _p_flops(w, c, h, wd, False, False),
              "dec": lambda w, c, h, wd: _p_flops(w, c, h, wd, True, False)},
    "inter_reset": {
        "enc": lambda w, c, h, wd: _p_flops(w, c, h, wd, False, True),
        "dec": lambda w, c, h, wd: _p_flops(w, c, h, wd, True, True)},
}
