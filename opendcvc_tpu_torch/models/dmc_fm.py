"""DMCFM — the DCVC-FM P-frame codec (NCHW).

Counterpart of the JAX package's `models/dmc_fm.py`: explicit motion
coding (SpyNet flow -> a coded motion latent -> bilinear-warp motion
compensation refined by OffsetDiversity), multi-scale feature
propagation, the latent references ref_y / ref_mv_y fused into the
priors, four-part quadtree coding of the motion and contextual latents,
and a continuous QP in [0, 63] that log-interpolates each quant pair
between its learned (min, max).  y is coded against 256 Laplace scale
levels in [0.01, 64], both z planes against single-bank factorized priors
(support 50).

The DPB is an explicit dict: "ref_frame" the reference frame, NHWC (1, H,
W, 3) as the codecs return x_hat; "ref_feature", "ref_mv_feature",
"ref_y", "ref_mv_y" NCHW tensors, None before the first P-frame and after
a refresh.  fa_idx picks `feature_adaptor[fa_idx]`.

Entropy coding has two modes, as in the JAX package (`device_ec`, by
default OPENDCVC_TPU_DEVICE_EC):
  * host EC (the default): the encoder copies both z planes and the eight
    packed y planes to the host in one copy while the device runs the
    reconstruction; the decoder decodes both z planes on the host, then
    fetches each pass's CDF indexes and uploads its symbols.  With
    stream_part > 1 the frame's symbols split over that many coders
    (`entropy/nparts.py`);
  * device EC: kernel K1 codes the ten planes in reverse decode order (y3
    .. y0, z, mv3 .. mv0, motion z) back to back per lane in one launch
    over the frame's 384-row table (y rows 0-255, z rows 256 + channel,
    motion z rows 320 + channel: the JAX package's layout), and ten K2
    launches decode motion z, the four motion passes, z and the four y
    passes, each between the stages that need it, carrying one rANS state
    per lane.  stream_part has no effect, as in the JAX codec.  The
    container and the staging ladder are DMCIFM's.
Every stage the encoder and the decoder both evaluate is one shared
function, so the DPB chain is bit-identical on the two sides (see
models/dmc.py); the streams are the JAX package's, byte for byte, but for
the device-EC fault of the JAX package models/dmci_fm.py describes (a y
or motion-y CDF index of 255).  dtype is float32 or bfloat16, the
activations' dtype, with DMCIFM's rules (models/dmci_fm.py); the
quant anchors are log-interpolated in float32 and cast to it.
"""

import numpy as np
import torch

from ..entropy.coder import EntropyCoder
from ..entropy.device_rans import (effective_lanes, fm_rung,
                                   fm_settle_staging, full_range_cdf_rows)
from ..entropy.models import (BitEstimator, GaussianEncoder,
                              bit_estimator_init)
from ..entropy.nparts import NPartEntropyCoder
from ..layers import blocks_fm as FM
from ..layers.blocks import conv_apply, conv_init
from ..ops import fused as F
from ..ops.fused import depth_to_space
from ..ops.lane_rans import (pack_operand, prepare_decode_table,
                             prepare_encode_table)
from ..ops.warp import bilinear_resize_2x, flow_warp
from ..utils import trace
from ..utils.params import to_device
from . import common as C
from .dmc import _dec_plane, _lane_layout_t, _z_rows
from .dmci_fm import (decode_carry, dec_y_plane, fm_device_ec, gaussian_cfg,
                      hyper_enc_apply, launch_staging, y_operand)
from .prior_stages import make_pass_stages

G_CH_1X = 48
G_CH_2X = 64
G_CH_4X = 96
G_CH_8X = 96
G_CH_16X = 128
G_CH_Z = 64
CH_MV = 64
QP_NUM = 64


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def dmc_fm_init(gen):
    dcb, dcb4 = FM.dcb_init, FM.dcb4_init
    rbu = FM.res_block_upsample_init
    p = {}
    p["optic_flow"] = FM.spynet_init(gen)
    p["align"] = {
        "off1": conv_init(gen, G_CH_1X + 3 + 2, G_CH_2X, 3),
        "off2": conv_init(gen, G_CH_2X, G_CH_2X, 3),
        "off3": conv_init(gen, G_CH_2X, 3 * 16 * 2, 3),
        "fusion": conv_init(gen, G_CH_1X * 2, G_CH_1X, 1, groups=16),
    }
    p["mv_enc"] = {
        "enc1_rbs": FM.res_block_stride_init(gen, 2, CH_MV),
        "enc1_dcb": dcb4(gen, CH_MV, CH_MV),
        "enc2": FM.res_block_stride_init(gen, CH_MV, CH_MV),
        "adaptor_0": dcb4(gen, CH_MV, CH_MV),
        "adaptor_1": dcb4(gen, CH_MV * 2, CH_MV),
        "enc3_rbs": FM.res_block_stride_init(gen, CH_MV, CH_MV),
        "enc3_dcb": dcb4(gen, CH_MV, CH_MV),
        "enc3_down": conv_init(gen, CH_MV, CH_MV, 3),
    }
    p["mv_dec"] = {
        "dec1": [dcb4(gen, CH_MV, CH_MV), rbu(gen, CH_MV, CH_MV),
                 dcb4(gen, CH_MV, CH_MV), rbu(gen, CH_MV, CH_MV),
                 dcb4(gen, CH_MV, CH_MV)],
        "dec2": rbu(gen, CH_MV, CH_MV),
        "dec3_dcb": dcb4(gen, CH_MV, CH_MV),
        "dec3_subpel": FM.subpel1x1_init(gen, CH_MV, 2),
    }
    p["mv_hyper_enc"] = {
        "dcb": dcb4(gen, CH_MV, CH_MV),
        "c1": conv_init(gen, CH_MV, CH_MV, 3),
        "c2": conv_init(gen, CH_MV, CH_MV, 3),
    }
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

    p["feature_adaptor_I"] = conv_init(gen, 3, G_CH_1X, 3)
    p["feature_adaptor"] = [conv_init(gen, G_CH_1X, G_CH_1X, 1)
                            for _ in range(3)]
    p["feature_extractor"] = {
        "c1": conv_init(gen, G_CH_1X, G_CH_1X, 3),
        "r1": FM.res_block_init(gen, G_CH_1X, G_CH_1X),
        "c2": conv_init(gen, G_CH_1X, G_CH_2X, 3),
        "r2": FM.res_block_init(gen, G_CH_2X, G_CH_2X),
        "c3": conv_init(gen, G_CH_2X, G_CH_4X, 3),
        "r3": FM.res_block_init(gen, G_CH_4X, G_CH_4X),
    }
    p["ctx_fusion"] = {
        "c3_up": conv_init(gen, G_CH_4X, G_CH_2X * 4, 3),
        "r3_up": FM.res_block_init(gen, G_CH_2X, G_CH_2X),
        "c3_out": conv_init(gen, G_CH_4X, G_CH_4X, 3),
        "r3_out": FM.res_block_init(gen, G_CH_4X, G_CH_4X),
        "c2_up": conv_init(gen, G_CH_2X * 2, G_CH_1X * 4, 3),
        "r2_up": FM.res_block_init(gen, G_CH_1X, G_CH_1X),
        "c2_out": conv_init(gen, G_CH_2X * 2, G_CH_2X, 3),
        "r2_out": FM.res_block_init(gen, G_CH_2X, G_CH_2X),
        "c1_out": conv_init(gen, G_CH_1X * 2, G_CH_1X, 3),
        "r1_out": FM.res_block_init(gen, G_CH_1X, G_CH_1X),
    }
    p["ctx_enc"] = {
        "c1": conv_init(gen, G_CH_1X + 3, G_CH_2X, 3),
        "r1": dcb4(gen, G_CH_2X * 2, G_CH_2X * 2),
        "c2": conv_init(gen, G_CH_2X * 2, G_CH_4X, 3),
        "r2": dcb4(gen, G_CH_4X * 2, G_CH_4X * 2),
        "c3": conv_init(gen, G_CH_4X * 2, G_CH_8X, 3),
        "c4": conv_init(gen, G_CH_8X, G_CH_16X, 3),
    }
    p["ctx_dec"] = {
        "up1": conv_init(gen, G_CH_16X, G_CH_8X * 4, 3),
        "up2": conv_init(gen, G_CH_8X, G_CH_4X * 4, 3),
        "r1": dcb4(gen, G_CH_4X * 2, G_CH_4X * 2),
        "up3": conv_init(gen, G_CH_4X * 2, G_CH_2X * 4, 3),
        "r2": dcb4(gen, G_CH_2X * 2, G_CH_2X * 2),
        "up4": conv_init(gen, G_CH_2X * 2, 32 * 4, 3),
    }
    p["recon"] = {
        "first": conv_init(gen, G_CH_1X + 32, G_CH_1X, 3),
        "unet1": FM.unet2_init(gen, G_CH_1X, G_CH_1X),
        "unet2": FM.unet2_init(gen, G_CH_1X, G_CH_1X),
        "head": conv_init(gen, G_CH_1X, 3, 3),
    }
    p["hyper_enc"] = {
        "dcb": dcb4(gen, G_CH_16X, G_CH_Z),
        "c1": conv_init(gen, G_CH_Z, G_CH_Z, 3),
        "c2": conv_init(gen, G_CH_Z, G_CH_Z, 3),
    }
    p["hyper_dec"] = [rbu(gen, G_CH_Z, G_CH_Z), rbu(gen, G_CH_Z, G_CH_Z),
                      dcb4(gen, G_CH_Z, G_CH_16X)]
    p["temporal_prior"] = {
        "c1": conv_init(gen, G_CH_4X, G_CH_8X, 3),
        "c2": conv_init(gen, G_CH_8X, G_CH_16X, 3),
    }
    p["y_fusion_adaptor_0"] = dcb(gen, G_CH_16X * 2, G_CH_16X * 3)
    p["y_fusion_adaptor_1"] = dcb(gen, G_CH_16X * 3, G_CH_16X * 3)
    p["y_fusion"] = [dcb(gen, G_CH_16X * 3, G_CH_16X * 3),
                     dcb(gen, G_CH_16X * 3, G_CH_16X * 3)]
    for k in (1, 2, 3):
        p[f"y_sp_adaptor_{k}"] = conv_init(gen, G_CH_16X * 4,
                                           G_CH_16X * 3, 1)
    p["y_spatial_prior"] = [dcb(gen, G_CH_16X * 3, G_CH_16X * 3),
                            dcb(gen, G_CH_16X * 3, G_CH_16X * 3),
                            dcb(gen, G_CH_16X * 3, G_CH_16X * 2)]

    # (min, max) quant anchors, log-interpolated over the 64 QPs
    for name in ("mv_y_q_enc", "mv_y_q_dec", "y_q_enc", "y_q_dec"):
        p[name] = torch.ones((2,))
    p["bit_estimator_z"] = bit_estimator_init(gen, 1, G_CH_Z)
    p["bit_estimator_z_mv"] = bit_estimator_init(gen, 1, CH_MV)
    return p


# ---------------------------------------------------------------------------
# sub-networks
# ---------------------------------------------------------------------------

def get_curr_q(anchors, q_index, qp_num=QP_NUM):
    """Log-interpolate between the learned (min, max) anchors, in the
    anchors' float32: a 0-dim tensor."""
    log_min = torch.log(anchors[0])
    step = (torch.log(anchors[1]) - log_min) / (qp_num - 1)
    return torch.exp(log_min + step * q_index)


def _seq(apply_fn, plist, x):
    for bp in plist:
        x = apply_fn(bp, x)
    return x


def mv_encoder(p, est_mv, ref_mv_feature, q):
    e = p["mv_enc"]
    out = FM.res_block_stride_apply(e["enc1_rbs"], est_mv)
    out = FM.dcb4_apply(e["enc1_dcb"], out) * q
    out = FM.res_block_stride_apply(e["enc2"], out)
    if ref_mv_feature is None:
        out = FM.dcb4_apply(e["adaptor_0"], out)
    else:
        out = FM.dcb4_apply(e["adaptor_1"],
                            torch.cat((out, ref_mv_feature), dim=1))
    out = FM.res_block_stride_apply(e["enc3_rbs"], out)
    out = FM.dcb4_apply(e["enc3_dcb"], out)
    return conv_apply(e["enc3_down"], out, stride=2, padding=1)


def mv_decoder(p, mv_y_hat, q):
    d = p["mv_dec"]
    feat = FM.dcb4_apply(d["dec1"][0], mv_y_hat)
    feat = FM.res_block_upsample_apply(d["dec1"][1], feat)
    feat = FM.dcb4_apply(d["dec1"][2], feat)
    feat = FM.res_block_upsample_apply(d["dec1"][3], feat)
    feat = FM.dcb4_apply(d["dec1"][4], feat)
    out = FM.res_block_upsample_apply(d["dec2"], feat) * q
    out = FM.dcb4_apply(d["dec3_dcb"], out)
    return FM.subpel1x1_apply(d["dec3_subpel"], out), feat


def feature_extractor(p, feature):
    fe = p["feature_extractor"]
    l1 = FM.res_block_apply(fe["r1"], conv_apply(fe["c1"], feature,
                                                 padding=1))
    l2 = FM.res_block_apply(fe["r2"], conv_apply(fe["c2"], l1, stride=2,
                                                 padding=1))
    l3 = FM.res_block_apply(fe["r3"], conv_apply(fe["c3"], l2, stride=2,
                                                 padding=1))
    return l1, l2, l3


def context_fusion(p, c1, c2, c3):
    f = p["ctx_fusion"]
    c3_up = depth_to_space(conv_apply(f["c3_up"], c3, padding=1), 2)
    c3_up = FM.res_block_apply(f["r3_up"], c3_up)
    c3_out = FM.res_block_apply(f["r3_out"],
                                conv_apply(f["c3_out"], c3, padding=1))
    cat32 = torch.cat((c3_up, c2), dim=1)
    c2_up = depth_to_space(conv_apply(f["c2_up"], cat32, padding=1), 2)
    c2_up = FM.res_block_apply(f["r2_up"], c2_up)
    c2_out = FM.res_block_apply(f["r2_out"],
                                conv_apply(f["c2_out"], cat32, padding=1))
    cat21 = torch.cat((c2_up, c1), dim=1)
    c1_out = FM.res_block_apply(f["r1_out"],
                                conv_apply(f["c1_out"], cat21, padding=1))
    return c1 + c1_out, c2 + c2_out, c3 + c3_out


def offset_diversity(p, x, aux, flow, group_num=16, offset_num=2,
                     max_mag=40.0):
    """Group-wise multi-offset warping with masks.  Units are ordered u =
    o * G + g (offset o of channel group g); unit u's (dx, dy) are
    channels (2u, 2u + 1) of the offset head (read pairwise), its mask
    channel 2 G O + u.  The warped units concatenate in (o, g, cg)
    channel order for the grouped fusion conv."""
    a = p["align"]
    b, c, h, w = x.shape
    out = FM.lrelu(conv_apply(a["off1"], aux, stride=2, padding=1), 0.1)
    out = FM.lrelu(conv_apply(a["off2"], out, padding=1), 0.1)
    out = bilinear_resize_2x(conv_apply(a["off3"], out, padding=1), up=True)
    go = group_num * offset_num
    cg = c // group_num
    offs = max_mag * torch.tanh(out[:, :2 * go]) + flow.repeat(1, go, 1, 1)
    flows = offs.reshape(b * go, 2, h, w)
    mask = torch.sigmoid(out[:, 2 * go:]).reshape(b * go, 1, h, w)
    xg = x.reshape(b, 1, group_num, cg, h, w).expand(
        b, offset_num, group_num, cg, h, w).reshape(b * go, cg, h, w)
    warped = flow_warp(xg, flows) * mask
    return conv_apply(a["fusion"], warped.reshape(b, go * cg, h, w),
                      groups=group_num)


def contextual_encoder(p, x, c1, c2, c3, q):
    e = p["ctx_enc"]
    feat = conv_apply(e["c1"], torch.cat((x, c1), dim=1), stride=2,
                      padding=1)
    feat = FM.dcb4_apply(e["r1"], torch.cat((feat, c2), dim=1)) * q
    feat = conv_apply(e["c2"], feat, stride=2, padding=1)
    feat = FM.dcb4_apply(e["r2"], torch.cat((feat, c3), dim=1))
    feat = conv_apply(e["c3"], feat, stride=2, padding=1)
    return conv_apply(e["c4"], feat, stride=2, padding=1)


def contextual_decoder(p, y_hat, c2, c3, q):
    d = p["ctx_dec"]
    feat = depth_to_space(conv_apply(d["up1"], y_hat, padding=1), 2)
    feat = depth_to_space(conv_apply(d["up2"], feat, padding=1), 2)
    feat = FM.dcb4_apply(d["r1"], torch.cat((feat, c3), dim=1))
    feat = depth_to_space(conv_apply(d["up3"], feat, padding=1), 2) * q
    feat = FM.dcb4_apply(d["r2"], torch.cat((feat, c2), dim=1))
    return depth_to_space(conv_apply(d["up4"], feat, padding=1), 2)


def recon_generation(p, res, c1):
    """The decoded residual feature is the first operand of the
    concatenation, as in the reference."""
    r = p["recon"]
    feat = conv_apply(r["first"], torch.cat((res, c1), dim=1), padding=1)
    feat = FM.unet2_apply(r["unet1"], feat)
    feat = FM.unet2_apply(r["unet2"], feat)
    x_hat = conv_apply(r["head"], feat, padding=1)
    return feat, torch.clamp(x_hat, 0.0, 1.0)


def _spatial_pass(adaptor_p, prior_list, y_hat_so_far, common_params):
    h = conv_apply(adaptor_p, torch.cat((y_hat_so_far, common_params),
                                        dim=1))
    out = _seq(FM.dcb_apply, prior_list, h)
    c = out.shape[1] // 2
    return out[:, :c], out[:, c:]


# ---------------------------------------------------------------------------
# stages (shared = evaluated by both encoder and decoder)
# ---------------------------------------------------------------------------

@trace.spanned("nn.mv_enc")
def _stage_mv_enc(p, x, ref_frame, ref_mv_feature, q_index):
    """Encoder-only: flow -> motion latent, rounded motion z."""
    q = get_curr_q(p["mv_y_q_enc"], q_index).to(x.dtype)
    est_mv = FM.spynet_apply(p["optic_flow"], x, ref_frame)
    mv_y = mv_encoder(p, est_mv, ref_mv_feature, q)
    mv_z = hyper_enc_apply(p["mv_hyper_enc"], C.pad_for_y(mv_y))
    mv_z_hat, mv_z_int8 = F.round_and_to_int8(mv_z)
    return mv_y, mv_z_hat.to(x.dtype), mv_z_int8


@trace.spanned("nn.mv_prior")
def _stage_mv_prior(p, mv_z_hat, ref_mv_y, y_h, y_w):
    """Shared: motion z (+ ref_mv_y) -> the motion latent's chunk-3
    prior."""
    mv_params = _seq(FM.res_block_upsample_apply, p["mv_hyper_dec"][:2],
                     mv_z_hat)
    mv_params = FM.dcb4_apply(p["mv_hyper_dec"][2], mv_params)
    mv_params = mv_params[:, :, :y_h, :y_w]
    if ref_mv_y is None:
        mv_params = FM.dcb_apply(p["mv_fusion_adaptor_0"], mv_params)
    else:
        mv_params = FM.dcb_apply(p["mv_fusion_adaptor_1"],
                                 torch.cat((mv_params, ref_mv_y), dim=1))
    return _seq(FM.dcb_apply, p["mv_fusion"], mv_params)


@trace.spanned("nn.mv_dec")
def _stage_mv_dec(p, mv_y_hat, q_index):
    """Shared: motion latent -> (flow, next ref_mv_feature)."""
    q = get_curr_q(p["mv_y_q_dec"], q_index).to(mv_y_hat.dtype)
    return mv_decoder(p, mv_y_hat, q)


@trace.spanned("nn.motion_comp")
def _stage_motion_comp(p, mv_hat, ref_frame, ref_feature, fa_idx):
    """Shared: flow + references -> contexts (c1, c2, c3) and the warped
    frame."""
    if ref_feature is None:
        feature = conv_apply(p["feature_adaptor_I"], ref_frame, padding=1)
    else:
        feature = conv_apply(p["feature_adaptor"][fa_idx], ref_feature)
    f1, f2, f3 = feature_extractor(p, feature)
    warpframe = flow_warp(ref_frame, mv_hat)
    mv2 = bilinear_resize_2x(mv_hat, up=False) / 2
    mv3 = bilinear_resize_2x(mv2, up=False) / 2
    c1_init = flow_warp(f1, mv_hat)
    aux = torch.cat((c1_init, warpframe, mv_hat), dim=1)
    c1 = offset_diversity(p, f1, aux, mv_hat)
    c2 = flow_warp(f2, mv2)
    c3 = flow_warp(f3, mv3)
    c1, c2, c3 = context_fusion(p, c1, c2, c3)
    return c1, c2, c3, warpframe


@trace.spanned("nn.ctx_enc")
def _stage_ctx_enc(p, x, c1, c2, c3, q_index):
    """Encoder-only: frame + contexts -> y, rounded z."""
    q = get_curr_q(p["y_q_enc"], q_index).to(x.dtype)
    y = contextual_encoder(p, x, c1, c2, c3, q)
    z = hyper_enc_apply(p["hyper_enc"], C.pad_for_y(y))
    z_hat, z_int8 = F.round_and_to_int8(z)
    return y, z_hat.to(x.dtype), z_int8


@trace.spanned("nn.ctx_prior")
def _stage_ctx_prior(p, z_hat, c3, ref_y, y_h, y_w):
    """Shared: z (+ temporal context, ref_y) -> y's chunk-3 prior."""
    hier = _seq(FM.res_block_upsample_apply, p["hyper_dec"][:2], z_hat)
    hier = FM.dcb4_apply(p["hyper_dec"][2], hier)[:, :, :y_h, :y_w]
    tp = p["temporal_prior"]
    temporal = FM.lrelu(conv_apply(tp["c1"], c3, stride=2, padding=1), 0.1)
    temporal = conv_apply(tp["c2"], temporal, stride=2, padding=1)
    if ref_y is None:
        params = FM.dcb_apply(p["y_fusion_adaptor_0"],
                              torch.cat((temporal, hier), dim=1))
    else:
        params = FM.dcb_apply(p["y_fusion_adaptor_1"],
                              torch.cat((temporal, hier, ref_y), dim=1))
    return _seq(FM.dcb_apply, p["y_fusion"], params)


@trace.spanned("nn.recon")
def _stage_recon(p, y_hat, c1, c2, c3, q_index):
    """Shared: y_hat + contexts -> (x_hat, next ref_feature)."""
    q = get_curr_q(p["y_q_dec"], q_index).to(y_hat.dtype)
    res = contextual_decoder(p, y_hat, c2, c3, q)
    feature, x_hat = recon_generation(p, res, c1)
    return x_hat, feature


@trace.spanned("nn.mv_spatial")
def _stage_mv_spatial(p, k, y_hat_so_far, common_params):
    return _spatial_pass(p[f"mv_sp_adaptor_{k}"], p["mv_spatial_prior"],
                         y_hat_so_far, common_params)


@trace.spanned("nn.y_spatial")
def _stage_y_spatial(p, k, y_hat_so_far, common_params):
    return _spatial_pass(p[f"y_sp_adaptor_{k}"], p["y_spatial_prior"],
                         y_hat_so_far, common_params)


# ---------------------------------------------------------------------------
# the four-part prior passes and host-EC z planes (DMCFM's and DMCDC's)
# ---------------------------------------------------------------------------

def compress_4x(stages, y, params_prior, spatial_fn):
    """The four passes of a latent on the encoder: (the four packed
    planes, y_hat); `stages` a make_pass_stages(cfg, 4) dict,
    `spatial_fn(k, so_far, params_prior)` pass k's (scales, means)."""
    y_div, packed0, so_far = stages["enc_pass0_video"](y, params_prior)
    packed = [packed0]
    for k in range(1, 4):
        scales, means = spatial_fn(k, so_far, params_prior)
        pk, so_far = stages["enc_pass_k"](y_div, scales, means, so_far, k)
        packed.append(pk)
    return packed, stages["finalize_video"](so_far, params_prior)


def decompress_4x(stages, params_prior, spatial_fn, decode):
    """The four passes of a latent on the decoder, `decode(idx)` giving
    each pass's symbols from its CDF indexes: y_hat."""
    so_far = stages["dec_restore0_video"](
        decode(stages["dec_index0_video"](params_prior)), params_prior)
    for k in range(1, 4):
        scales, means = spatial_fn(k, so_far, params_prior)
        so_far = stages["dec_restore_acc"](
            decode(stages["dec_index_k"](scales, k)), means, so_far, k)
    return stages["finalize_video"](so_far, params_prior)


def host_planes(coder, z_estimators, gaussian, bit_stream, zh, zw, device,
                dtype, transfers):
    """Host EC: the z planes decoded on the host at once (they lead the
    stream), `z_estimators` [(name, BitEstimator)] in stream order;
    (z_plane(name), decode(idx), done()), decode host-decoding a y pass
    with `gaussian`, done checking that the stream ends with the frame's
    last symbol.  Planes land on `device` as `dtype`; the copies are
    counted in `transfers`."""
    coder.set_stream(bit_stream)
    z = {}
    for name, be in z_estimators:
        z[name] = C.decode_z_host(be, 0, zh, zw, device, dtype, transfers)

    def decode(idx):
        return C.decode_y_host(gaussian, C.fetch_async(C.index_buf(idx)),
                               idx.shape, device, dtype, transfers)

    return z.__getitem__, decode, coder.check_stream_end


# ---------------------------------------------------------------------------
# host orchestrator
# ---------------------------------------------------------------------------

class DMCFM:
    """DCVC-FM P-frame codec.

    compress / decompress exchange explicit DPB dicts (see the module
    docstring).  device: torch device (default cuda; without CUDA that
    raises).  device_ec and its settings: as DMCIFM's.
    stream_part > 1 splits each host-EC frame's stream over that many
    coders (`NPartEntropyCoder`), each on a worker thread of its own with
    ec_thread (as the JAX package's DMCFM(ec_thread=); threading changes
    no byte).  dtype: float32 or bfloat16 activations.  `transfers`
    counts the host-EC copies: "d2h" the fetches the host waits for,
    "h2d" the uploads; `ec_reruns` the device-EC frames' ladder reruns
    (one K1 launch each)."""

    def __init__(self, device="cuda", device_ec=None, dtype=torch.float32,
                 stream_part=1, ec_thread=False):
        C.check_dtype(dtype, "DMCFM")
        self.device = C.resolve_device(device)
        self.device_ec = fm_device_ec(device_ec)
        self.dtype = dtype
        self.stream_part = stream_part
        self.ec_thread = ec_thread
        self.lanes = C.ec_setting(None, "OPENDCVC_TPU_EC_LANES", 4096)
        self.bytes_per_symbol = C.ec_setting(None, "OPENDCVC_TPU_EC_BPS", 0.5)
        self.params = None
        self.entropy_coder = None
        self.bit_estimator_z = BitEstimator(1, G_CH_Z, support=50)
        self.bit_estimator_z_mv = BitEstimator(1, CH_MV, support=50)
        self.gaussian_encoder = GaussianEncoder(
            distribution="laplace", scale_min=0.01, scale_max=64.0,
            scale_levels=256, support=50)
        self.transfers = {"d2h": 0, "h2d": 0}
        self.ec_reruns = 0
        # the encode copy's window for each staging capacity
        self._fetch_windows = {}
        self.enc_table = None
        self.dec_tables = None
        self._stages = make_pass_stages(gaussian_cfg(self.gaussian_encoder),
                                        4)

    def init_params(self, seed=0):
        """The port's random init; the anchors are set apart ([0.5, 2.0])
        so the log-interpolation is well defined, as the JAX package's
        init_params sets them."""
        gen = torch.Generator().manual_seed(seed)
        p = dmc_fm_init(gen)
        for name in ("mv_y_q_enc", "mv_y_q_dec", "y_q_enc", "y_q_dec"):
            p[name] = torch.tensor([0.5, 2.0])
        self.params = to_device(p, self.device)
        return self.params

    def load_params(self, params):
        self.params = to_device(params, self.device)

    def update(self):
        """Build the CDF tables: the Laplace scale rows, z's rows, the
        motion z's.  Host EC: register them with a new host coder (or
        N-part coder), groups 0, 1 and 2.  Device EC: K1 reads the
        prepared 384-row table `enc_table`; K2 reads `dec_tables`: "y"
        the 256 y rows, "z" and "mv_z" the y table's row 0 followed by the
        plane's 64 rows (a lane's pad slot codes symbol 0 on row 0 of the
        whole table, as the JAX package's lane layout pads it)."""
        if not self.device_ec:
            if self.stream_part > 1:
                self.entropy_coder = NPartEntropyCoder(
                    self.stream_part, threaded=self.ec_thread or None)
            else:
                self.entropy_coder = EntropyCoder()
            self.gaussian_encoder.update(self.entropy_coder)
            self.bit_estimator_z.update(self.params["bit_estimator_z"],
                                        self.entropy_coder)
            self.bit_estimator_z_mv.update(self.params["bit_estimator_z_mv"],
                                           self.entropy_coder)
            return
        y_rows = full_range_cdf_rows(*self.gaussian_encoder.update())
        rows = [y_rows] + [full_range_cdf_rows(*be.update(self.params[name]))
                           for be, name in (
                               (self.bit_estimator_z, "bit_estimator_z"),
                               (self.bit_estimator_z_mv,
                                "bit_estimator_z_mv"))]
        table = torch.from_numpy(np.concatenate(rows)).to(self.device)
        self.enc_table = prepare_encode_table(table)
        dec = prepare_decode_table(table)
        n_y = y_rows.shape[0]
        self.dec_tables = {
            "y": dec[:n_y],
            "z": torch.cat([dec[:1], dec[n_y:n_y + G_CH_Z]]),
            "mv_z": torch.cat([dec[:1], dec[n_y + G_CH_Z:]])}

    def set_use_two_entropy_coders(self, b):
        """Split each plane between two host coders (the JAX package's
        DMCFM.set_use_two_entropy_coders; an N-part coder refuses it).
        As there, it needs update() first, and has no effect with device
        EC."""
        if self.entropy_coder is None and self.enc_table is None:
            raise RuntimeError(
                "DMCFM.set_use_two_entropy_coders: call update() first")
        if not self.device_ec:
            self.entropy_coder.set_use_two_entropy_coders(b)

    def _ref_frame(self, dpb):
        return C.frame_to_nchw(dpb["ref_frame"], self.device, self.dtype)

    def _mw_cap_for(self, H, W):
        """(lanes, steps a lane) of a frame, as the JAX package's
        DMCFM._mw_cap_for: the lane count scaled to the ten planes'
        symbols, k_total the sum of each plane's ceil(n / L)."""
        n_y = (H // 16) * (W // 16) * G_CH_16X // 4
        n_mv = (H // 16) * (W // 16) * CH_MV // 4
        zh, zw = C.get_downsampled_shape(H, W, 64)
        n_z, n_mvz = zh * zw * G_CH_Z, zh * zw * CH_MV
        lanes = effective_lanes(self.lanes,
                                4 * n_y + 4 * n_mv + n_z + n_mvz)
        k_total = (4 * (-(-n_y // lanes)) + 4 * (-(-n_mv // lanes))
                   + (-(-n_z // lanes)) + (-(-n_mvz // lanes)))
        return lanes, k_total

    # -- compress / decompress -----------------------------------------------

    @trace.spanned("dmc_fm.compress", 1)
    def compress(self, x, dpb, q_index, fa_idx):
        """x: (1, H, W, 3) NHWC in [0, 1], H and W multiples of 16; dpb the
        DPB dict; fa_idx in {0, 1, 2}.  Returns {"dpb": the next DPB,
        "bit_stream": bytes}."""
        p, qi = self.params, int(q_index)
        x = C.frame_to_nchw(x, self.device, self.dtype)
        ref_frame = self._ref_frame(dpb)
        mv_y, mv_z_hat, mv_z_int8 = _stage_mv_enc(
            p, x, ref_frame, dpb["ref_mv_feature"], qi)
        mv_params = _stage_mv_prior(p, mv_z_hat, dpb["ref_mv_y"],
                                    mv_y.shape[2], mv_y.shape[3])
        mv_packed, mv_y_hat = compress_4x(
            self._stages, mv_y, mv_params,
            lambda k, so_far, prm: _stage_mv_spatial(p, k, so_far, prm))
        mv_hat, mv_feature = _stage_mv_dec(p, mv_y_hat, qi)
        c1, c2, c3, _ = _stage_motion_comp(p, mv_hat, ref_frame,
                                           dpb["ref_feature"], fa_idx)
        y, z_hat, z_int8 = _stage_ctx_enc(p, x, c1, c2, c3, qi)
        params = _stage_ctx_prior(p, z_hat, c3, dpb["ref_y"], y.shape[2],
                                  y.shape[3])
        y_packed, y_hat = compress_4x(
            self._stages, y, params,
            lambda k, so_far, prm: _stage_y_spatial(p, k, so_far, prm))
        if self.device_ec:
            finish = self._launch_device(x, mv_z_int8, z_int8, mv_packed,
                                         y_packed)
        else:
            fetch = C.fetch_async(C.pack_host([mv_z_int8, z_int8],
                                              mv_packed + y_packed))
        # the device reconstructs while the host codes
        x_hat, feature = _stage_recon(p, y_hat, c1, c2, c3, qi)
        x_hat = C.frame_to_nhwc(x_hat)

        if self.device_ec:
            stream = finish()
        else:
            buf = fetch()
            self.transfers["d2h"] += 1
            stream = C.code_host(
                self.entropy_coder,
                [(self.bit_estimator_z_mv, 0), (self.bit_estimator_z, 0)],
                self.gaussian_encoder, buf,
                [mv_z_int8.numel(), z_int8.numel()],
                [pk.numel() for pk in mv_packed + y_packed])
        return {
            "dpb": {"ref_frame": x_hat, "ref_feature": feature,
                    "ref_mv_feature": mv_feature, "ref_y": y_hat,
                    "ref_mv_y": mv_y_hat},
            "bit_stream": stream,
        }

    def _launch_device(self, x, mv_z_int8, z_int8, mv_packed, y_packed):
        """Device EC: queue the frame's one K1 launch over the ten planes
        in reverse decode order and its staging's copy; returns the
        callable that serializes the stream (the FM staging ladder)."""
        lanes, k_total = self._mw_cap_for(x.shape[2], x.shape[3])
        n_y = self.dec_tables["y"].shape[0]

        def z_operand(z_int8, base):
            z_sym = z_int8.reshape(-1).to(torch.int32)
            rows = _z_rows(z_sym.numel(), z_int8.shape[1], z_sym.device)
            return pack_operand(_lane_layout_t(z_sym, lanes, True),
                                _lane_layout_t(rows + base, lanes, True))

        operand = torch.cat(
            [y_operand(pk, lanes) for pk in y_packed[::-1]]
            + [z_operand(z_int8, n_y)]
            + [y_operand(pk, lanes) for pk in mv_packed[::-1]]
            + [z_operand(mv_z_int8, n_y + G_CH_Z)])
        bps = self.bytes_per_symbol
        mw, cap = fm_rung(lanes, k_total, bps)
        first = launch_staging(operand, self.enc_table, mw, cap,
                               self._fetch_windows, lanes)

        def finish():
            stream, reruns = fm_settle_staging(
                first(), lanes, k_total, bps,
                lambda mw, cap: launch_staging(operand, self.enc_table, mw,
                                               cap)())
            self.ec_reruns += reruns
            if reruns:
                trace.count("ec.rerun", reruns)
            return stream

        return finish

    @trace.spanned("dmc_fm.decompress", 1)
    def decompress(self, bit_stream, dpb, sps):
        """sps: {"height", "width", "qp", "fa_idx" in {0, 1, 2}}.  Returns
        {"dpb": the next DPB}; its "ref_frame" is the decoded frame.  A
        host-EC stream that is not exactly the frame's symbols raises
        ValueError."""
        p, qi = self.params, int(sps["qp"])
        zh, zw = C.get_downsampled_shape(sps["height"], sps["width"], 64)
        y_h, y_w = C.get_downsampled_shape(sps["height"], sps["width"], 16)
        if self.device_ec:
            z_plane, decode, done = self._device_planes(bit_stream, zh, zw)
        else:
            z_plane, decode, done = host_planes(
                self.entropy_coder,
                [("mv_z", self.bit_estimator_z_mv),
                 ("z", self.bit_estimator_z)],
                self.gaussian_encoder, bit_stream, zh, zw, self.device,
                self.dtype, self.transfers)
        ref_frame = self._ref_frame(dpb)

        mv_params = _stage_mv_prior(p, z_plane("mv_z"), dpb["ref_mv_y"],
                                    y_h, y_w)
        mv_y_hat = decompress_4x(
            self._stages, mv_params,
            lambda k, so_far, prm: _stage_mv_spatial(p, k, so_far, prm),
            decode)
        mv_hat, mv_feature = _stage_mv_dec(p, mv_y_hat, qi)
        c1, c2, c3, _ = _stage_motion_comp(p, mv_hat, ref_frame,
                                           dpb["ref_feature"],
                                           sps["fa_idx"])
        params = _stage_ctx_prior(p, z_plane("z"), c3, dpb["ref_y"], y_h,
                                  y_w)
        y_hat = decompress_4x(
            self._stages, params,
            lambda k, so_far, prm: _stage_y_spatial(p, k, so_far, prm),
            decode)
        done()
        x_hat, feature = _stage_recon(p, y_hat, c1, c2, c3, qi)
        return {"dpb": {"ref_frame": C.frame_to_nhwc(x_hat),
                        "ref_feature": feature,
                        "ref_mv_feature": mv_feature, "ref_y": y_hat,
                        "ref_mv_y": mv_y_hat}}

    def _device_planes(self, bit_stream, zh, zw):
        """Device EC: (z_plane(name), decode(idx), done()), each plane one
        K2 launch in decode order with the carry passed on; a z plane's
        row ids are 1 + channel into its table (row 0 takes the pad
        slots)."""
        data, carry, lanes = decode_carry(bit_stream, self.device)
        tabs = self.dec_tables

        def z_plane(name):
            nonlocal carry
            c = tabs[name].shape[0] - 1
            flat, carry = _dec_plane(
                data, _z_rows(zh * zw * c, c, self.device) + 1, tabs[name],
                carry, lanes)
            return flat.reshape(1, c, zh, zw).to(self.dtype)

        def decode(idx):
            nonlocal carry
            y, carry = dec_y_plane(data, idx, tabs["y"], carry, lanes,
                                   self.dtype)
            return y

        return z_plane, decode, lambda: None
