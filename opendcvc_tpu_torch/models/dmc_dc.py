"""DMCDC — the DCVC-DC P-frame codec (NCHW), host EC.

Counterpart of the JAX package's `models/dmc_dc.py`, the generation
between HEM and FM: HEM's SpyNet (four 7x7 levels), a coded motion latent,
OffsetDiversity warping and multi-scale context fusion (FM's, imported
from `models/dmc_fm.py` as the JAX package imports them), the latent
references ref_y / ref_mv_y fused into the priors, four-part quadtree
coding of the motion and contextual latents, cyclic feature adaptors
(INDEX_MAP over the frame index), separate encoder / decoder quant banks
per latent with a 64-step fine QP ladder log-interpolated from the
anchors, and a UNet of DepthConvBlocks for the reconstruction.  y is
coded against 256 Laplace scale levels in [0.01, 64], both z planes
against single-bank factorized priors (support 50).

The DPB is an explicit dict, as DMCFM's: "ref_frame" NHWC (1, H, W, 3),
"ref_feature", "ref_mv_feature", "ref_y", "ref_mv_y" NCHW tensors, None
before the first P-frame (a chain may start from a raw frame).  The
reference frame is cast to the codec's dtype, as DMCFM casts it.  The
JAX DMCDC takes it in its own dtype: there a float32 reference before a
bfloat16 codec promotes the encoder's motion path and the whole DPB to
float32, while its decoder's priors stay in bfloat16, so its own decoder
does not rebuild its encoder's DPB (ROADMAP Queue 3).  The cast keeps
the port's chain exact from a raw float32 frame.

Entropy coding is host EC only, as in the JAX package: the encoder copies
both z planes and the eight packed y planes to the host in one copy while
the device runs the reconstruction; the decoder decodes both z planes on
the host, then fetches each pass's CDF indexes and uploads its symbols.
With stream_part > 1 the frame's symbols split over that many coders
(`entropy/nparts.py`).  Every stage the encoder and the decoder both
evaluate is one shared function, so the DPB chain is bit-identical on the
two sides; the streams are the JAX package's, byte for byte.

Parameters stay in the dtype they were loaded in (float32 from init);
activations run in `dtype` (float32 or bfloat16): each convolution casts
its weights to its input's dtype and the quant banks are cast once a
frame, as in the JAX package.
"""

import numpy as np
import torch

from ..entropy.coder import EntropyCoder
from ..entropy.models import (BitEstimator, GaussianEncoder,
                              bit_estimator_init)
from ..entropy.nparts import NPartEntropyCoder
from ..layers import blocks_fm as FM
from ..layers import blocks_hem as H
from ..layers.blocks import conv_apply, conv_init
from ..ops import fused as F
from ..ops.fused import depth_to_space
from ..utils.params import to_device
from ..utils.transfer import fetch_async
from . import common as C
from .dmc_fm import (_seq, _spatial_pass, _stage_motion_comp,
                     compress_4x, decompress_4x, host_planes)
from .dmci_fm import gaussian_cfg
from .prior_stages import make_pass_stages

G_CH_1X = 48
G_CH_2X = 64
G_CH_4X = 96
G_CH_8X = 96
G_CH_16X = 128
CH_MV = 64
CH_N = 64
QP_NUM = 64
INDEX_MAP = [0, 1, 0, 2]
Q_NAMES = (("mv_y_q_basic_enc", "mv_y_q_scale_enc"),
           ("mv_y_q_basic_dec", "mv_y_q_scale_dec"),
           ("y_q_basic_enc", "y_q_scale_enc"),
           ("y_q_basic_dec", "y_q_scale_dec"))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def dmc_dc_init(gen, anchor_num=4):
    dcb = FM.dcb_init
    rbu = FM.res_block_upsample_init
    p = {}
    p["optic_flow"] = H.hem_spynet_init(gen)
    p["align"] = {
        "off1": conv_init(gen, G_CH_1X + 3 + 2, G_CH_2X, 3),
        "off2": conv_init(gen, G_CH_2X, G_CH_2X, 3),
        "off3": conv_init(gen, G_CH_2X, 3 * 16 * 2, 3),
        "fusion": conv_init(gen, G_CH_1X * 2, G_CH_1X, 1, groups=16),
    }
    p["mv_enc"] = {
        "enc1_rbs": FM.res_block_stride_init(gen, 2, CH_MV),
        "enc1_dcb": dcb(gen, CH_MV, CH_MV),
        "enc2": FM.res_block_stride_init(gen, CH_MV, CH_MV),
        "adaptor_0": dcb(gen, CH_MV, CH_MV),
        "adaptor_1": dcb(gen, CH_MV * 2, CH_MV),
        "enc3_rbs": FM.res_block_stride_init(gen, CH_MV, CH_MV),
        "enc3_dcb": dcb(gen, CH_MV, CH_MV),
        "enc3_down": conv_init(gen, CH_MV, CH_MV, 3),
    }
    p["mv_dec"] = {
        "dec1": [dcb(gen, CH_MV, CH_MV), rbu(gen, CH_MV, CH_MV),
                 dcb(gen, CH_MV, CH_MV), rbu(gen, CH_MV, CH_MV),
                 dcb(gen, CH_MV, CH_MV)],
        "dec2": rbu(gen, CH_MV, CH_MV),
        "dec3_dcb": dcb(gen, CH_MV, CH_MV),
        "dec3_subpel": FM.subpel1x1_init(gen, CH_MV, 2),
    }
    p["mv_hyper_enc"] = H.hyper_enc_init(gen, CH_MV, CH_N)
    p["mv_hyper_dec"] = H.hyper_dec_init(gen, CH_MV, CH_N, out_factor=1,
                                         mid=CH_MV)
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
        "r1": H.res_block_init(gen, G_CH_2X * 2, bottleneck=True),
        "c2": conv_init(gen, G_CH_2X * 2, G_CH_4X, 3),
        "r2": H.res_block_init(gen, G_CH_4X * 2, bottleneck=True),
        "c3": conv_init(gen, G_CH_4X * 2, G_CH_8X, 3),
        "c4": conv_init(gen, G_CH_8X, G_CH_16X, 3),
    }
    p["ctx_dec"] = {
        "up1": conv_init(gen, G_CH_16X, G_CH_8X * 4, 3),
        "up2": conv_init(gen, G_CH_8X, G_CH_4X * 4, 3),
        "r1": H.res_block_init(gen, G_CH_4X * 2, bottleneck=True),
        "up3": conv_init(gen, G_CH_4X * 2, G_CH_2X * 4, 3),
        "r2": H.res_block_init(gen, G_CH_2X * 2, bottleneck=True),
        "up4": conv_init(gen, G_CH_2X * 2, 32 * 4, 3),
    }
    p["recon"] = {
        "first": conv_init(gen, G_CH_1X + 32, G_CH_1X, 3),
        "unet1": _dc_unet_init(gen, G_CH_1X, G_CH_1X),
        "unet2": _dc_unet_init(gen, G_CH_1X, G_CH_1X),
        "head": conv_init(gen, G_CH_1X, 3, 3),
    }
    # the contextual hyper towers: a reduced 3-conv encoder, a uniform
    # decoder
    p["hyper_enc"] = {k: conv_init(gen, G_CH_16X, G_CH_16X, 3)
                      for k in ("c0", "c1", "c2")}
    p["hyper_dec"] = H.hyper_dec_init(gen, G_CH_16X, G_CH_16X, out_factor=1,
                                      mid=G_CH_16X)
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

    # encoder / decoder quant anchors and per-channel basics
    for (basic, scale), ch in zip(Q_NAMES, (CH_MV, CH_MV, G_CH_2X * 2,
                                            G_CH_2X)):
        p[basic] = torch.ones((ch,))
        p[scale] = torch.ones((anchor_num,))
    p["bit_estimator_z"] = bit_estimator_init(gen, 1, G_CH_16X)
    p["bit_estimator_z_mv"] = bit_estimator_init(gen, 1, CH_N)
    return p


def _dc_unet_init(gen, in_ch, out_ch):
    """DC's UNet: DepthConvBlocks, 2x2 max pooling down, 1x1 subpel up."""
    return {
        "conv1": FM.dcb_init(gen, in_ch, 32),
        "conv2": FM.dcb_init(gen, 32, 64),
        "conv3": FM.dcb_init(gen, 64, 128),
        "refine": [FM.dcb_init(gen, 128, 128) for _ in range(4)],
        "up3": FM.subpel1x1_init(gen, 128, 64),
        "up_conv3": FM.dcb_init(gen, 128, 64),
        "up2": FM.subpel1x1_init(gen, 64, 32),
        "up_conv2": FM.dcb_init(gen, 64, out_ch),
    }


def _dc_unet_apply(p, x):
    x1 = FM.dcb_apply(p["conv1"], x)
    x2 = FM.dcb_apply(p["conv2"], FM._max_pool2(x1))
    x3 = FM.dcb_apply(p["conv3"], FM._max_pool2(x2))
    x3 = _seq(FM.dcb_apply, p["refine"], x3)
    d3 = FM.subpel1x1_apply(p["up3"], x3)
    d3 = FM.dcb_apply(p["up_conv3"], torch.cat((x2, d3), dim=1))
    d2 = FM.subpel1x1_apply(p["up2"], d3)
    return FM.dcb_apply(p["up_conv2"], torch.cat((x1, d2), dim=1))


# ---------------------------------------------------------------------------
# sub-networks
# ---------------------------------------------------------------------------

def mv_encoder(p, est_mv, ref_mv_feature, q):
    e = p["mv_enc"]
    out = FM.res_block_stride_apply(e["enc1_rbs"], est_mv)
    out = FM.dcb_apply(e["enc1_dcb"], out) * q
    out = FM.res_block_stride_apply(e["enc2"], out)
    if ref_mv_feature is None:
        out = FM.dcb_apply(e["adaptor_0"], out)
    else:
        out = FM.dcb_apply(e["adaptor_1"],
                           torch.cat((out, ref_mv_feature), dim=1))
    out = FM.res_block_stride_apply(e["enc3_rbs"], out)
    out = FM.dcb_apply(e["enc3_dcb"], out)
    return conv_apply(e["enc3_down"], out, stride=2, padding=1)


def mv_decoder(p, mv_y_hat, q):
    d = p["mv_dec"]
    feat = FM.dcb_apply(d["dec1"][0], mv_y_hat)
    feat = FM.res_block_upsample_apply(d["dec1"][1], feat)
    feat = FM.dcb_apply(d["dec1"][2], feat)
    feat = FM.res_block_upsample_apply(d["dec1"][3], feat)
    feat = FM.dcb_apply(d["dec1"][4], feat)
    out = FM.res_block_upsample_apply(d["dec2"], feat) * q
    out = FM.dcb_apply(d["dec3_dcb"], out)
    return FM.subpel1x1_apply(d["dec3_subpel"], out), feat


def contextual_encoder(p, x, c1, c2, c3, q):
    e = p["ctx_enc"]
    feat = conv_apply(e["c1"], torch.cat((x, c1), dim=1), stride=2,
                      padding=1)
    feat = H.res_block_apply(e["r1"], torch.cat((feat, c2), dim=1),
                             slope=0.1, end_with_relu=True) * q
    feat = conv_apply(e["c2"], feat, stride=2, padding=1)
    feat = H.res_block_apply(e["r2"], torch.cat((feat, c3), dim=1),
                             slope=0.1, end_with_relu=True)
    feat = conv_apply(e["c3"], feat, stride=2, padding=1)
    return conv_apply(e["c4"], feat, stride=2, padding=1)


def contextual_decoder(p, y_hat, c2, c3, q):
    d = p["ctx_dec"]
    feat = depth_to_space(conv_apply(d["up1"], y_hat, padding=1), 2)
    feat = depth_to_space(conv_apply(d["up2"], feat, padding=1), 2)
    feat = H.res_block_apply(d["r1"], torch.cat((feat, c3), dim=1),
                             slope=0.1, end_with_relu=True)
    feat = depth_to_space(conv_apply(d["up3"], feat, padding=1), 2) * q
    feat = H.res_block_apply(d["r2"], torch.cat((feat, c2), dim=1),
                             slope=0.1, end_with_relu=True)
    return depth_to_space(conv_apply(d["up4"], feat, padding=1), 2)


def recon_generation(p, res, c1):
    """The decoded residual feature is the first operand of the
    concatenation, as in the reference."""
    r = p["recon"]
    feat = conv_apply(r["first"], torch.cat((res, c1), dim=1), padding=1)
    feat = _dc_unet_apply(r["unet1"], feat)
    feat = _dc_unet_apply(r["unet2"], feat)
    x_hat = conv_apply(r["head"], feat, padding=1)
    return feat, torch.clamp(x_hat, 0.0, 1.0)


def ctx_hyper_enc_apply(hp, y_pad):
    h = FM.lrelu(conv_apply(hp["c0"], y_pad, padding=1), 0.01)
    h = FM.lrelu(conv_apply(hp["c1"], h, stride=2, padding=1), 0.01)
    return conv_apply(hp["c2"], h, stride=2, padding=1)


# ---------------------------------------------------------------------------
# stages (shared = evaluated by both encoder and decoder); the motion
# compensation and the spatial passes are FM's (`models/dmc_fm.py`), which
# the JAX package's DC stages compute too
# ---------------------------------------------------------------------------

def _stage_mv_enc(p, x, ref_frame, ref_mv_feature, mv_q_enc):
    """Encoder-only: flow -> motion latent, rounded motion z."""
    est_mv = H.hem_spynet_apply(p["optic_flow"], x, ref_frame)
    mv_y = mv_encoder(p, est_mv, ref_mv_feature, mv_q_enc)
    mv_z = H.hyper_enc_apply(p["mv_hyper_enc"], C.pad_for_y(mv_y))
    mv_z_hat, mv_z_int8 = F.round_and_to_int8(mv_z)
    return mv_y, mv_z_hat.to(x.dtype), mv_z_int8


def _stage_mv_prior(p, mv_z_hat, ref_mv_y, y_h, y_w):
    """Shared: motion z (+ ref_mv_y) -> the motion latent's chunk-3
    prior."""
    mv_params = H.hyper_dec_apply(p["mv_hyper_dec"], mv_z_hat)
    mv_params = mv_params[:, :, :y_h, :y_w]
    if ref_mv_y is None:
        mv_params = FM.dcb_apply(p["mv_fusion_adaptor_0"], mv_params)
    else:
        mv_params = FM.dcb_apply(p["mv_fusion_adaptor_1"],
                                 torch.cat((mv_params, ref_mv_y), dim=1))
    return _seq(FM.dcb_apply, p["mv_fusion"], mv_params)


def _stage_ctx_enc(p, x, c1, c2, c3, y_q_enc):
    """Encoder-only: frame + contexts -> y, rounded z."""
    y = contextual_encoder(p, x, c1, c2, c3, y_q_enc)
    z = ctx_hyper_enc_apply(p["hyper_enc"], C.pad_for_y(y))
    z_hat, z_int8 = F.round_and_to_int8(z)
    return y, z_hat.to(x.dtype), z_int8


def _stage_ctx_prior(p, z_hat, c3, ref_y, y_h, y_w):
    """Shared: z (+ temporal context, ref_y) -> y's chunk-3 prior."""
    hier = H.hyper_dec_apply(p["hyper_dec"], z_hat)[:, :, :y_h, :y_w]
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


def _stage_mv_dec(p, mv_y_hat, mv_q_dec):
    """Shared: motion latent -> (flow, next ref_mv_feature)."""
    return mv_decoder(p, mv_y_hat, mv_q_dec)


def _stage_recon(p, y_hat, c1, c2, c3, y_q_dec):
    """Shared: y_hat + contexts -> (x_hat, next ref_feature)."""
    res = contextual_decoder(p, y_hat, c2, c3, y_q_dec)
    feature, x_hat = recon_generation(p, res, c1)
    return x_hat, feature


def _stage_mv_spatial(p, k, y_hat_so_far, common_params):
    return _spatial_pass(p[f"mv_sp_adaptor_{k}"], p["mv_spatial_prior"],
                         y_hat_so_far, common_params)


def _stage_y_spatial(p, k, y_hat_so_far, common_params):
    return _spatial_pass(p[f"y_sp_adaptor_{k}"], p["y_spatial_prior"],
                         y_hat_so_far, common_params)


# ---------------------------------------------------------------------------
# host orchestrator
# ---------------------------------------------------------------------------

class DMCDC:
    """DCVC-DC P-frame codec.

    compress / decompress exchange explicit DPB dicts (see the module
    docstring).  device: torch device (default cuda; without CUDA that
    raises, and the CPU runs only when asked for).  dtype: float32 or
    bfloat16 activations.  stream_part > 1 splits each frame's stream
    over that many coders (`NPartEntropyCoder`), each on a worker thread
    of its own with ec_thread (threading changes no byte)."""

    def __init__(self, device="cuda", anchor_num=4, dtype=torch.float32,
                 ec_thread=False, stream_part=1):
        C.check_dtype(dtype, "DMCDC")
        self.device = C.resolve_device(device)
        self.anchor_num = anchor_num
        self.dtype = dtype
        self.stream_part = stream_part
        self.ec_thread = ec_thread
        self.params = None
        self.entropy_coder = None
        self.bit_estimator_z = BitEstimator(1, G_CH_16X, support=50)
        self.bit_estimator_z_mv = BitEstimator(1, CH_N, support=50)
        self.gaussian_encoder = GaussianEncoder(
            distribution="laplace", scale_min=0.01, scale_max=64.0,
            scale_levels=256, support=50)
        self._fine = {}
        self._stages = make_pass_stages(gaussian_cfg(self.gaussian_encoder),
                                        4)

    @staticmethod
    def get_qp_num():
        return QP_NUM

    def init_params(self, seed=0):
        """The port's random init; the anchors are spread over [0.5, 2.0],
        as the JAX package's init_params spreads them."""
        gen = torch.Generator().manual_seed(seed)
        p = dmc_dc_init(gen, self.anchor_num)
        for _, scale in Q_NAMES:
            p[scale] = torch.linspace(0.5, 2.0, self.anchor_num)
        self.load_params(p)
        return self.params

    def load_params(self, params):
        self.params = to_device(params, self.device)
        self._build_fine_ladders()

    def _build_fine_ladders(self):
        """The 64-step fine QP ladders, log-interpolated between each
        scale's first and last anchor in numpy (the JAX package's
        expression, on the anchors' own dtype)."""
        for _, name in Q_NAMES:
            a = self.params[name].detach().cpu().numpy().reshape(-1)
            self._fine[name] = np.exp(
                np.linspace(np.log(a[0]), np.log(a[-1]), QP_NUM))

    def update(self):
        """A new host coder (or N-part coder) with the Laplace scale rows
        and both z tables registered (groups 0, 1 and 2)."""
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

    def _q(self, basic_name, scale_name, q_index, q_in_ckpt):
        """max(basic, 0.5) * the qp's scale in float32, then cast to the
        activations' dtype, as a (1, C, 1, 1) multiplier."""
        if q_in_ckpt:
            scale = float(self.params[scale_name].reshape(-1)[q_index])
        else:
            scale = float(self._fine[scale_name][q_index])
        basic = torch.clamp_min(self.params[basic_name], 0.5)
        return (basic * scale)[None, :, None, None].to(self.dtype)

    def get_q_for_inference(self, q_in_ckpt, q_index):
        """(mv_q_enc, mv_q_dec, y_q_enc, y_q_dec)."""
        return tuple(self._q(basic, scale, q_index, q_in_ckpt)
                     for basic, scale in Q_NAMES)

    def _ref_frame(self, dpb):
        return C.frame_to_nchw(dpb["ref_frame"], self.device, self.dtype)

    def compress(self, x, dpb, q_in_ckpt, q_index, frame_idx=0):
        """x: (1, H, W, 3) NHWC in [0, 1], H and W multiples of 16; dpb the
        DPB dict.  Returns {"dpb": the next DPB, "bit_stream": bytes}."""
        p = self.params
        x = C.frame_to_nchw(x, self.device, self.dtype)
        mv_q_enc, mv_q_dec, y_q_enc, y_q_dec = self.get_q_for_inference(
            q_in_ckpt, q_index)
        fa_idx = INDEX_MAP[frame_idx % 4]
        ref_frame = self._ref_frame(dpb)
        mv_y, mv_z_hat, mv_z_int8 = _stage_mv_enc(
            p, x, ref_frame, dpb["ref_mv_feature"], mv_q_enc)
        mv_params = _stage_mv_prior(p, mv_z_hat, dpb["ref_mv_y"],
                                    mv_y.shape[2], mv_y.shape[3])
        mv_packed, mv_y_hat = compress_4x(
            self._stages, mv_y, mv_params,
            lambda k, so_far, prm: _stage_mv_spatial(p, k, so_far, prm))
        mv_hat, mv_feature = _stage_mv_dec(p, mv_y_hat, mv_q_dec)
        c1, c2, c3, _ = _stage_motion_comp(p, mv_hat, ref_frame,
                                           dpb["ref_feature"], fa_idx)
        y, z_hat, z_int8 = _stage_ctx_enc(p, x, c1, c2, c3, y_q_enc)
        params = _stage_ctx_prior(p, z_hat, c3, dpb["ref_y"], y.shape[2],
                                  y.shape[3])
        y_packed, y_hat = compress_4x(
            self._stages, y, params,
            lambda k, so_far, prm: _stage_y_spatial(p, k, so_far, prm))
        fetch = fetch_async(C.pack_host([mv_z_int8, z_int8],
                                        mv_packed + y_packed))
        # the device reconstructs while the host codes
        x_hat, feature = _stage_recon(p, y_hat, c1, c2, c3, y_q_dec)
        x_hat = C.frame_to_nhwc(x_hat)
        buf = fetch()
        stream = C.code_host(
            self.entropy_coder,
            [(self.bit_estimator_z_mv, 0), (self.bit_estimator_z, 0)],
            self.gaussian_encoder, buf, [mv_z_int8.numel(), z_int8.numel()],
            [pk.numel() for pk in mv_packed + y_packed])
        return {
            "dpb": {"ref_frame": x_hat, "ref_feature": feature,
                    "ref_mv_feature": mv_feature, "ref_y": y_hat,
                    "ref_mv_y": mv_y_hat},
            "bit_stream": stream,
        }

    def decompress(self, bit_stream, dpb, height, width, q_in_ckpt, q_index,
                   frame_idx=0):
        """Returns {"dpb": the next DPB}; its "ref_frame" is the decoded
        frame.  A stream that is not exactly the frame's symbols raises
        ValueError."""
        p = self.params
        _, mv_q_dec, _, y_q_dec = self.get_q_for_inference(q_in_ckpt,
                                                           q_index)
        fa_idx = INDEX_MAP[frame_idx % 4]
        zh, zw = C.get_downsampled_shape(height, width, 64)
        y_h, y_w = C.get_downsampled_shape(height, width, 16)
        z_plane, decode, done = host_planes(
            self.entropy_coder,
            [("mv_z", self.bit_estimator_z_mv), ("z", self.bit_estimator_z)],
            self.gaussian_encoder, bit_stream, zh, zw, self.device,
            self.dtype)
        ref_frame = self._ref_frame(dpb)

        mv_params = _stage_mv_prior(p, z_plane("mv_z"), dpb["ref_mv_y"],
                                    y_h, y_w)
        mv_y_hat = decompress_4x(
            self._stages, mv_params,
            lambda k, so_far, prm: _stage_mv_spatial(p, k, so_far, prm),
            decode)
        mv_hat, mv_feature = _stage_mv_dec(p, mv_y_hat, mv_q_dec)
        c1, c2, c3, _ = _stage_motion_comp(p, mv_hat, ref_frame,
                                           dpb["ref_feature"], fa_idx)
        params = _stage_ctx_prior(p, z_plane("z"), c3, dpb["ref_y"], y_h,
                                  y_w)
        y_hat = decompress_4x(
            self._stages, params,
            lambda k, so_far, prm: _stage_y_spatial(p, k, so_far, prm),
            decode)
        done()
        x_hat, feature = _stage_recon(p, y_hat, c1, c2, c3, y_q_dec)
        return {"dpb": {"ref_frame": C.frame_to_nhwc(x_hat),
                        "ref_feature": feature,
                        "ref_mv_feature": mv_feature, "ref_y": y_hat,
                        "ref_mv_y": mv_y_hat}}
