"""DMCHEM — the DCVC-HEM P-frame codec (NCHW), host EC.

Counterpart of the JAX package's `models/dmc_hem.py`: HEM's SpyNet (four
7x7 levels) and a coded motion latent (64 channels at 1/16), multi-scale
warped feature contexts and their fusion, the latent references ref_y /
ref_mv_y (zeros before the first P-frame) concatenated into the priors,
two-pass checkerboard coding of both latents (`make_pass_stages(cfg, 2)`)
with conv-stack spatial priors, a two-UNet reconstruction, and a
continuous rate: per-latent q_basic x q_scale, any float between the four
anchors (`get_interpolated_q_scales`).  y (96 channels) and the motion
latent are coded against 256 Laplace scale levels in [0.01, 64], both z
planes against single-bank factorized priors (support 50).  The
sub-networks are HEM's own (`blocks_hem.res_block` and its slope-0.1
end-with-ReLU form), not FM's.

The DPB is an explicit dict: "ref_frame" NHWC (1, H, W, 3), "ref_feature",
"ref_y", "ref_mv_y" NCHW tensors, None before the first P-frame (a chain
may start from an IntraNoAR x_hat or a raw frame).  Without a
ref_feature the feature adaptor is the 3x3 conv on the frame
(feature_adaptor_I), else the 1x1 on the feature (feature_adaptor_P).
The reference frame is cast to the codec's dtype, as DMCDC and DMCFM cast
it.  The JAX DMCHEM takes it in its own dtype: there a float32 reference
before a bfloat16 codec promotes the encoder's motion path and DPB to
float32, while its decoder's priors stay bfloat16, so its own decoder
does not rebuild its encoder's DPB (ROADMAP Queue 3).  The cast keeps the
port's chain exact from a raw float32 frame.

One host stream a frame, in the JAX package's order: mv_z, motion pass
0, motion pass 1, z, y pass 0, y pass 1.  The encoder copies the six
planes to the host in one copy while the device reconstructs; the
decoder decodes them in that order, each between the stages that need
it.  Every stage both sides evaluate is one shared function, so the DPB
chain is bit-identical on the two sides; the streams are the JAX
package's, byte for byte.

Parameters stay as loaded (float32 from init, never cast); activations
run in `dtype` (float32 or bfloat16): each convolution casts its weights
to its input's dtype and the rate multipliers are cast once a frame.
"""

import numpy as np
import torch

from ..entropy.coder import EntropyCoder
from ..entropy.models import (BitEstimator, GaussianEncoder,
                              bit_estimator_init)
from ..layers import blocks_hem as H
from ..layers.blocks import conv_apply, conv_init
from ..ops import fused as F
from ..ops.fused import depth_to_space
from ..ops.warp import bilinear_resize_2x, flow_warp
from ..utils import trace
from ..utils.params import to_device
from ..utils.stream_helper import interpolate_log
from ..utils.transfer import fetch_async
from . import common as C
from .dmci_fm import gaussian_cfg
from .prior_stages import make_pass_stages

CH_MV = 64
CH_N = 64
CH_M = 96
Q_NAMES = {"mv": ("mv_y_q_basic", "mv_y_q_scale"),
           "y": ("y_q_basic", "y_q_scale")}


def dmc_hem_init(gen, anchor_num=4):
    p = {}
    p["optic_flow"] = H.hem_spynet_init(gen)
    p["mv_encoder"] = H.enc_tower_init(gen, 2, CH_MV)
    p["mv_decoder"] = H.dec_tower_init(gen, 2, CH_MV)
    p["mv_hyper_enc"] = H.hyper_enc_init(gen, CH_MV, CH_N)
    p["mv_hyper_dec"] = H.hyper_dec_init(gen, CH_MV, CH_N, out_factor=2)
    p["mv_y_prior_fusion"] = H.conv_lrelu_stack_init(
        gen, [CH_MV * 3, CH_MV * 3, CH_MV * 3, CH_MV * 3])
    p["mv_y_spatial_prior"] = H.conv_lrelu_stack_init(
        gen, [CH_MV * 4, CH_MV * 3, CH_MV * 3, CH_MV * 2])

    p["feature_adaptor_I"] = conv_init(gen, 3, CH_N, 3)
    p["feature_adaptor_P"] = conv_init(gen, CH_N, CH_N, 1)
    p["feature_extractor"] = {
        "c1": conv_init(gen, CH_N, CH_N, 3),
        "r1": H.res_block_init(gen, CH_N),
        "c2": conv_init(gen, CH_N, CH_N, 3),
        "r2": H.res_block_init(gen, CH_N),
        "c3": conv_init(gen, CH_N, CH_N, 3),
        "r3": H.res_block_init(gen, CH_N),
    }
    p["ctx_fusion"] = {
        "c3_up": conv_init(gen, CH_N, CH_N * 4, 3),
        "r3_up": H.res_block_init(gen, CH_N),
        "c3_out": conv_init(gen, CH_N, CH_N, 3),
        "r3_out": H.res_block_init(gen, CH_N),
        "c2_up": conv_init(gen, CH_N * 2, CH_N * 4, 3),
        "r2_up": H.res_block_init(gen, CH_N),
        "c2_out": conv_init(gen, CH_N * 2, CH_N, 3),
        "r2_out": H.res_block_init(gen, CH_N),
        "c1_out": conv_init(gen, CH_N * 2, CH_N, 3),
        "r1_out": H.res_block_init(gen, CH_N),
    }
    p["ctx_enc"] = {
        "c1": conv_init(gen, CH_N + 3, CH_N, 3),
        "r1": H.res_block_init(gen, CH_N * 2, bottleneck=True),
        "c2": conv_init(gen, CH_N * 2, CH_N, 3),
        "r2": H.res_block_init(gen, CH_N * 2, bottleneck=True),
        "c3": conv_init(gen, CH_N * 2, CH_N, 3),
        "c4": conv_init(gen, CH_N, CH_M, 3),
    }
    # the contextual hyper encoder is the short 3-conv stack, unlike the
    # motion latent's 5-conv tower
    p["hyper_enc"] = H.conv_lrelu_stack_init(gen, [CH_M, CH_N, CH_N, CH_N])
    p["hyper_dec"] = H.hyper_dec_init(gen, CH_M, CH_N, out_factor=2)
    p["temporal_prior"] = {
        "c1": conv_init(gen, CH_N, CH_M * 3 // 2, 3),
        "c2": conv_init(gen, CH_M * 3 // 2, CH_M * 2, 3),
    }
    p["y_prior_fusion"] = H.conv_lrelu_stack_init(
        gen, [CH_M * 5, CH_M * 4, CH_M * 3, CH_M * 3])
    p["y_spatial_prior"] = H.conv_lrelu_stack_init(
        gen, [CH_M * 4, CH_M * 3, CH_M * 3, CH_M * 2])
    p["ctx_dec"] = {
        "up1": conv_init(gen, CH_M, CH_N * 4, 3),
        "up2": conv_init(gen, CH_N, CH_N * 4, 3),
        "r1": H.res_block_init(gen, CH_N * 2, bottleneck=True),
        "up3": conv_init(gen, CH_N * 2, CH_N * 4, 3),
        "r2": H.res_block_init(gen, CH_N * 2, bottleneck=True),
        "up4": conv_init(gen, CH_N * 2, 32 * 4, 3),
    }
    p["recon"] = {
        "first": conv_init(gen, CH_N + 32, CH_N, 3),
        "unet1": H.unet_init(gen, CH_N, CH_N),
        "unet2": H.unet_init(gen, CH_N, CH_N),
        "head": conv_init(gen, CH_N, 3, 3),
    }
    p["mv_y_q_basic"] = torch.ones((CH_MV,))
    p["mv_y_q_scale"] = torch.ones((anchor_num,))
    p["y_q_basic"] = torch.ones((CH_M,))
    p["y_q_scale"] = torch.ones((anchor_num,))
    p["bit_estimator_z"] = bit_estimator_init(gen, 1, CH_N)
    p["bit_estimator_z_mv"] = bit_estimator_init(gen, 1, CH_N)
    return p


# ---------------------------------------------------------------------------
# sub-networks (HEM's, also DCVC-TCM's feature extractor and fusion)
# ---------------------------------------------------------------------------

def feature_extractor(p, feature):
    fe = p["feature_extractor"]
    l1 = H.res_block_apply(fe["r1"], conv_apply(fe["c1"], feature,
                                                padding=1))
    l2 = H.res_block_apply(fe["r2"], conv_apply(fe["c2"], l1, stride=2,
                                                padding=1))
    l3 = H.res_block_apply(fe["r3"], conv_apply(fe["c3"], l2, stride=2,
                                                padding=1))
    return l1, l2, l3


def context_fusion(p, c1, c2, c3):
    f = p["ctx_fusion"]
    c3_up = depth_to_space(conv_apply(f["c3_up"], c3, padding=1), 2)
    c3_up = H.res_block_apply(f["r3_up"], c3_up)
    c3_out = H.res_block_apply(f["r3_out"],
                               conv_apply(f["c3_out"], c3, padding=1))
    cat32 = torch.cat((c3_up, c2), dim=1)
    c2_up = depth_to_space(conv_apply(f["c2_up"], cat32, padding=1), 2)
    c2_up = H.res_block_apply(f["r2_up"], c2_up)
    c2_out = H.res_block_apply(f["r2_out"],
                               conv_apply(f["c2_out"], cat32, padding=1))
    cat21 = torch.cat((c2_up, c1), dim=1)
    c1_out = H.res_block_apply(f["r1_out"],
                               conv_apply(f["c1_out"], cat21, padding=1))
    return c1 + c1_out, c2 + c2_out, c3 + c3_out


def contextual_encoder(p, x, c1, c2, c3):
    e = p["ctx_enc"]
    feat = conv_apply(e["c1"], torch.cat((x, c1), dim=1), stride=2,
                      padding=1)
    feat = H.res_block_apply(e["r1"], torch.cat((feat, c2), dim=1),
                             slope=0.1, end_with_relu=True)
    feat = conv_apply(e["c2"], feat, stride=2, padding=1)
    feat = H.res_block_apply(e["r2"], torch.cat((feat, c3), dim=1),
                             slope=0.1, end_with_relu=True)
    feat = conv_apply(e["c3"], feat, stride=2, padding=1)
    return conv_apply(e["c4"], feat, stride=2, padding=1)


def contextual_decoder(p, y_hat, c2, c3):
    d = p["ctx_dec"]
    feat = depth_to_space(conv_apply(d["up1"], y_hat, padding=1), 2)
    feat = depth_to_space(conv_apply(d["up2"], feat, padding=1), 2)
    feat = H.res_block_apply(d["r1"], torch.cat((feat, c3), dim=1),
                             slope=0.1, end_with_relu=True)
    feat = depth_to_space(conv_apply(d["up3"], feat, padding=1), 2)
    feat = H.res_block_apply(d["r2"], torch.cat((feat, c2), dim=1),
                             slope=0.1, end_with_relu=True)
    return depth_to_space(conv_apply(d["up4"], feat, padding=1), 2)


def recon_generation(p, res, c1):
    """The decoded residual feature is the first operand of the
    concatenation, as in the reference.  Returns (feature, x_hat)."""
    r = p["recon"]
    feat = conv_apply(r["first"], torch.cat((res, c1), dim=1), padding=1)
    feat = H.unet_apply(r["unet1"], feat)
    feat = H.unet_apply(r["unet2"], feat)
    x_hat = conv_apply(r["head"], feat, padding=1)
    return feat, torch.clamp(x_hat, 0.0, 1.0)


def _prior_chunks(fused):
    """A fused prior's thirds: (q_step clamped >= 0.5, scales, means)."""
    c = fused.shape[1] // 3
    return (torch.clamp_min(fused[:, :c], 0.5), fused[:, c:2 * c],
            fused[:, 2 * c:])


def _or_zeros(ref, like, channels):
    """A latent reference, or zeros of (1, channels) x like's spatial size
    in like's dtype before the first P-frame."""
    if ref is not None:
        return ref
    return torch.zeros((1, channels) + tuple(like.shape[2:]),
                       dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# stages (shared = evaluated by both encoder and decoder); the checkerboard
# passes are `make_pass_stages(cfg, 2)`'s
# ---------------------------------------------------------------------------

@trace.spanned("nn.mv_enc")
def _stage_mv_enc(p, x, ref_frame, mv_q):
    """Encoder-only: flow -> motion latent / mv_q, rounded motion z."""
    est_mv = H.hem_spynet_apply(p["optic_flow"], x, ref_frame)
    mv_y = H.enc_tower_apply(p["mv_encoder"], est_mv) / mv_q
    mv_z = H.hyper_enc_apply(p["mv_hyper_enc"], mv_y)
    mv_z_hat, mv_z_int8 = F.round_and_to_int8(mv_z)
    return mv_y, mv_z_hat.to(x.dtype), mv_z_int8


@trace.spanned("nn.mv_prior")
def _stage_mv_prior(p, mv_z_hat, ref_mv_y):
    """Shared: motion z + ref_mv_y (zeros when None) -> (q_step, scales,
    means)."""
    mv_params = H.hyper_dec_apply(p["mv_hyper_dec"], mv_z_hat)
    mv_params = torch.cat((mv_params, _or_zeros(ref_mv_y, mv_params,
                                                 CH_MV)), dim=1)
    return _prior_chunks(H.conv_lrelu_stack_apply(p["mv_y_prior_fusion"],
                                                  mv_params))


@trace.spanned("nn.motion_comp")
def _stage_motion_comp(p, mv_hat, ref_frame, ref_feature):
    """Shared: the decoded flow warps the reference's features at three
    scales -> the fused contexts (c1, c2, c3) and the warped frame."""
    if ref_feature is None:
        feature = conv_apply(p["feature_adaptor_I"], ref_frame, padding=1)
    else:
        feature = conv_apply(p["feature_adaptor_P"], ref_feature)
    f1, f2, f3 = feature_extractor(p, feature)
    warpframe = flow_warp(ref_frame, mv_hat)
    mv2 = bilinear_resize_2x(mv_hat, up=False) / 2
    mv3 = bilinear_resize_2x(mv2, up=False) / 2
    c1 = flow_warp(f1, mv_hat)
    c2 = flow_warp(f2, mv2)
    c3 = flow_warp(f3, mv3)
    c1, c2, c3 = context_fusion(p, c1, c2, c3)
    return c1, c2, c3, warpframe


@trace.spanned("nn.ctx_enc")
def _stage_ctx_enc(p, x, c1, c2, c3, y_q):
    """Encoder-only: frame + contexts -> y / y_q, rounded z."""
    y = contextual_encoder(p, x, c1, c2, c3) / y_q
    he = p["hyper_enc"]
    z = conv_apply(he[0], y, padding=1)
    z = conv_apply(he[1], H.lrelu(z, 0.01), stride=2, padding=1)
    z = conv_apply(he[2], H.lrelu(z, 0.01), stride=2, padding=1)
    z_hat, z_int8 = F.round_and_to_int8(z)
    return y, z_hat.to(x.dtype), z_int8


@trace.spanned("nn.ctx_prior")
def _stage_ctx_prior(p, z_hat, c3, ref_y):
    """Shared: z + the temporal prior of c3 + ref_y (zeros when None) ->
    (q_step, scales, means)."""
    hier = H.hyper_dec_apply(p["hyper_dec"], z_hat)
    tp = p["temporal_prior"]
    temporal = H.lrelu(conv_apply(tp["c1"], c3, stride=2, padding=1), 0.1)
    temporal = conv_apply(tp["c2"], temporal, stride=2, padding=1)
    params = torch.cat((temporal, hier, _or_zeros(ref_y, hier, CH_M)),
                       dim=1)
    return _prior_chunks(H.conv_lrelu_stack_apply(p["y_prior_fusion"],
                                                  params))


@trace.spanned("nn.spatial")
def _stage_spatial(plist, y_hat_0, means, scales, q_step):
    """Shared: pass 0's y_hat and the prior -> pass 1's (scales, means)
    from the conv stack `plist` (its output quarters: scales, means,
    scales, means)."""
    cat = torch.cat((y_hat_0, means, scales, q_step), dim=1)
    out = H.conv_lrelu_stack_apply(plist, cat)
    q = out.shape[1] // 4
    scales1 = torch.cat((out[:, :q], out[:, 2 * q:3 * q]), dim=1)
    means1 = torch.cat((out[:, q:2 * q], out[:, 3 * q:]), dim=1)
    return scales1, means1


@trace.spanned("nn.mv_dec")
def _stage_mv_dec(p, mv_y_hat):
    """Shared: motion latent -> flow."""
    return H.dec_tower_apply(p["mv_decoder"], mv_y_hat)


@trace.spanned("nn.recon")
def _stage_recon(p, y_hat, c1, c2, c3):
    """Shared: y_hat + contexts -> (next ref_feature, x_hat)."""
    res = contextual_decoder(p, y_hat, c2, c3)
    return recon_generation(p, res, c1)


# ---------------------------------------------------------------------------
# host orchestrator
# ---------------------------------------------------------------------------

class DMCHEM:
    """DCVC-HEM P-frame codec.

    compress / decompress exchange explicit DPB dicts (see the module
    docstring).  device: torch device (default cuda; without CUDA that
    raises, and the CPU runs only when asked for).  dtype: float32 or
    bfloat16 activations."""

    def __init__(self, device="cuda", anchor_num=4, dtype=torch.float32):
        C.check_dtype(dtype, "DMCHEM")
        self.device = C.resolve_device(device)
        self.anchor_num = anchor_num
        self.dtype = dtype
        self.params = None
        self.entropy_coder = None
        self.bit_estimator_z = BitEstimator(1, CH_N, support=50)
        self.bit_estimator_z_mv = BitEstimator(1, CH_N, support=50)
        self.gaussian_encoder = GaussianEncoder(
            distribution="laplace", scale_min=0.01, scale_max=64.0,
            scale_levels=256, support=50)
        self._stages = make_pass_stages(gaussian_cfg(self.gaussian_encoder),
                                        2)

    def init_params(self, seed=0):
        """The port's random init (torch.Generator); the anchors are flat
        ones, as the JAX package's init leaves them."""
        gen = torch.Generator().manual_seed(seed)
        self.load_params(dmc_hem_init(gen, self.anchor_num))
        return self.params

    def load_params(self, params):
        self.params = to_device(params, self.device)

    def update(self):
        """A new host coder with the Laplace scale rows and both z tables
        registered (groups 0, 1 and 2)."""
        self.entropy_coder = EntropyCoder()
        self.gaussian_encoder.update(self.entropy_coder)
        self.bit_estimator_z.update(self.params["bit_estimator_z"],
                                    self.entropy_coder)
        self.bit_estimator_z_mv.update(self.params["bit_estimator_z_mv"],
                                       self.entropy_coder)

    def get_q_scales(self):
        """(y anchors, motion anchors) as numpy."""
        return tuple(self.params[Q_NAMES[k][1]].detach().cpu().numpy()
                     .reshape(-1) for k in ("y", "mv"))

    def get_interpolated_q_scales(self, rate_num):
        """The continuous-rate ladder: rate_num points log-interpolated
        between the extreme anchors, highest rate (largest scale) first,
        for y and the motion latent; flat anchors (an untrained init)
        give a flat ladder."""
        def ladder(a):
            lo, hi = float(a.min()), float(a.max())
            if lo >= hi:
                return np.full(rate_num, hi)
            return np.asarray(interpolate_log(lo, hi, rate_num))

        y, mv = self.get_q_scales()
        return ladder(y), ladder(mv)

    def _q(self, latent, q_scale):
        """max(basic, 0.5) * q_scale (taken as a float32) in float32, cast
        to the activations' dtype, as (1, C, 1, 1)."""
        basic = torch.clamp_min(self.params[Q_NAMES[latent][0]], 0.5)
        q = basic * float(np.float32(q_scale))
        return q[None, :, None, None].to(self.dtype)

    def _ref_frame(self, dpb):
        return C.frame_to_nchw(dpb["ref_frame"], self.device, self.dtype)

    # -- the two checkerboard passes of a latent -----------------------------

    def _compress_2x(self, y, q_step, scales, means, spatial, outer_q):
        st = self._stages
        y_div, packed0, y_hat_0 = st["enc_pass0_qstep"](y, q_step, scales,
                                                        means)
        scales1, means1 = _stage_spatial(spatial, y_hat_0, means, scales,
                                         q_step)
        packed1, y_hat_1 = st["enc_pass_k"](y_div, scales1, means1, None, 1)
        return [packed0, packed1], st["finalize_qstep"](y_hat_0, y_hat_1,
                                                        q_step, outer_q)

    def _decompress_2x(self, q_step, scales, means, spatial, outer_q):
        st = self._stages
        y_hat_0 = st["dec_restore_acc"](
            self._decode_y(st["dec_index_k"](scales, 0)), means, None, 0)
        scales1, means1 = _stage_spatial(spatial, y_hat_0, means, scales,
                                         q_step)
        y_hat_1 = st["dec_restore_acc"](
            self._decode_y(st["dec_index_k"](scales1, 1)), means1, None, 1)
        return st["finalize_qstep"](y_hat_0, y_hat_1, q_step, outer_q)

    def _decode_y(self, idx):
        return C.decode_y_host(self.gaussian_encoder,
                               fetch_async(C.index_buf(idx)), idx.shape,
                               self.device, self.dtype)

    # -- compress / decompress -----------------------------------------------

    @trace.spanned("dmc_hem.compress", 1)
    def compress(self, x, dpb, mv_y_q_scale, y_q_scale):
        """x: (1, H, W, 3) NHWC in [0, 1], H and W multiples of 64; dpb the
        DPB dict.  Returns {"dpb": the next DPB, "bit_stream": bytes}."""
        p = self.params
        x = C.frame_to_nchw(x, self.device, self.dtype)
        mv_q, y_q = self._q("mv", mv_y_q_scale), self._q("y", y_q_scale)
        ref_frame = self._ref_frame(dpb)
        mv_y, mv_z_hat, mv_z_int8 = _stage_mv_enc(p, x, ref_frame, mv_q)
        mv_packed, mv_y_hat = self._compress_2x(
            mv_y, *_stage_mv_prior(p, mv_z_hat, dpb["ref_mv_y"]),
            p["mv_y_spatial_prior"], mv_q)
        mv_hat = _stage_mv_dec(p, mv_y_hat)
        c1, c2, c3, _ = _stage_motion_comp(p, mv_hat, ref_frame,
                                           dpb["ref_feature"])
        y, z_hat, z_int8 = _stage_ctx_enc(p, x, c1, c2, c3, y_q)
        y_packed, y_hat = self._compress_2x(
            y, *_stage_ctx_prior(p, z_hat, c3, dpb["ref_y"]),
            p["y_spatial_prior"], y_q)
        planes = [mv_z_int8] + mv_packed + [z_int8] + y_packed
        fetch = fetch_async(C.pack_planes(planes))
        # the device reconstructs while the host codes
        feature, x_hat = _stage_recon(p, y_hat, c1, c2, c3)
        x_hat = C.frame_to_nhwc(x_hat)
        buf = fetch()
        z_coders = {0: (self.bit_estimator_z_mv, 0),
                    3: (self.bit_estimator_z, 0)}
        stream = C.code_host_ordered(
            self.entropy_coder, self.gaussian_encoder, buf,
            [(pl.numel(), z_coders.get(i)) for i, pl in enumerate(planes)])
        return {
            "dpb": {"ref_frame": x_hat, "ref_feature": feature,
                    "ref_y": y_hat, "ref_mv_y": mv_y_hat},
            "bit_stream": stream,
        }

    @trace.spanned("dmc_hem.decompress", 1)
    def decompress(self, dpb, bit_stream, height, width, mv_y_q_scale,
                   y_q_scale):
        """Returns {"dpb": the next DPB}; its "ref_frame" is the decoded
        frame.  A stream that is not exactly the frame's symbols raises
        ValueError."""
        p = self.params
        mv_q, y_q = self._q("mv", mv_y_q_scale), self._q("y", y_q_scale)
        zh, zw = C.get_downsampled_shape(height, width, 64)
        self.entropy_coder.set_stream(bit_stream)
        mv_z_hat = C.decode_z_host(self.bit_estimator_z_mv, 0, zh, zw,
                                   self.device, self.dtype)
        ref_frame = self._ref_frame(dpb)
        mv_y_hat = self._decompress_2x(
            *_stage_mv_prior(p, mv_z_hat, dpb["ref_mv_y"]),
            p["mv_y_spatial_prior"], mv_q)
        mv_hat = _stage_mv_dec(p, mv_y_hat)
        c1, c2, c3, _ = _stage_motion_comp(p, mv_hat, ref_frame,
                                           dpb["ref_feature"])
        z_hat = C.decode_z_host(self.bit_estimator_z, 0, zh, zw, self.device,
                                self.dtype)
        y_hat = self._decompress_2x(
            *_stage_ctx_prior(p, z_hat, c3, dpb["ref_y"]),
            p["y_spatial_prior"], y_q)
        self.entropy_coder.check_stream_end()
        feature, x_hat = _stage_recon(p, y_hat, c1, c2, c3)
        return {"dpb": {"ref_frame": C.frame_to_nhwc(x_hat),
                        "ref_feature": feature, "ref_y": y_hat,
                        "ref_mv_y": mv_y_hat}}
