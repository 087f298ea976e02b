"""DMCTCM — the DCVC-TCM P-frame codec (NCHW), host EC.

Counterpart of the JAX package's `models/dmc_tcm.py`: HEM's SpyNet, a
motion latent (128 channels at 1/16) through GDN encoder / IGDN decoder
towers with 2x transposed-conv upsampling (`conv_transpose2x_apply`, also
in both hyper decoders), multi-scale propagated feature contexts (HEM's
feature extractor and fusion, `models/dmc_hem.py`), a GDN temporal prior
encoder, and SEQUENTIAL dense entropy coding with no checkerboard: each
latent is coded whole against its per-element scales and means.  y (96
channels) and the motion latent are coded against 256 Laplace scale
levels in [0.01, 64], both z planes against single-bank factorized priors
(support 50).

The references are the reference frame (NHWC (1, H, W, 3): a raw frame or
the previous x_hat) and the propagated feature (NCHW, None for the first
P-frame, when the 3x3 adaptor takes the frame).  The reference frame is
cast to the codec's dtype, as DMCHEM casts it; the JAX DMCTCM takes it
in its own dtype, so there a float32 reference before a bfloat16 codec
promotes the encoder and its own decoder does not rebuild the encoder's
x_hat and feature (ROADMAP Queue 3).

One host stream a frame, in the JAX package's order: mv_z, the motion
latent, z, y.  The encoder copies the four planes to the host in one copy
while the device reconstructs; the decoder decodes them in that order,
each between the stages that need it.  Every stage both sides evaluate
is one shared function, so the decoder rebuilds the encoder's x_hat and
feature bit for bit; the streams are the JAX package's, byte for byte.

Parameters stay as loaded (float32 from init, never cast); activations
run in `dtype` (float32 or bfloat16), each convolution casting its
weights to its input's dtype; GDN's norm is computed in float32.
"""

import torch

from ..entropy.coder import EntropyCoder
from ..entropy.models import (BitEstimator, GaussianEncoder,
                              bit_estimator_init)
from ..layers import blocks_hem as H
from ..layers.blocks import conv_apply, conv_init, conv_transpose2x_apply
from ..layers.gdn import gdn_apply, gdn_init
from ..ops import fused as F
from ..ops.fused import depth_to_space
from ..utils.params import to_device
from . import common as C
from .dmc_hem import _stage_motion_comp  # noqa: F401  (TCM's stage too)
from .dmci_fm import gaussian_cfg

CH_MV = 128
CH_N = 64
CH_M = 96


def dmc_tcm_init(gen):
    p = {}
    p["optic_flow"] = H.hem_spynet_init(gen)
    # 3 x [conv s2, GDN, ResBlock, LeakyReLU] + a last conv s2
    p["mv_enc"] = []
    in_ch = 2
    for _ in range(3):
        p["mv_enc"].append({"conv": conv_init(gen, in_ch, CH_MV, 3),
                            "gdn": gdn_init(gen, CH_MV),
                            "res": H.res_block_init(gen, CH_MV)})
        in_ch = CH_MV
    p["mv_enc"].append({"conv": conv_init(gen, CH_MV, CH_MV, 3)})
    p["mv_prior_enc"] = [conv_init(gen, CH_MV, CH_N, 3),
                         conv_init(gen, CH_N, CH_N, 3),
                         conv_init(gen, CH_N, CH_N, 3)]
    p["mv_prior_dec"] = [conv_init(gen, CH_N, CH_MV, 3),
                         conv_init(gen, CH_MV, CH_MV * 3 // 2, 3),
                         conv_init(gen, CH_MV * 3 // 2, CH_MV * 2, 3)]
    p["mv_dec"] = {
        "t1": conv_init(gen, CH_MV, CH_MV, 3),
        "res": H.res_block_init(gen, CH_MV),
        "gdn1": gdn_init(gen, CH_MV),
        "t2": conv_init(gen, CH_MV, CH_MV, 3),
        "gdn2": gdn_init(gen, CH_MV),
        "t3": conv_init(gen, CH_MV, CH_MV, 3),
        "gdn3": gdn_init(gen, CH_MV),
        "t4": conv_init(gen, CH_MV, 2, 3),
    }

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
        "g1": gdn_init(gen, CH_N),
        "r1": H.res_block_init(gen, CH_N * 2, bottleneck=True),
        "c2": conv_init(gen, CH_N * 2, CH_N, 3),
        "g2": gdn_init(gen, CH_N),
        "r2": H.res_block_init(gen, CH_N * 2, bottleneck=True),
        "c3": conv_init(gen, CH_N * 2, CH_N, 3),
        "g3": gdn_init(gen, CH_N),
        "c4": conv_init(gen, CH_N, CH_M, 3),
    }
    p["ctx_dec"] = {
        "up1": conv_init(gen, CH_M, CH_N * 4, 3),
        "g1": gdn_init(gen, CH_N),
        "up2": conv_init(gen, CH_N, CH_N * 4, 3),
        "g2": gdn_init(gen, CH_N),
        "r1": H.res_block_init(gen, CH_N * 2, bottleneck=True),
        "up3": conv_init(gen, CH_N * 2, CH_N * 4, 3),
        "g3": gdn_init(gen, CH_N),
        "r2": H.res_block_init(gen, CH_N * 2, bottleneck=True),
        "up4": conv_init(gen, CH_N * 2, 32 * 4, 3),
    }
    p["hyper_enc"] = [conv_init(gen, CH_M, CH_N, 3),
                      conv_init(gen, CH_N, CH_N, 3),
                      conv_init(gen, CH_N, CH_N, 3)]
    p["hyper_dec"] = [conv_init(gen, CH_N, CH_M, 3),
                      conv_init(gen, CH_M, CH_M * 3 // 2, 3),
                      conv_init(gen, CH_M * 3 // 2, CH_M * 2, 3)]
    p["temporal_prior"] = {
        "c1": conv_init(gen, CH_N, CH_N, 3),
        "g1": gdn_init(gen, CH_N),
        "c2": conv_init(gen, CH_N * 2, CH_M, 3),
        "g2": gdn_init(gen, CH_M),
        "c3": conv_init(gen, CH_M + CH_N, CH_M * 3 // 2, 3),
        "g3": gdn_init(gen, CH_M * 3 // 2),
        "c4": conv_init(gen, CH_M * 3 // 2, CH_M * 2, 3),
    }
    p["entropy_parameter"] = [
        conv_init(gen, CH_M * 4, CH_M * 10 // 3, 3),
        conv_init(gen, CH_M * 10 // 3, CH_M * 8 // 3, 3),
        conv_init(gen, CH_M * 8 // 3, CH_M * 2, 3)]
    p["recon"] = {
        "first": conv_init(gen, CH_N + 32, CH_N, 3),
        "res1": H.res_block_init(gen, CH_N),
        "res2": H.res_block_init(gen, CH_N),
        "head": conv_init(gen, CH_N, 3, 3),
    }
    p["bit_estimator_z"] = bit_estimator_init(gen, 1, CH_N)
    p["bit_estimator_z_mv"] = bit_estimator_init(gen, 1, CH_N)
    return p


# ---------------------------------------------------------------------------
# sub-networks
# ---------------------------------------------------------------------------

def mv_encoder(p, mv):
    h = mv
    for blk in p["mv_enc"]:
        h = conv_apply(blk["conv"], h, stride=2, padding=1)
        if "gdn" in blk:
            h = gdn_apply(blk["gdn"], h)
            h = H.res_block_apply(blk["res"], h, start_from_relu=False)
            h = H.lrelu(h, 0.1)
    return h


def mv_prior_enc(p, mv_y):
    pe = p["mv_prior_enc"]
    h = H.lrelu(conv_apply(pe[0], mv_y, padding=1), 0.01)
    h = H.lrelu(conv_apply(pe[1], h, stride=2, padding=1), 0.01)
    return conv_apply(pe[2], h, stride=2, padding=1)


def mv_prior_dec(p, mv_z_hat):
    pd = p["mv_prior_dec"]
    h = H.lrelu(conv_transpose2x_apply(pd[0], mv_z_hat), 0.01)
    h = H.lrelu(conv_transpose2x_apply(pd[1], h), 0.01)
    return conv_apply(pd[2], h, padding=1)


def mv_decoder(p, mv_y_hat):
    d = p["mv_dec"]
    h = H.lrelu(conv_transpose2x_apply(d["t1"], mv_y_hat), 0.1)
    h = H.res_block_apply(d["res"], h, start_from_relu=False)
    h = gdn_apply(d["gdn1"], h, inverse=True)
    h = conv_transpose2x_apply(d["t2"], h)
    h = gdn_apply(d["gdn2"], h, inverse=True)
    h = conv_transpose2x_apply(d["t3"], h)
    h = gdn_apply(d["gdn3"], h, inverse=True)
    return conv_transpose2x_apply(d["t4"], h)


def contextual_encoder(p, x, c1, c2, c3):
    e = p["ctx_enc"]
    h = conv_apply(e["c1"], torch.cat((x, c1), dim=1), stride=2, padding=1)
    h = gdn_apply(e["g1"], h)
    h = H.res_block_apply(e["r1"], torch.cat((h, c2), dim=1), slope=0.1,
                          start_from_relu=False, end_with_relu=True)
    h = conv_apply(e["c2"], h, stride=2, padding=1)
    h = gdn_apply(e["g2"], h)
    h = H.res_block_apply(e["r2"], torch.cat((h, c3), dim=1), slope=0.1,
                          start_from_relu=False, end_with_relu=True)
    h = conv_apply(e["c3"], h, stride=2, padding=1)
    h = gdn_apply(e["g3"], h)
    return conv_apply(e["c4"], h, stride=2, padding=1)


def contextual_decoder(p, y_hat, c2, c3):
    d = p["ctx_dec"]
    h = depth_to_space(conv_apply(d["up1"], y_hat, padding=1), 2)
    h = gdn_apply(d["g1"], h, inverse=True)
    h = depth_to_space(conv_apply(d["up2"], h, padding=1), 2)
    h = gdn_apply(d["g2"], h, inverse=True)
    h = H.res_block_apply(d["r1"], torch.cat((h, c3), dim=1), slope=0.1,
                          start_from_relu=False, end_with_relu=True)
    h = depth_to_space(conv_apply(d["up3"], h, padding=1), 2)
    h = gdn_apply(d["g3"], h, inverse=True)
    h = H.res_block_apply(d["r2"], torch.cat((h, c2), dim=1), slope=0.1,
                          start_from_relu=False, end_with_relu=True)
    return depth_to_space(conv_apply(d["up4"], h, padding=1), 2)


def temporal_prior_encoder(p, c1, c2, c3):
    t = p["temporal_prior"]
    h = gdn_apply(t["g1"], conv_apply(t["c1"], c1, stride=2, padding=1))
    h = gdn_apply(t["g2"], conv_apply(t["c2"], torch.cat((h, c2), dim=1),
                                      stride=2, padding=1))
    h = gdn_apply(t["g3"], conv_apply(t["c3"], torch.cat((h, c3), dim=1),
                                      stride=2, padding=1))
    return conv_apply(t["c4"], h, stride=2, padding=1)


def hyper_enc(p, y):
    he = p["hyper_enc"]
    h = H.lrelu(conv_apply(he[0], y, padding=1), 0.01)
    h = H.lrelu(conv_apply(he[1], h, stride=2, padding=1), 0.01)
    return conv_apply(he[2], h, stride=2, padding=1)


def hyper_dec(p, z_hat):
    hd = p["hyper_dec"]
    h = H.lrelu(conv_transpose2x_apply(hd[0], z_hat), 0.01)
    h = H.lrelu(conv_transpose2x_apply(hd[1], h), 0.01)
    return conv_apply(hd[2], h, padding=1)


def entropy_parameter(p, params):
    ep = p["entropy_parameter"]
    h = H.lrelu(conv_apply(ep[0], params, padding=1), 0.01)
    h = H.lrelu(conv_apply(ep[1], h, padding=1), 0.01)
    return conv_apply(ep[2], h, padding=1)


def recon_generation(p, res, c1):
    """The decoded residual feature is the first operand of the
    concatenation, as in the reference.  Returns (feature, x_hat)."""
    r = p["recon"]
    h = conv_apply(r["first"], torch.cat((res, c1), dim=1), padding=1)
    h = H.res_block_apply(r["res1"], h)
    h = H.res_block_apply(r["res2"], h)
    x_hat = conv_apply(r["head"], h, padding=1)
    return h, torch.clamp(x_hat, 0.0, 1.0)


def _halves(params):
    c = params.shape[1] // 2
    return params[:, :c], params[:, c:]


# ---------------------------------------------------------------------------
# stages (shared = evaluated by both encoder and decoder); the motion
# compensation is HEM's
# ---------------------------------------------------------------------------

def _stage_mv_enc(p, x, ref_frame):
    """Encoder-only: flow -> motion latent, rounded motion z."""
    est_mv = H.hem_spynet_apply(p["optic_flow"], x, ref_frame)
    mv_y = mv_encoder(p, est_mv)
    mv_z = mv_prior_enc(p, mv_y)
    mv_z_hat, mv_z_int8 = F.round_and_to_int8(mv_z)
    return mv_y, mv_z_hat.to(x.dtype), mv_z_int8


def _stage_mv_params(p, mv_z_hat):
    """Shared: motion z -> the motion latent's (scales, means)."""
    return _halves(mv_prior_dec(p, mv_z_hat))


def _stage_quantize_dense(y, scales, means, cfg):
    """Encoder-only: a latent quantized whole (y - means rounded in
    float32, clipped to [-128, 127]) and packed (symbol << 8) + CDF index
    as int16; y_hat = the symbols in y's dtype + means."""
    y_q = F.quantize_dense(y, means)
    idx = _stage_index_dense(scales, cfg)
    packed = (y_q.to(torch.int32) * 256 + idx.to(torch.int32)) \
        .to(torch.int16)
    return packed, y_q.to(y.dtype) + means


def _stage_index_dense(scales, cfg):
    """Shared: a latent's CDF indexes."""
    smin, smax, lsm, recip = cfg
    idx, _ = F.build_index_dec(scales, smin, smax, lsm, recip, None)
    return idx


def _stage_mv_dec(p, mv_y_hat):
    """Shared: motion latent -> flow."""
    return mv_decoder(p, mv_y_hat)


def _stage_ctx_enc(p, x, c1, c2, c3):
    """Encoder-only: frame + contexts -> y, rounded z."""
    y = contextual_encoder(p, x, c1, c2, c3)
    z = hyper_enc(p, y)
    z_hat, z_int8 = F.round_and_to_int8(z)
    return y, z_hat.to(x.dtype), z_int8


def _stage_y_params(p, z_hat, c1, c2, c3):
    """Shared: z + the temporal prior of the contexts -> y's (scales,
    means)."""
    hier = hyper_dec(p, z_hat)
    temporal = temporal_prior_encoder(p, c1, c2, c3)
    return _halves(entropy_parameter(p, torch.cat((temporal, hier), dim=1)))


def _stage_recon(p, y_hat, c1, c2, c3):
    """Shared: y_hat + contexts -> (next feature, x_hat)."""
    res = contextual_decoder(p, y_hat, c2, c3)
    return recon_generation(p, res, c1)


# ---------------------------------------------------------------------------
# host orchestrator
# ---------------------------------------------------------------------------

class DMCTCM:
    """DCVC-TCM P-frame codec; its references are (ref_frame,
    ref_feature), see the module docstring.

    device: torch device (default cuda; without CUDA that raises, and the
    CPU runs only when asked for).  dtype: float32 or bfloat16
    activations.  `transfers` counts the host-EC copies: "d2h" the
    fetches the host waits for, "h2d" the uploads."""

    def __init__(self, device="cuda", dtype=torch.float32):
        C.check_dtype(dtype, "DMCTCM")
        self.device = C.resolve_device(device)
        self.dtype = dtype
        self.params = None
        self.entropy_coder = None
        self.bit_estimator_z = BitEstimator(1, CH_N, support=50)
        self.bit_estimator_z_mv = BitEstimator(1, CH_N, support=50)
        self.gaussian_encoder = GaussianEncoder(
            distribution="laplace", scale_min=0.01, scale_max=64.0,
            scale_levels=256, support=50)
        self.transfers = {"d2h": 0, "h2d": 0}
        self._cfg = gaussian_cfg(self.gaussian_encoder)

    def init_params(self, seed=0):
        """The port's random init (torch.Generator), not the JAX
        package's draws."""
        gen = torch.Generator().manual_seed(seed)
        self.load_params(dmc_tcm_init(gen))
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

    def _decode_y(self, scales, means):
        idx = _stage_index_dense(scales, self._cfg)
        y_q = C.decode_y_host(self.gaussian_encoder,
                              C.fetch_async(C.index_buf(idx)), idx.shape,
                              self.device, self.dtype, self.transfers)
        return y_q + means

    def compress(self, x, ref_frame, ref_feature):
        """x and ref_frame: (1, H, W, 3) NHWC in [0, 1], H and W multiples
        of 64; ref_feature: the previous frame's feature (NCHW) or None.
        Returns {"bit_stream": bytes, "x_hat": NHWC, "feature": NCHW}."""
        p = self.params
        x = C.frame_to_nchw(x, self.device, self.dtype)
        ref_frame = C.frame_to_nchw(ref_frame, self.device, self.dtype)
        mv_y, mv_z_hat, mv_z_int8 = _stage_mv_enc(p, x, ref_frame)
        mv_packed, mv_y_hat = _stage_quantize_dense(
            mv_y, *_stage_mv_params(p, mv_z_hat), self._cfg)
        mv_hat = _stage_mv_dec(p, mv_y_hat)
        c1, c2, c3, _ = _stage_motion_comp(p, mv_hat, ref_frame, ref_feature)
        y, z_hat, z_int8 = _stage_ctx_enc(p, x, c1, c2, c3)
        y_packed, y_hat = _stage_quantize_dense(
            y, *_stage_y_params(p, z_hat, c1, c2, c3), self._cfg)
        planes = [mv_z_int8, mv_packed, z_int8, y_packed]
        fetch = C.fetch_async(C.pack_planes(planes))
        # the device reconstructs while the host codes
        feature, x_hat = _stage_recon(p, y_hat, c1, c2, c3)
        x_hat = C.frame_to_nhwc(x_hat)
        buf = fetch()
        self.transfers["d2h"] += 1
        coders = [(self.bit_estimator_z_mv, 0), None,
                  (self.bit_estimator_z, 0), None]
        stream = C.code_host_ordered(
            self.entropy_coder, self.gaussian_encoder, buf,
            [(pl.numel(), c) for pl, c in zip(planes, coders)])
        return {"bit_stream": stream, "x_hat": x_hat, "feature": feature}

    def decompress(self, ref_frame, ref_feature, bit_stream, height, width):
        """Returns {"x_hat": NHWC (1, H, W, 3), "feature": NCHW}.  A
        stream that is not exactly the frame's symbols raises
        ValueError."""
        p = self.params
        zh, zw = C.get_downsampled_shape(height, width, 64)
        self.entropy_coder.set_stream(bit_stream)
        mv_z_hat = C.decode_z_host(self.bit_estimator_z_mv, 0, zh, zw,
                                   self.device, self.dtype, self.transfers)
        ref_frame = C.frame_to_nchw(ref_frame, self.device, self.dtype)
        mv_y_hat = self._decode_y(*_stage_mv_params(p, mv_z_hat))
        mv_hat = _stage_mv_dec(p, mv_y_hat)
        c1, c2, c3, _ = _stage_motion_comp(p, mv_hat, ref_frame, ref_feature)
        z_hat = C.decode_z_host(self.bit_estimator_z, 0, zh, zw, self.device,
                                self.dtype, self.transfers)
        y_hat = self._decode_y(*_stage_y_params(p, z_hat, c1, c2, c3))
        self.entropy_coder.check_stream_end()
        feature, x_hat = _stage_recon(p, y_hat, c1, c2, c3)
        return {"x_hat": C.frame_to_nhwc(x_hat), "feature": feature}
