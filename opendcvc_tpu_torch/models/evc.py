"""EVC — the real-time scalable image codec (NCHW), host EC.

Counterpart of the JAX package's `models/evc.py`: a hyperprior image codec
on the EVC-generation blocks (`layers/blocks_evc.py`), with a dual prior
(two-pass checkerboard coding, `make_pass_stages(cfg, 2)`), eight width
variants of its encoder and decoder (EVC_{LL,LM,LS,ML,SL,MM,MS,SS}), a
continuous rate max(q_basic, 0.5) x q_scale, and ScalableEVC, whose
enc_num small encoders are summed cumulatively up to the chosen rate.  y
(N = 192 at 1/16) is coded against 256 Gaussian scale levels in [0.11,
64], z (N at 1/64) against a single-bank factorized prior (support 50):
IntraNoAR's pair.

One host stream a frame, in the JAX package's order: z, then y pass 0,
then y pass 1.  The encoder copies the three planes to the host in one
copy while the device reconstructs; the decoder decodes z, then fetches
each pass's CDF indexes and uploads its symbols.

The rate multiplier `_curr_q` is one float32 product max(q_basic, 0.5) x
q_scale (q_scale taken as a float32), cast to the activations' dtype, on
both sides.  The JAX package's encoder computes it so; its decoder rounds
q_scale to bfloat16 first and multiplies in bfloat16, so in bfloat16 with
a q_basic other than ones the JAX decoder does not rebuild its encoder's
x_hat (ROADMAP Queue 3); the port's decoder does.

dtype: EVC's `init_params` casts every float32 leaf to `dtype`, as the
JAX package's does; ScalableEVC's casts nothing, so a bfloat16
ScalableEVC keeps float32 parameters, and then, as in the JAX package,
its encoder's y (divided by a float32 rate multiplier, whose q_scale is
rounded to the activations' dtype first) and everything computed from y
are float32, the hyperprior bfloat16, and x_hat float32.  The port's
decoder computes its y planes in the encoder's dtype (`y_dtype`), so it
rebuilds the encoder's x_hat; the JAX decoder computes them in bfloat16
and does not.
"""

import numpy as np
import torch

from ..entropy.coder import EntropyCoder
from ..entropy.models import (BitEstimator, GaussianEncoder,
                              bit_estimator_init)
from ..layers import blocks_evc as E
from ..layers.blocks import conv_apply, conv_init
from ..ops import fused as F
from ..utils.params import cast_floating, to_device
from ..utils.transfer import fetch_async
from . import common as C
from .dmci_fm import gaussian_cfg as _fold_index_cfg
from .prior_stages import make_pass_stages


# ---------------------------------------------------------------------------
# sub-networks
# ---------------------------------------------------------------------------

def enc_init(gen, channels, in_ch=3):
    c2, c4, c8, c16 = channels
    return {
        "rbs1": E.res_block_stride_init(gen, in_ch, c2),
        "dcb1": E.dcb_init(gen, c2, c2),
        "rbs2": E.res_block_stride_init(gen, c2, c4),
        "dcb2": E.dcb_init(gen, c4, c4),
        "rbs3": E.res_block_stride_init(gen, c4, c8),
        "dcb3": E.dcb_init(gen, c8, c8),
        "down": conv_init(gen, c8, c16, 3),
    }


def enc_apply(p, x):
    h = E.res_block_stride_apply(p["rbs1"], x)
    h = E.dcb_apply(p["dcb1"], h)
    h = E.res_block_stride_apply(p["rbs2"], h)
    h = E.dcb_apply(p["dcb2"], h)
    h = E.res_block_stride_apply(p["rbs3"], h)
    h = E.dcb_apply(p["dcb3"], h)
    return conv_apply(p["down"], h, stride=2, padding=1)


def dec_init(gen, channels, out_ch=3):
    c2, c4, c8, c16 = channels
    return {
        "dcb1": E.dcb_init(gen, c16, c16),
        "rbu1": E.res_block_upsample_init(gen, c16, c8),
        "dcb2": E.dcb_init(gen, c8, c8),
        "rbu2": E.res_block_upsample_init(gen, c8, c4),
        "dcb3": E.dcb_init(gen, c4, c4),
        "rbu3": E.res_block_upsample_init(gen, c4, c2),
        "dcb4": E.dcb_init(gen, c2, c2),
        "subpel": E.subpel1x1_init(gen, c2, out_ch),
    }


def dec_apply(p, y):
    h = E.dcb_apply(p["dcb1"], y)
    h = E.res_block_upsample_apply(p["rbu1"], h)
    h = E.dcb_apply(p["dcb2"], h)
    h = E.res_block_upsample_apply(p["rbu2"], h)
    h = E.dcb_apply(p["dcb3"], h)
    h = E.res_block_upsample_apply(p["rbu3"], h)
    h = E.dcb_apply(p["dcb4"], h)
    return E.subpel1x1_apply(p["subpel"], h)


def hyper_init(gen, N):
    return {
        "he_dcb": E.hp_dcb_init(gen, N, N),
        "he_c1": conv_init(gen, N, N, 3),
        "he_c2": conv_init(gen, N, N, 3),
        "hd_up1": E.hp_dcb_upsample_init(gen, N, N),
        "hd_up2": E.hp_dcb_upsample_init(gen, N, N),
        "hd_dcb": E.hp_dcb_init(gen, N, N),
        "fusion1": E.hp_dcb_init(gen, N, N * 2),
        "fusion2": E.hp_dcb_init(gen, N * 2, N * 3),
    }


def hyper_enc_apply(p, y):
    h = E.hp_dcb_apply(p["he_dcb"], y)
    h = E.lrelu(conv_apply(p["he_c1"], h, stride=2, padding=1), 0.01)
    return conv_apply(p["he_c2"], h, stride=2, padding=1)


def hyper_dec_fusion_apply(p, z_hat):
    h = E.hp_dcb_upsample_apply(p["hd_up1"], z_hat)
    h = E.hp_dcb_upsample_apply(p["hd_up2"], h)
    h = E.hp_dcb_apply(p["hd_dcb"], h)
    h = E.hp_dcb_apply(p["fusion1"], h)
    return E.hp_dcb_apply(p["fusion2"], h)


def dual_prior_init(gen, N):
    return [E.hp_dcb_init(gen, N * 4, N * 3),
            E.hp_dcb_init(gen, N * 3, N * 2),
            E.hp_dcb_init(gen, N * 2, N * 2)]


def dual_prior_apply(plist, x):
    for p in plist:
        x = E.hp_dcb_apply(p, x)
    return x


ENC_DEC_CHANNELS = {
    "L": [192, 192, 192, 192],
    "M": [128, 128, 192, 192],
    "S": [64, 64, 128, 192],
}


def evc_init(gen, N=192, enc_width="L", dec_width="L", anchor_num=4,
             enc_num=1):
    """The JAX package's tree: one encoder "enc" of enc_width, or, with
    enc_num > 1, a list "encs" of enc_num "S" encoders."""
    p = {}
    if enc_num > 1:
        p["encs"] = [enc_init(gen, ENC_DEC_CHANNELS["S"])
                     for _ in range(enc_num)]
    else:
        p["enc"] = enc_init(gen, ENC_DEC_CHANNELS[enc_width])
    p["dec"] = dec_init(gen, ENC_DEC_CHANNELS[dec_width])
    p["hyper"] = hyper_init(gen, N)
    p["y_spatial_prior"] = dual_prior_init(gen, N)
    p["q_basic"] = torch.ones((N,))
    p["q_scale"] = torch.ones((anchor_num,))
    p["bit_estimator_z"] = bit_estimator_init(gen, 1, N)
    return p


# ---------------------------------------------------------------------------
# stages (shared = evaluated by both encoder and decoder); the checkerboard
# passes are `make_pass_stages(cfg, 2)`'s
# ---------------------------------------------------------------------------

def _curr_q(p, q_scale, dtype):
    """max(q_basic, 0.5) x q_scale as one float32 product (q_scale taken
    as a float32), cast to `dtype`, as (1, N, 1, 1)."""
    q = torch.clamp_min(p["q_basic"].float(), 0.5) \
        * float(np.float32(q_scale))
    return q[None, :, None, None].to(dtype)


def _stage_enc_front(p, x, q_scale):
    """Encoder-only: frame -> y / q, rounded z."""
    y = enc_apply(p["enc"], x) / _curr_q(p, q_scale, x.dtype)
    z = hyper_enc_apply(p["hyper"], y)
    z_hat, z_int8 = F.round_and_to_int8(z)
    return y, z_hat.to(x.dtype), z_int8


def _stage_prior(p, z_hat):
    """Shared: z -> (q_step clamped >= 0.5, scales, means)."""
    params = hyper_dec_fusion_apply(p["hyper"], z_hat)
    c = params.shape[1] // 3
    q_step = torch.clamp_min(params[:, :c], 0.5)
    return q_step, params[:, c:2 * c], params[:, 2 * c:]


def _stage_spatial(p, y_hat_0, means, scales, q_step):
    """Shared: the dual prior's second pass.  Its output's channel
    quarters are (scales_0, means_0, scales_1, means_1), regrouped into
    full-width (scales, means)."""
    cat = torch.cat((y_hat_0, means, scales, q_step), dim=1)
    out = dual_prior_apply(p["y_spatial_prior"], cat)
    q = out.shape[1] // 4
    scales1 = torch.cat((out[:, :q], out[:, 2 * q:3 * q]), dim=1)
    means1 = torch.cat((out[:, q:2 * q], out[:, 3 * q:]), dim=1)
    return scales1, means1


def _stage_recon(p, y_hat_0, y_hat_1, q_step, q_scale):
    """Shared: the two passes' y_hat -> the frame in [0, 1]."""
    y_hat = (y_hat_0 + y_hat_1) * q_step \
        * _curr_q(p, q_scale, y_hat_0.dtype)
    return torch.clamp(dec_apply(p["dec"], y_hat), 0.0, 1.0)


# ---------------------------------------------------------------------------
# host orchestrator
# ---------------------------------------------------------------------------

class EVC:
    """Base EVC; the width classes pick the encoder's and decoder's
    channel plans.

    device: torch device (default cuda; without CUDA that raises, and the
    CPU runs only when asked for).  dtype: float32 or bfloat16."""

    enc_width = "L"
    dec_width = "L"

    def __init__(self, device="cuda", N=192, anchor_num=4,
                 dtype=torch.float32):
        C.check_dtype(dtype, type(self).__name__)
        self.device = C.resolve_device(device)
        self.N = N
        self.anchor_num = anchor_num
        self.dtype = dtype
        self.params = None
        self.entropy_coder = None
        self.bit_estimator_z = BitEstimator(1, N, support=50)
        self.gaussian_encoder = GaussianEncoder(
            distribution="gaussian", scale_min=0.11, scale_max=64.0,
            scale_levels=256, support=50)
        self._stages = make_pass_stages(
            _fold_index_cfg(self.gaussian_encoder), 2)

    def init_params(self, seed=0):
        """The port's random init (torch.Generator), not the JAX
        package's draws; float32 leaves cast to `dtype`."""
        gen = torch.Generator().manual_seed(seed)
        self.load_params(cast_floating(
            evc_init(gen, self.N, self.enc_width, self.dec_width,
                     self.anchor_num), self.dtype))
        return self.params

    def load_params(self, params):
        self.params = to_device(params, self.device)

    def update(self):
        """A new host coder with the Gaussian scale rows and z's rows
        registered (groups 0 and 1)."""
        self.entropy_coder = EntropyCoder()
        self.gaussian_encoder.update(self.entropy_coder)
        self.bit_estimator_z.update(self.params["bit_estimator_z"],
                                    self.entropy_coder)

    def get_q_scales(self):
        return self.params["q_scale"].detach().float().cpu().numpy() \
            .reshape(-1)

    @property
    def y_dtype(self):
        """The dtype of the encoder's y and of the y planes computed from
        it: the activations' dtype."""
        return self.dtype

    def _enc_front(self, x, q_scale):
        return _stage_enc_front(self.params, x, q_scale)

    def _decode_y(self, idx):
        return C.decode_y_host(self.gaussian_encoder,
                               fetch_async(C.index_buf(idx)), idx.shape,
                               self.device, self.y_dtype)

    def compress(self, x, q_scale):
        """x: (1, H, W, 3) NHWC in [0, 1], H and W multiples of 64.
        Returns {"bit_stream": bytes, "x_hat": NHWC tensor}."""
        p, st = self.params, self._stages
        x = C.frame_to_nchw(x, self.device, self.dtype)
        y, z_hat, z_int8 = self._enc_front(x, q_scale)
        q_step, scales, means = _stage_prior(p, z_hat)
        y_div, packed0, y_hat_0 = st["enc_pass0_qstep"](y, q_step, scales,
                                                        means)
        scales1, means1 = _stage_spatial(p, y_hat_0, means, scales, q_step)
        packed1, y_hat_1 = st["enc_pass_k"](y_div, scales1, means1, None, 1)
        fetch = fetch_async(C.pack_host([z_int8], [packed0, packed1]))
        # the device reconstructs while the host codes
        x_hat = C.frame_to_nhwc(_stage_recon(p, y_hat_0, y_hat_1, q_step,
                                             q_scale))
        buf = fetch()
        stream = C.code_host(self.entropy_coder, [(self.bit_estimator_z, 0)],
                             self.gaussian_encoder, buf, [z_int8.numel()],
                             [packed0.numel(), packed1.numel()])
        return {"bit_stream": stream, "x_hat": x_hat}

    def decompress(self, bit_stream, height, width, q_scale):
        """Returns {"x_hat": NHWC (1, H, W, 3)}.  A stream that is not
        exactly the frame's symbols raises ValueError."""
        p, st = self.params, self._stages
        self.entropy_coder.set_stream(bit_stream)
        zh, zw = C.get_downsampled_shape(height, width, 64)
        z_hat = C.decode_z_host(self.bit_estimator_z, 0, zh, zw, self.device,
                                self.dtype)
        q_step, scales, means = _stage_prior(p, z_hat)
        y_hat_0 = st["dec_restore_acc"](
            self._decode_y(st["dec_index_k"](scales, 0)), means, None, 0)
        scales1, means1 = _stage_spatial(p, y_hat_0, means, scales, q_step)
        y_hat_1 = st["dec_restore_acc"](
            self._decode_y(st["dec_index_k"](scales1, 1)), means1, None, 1)
        self.entropy_coder.check_stream_end()
        return {"x_hat": C.frame_to_nhwc(_stage_recon(
            p, y_hat_0, y_hat_1, q_step, q_scale))}


class EVC_LL(EVC):
    enc_width, dec_width = "L", "L"


class EVC_LM(EVC):
    enc_width, dec_width = "L", "M"


class EVC_LS(EVC):
    enc_width, dec_width = "L", "S"


class EVC_ML(EVC):
    enc_width, dec_width = "M", "L"


class EVC_SL(EVC):
    enc_width, dec_width = "S", "L"


class EVC_MM(EVC):
    enc_width, dec_width = "M", "M"


class EVC_MS(EVC):
    enc_width, dec_width = "M", "S"


class EVC_SS(EVC):
    enc_width, dec_width = "S", "S"


class ScalableEVC(EVC):
    """The mask-decay scalable encoder: enc_num small ("S") encoders whose
    latents are summed cumulatively, encoder 0 first; set_rate picks how
    many (rate + 1) run.  The decoder is EVC's ("L")."""

    enc_width, dec_width = "S", "L"

    def __init__(self, device="cuda", N=192, anchor_num=4, enc_num=4,
                 dtype=torch.float32):
        super().__init__(device, N, anchor_num, dtype)
        self.enc_num = enc_num
        self.rate = 0

    def init_params(self, seed=0):
        """The port's random init; nothing is cast (see the module
        docstring)."""
        gen = torch.Generator().manual_seed(seed)
        self.load_params(evc_init(gen, self.N, "S", "L", self.anchor_num,
                                  enc_num=self.enc_num))
        return self.params

    def set_rate(self, rate):
        assert 0 <= rate < self.enc_num
        self.rate = rate

    @property
    def y_dtype(self):
        """y / q with q of q_basic's dtype: float32 when the parameters
        are float32, whatever the activations' dtype."""
        return torch.promote_types(self.dtype, self.params["q_basic"].dtype)

    def _enc_front(self, x, q_scale):
        """The cumulative latent of the first rate + 1 encoders, divided by
        max(q_basic, 0.5) x q_scale, q_scale rounded to x's dtype first
        (the JAX package's ScalableEVC); then the rounded z in x's
        dtype."""
        p = self.params
        y = enc_apply(p["encs"][0], x)
        for e in p["encs"][1:self.rate + 1]:
            y = y + enc_apply(e, x)
        qs = torch.tensor(np.float32(q_scale), device=self.device) \
            .to(x.dtype)
        q = torch.clamp_min(p["q_basic"], 0.5) * qs
        y = y / q[None, :, None, None]
        z = hyper_enc_apply(p["hyper"], y)
        z_hat, z_int8 = F.round_and_to_int8(z)
        return y, z_hat.to(x.dtype), z_int8


Scale_EVC_SS = ScalableEVC
Scale_EVC_SL = ScalableEVC
