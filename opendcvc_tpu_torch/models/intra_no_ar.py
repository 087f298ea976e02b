"""IntraNoAR — the HEM/DC-generation hyperprior image codec (NCHW), host EC.

Counterpart of the JAX package's `models/intra_no_ar.py`: residual-block
encoder and decoder towers (the decoder to 16 channels, then a UNet and a
3x3 head), five-conv hyper towers, a conv-stack prior fusion giving
(q_step, scales, means), two-pass checkerboard coding with a spatial
prior (`make_pass_stages(cfg, 2)`), and a continuous rate q_basic x
q_scale.  y (N = 192 at 1/16) is coded against 256 Gaussian scale levels
in [0.11, 64], z (N at 1/64) against a single-bank factorized prior
(support 50).

Entropy coding is host EC only, as in the JAX package: the encoder copies
z and the two packed y planes to the host in one copy while the device
reconstructs; the decoder decodes z, then fetches each pass's CDF indexes
and uploads its symbols.  Every stage both sides evaluate is one shared
function, so the decoder rebuilds the encoder's x_hat bit for bit; the
streams are the JAX package's, byte for byte.

dtype (float32 or bfloat16) is the activations' dtype: the parameters
stay as loaded (float32 from init, never cast), each convolution casts
its weights to its input's dtype, and the rate multiplier is computed in
float32 and cast once a frame, as in the JAX package.
"""

import numpy as np
import torch

from ..entropy.coder import EntropyCoder
from ..entropy.models import (BitEstimator, GaussianEncoder,
                              bit_estimator_init)
from ..layers import blocks_hem as H
from ..layers.blocks import conv_apply, conv_init
from ..ops import fused as F
from ..utils import trace
from ..utils.params import to_device
from ..utils.transfer import fetch_async
from . import common as C
from .dmc_hem import _stage_spatial as _spatial_stack
from .dmci_fm import gaussian_cfg
from .prior_stages import make_pass_stages


def intra_no_ar_init(gen, N=192, anchor_num=4):
    p = {}
    p["enc"] = H.enc_tower_init(gen, 3, N)
    p["dec"] = H.dec_tower_init(gen, 16, N)
    p["refine_unet"] = H.unet_init(gen, 16, 16)
    p["refine_head"] = conv_init(gen, 16, 3, 3)
    p["hyper_enc"] = H.hyper_enc_init(gen, N, N)
    p["hyper_dec"] = H.hyper_dec_init(gen, N, N, out_factor=2)
    p["y_prior_fusion"] = H.conv_lrelu_stack_init(
        gen, [N * 2, N * 3, N * 3, N * 3])
    p["y_spatial_prior"] = H.conv_lrelu_stack_init(
        gen, [N * 4, N * 3, N * 3, N * 2])
    p["q_basic"] = torch.ones((N,))
    p["q_scale"] = torch.ones((anchor_num,))
    p["bit_estimator_z"] = bit_estimator_init(gen, 1, N)
    return p


# ---------------------------------------------------------------------------
# stages (shared = evaluated by both encoder and decoder); the checkerboard
# passes are `make_pass_stages(cfg, 2)`'s
# ---------------------------------------------------------------------------

@trace.spanned("nn.enc_front")
def _stage_enc_front(p, x, q):
    """Encoder-only: frame -> y / q, rounded z."""
    y = H.enc_tower_apply(p["enc"], x) / q
    z = H.hyper_enc_apply(p["hyper_enc"], y)
    z_hat, z_int8 = F.round_and_to_int8(z)
    return y, z_hat.to(x.dtype), z_int8


@trace.spanned("nn.prior")
def _stage_prior(p, z_hat):
    """Shared: z -> (q_step clamped >= 0.5, scales, means)."""
    params = H.hyper_dec_apply(p["hyper_dec"], z_hat)
    fused = H.conv_lrelu_stack_apply(p["y_prior_fusion"], params)
    c = fused.shape[1] // 3
    q_step = torch.clamp_min(fused[:, :c], 0.5)
    return q_step, fused[:, c:2 * c], fused[:, 2 * c:]


def _stage_spatial(p, y_hat_0, means, scales, q_step):
    """Shared: pass 0's y_hat and the prior -> pass 1's (scales, means)."""
    return _spatial_stack(p["y_spatial_prior"], y_hat_0, means, scales,
                          q_step)


@trace.spanned("nn.recon")
def _stage_recon(p, y_hat, q):
    """Shared: y_hat -> the frame in [0, 1]."""
    out = H.dec_tower_apply(p["dec"], y_hat * q)
    out = H.unet_apply(p["refine_unet"], out)
    out = conv_apply(p["refine_head"], out, padding=1)
    return torch.clamp(out, 0.0, 1.0)


class IntraNoAR:
    """The HEM/DC-generation intra codec.

    device: torch device (default cuda; without CUDA that raises, and the
    CPU runs only when asked for).  dtype: float32 or bfloat16
    activations."""

    def __init__(self, device="cuda", N=192, anchor_num=4,
                 dtype=torch.float32):
        C.check_dtype(dtype, "IntraNoAR")
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
        self._stages = make_pass_stages(gaussian_cfg(self.gaussian_encoder),
                                        2)
        # finalize's outer multiplier (the JAX package's ones((), dtype))
        self._one = torch.ones((), dtype=dtype, device=self.device)

    def init_params(self, seed=0):
        """The port's random init (torch.Generator), not the JAX
        package's draws."""
        gen = torch.Generator().manual_seed(seed)
        self.load_params(intra_no_ar_init(gen, self.N, self.anchor_num))
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
        return self.params["q_scale"].detach().cpu().numpy().reshape(-1)

    def _q(self, q_scale):
        """max(q_basic, 0.5) * q_scale in float32 (q_scale taken as a
        float32), cast to the activations' dtype, as (1, N, 1, 1)."""
        q = torch.clamp_min(self.params["q_basic"], 0.5) \
            * float(np.float32(q_scale))
        return q[None, :, None, None].to(self.dtype)

    def _decode_y(self, idx):
        return C.decode_y_host(self.gaussian_encoder,
                               fetch_async(C.index_buf(idx)), idx.shape,
                               self.device, self.dtype)

    @trace.spanned("intra_no_ar.compress", 1)
    def compress(self, x, q_scale):
        """x: (1, H, W, 3) NHWC in [0, 1], H and W multiples of 64.
        Returns {"bit_stream": bytes, "x_hat": NHWC tensor}."""
        p, st = self.params, self._stages
        x = C.frame_to_nchw(x, self.device, self.dtype)
        q = self._q(q_scale)
        y, z_hat, z_int8 = _stage_enc_front(p, x, q)
        q_step, scales, means = _stage_prior(p, z_hat)
        y_div, packed0, y_hat_0 = st["enc_pass0_qstep"](y, q_step, scales,
                                                        means)
        scales1, means1 = _stage_spatial(p, y_hat_0, means, scales, q_step)
        packed1, y_hat_1 = st["enc_pass_k"](y_div, scales1, means1, None, 1)
        y_hat = st["finalize_qstep"](y_hat_0, y_hat_1, q_step, self._one)
        fetch = fetch_async(C.pack_host([z_int8], [packed0, packed1]))
        # the device reconstructs while the host codes
        x_hat = C.frame_to_nhwc(_stage_recon(p, y_hat, q))
        buf = fetch()
        stream = C.code_host(self.entropy_coder, [(self.bit_estimator_z, 0)],
                             self.gaussian_encoder, buf, [z_int8.numel()],
                             [packed0.numel(), packed1.numel()])
        return {"bit_stream": stream, "x_hat": x_hat}

    @trace.spanned("intra_no_ar.decompress", 1)
    def decompress(self, bit_stream, height, width, q_scale):
        """Returns {"x_hat": NHWC (1, H, W, 3)}.  A stream that is not
        exactly the frame's symbols raises ValueError."""
        p, st = self.params, self._stages
        q = self._q(q_scale)
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
        y_hat = st["finalize_qstep"](y_hat_0, y_hat_1, q_step, self._one)
        return {"x_hat": C.frame_to_nhwc(_stage_recon(p, y_hat, q))}
