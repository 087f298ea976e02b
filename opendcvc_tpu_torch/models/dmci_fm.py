"""DMCIFM — the DCVC-FM intra codec (NCHW), host EC.

Counterpart of the JAX package's `models/dmci_fm.py`: gated DCB3
encoder/decoder, y N = 256 at 1/16, z 128 at 1/64, a four-pass quadtree
prior with a reduction conv and DCB2 adaptors, a UNet refinement head,
QP-banked q_scale vectors (64 x 128) and a QP-banked factorized prior for
z (support 50).  y is coded against 256 Gaussian scale levels in [0.11,
64].  The host C++ rANS coder codes the frame (the JAX package's default
path): the encoder copies z and the four packed planes to the host in one
copy while the device runs the reconstruction; the decoder decodes z on
the host, then fetches each pass's CDF indexes and uploads its symbols.
The streams are the JAX package's, byte for byte.

Not ported yet, and refused rather than run another way: device EC
(`device_ec=True` or OPENDCVC_TPU_DEVICE_EC) and any dtype but float32
(ROADMAP, "FM device EC" and "FM bfloat16").
"""

import numpy as np
import torch

from ..entropy.coder import EntropyCoder
from ..entropy.models import (BitEstimator, GaussianEncoder,
                              bit_estimator_init)
from ..layers import blocks_fm as FM
from ..layers.blocks import conv_apply, conv_init
from ..ops import fused as F
from ..utils.common import env_flag
from ..utils.params import to_device
from . import common as C
from .prior_stages import make_pass_stages

QP_NUM = 64
N = 256       # y channels
Z_CH = 128    # z channels


def refuse_unported(device_ec, dtype, codec):
    """Raise NotImplementedError for what the port's FM codecs do not run
    yet: device EC (asked for, or OPENDCVC_TPU_DEVICE_EC set, which the
    JAX package's FM codecs read) and a dtype other than float32."""
    if device_ec or env_flag("OPENDCVC_TPU_DEVICE_EC"):
        raise NotImplementedError(
            f"{codec}: FM device EC is not ported (ROADMAP Queue 1, 'FM "
            f"device EC'); unset OPENDCVC_TPU_DEVICE_EC for host EC")
    if dtype != torch.float32:
        raise NotImplementedError(
            f"{codec}: dtype {dtype} is not ported (ROADMAP Queue 1, 'FM "
            f"bfloat16'); FM runs in float32")


def gaussian_cfg(ge):
    """The index-building constants of a GaussianEncoder, as
    make_pass_stages takes them."""
    return (ge.SCALE_MIN, ge.SCALE_MAX, float(np.log(ge.SCALE_MIN)),
            ge.log_step_recip)


def dmci_fm_init(gen):
    p = {}
    p["enc1"] = [FM.rbs2_init(gen, 3, 128), FM.dcb3_init(gen, 128, 128)]
    p["enc2"] = {
        "rbs1": FM.rbs2_init(gen, 128, 192),
        "dcb1": FM.dcb3_init(gen, 192, 192),
        "rbs2": FM.rbs2_init(gen, 192, N),
        "dcb2": FM.dcb3_init(gen, N, N),
        "down": conv_init(gen, N, N, 3),
    }
    p["hyper_enc"] = {
        "dcb": FM.dcb4_init(gen, N, Z_CH),
        "c1": conv_init(gen, Z_CH, Z_CH, 3),
        "c2": conv_init(gen, Z_CH, Z_CH, 3),
    }
    p["hyper_dec"] = [FM.res_block_upsample_init(gen, Z_CH, Z_CH),
                      FM.res_block_upsample_init(gen, Z_CH, Z_CH),
                      FM.dcb4_init(gen, Z_CH, N)]
    p["y_fusion"] = [FM.dcb4_init(gen, N, N * 2),
                     FM.dcb4_init(gen, N * 2, N * 2 + 2)]
    p["reduction"] = conv_init(gen, N * 2 + 2, N, 1)
    for k in (1, 2, 3):
        p[f"adaptor_{k}"] = FM.dcb2_init(gen, N * 2, N * 2)
    p["y_spatial_prior"] = [FM.dcb2_init(gen, N * 2, N * 2)
                            for _ in range(3)]
    p["dec1"] = {
        "dcb1": FM.dcb3_init(gen, N, N),
        "rbu1": FM.res_block_upsample_init(gen, N, N),
        "dcb2": FM.dcb3_init(gen, N, N),
        "rbu2": FM.res_block_upsample_init(gen, N, 192),
        "dcb3": FM.dcb3_init(gen, 192, 192),
        "rbu3": FM.res_block_upsample_init(gen, 192, 128),
    }
    p["dec2"] = {
        "dcb": FM.dcb3_init(gen, 128, 128),
        "rbu": FM.res_block_upsample_init(gen, 128, 16),
    }
    p["refine_unet"] = FM.unet_init(gen, 16, 16)
    p["refine_head"] = conv_init(gen, 16, 3, 3)
    p["q_scale_enc"] = torch.ones((QP_NUM, 128))
    p["q_scale_dec"] = torch.ones((QP_NUM, 128))
    p["bit_estimator_z"] = bit_estimator_init(gen, QP_NUM, Z_CH)
    return p


# ---------------------------------------------------------------------------
# sub-networks and stages
# ---------------------------------------------------------------------------

def intra_encoder(p, x, q_enc):
    out = FM.rbs2_apply(p["enc1"][0], x)
    out = FM.dcb3_apply(p["enc1"][1], out) * q_enc
    e = p["enc2"]
    out = FM.dcb3_apply(e["dcb1"], FM.rbs2_apply(e["rbs1"], out))
    out = FM.dcb3_apply(e["dcb2"], FM.rbs2_apply(e["rbs2"], out))
    return conv_apply(e["down"], out, stride=2, padding=1)


def intra_decoder(p, y_hat, q_dec):
    d = p["dec1"]
    out = FM.dcb3_apply(d["dcb1"], y_hat)
    out = FM.dcb3_apply(d["dcb2"], FM.res_block_upsample_apply(d["rbu1"],
                                                               out))
    out = FM.dcb3_apply(d["dcb3"], FM.res_block_upsample_apply(d["rbu2"],
                                                               out))
    out = FM.res_block_upsample_apply(d["rbu3"], out) * q_dec
    out = FM.dcb3_apply(p["dec2"]["dcb"], out)
    return FM.res_block_upsample_apply(p["dec2"]["rbu"], out)


def refine(p, x):
    return conv_apply(p["refine_head"], FM.unet_apply(p["refine_unet"], x),
                      padding=1)


def hyper_enc_apply(hp, y_pad):
    out = FM.dcb4_apply(hp["dcb"], y_pad)
    out = FM.lrelu(conv_apply(hp["c1"], out, stride=2, padding=1), 0.01)
    return conv_apply(hp["c2"], out, stride=2, padding=1)


def _stage_enc_front(p, x, qp):
    """Encoder-only: frame -> y, rounded z."""
    y = intra_encoder(p, x, C.q_vec(p["q_scale_enc"], qp, x.dtype))
    z = hyper_enc_apply(p["hyper_enc"], C.pad_for_y(y))
    z_hat, z_int8 = F.round_and_to_int8(z)
    return y, z_hat.to(x.dtype), z_int8


def _stage_prior(p, z_hat, y_h, y_w):
    """Shared: z_hat -> separated prior + reduced context."""
    params = FM.res_block_upsample_apply(p["hyper_dec"][0], z_hat)
    params = FM.res_block_upsample_apply(p["hyper_dec"][1], params)
    params = FM.dcb4_apply(p["hyper_dec"][2], params)
    params = FM.dcb4_apply(p["y_fusion"][0], params)
    params = FM.dcb4_apply(p["y_fusion"][1], params)
    params = params[:, :, :y_h, :y_w]
    q_enc, q_dec, scales, means = C.separate_prior_image(params)
    reduced = conv_apply(p["reduction"], params)
    return q_enc, q_dec, scales, means, reduced


def _stage_spatial(p, k, y_hat_so_far, reduced):
    """Shared: spatial-prior pass k in {1, 2, 3} -> (scales, means)."""
    h = FM.dcb2_apply(p[f"adaptor_{k}"],
                      torch.cat((y_hat_so_far, reduced), dim=1))
    for sp in p["y_spatial_prior"]:
        h = FM.dcb2_apply(sp, h)
    c = h.shape[1] // 2
    return h[:, :c], h[:, c:]


def _stage_recon(p, y_hat_so_far, q_dec_prior, qp):
    """Shared: final dequant + intra decoder + refinement + clamp."""
    y_hat = y_hat_so_far * q_dec_prior
    out = intra_decoder(p, y_hat, C.q_vec(p["q_scale_dec"], qp, y_hat.dtype))
    return torch.clamp(refine(p, out), 0.0, 1.0)


def encode_stages_ifm(p, st, x, qp):
    """Frame (NCHW) -> (x_hat NCHW, z int8, [packed y0..y3 int16]); st
    the codec's make_pass_stages(cfg, 4)."""
    y, z_hat, z_int8 = _stage_enc_front(p, x, qp)
    q_enc, q_dec_prior, scales, means, reduced = _stage_prior(
        p, z_hat, y.shape[2], y.shape[3])
    y_s = y * q_enc
    packed, so_far = [], None
    for k in range(4):
        if k > 0:
            scales, means = _stage_spatial(p, k, so_far, reduced)
        pk, so_far = st["enc_pass_k"](y_s, scales, means, so_far, k)
        packed.append(pk)
    return _stage_recon(p, so_far, q_dec_prior, qp), z_int8, packed


# ---------------------------------------------------------------------------
# host orchestrator
# ---------------------------------------------------------------------------

class DMCIFM:
    """DCVC-FM intra codec on the host C++ rANS coder.

    device: torch device (default cuda; without CUDA that raises, and the
    CPU runs only when asked for).  device_ec and a dtype other than
    float32 raise NotImplementedError (not ported yet), as does
    OPENDCVC_TPU_DEVICE_EC set in the environment.  `transfers` counts
    the host-EC path's copies: "d2h" the fetches the host waits for,
    "h2d" the uploads."""

    def __init__(self, device="cuda", device_ec=False, dtype=torch.float32):
        refuse_unported(device_ec, dtype, "DMCIFM")
        self.device = C.resolve_device(device)
        self.dtype = dtype
        self.params = None
        self.entropy_coder = None
        self.bit_estimator_z = BitEstimator(QP_NUM, Z_CH, support=50)
        self.gaussian_encoder = GaussianEncoder(
            distribution="gaussian", scale_min=0.11, scale_max=64.0,
            scale_levels=256, support=50)
        self.transfers = {"d2h": 0, "h2d": 0}
        self._stages = make_pass_stages(gaussian_cfg(self.gaussian_encoder),
                                        4)

    def init_params(self, seed=0):
        gen = torch.Generator().manual_seed(seed)
        self.params = to_device(dmci_fm_init(gen), self.device)
        return self.params

    def load_params(self, params):
        self.params = to_device(params, self.device)

    def update(self):
        """Register the CDF tables with a new host coder: group 0 the
        gaussian scale rows, group 1 the z rows by (qp, channel)."""
        self.entropy_coder = EntropyCoder()
        self.gaussian_encoder.update(self.entropy_coder)
        self.bit_estimator_z.update(self.params["bit_estimator_z"],
                                    self.entropy_coder)

    def compress(self, x, q_index):
        """x: (1, H, W, 3) NHWC in [0, 1], H and W multiples of 16.
        Returns {"bit_stream": bytes, "x_hat": NHWC tensor}."""
        qp = int(q_index)
        x = C.frame_to_nchw(x, self.device, self.dtype)
        x_hat, z_int8, packed = encode_stages_ifm(self.params, self._stages,
                                                  x, qp)
        fetch = C.fetch_async(C.pack_host([z_int8], packed))
        x_hat = C.frame_to_nhwc(x_hat)
        buf = fetch()
        self.transfers["d2h"] += 1
        stream = C.code_host(self.entropy_coder, [(self.bit_estimator_z, qp)],
                             self.gaussian_encoder, buf, [z_int8.numel()],
                             [pk.numel() for pk in packed])
        return {"bit_stream": stream, "x_hat": x_hat}

    def decompress(self, bit_stream, sps):
        """sps: {"height", "width", "qp"}.  Returns {"x_hat": NHWC (1, H,
        W, 3)}.  A stream that is not exactly the frame's symbols raises
        ValueError."""
        p, st, qp = self.params, self._stages, int(sps["qp"])
        zh, zw = C.get_downsampled_shape(sps["height"], sps["width"], 64)
        y_h, y_w = C.get_downsampled_shape(sps["height"], sps["width"], 16)
        self.entropy_coder.set_stream(bit_stream)
        self.bit_estimator_z.decode_z((zh, zw), qp)
        z_hat = C.from_host_nhwc(self.bit_estimator_z.get_z((zh, zw),
                                                            np.int8),
                                 self.device, self.dtype)
        self.transfers["h2d"] += 1
        _, q_dec_prior, scales, means, reduced = _stage_prior(p, z_hat, y_h,
                                                              y_w)
        so_far = None
        for k in range(4):
            if k > 0:
                scales, means = _stage_spatial(p, k, so_far, reduced)
            idx = st["dec_index_k"](scales, k)
            y_q_r = C.decode_y_host(self.gaussian_encoder,
                                    C.fetch_async(C.index_buf(idx)),
                                    idx.shape, self.device, self.dtype,
                                    self.transfers)
            so_far = st["dec_restore_acc"](y_q_r, means, so_far, k)
        self.entropy_coder.check_stream_end()
        return {"x_hat": C.frame_to_nhwc(
            _stage_recon(p, so_far, q_dec_prior, qp))}
