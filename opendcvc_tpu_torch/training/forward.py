"""Differentiable training forwards of DCVC-RT (DMCI and DMC).

Counterpart of the JAX package's `training/forward.py`, cut to the RT
pair: straight-through rounding (or additive uniform noise) for the
quantizers, the factorized prior's and the conditional Gaussian's rate
terms (`entropy/models.py`, always float32), the same stages the codecs
run.  Frames are NHWC (B, H, W, 3) at the edges, as the codecs take them;
inside everything is NCHW, and the propagated feature DMC returns and
takes is NCHW, as the codecs' DPB holds it.  Rates are bits over the
frame's pixel count H * W, summed over the batch, as in the JAX package.
"""

import torch

from ..entropy.models import bit_estimator_bits, gaussian_bits
from ..layers import blocks as L
from ..models import common as C
from ..models import dmc as MV
from ..models import dmci as MI
from ..ops import fused as F


def ste_round(x):
    """Straight-through round (half to even, as jnp.round): the identity
    gradient."""
    return x + (torch.round(x) - x).detach()


def quant_noise(x, rng):
    """Additive uniform noise in [-0.5, 0.5): `rng` is a torch.Generator on
    x's device, or the noise tensor itself (a test passes JAX's draw)."""
    if isinstance(rng, torch.Tensor):
        return x + rng.to(x.dtype)
    noise = torch.rand(x.shape, generator=rng, device=x.device,
                       dtype=torch.float32) - 0.5
    return x + noise.to(x.dtype)


def _quant(x, rng, mode):
    if mode == "noise":
        return quant_noise(x, rng)
    return ste_round(x)


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _rates(bits_y, bits_z, n_pix):
    bpp_y = bits_y / n_pix
    bpp_z = torch.sum(bits_z) / n_pix
    return {"bpp_y": bpp_y, "bpp_z": bpp_z, "bpp": bpp_y + bpp_z}


def dmci_forward(params, x, qp, rng=None, quant_mode="ste"):
    """One-image RD forward of DMCI: x (B, H, W, 3) NHWC in [0, 1], H and W
    multiples of 16.  Returns {x_hat (NHWC), mse, bpp, bpp_y, bpp_z}."""
    p = params
    n_pix = x.shape[1] * x.shape[2]
    xc = _nchw(x)
    y = MI.intra_encoder(p, xc, C.q_vec(p["q_scale_enc"], qp, xc.dtype))
    z = MI.hyper_encoder(p, C.pad_for_y(y))
    z_hat = _quant(z, rng, quant_mode)
    bits_z = bit_estimator_bits(p["bit_estimator_z"], z_hat, qp)

    prior = MI.prior_fusion(p, MI.hyper_decoder(p, z_hat))
    prior = prior[:, :, :y.shape[2], :y.shape[3]]
    q_enc_p, q_dec_p, scales, means = C.separate_prior_image(prior)
    reduced = L.conv_apply(p["reduction"], prior)

    y = y * q_enc_p
    _, c, h, w = y.shape
    masks = F.checkerboard_masks_4x(h, w, c, y.dtype, y.device)
    bits_y = 0.0
    y_hat_so_far = torch.zeros_like(y)
    for k in range(4):
        if k > 0:
            sm = MI.spatial_prior(p, p[f"adaptor_{k}"],
                                  torch.cat((y_hat_so_far, reduced), dim=1))
            half = sm.shape[1] // 2
            scales, means = sm[:, :half], sm[:, half:]
        mask = masks[k]
        y_q = ste_round((y - means * mask) * mask)
        # the quantized residual is priced, as the coder charges it
        y_hat_so_far = y_hat_so_far + (y_q + means * mask)
        bits_y = bits_y + torch.sum(gaussian_bits(y_q, scales * mask) * mask)

    y_hat = y_hat_so_far * q_dec_p
    x_hat = torch.clamp(MI.intra_decoder(
        p, y_hat, C.q_vec(p["q_scale_dec"], qp, y_hat.dtype)), 0.0, 1.0)
    x_hat = C.frame_to_nhwc(x_hat)
    out = {"x_hat": x_hat, "mse": torch.mean(torch.square(x_hat - x))}
    out.update(_rates(bits_y, bits_z, n_pix))
    return out


def dmc_forward_one_frame(params, x, ref_frame, ref_feature, qp, rng=None,
                          quant_mode="ste"):
    """One P-frame RD forward of DMC: x (B, H, W, 3) NHWC; the reference
    is the NHWC pixel frame `ref_frame` when `ref_feature` (NCHW) is None.
    Returns {x_hat (NHWC), feature (NCHW), mse, bpp, bpp_y, bpp_z}."""
    p = params
    n_pix = x.shape[1] * x.shape[2]
    xc = _nchw(x)
    if ref_feature is None:
        feature = MV._stage_adaptor_i(p, _nchw(ref_frame))
    else:
        feature = MV._stage_adaptor_p(p, ref_feature)
    x1, ctx_t = MV._stage_fe_part1(p, feature, qp)
    ctx = MV._stage_fe_part2(p, x1)

    feat = L.conv_apply(p["enc_conv1"], F.space_to_depth(xc, 8))
    feat = L.depth_conv_block_apply(p["enc_conv2"][0],
                                    torch.cat((feat, ctx), dim=1))
    feat = L.depth_conv_block_apply(p["enc_conv2"][1], feat)
    feat = L.depth_conv_block_apply(
        p["enc_conv3"], feat,
        quant_step=C.q_vec(p["q_encoder"], qp, xc.dtype))
    y = L.conv_apply(p["enc_down"], feat, stride=2, padding=1)
    z = MV.hyper_encoder(p, C.pad_for_y(y))
    z_hat = _quant(z, rng, quant_mode)
    bits_z = bit_estimator_bits(p["bit_estimator_z"], z_hat, qp)

    prior = MV._stage_prior(p, z_hat, ctx_t)
    y, q_dec, scales, means = C.separate_prior_video_encoding(prior, y)
    _, c, h, w = y.shape
    masks = F.checkerboard_masks_2x(h, w, c, y.dtype, y.device)
    bits_y = 0.0
    y_hats = []
    for k in range(2):
        if k > 0:
            scales, means = MV._stage_spatial(p, y_hats[0], prior)
        mask = masks[k]
        y_q = ste_round((y - means * mask) * mask)
        y_hats.append(y_q + means * mask)
        bits_y = bits_y + torch.sum(gaussian_bits(y_q, scales * mask) * mask)

    feature_out = MV._stage_feature(p, (y_hats[0] + y_hats[1]) * q_dec, ctx,
                                    qp)
    x_hat = C.frame_to_nhwc(MV._stage_recon_x(p, feature_out, qp))
    out = {"x_hat": x_hat, "feature": feature_out,
           "mse": torch.mean(torch.square(x_hat - x))}
    out.update(_rates(bits_y, bits_z, n_pix))
    return out
