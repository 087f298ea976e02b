"""Differentiable training forwards of DCVC-RT (DMCI and DMC) and
DCVC-TCM.

Counterpart of the JAX package's `training/forward.py`, cut to the RT
pair and TCM: straight-through rounding (or additive uniform noise) for
the quantizers, the factorized prior's and the conditional Gaussian's or
Laplace's rate terms (always float32), the same stages the codecs
run.  Frames are NHWC (B, H, W, 3) at the edges, as the codecs take them;
inside everything is NCHW, and the propagated feature DMC returns and
takes is NCHW, as the codecs' DPB holds it.  Rates are bits over the
frame's pixel count H * W, summed over the batch, as in the JAX package.
"""

import torch

from ..entropy.models import bit_estimator_bits, gaussian_bits
from ..layers import blocks as L
from ..layers.blocks_hem import hem_spynet_apply
from ..models import common as C
from ..models import dmc as MV
from ..models import dmc_tcm as T
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


# ---------------------------------------------------------------------------
# DCVC-TCM: hard rounding through a straight-through estimator, Laplace
# rates on y and the motion latent, factorized z and motion z
# ---------------------------------------------------------------------------

def laplace_bits(x_res, scales):
    """Differentiable bits of x_res under Laplace(0, b = scales),
    integrated over [x - 0.5, x + 0.5] (b clipped at 1e-9, the
    difference at 1e-9), in float32: the JAX package's
    cdf(v) = 0.5 + 0.5 sign(v) (-expm1(-|v| / b))."""
    b = torch.clamp(scales.float(), min=1e-9)
    x = x_res.float()

    def cdf(v):
        return 0.5 + 0.5 * torch.sign(v) * (-torch.expm1(-v.abs() / b))

    probs = torch.clamp(cdf(x + 0.5) - cdf(x - 0.5), min=1e-9)
    return -torch.log2(probs)


def dmc_tcm_forward_one_frame(params, x, ref_frame, ref_feature, rng=None,
                              quant_mode="ste"):
    """One P-frame RD forward of DMCTCM: x and ref_frame (B, H, W, 3)
    NHWC, ref_feature (NCHW) or None.  The four quantizers (motion z, the
    motion latent's residual, z, y's residual) round through the STE, or
    add uniform noise in quant_mode "noise", drawn from the Generator
    `rng` or taken from `rng`, a sequence of the four noise tensors (NCHW)
    in that order.  Rates are bits over B * H * W, as in the JAX
    package's TCM forward.  Returns {x_hat (NHWC), feature (NCHW), mse,
    warp_mse, bpp, bpp_y, bpp_z, bpp_mv_y, bpp_mv_z}."""
    p = params
    n_pix = x.shape[0] * x.shape[1] * x.shape[2]
    xc, rf = _nchw(x), _nchw(ref_frame)

    def quant(v, k):
        r = rng[k] if isinstance(rng, (list, tuple)) else rng
        return _quant(v, r, quant_mode)

    est_mv = hem_spynet_apply(p["optic_flow"], xc, rf)
    mv_y = T.mv_encoder(p, est_mv)
    mv_z_hat = quant(T.mv_prior_enc(p, mv_y), 0)
    mv_scales, mv_means = T._stage_mv_params(p, mv_z_hat)
    mv_y_q = quant(mv_y - mv_means, 1)
    mv_hat = T.mv_decoder(p, mv_y_q + mv_means)
    c1, c2, c3, warp_frame = T._stage_motion_comp(p, mv_hat, rf,
                                                  ref_feature)

    y = T.contextual_encoder(p, xc, c1, c2, c3)
    z_hat = quant(T.hyper_enc(p, y), 2)
    scales, means = T._stage_y_params(p, z_hat, c1, c2, c3)
    y_q = quant(y - means, 3)
    feature, x_hat = T._stage_recon(p, y_q + means, c1, c2, c3)
    x_hat = C.frame_to_nhwc(x_hat)

    # the Laplace rates with the reference's clamp of the scales at 1e-5
    bpp_y = torch.sum(laplace_bits(y_q, torch.clamp(scales, min=1e-5))) \
        / n_pix
    bpp_mv_y = torch.sum(laplace_bits(
        mv_y_q, torch.clamp(mv_scales, min=1e-5))) / n_pix
    bpp_z = torch.sum(bit_estimator_bits(p["bit_estimator_z"], z_hat,
                                         0)) / n_pix
    bpp_mv_z = torch.sum(bit_estimator_bits(p["bit_estimator_z_mv"],
                                            mv_z_hat, 0)) / n_pix
    return {"x_hat": x_hat, "feature": feature,
            "mse": torch.mean(torch.square(x_hat - x)),
            "warp_mse": torch.mean(torch.square(
                C.frame_to_nhwc(warp_frame) - x)),
            "bpp_y": bpp_y, "bpp_z": bpp_z, "bpp_mv_y": bpp_mv_y,
            "bpp_mv_z": bpp_mv_z,
            "bpp": bpp_y + bpp_z + bpp_mv_y + bpp_mv_z}
