"""Differentiable training forwards of DCVC-RT (DMCI and DMC), DCVC-TCM,
DCVC-FM and DCVC.

Counterpart of the JAX package's `training/forward.py` (the RT pair, TCM,
FM and DCVC with its four-stage loss): straight-through
rounding (or additive uniform noise) for the quantizers, the factorized
prior's and the conditional Gaussian's or Laplace's rate terms (always
float32), the same stages the codecs run.  Frames are NHWC (B, H, W, 3)
at the edges, as the codecs take them; inside everything is NCHW, and the
propagated feature DMC returns and takes is NCHW, as the codecs' DPB
holds it.  Rates are bits over the frame's pixel count H * W, summed over
the batch, as in the JAX package (TCM's and DCVC's over B * H * W).

Under `parallel/mesh.py::sharded` a rank computes its share of the global
batch's loss: every mean divides by the global element count and every
rate by the global pixel count, so each term adds up over the ranks; a
noise draw takes the global shape and keeps this rank's block.  DMCI and
DMC also run on a frame split in height (each shard a multiple of 64
rows, so padding, the prior's crop and the checkerboard parity act as on
the whole frame); TCM, FM and DCVC raise there, as their warps gather
across shards.
"""

import torch

from ..entropy.models import bit_estimator_bits, gaussian_bits
from ..layers import blocks as L
from ..layers.blocks_fm import spynet_apply as fm_spynet_apply
from ..layers.blocks_hem import hem_spynet_apply
from ..models import common as C
from ..models import dcvc as D
from ..models import dmc as MV
from ..models import dmc_fm as FMM
from ..models import dmc_tcm as T
from ..models import dmci as MI
from ..ops import fused as F
from ..ops.warp import flow_warp
from ..parallel.mesh import active_shard


def ste_round(x):
    """Straight-through round (half to even, as jnp.round): the identity
    gradient."""
    return x + (torch.round(x) - x).detach()


def quant_noise(x, rng):
    """Additive uniform noise in [-0.5, 0.5): `rng` is a torch.Generator on
    x's device, or the noise tensor itself (a test passes JAX's draw).
    Sharded, the generator draws the global batch's noise (every rank the
    same) and x takes its block, so the run equals one process's."""
    if isinstance(rng, torch.Tensor):
        return x + rng.to(x.dtype)
    sh = active_shard()
    shape = x.shape if sh is None else sh.global_shape(x.shape)
    noise = torch.rand(shape, generator=rng, device=x.device,
                       dtype=torch.float32) - 0.5
    if sh is not None:
        noise = sh.block(noise)
    return x + noise.to(x.dtype)


def _quant(x, rng, mode):
    if mode == "noise":
        return quant_noise(x, rng)
    return ste_round(x)


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _mean(v):
    """torch.mean; sharded, this rank's share of the global mean."""
    sh = active_shard()
    m = torch.mean(v)
    return m if sh is None else m / (sh.dp * sh.sp)


def _pixels(x, batch=False):
    """H * W of the (global) frame of x (B, H, W, 3); B * H * W with
    batch."""
    sh = active_shard()
    dp, sp = (1, 1) if sh is None else (sh.dp, sh.sp)
    n = x.shape[1] * sp * x.shape[2]
    return n * x.shape[0] * dp if batch else n


def _split_ok(x, what):
    """Raise unless a frame split in height suits `what` (DMCI, DMC): each
    shard a multiple of 64 rows."""
    sh = active_shard()
    if sh is not None and sh.sp > 1 and x.shape[1] % 64:
        raise ValueError(f"{what}: a shard of {x.shape[1]} rows; a frame "
                         f"split in height needs multiples of 64")


def _not_split(what):
    sh = active_shard()
    if sh is not None and sh.sp > 1:
        raise ValueError(f"{what} does not train on a frame split in "
                         f"height: its flow warps gather across shards")


def _rates(bits_y, bits_z, n_pix):
    bpp_y = bits_y / n_pix
    bpp_z = torch.sum(bits_z) / n_pix
    return {"bpp_y": bpp_y, "bpp_z": bpp_z, "bpp": bpp_y + bpp_z}


def dmci_forward(params, x, qp, rng=None, quant_mode="ste"):
    """One-image RD forward of DMCI: x (B, H, W, 3) NHWC in [0, 1], H and W
    multiples of 16.  Returns {x_hat (NHWC), mse, bpp, bpp_y, bpp_z}."""
    p = params
    _split_ok(x, "DMCI")
    n_pix = _pixels(x)
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
    out = {"x_hat": x_hat, "mse": _mean(torch.square(x_hat - x))}
    out.update(_rates(bits_y, bits_z, n_pix))
    return out


def dmc_forward_one_frame(params, x, ref_frame, ref_feature, qp, rng=None,
                          quant_mode="ste"):
    """One P-frame RD forward of DMC: x (B, H, W, 3) NHWC; the reference
    is the NHWC pixel frame `ref_frame` when `ref_feature` (NCHW) is None.
    Returns {x_hat (NHWC), feature (NCHW), mse, bpp, bpp_y, bpp_z}."""
    p = params
    _split_ok(x, "DMC")
    n_pix = _pixels(x)
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
           "mse": _mean(torch.square(x_hat - x))}
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
    _not_split("TCM")
    n_pix = _pixels(x, batch=True)
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
            "mse": _mean(torch.square(x_hat - x)),
            "warp_mse": _mean(torch.square(
                C.frame_to_nhwc(warp_frame) - x)),
            "bpp_y": bpp_y, "bpp_z": bpp_z, "bpp_mv_y": bpp_mv_y,
            "bpp_mv_z": bpp_mv_z,
            "bpp": bpp_y + bpp_z + bpp_mv_y + bpp_mv_z}


# ---------------------------------------------------------------------------
# DCVC-FM: one model over the whole q_index range (the quant pairs
# log-interpolated between learned anchors), straight-through four-pass
# quadtree rates on the motion latent and y, factorized z planes
# ---------------------------------------------------------------------------

def _fm_masked_4x(y_div, scales, means, spatial_fn, params_prior):
    """The four quadtree passes of a latent (NCHW) with the coder's
    rounding replaced by the straight-through estimator and its table rate
    by the Gaussian bits of the quantized residual.  Returns (the summed
    y_hat before the dequantization, its bits)."""
    _, c, h, w = y_div.shape
    masks = F.checkerboard_masks_4x(h, w, c, y_div.dtype, y_div.device)
    bits = 0.0
    so_far = torch.zeros_like(y_div)
    for k in range(4):
        if k > 0:
            scales, means = spatial_fn(k, so_far, params_prior)
        mask = masks[k]
        y_q = ste_round((y_div - means * mask) * mask)
        so_far = so_far + y_q + means * mask
        bits = bits + torch.sum(gaussian_bits(y_q, scales * mask) * mask)
    return so_far, bits


def dmc_fm_forward_one_frame(params, x, ref_frame, ref_feature,
                             ref_mv_feature, ref_y, ref_mv_y, q_index,
                             rng=None, quant_mode="ste", fa_idx=0):
    """One P-frame RD forward of DMCFM at q_index in [0, 64): x and
    ref_frame (B, H, W, 3) NHWC; ref_feature, ref_mv_feature, ref_y and
    ref_mv_y the propagated DPB entries (NCHW), None on the first P-frame
    after an intra frame (the adaptor-I and fusion-adaptor-0 path).  The
    motion z and z quantizers round through the STE, or add uniform noise
    in quant_mode "noise", drawn from the Generator `rng` or taken from
    `rng`, a sequence of the two noise tensors (NCHW) in that order; the
    latents' passes always round through the STE.  Rates are bits over H
    * W, summed over the batch, as in the JAX package.  Returns {x_hat
    (NHWC), feature, mv_feature, y_hat, mv_y_hat (NCHW), mse, warp_mse,
    bpp, bpp_y, bpp_z, bpp_mv_y, bpp_mv_z}."""
    p = params
    _not_split("FM")
    n_pix = _pixels(x)
    xc, rf = _nchw(x), _nchw(ref_frame)
    steady = ref_feature is not None

    def quant(v, k):
        r = rng[k] if isinstance(rng, (list, tuple)) else rng
        return _quant(v, r, quant_mode)

    # the motion branch
    q_mv_enc = FMM.get_curr_q(p["mv_y_q_enc"], q_index).to(xc.dtype)
    est_mv = fm_spynet_apply(p["optic_flow"], xc, rf)
    mv_y = FMM.mv_encoder(p, est_mv, ref_mv_feature if steady else None,
                          q_mv_enc)
    mv_z_hat = quant(FMM.hyper_enc_apply(p["mv_hyper_enc"],
                                         C.pad_for_y(mv_y)), 0)
    bits_mv_z = torch.sum(bit_estimator_bits(p["bit_estimator_z_mv"],
                                             mv_z_hat, 0))
    mv_params = FMM._stage_mv_prior(p, mv_z_hat.to(xc.dtype),
                                    ref_mv_y if steady else None,
                                    mv_y.shape[2], mv_y.shape[3])
    mv_y_div, mv_q_dec, mv_scales, mv_means = \
        C.separate_prior_video_encoding(mv_params, mv_y)
    mv_so_far, bits_mv_y = _fm_masked_4x(
        mv_y_div, mv_scales, mv_means,
        lambda k, sf, prm: FMM._stage_mv_spatial(p, k, sf, prm), mv_params)
    mv_y_hat = mv_so_far * mv_q_dec
    mv_hat, mv_feature = FMM._stage_mv_dec(p, mv_y_hat, q_index)
    c1, c2, c3, warpframe = FMM._stage_motion_comp(
        p, mv_hat, rf, ref_feature if steady else None, fa_idx)

    # the contextual branch
    q_y_enc = FMM.get_curr_q(p["y_q_enc"], q_index).to(xc.dtype)
    y = FMM.contextual_encoder(p, xc, c1, c2, c3, q_y_enc)
    z_hat = quant(FMM.hyper_enc_apply(p["hyper_enc"], C.pad_for_y(y)), 1)
    bits_z = torch.sum(bit_estimator_bits(p["bit_estimator_z"], z_hat, 0))
    y_params = FMM._stage_ctx_prior(p, z_hat.to(xc.dtype), c3,
                                    ref_y if steady else None, y.shape[2],
                                    y.shape[3])
    y_div, q_dec, scales, means = C.separate_prior_video_encoding(y_params,
                                                                  y)
    y_so_far, bits_y = _fm_masked_4x(
        y_div, scales, means,
        lambda k, sf, prm: FMM._stage_y_spatial(p, k, sf, prm), y_params)
    y_hat = y_so_far * q_dec
    x_hat, feature = FMM._stage_recon(p, y_hat, c1, c2, c3, q_index)
    x_hat = C.frame_to_nhwc(x_hat)
    return {"x_hat": x_hat, "feature": feature, "mv_feature": mv_feature,
            "y_hat": y_hat, "mv_y_hat": mv_y_hat,
            "mse": _mean(torch.square(x_hat - x)),
            "warp_mse": _mean(torch.square(
                C.frame_to_nhwc(warpframe) - x)),
            "bpp_y": bits_y / n_pix, "bpp_z": bits_z / n_pix,
            "bpp_mv_y": bits_mv_y / n_pix, "bpp_mv_z": bits_mv_z / n_pix,
            "bpp": (bits_y + bits_z + bits_mv_y + bits_mv_z) / n_pix}


# ---------------------------------------------------------------------------
# DCVC: the reference's own training target, additive-noise (or STE)
# quantizers, Laplace rates on y and the motion latent through the dense
# masked convolution, and the four-stage loss
# ---------------------------------------------------------------------------

def _laplace_scales(logscale):
    """exp(softplus(ls + 2.3) - 2.3), the reference's scale transform
    (log-scale kept above -2.3); softplus as JAX's logaddexp(v, 0)."""
    v = logscale + 2.3
    return torch.exp(torch.logaddexp(v, torch.zeros_like(v)) - 2.3)


def _mean_scale(plist, params, ctx_params):
    g = D.entropy_params_apply(plist, torch.cat((params, ctx_params), dim=1))
    c = g.shape[1] // 2
    return g[:, :c], _laplace_scales(g[:, c:])


def dcvc_forward(params, x, ref_frame, rng=None, stage=4, quant_mode="noise"):
    """One P-frame RD forward of DCVC with every term the staged losses
    take: x and ref_frame (B, H, W, 3) NHWC.  The four quantizers (motion
    z, motion latent, z, y) add uniform noise (quant_mode "noise") drawn
    from the Generator `rng`, or taken from `rng`, a sequence of the four
    noise tensors (NCHW) in that order, or round through the STE.  The
    autoregressive context is the masked convolution over the whole
    quantized latent.  Rates are bits over B * H * W.  Returns {x_hat,
    pixel_rec (NHWC), mse, warp_mse, bpp, bpp_y, bpp_z, bpp_mv_y,
    bpp_mv_z}; `stage` is taken for the JAX package's signature."""
    del stage
    p = params
    _not_split("DCVC")
    n_pix = _pixels(x, batch=True)
    xc, rf = _nchw(x), _nchw(ref_frame)

    def quant(v, k):
        r = rng[k] if isinstance(rng, (list, tuple)) else rng
        return _quant(v, r, quant_mode)

    est_mv = D.spynet_apply(p["optic_flow"], xc, rf)
    mv_y = D.mv_encoder(p, est_mv)
    mv_z_hat = quant(D.prior_enc(p["mv_prior_enc"], mv_y), 0)
    params_mv = D.prior_dec(p["mv_prior_dec"], mv_z_hat)
    mv_y_hat = quant(mv_y, 1)
    means_mv, scales_mv = _mean_scale(
        p["entropy_parameters_mv"], params_mv,
        D.masked_conv_apply(p["auto_regressive_mv"], mv_y_hat))

    mv_up = D.mv_decoder_part1(p, mv_y_hat)
    mv_ref = D.mv_refine(p, rf, mv_up)
    ctx = D.motion_compensation(p, rf, mv_ref)
    # stage 1's target: the pixel-domain warp of the reference
    pixel_rec = C.frame_to_nhwc(flow_warp(rf, mv_ref))

    temporal = D.temporal_prior_enc(p, ctx)
    y = D.contextual_encoder(p, xc, ctx)
    z_hat = quant(D.prior_enc(p["prior_enc"], y), 2)
    hp = D.prior_dec(p["prior_dec"], z_hat)
    y_hat = quant(y, 3)
    means, scales = _mean_scale(
        p["entropy_parameters"], torch.cat((temporal, hp), dim=1),
        D.masked_conv_apply(p["auto_regressive"], y_hat))

    x_hat = C.frame_to_nhwc(D.contextual_decoder(p, y_hat, ctx))

    bpp_y = torch.sum(laplace_bits(y_hat - means, scales)) / n_pix
    bpp_mv_y = torch.sum(laplace_bits(mv_y_hat - means_mv, scales_mv)) \
        / n_pix
    bpp_z = torch.sum(bit_estimator_bits(p["bit_estimator_z"], z_hat,
                                         0)) / n_pix
    bpp_mv_z = torch.sum(bit_estimator_bits(p["bit_estimator_z_mv"],
                                            mv_z_hat, 0)) / n_pix
    return {"x_hat": x_hat, "pixel_rec": pixel_rec,
            "mse": _mean(torch.square(x_hat - x)),
            "warp_mse": _mean(torch.square(pixel_rec - x)),
            "bpp_y": bpp_y, "bpp_z": bpp_z, "bpp_mv_y": bpp_mv_y,
            "bpp_mv_z": bpp_mv_z,
            "bpp": bpp_y + bpp_z + bpp_mv_y + bpp_mv_z}


#: parameter subtrees of the motion branch, frozen in stages 2-3
DCVC_MOTION_SUBTREES = (
    "optic_flow", "mv_enc", "mv_dec1", "mv_dec2", "mv_prior_enc",
    "mv_prior_dec", "entropy_parameters_mv", "auto_regressive_mv",
    "bit_estimator_z_mv",
)


def stage_loss_dcvc(out, lmbda, stage):
    """The reference's four-stage loss:
      1: lmbda * mse(warp, x) + bpp_mv_y + bpp_mv_z   (motion warm-up)
      2: lmbda * mse(x_hat, x)                        (motion frozen)
      3: lmbda * mse(x_hat, x) + bpp_y + bpp_z        (motion frozen)
      4: lmbda * mse(x_hat, x) + bpp                  (end to end)"""
    if stage == 1:
        return lmbda * out["warp_mse"] + out["bpp_mv_y"] + out["bpp_mv_z"]
    if stage == 2:
        return lmbda * out["mse"]
    if stage == 3:
        return lmbda * out["mse"] + out["bpp_y"] + out["bpp_z"]
    return lmbda * out["mse"] + out["bpp"]
