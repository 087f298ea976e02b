"""Mask, quantization and layout ops of the DCVC-RT path (NCHW).

Counterpart of the JAX package's `ops/fused.py` (NHWC there).  Pixel
(un)shuffle follows torch's channel order (c*r*r + dy*r + dx), which the
JAX package already keeps, so `F.pixel_shuffle`/`F.pixel_unshuffle` apply
as they are.  Rounding is half-to-even on both sides (`torch.round` ==
`jnp.round`).
"""

import torch
import torch.nn.functional as F


def space_to_depth(x, r):
    """(B, C, H*r, W*r) -> (B, C*r*r, H, W), torch channel order."""
    return F.pixel_unshuffle(x, r)


def depth_to_space(x, r):
    """Inverse of space_to_depth."""
    return F.pixel_shuffle(x, r)


def round_and_to_int8(z):
    """Round to nearest-even, clamp to int8 range; returns (z_hat in z's
    dtype, z_int8)."""
    z_hat = torch.clamp(torch.round(z.float()), -128.0, 127.0)
    return z_hat.to(z.dtype), z_hat.to(torch.int8)


def process_with_mask(y, scales, means, mask, force_zero_thres=None):
    """Masked quantization of y.  Returns (y_res, y_q, y_hat, scales_hat);
    with force_zero_thres set, symbols whose masked scale <= thres are
    forced to 0 (and are not coded)."""
    scales_hat = scales * mask
    means_hat = means * mask
    y_res = (y - means_hat) * mask
    y_q = torch.round(y_res.float())
    if force_zero_thres is not None:
        # a forced zero is +0, as XLA writes the JAX package's product
        y_q = torch.where(scales_hat.float() > force_zero_thres, y_q, 0.0)
    y_q = torch.clamp(y_q, -128.0, 127.0).to(y.dtype)
    y_hat = y_q + means_hat
    return y_res, y_q, y_hat, scales_hat


def fold_halves(x):
    """Sum the two channel halves: (B, C, H, W) -> (B, C/2, H, W)."""
    c = x.shape[1]
    return x[:, :c // 2] + x[:, c // 2:]


def fold_quarters(x):
    """Sum the four channel quarters: (B, C, H, W) -> (B, C/4, H, W)."""
    q = x.shape[1] // 4
    return (x[:, :q] + x[:, q:2 * q]) + (x[:, 2 * q:3 * q] + x[:, 3 * q:])


def combine_for_reading_2x(x, mask):
    """x*mask folded to half channels."""
    return fold_halves(x * mask)


def restore_y_2x(y, means, mask):
    """([y, y] + means) * mask."""
    return (torch.cat((y, y), dim=1) + means) * mask


def restore_y_4x(y, means, mask):
    """([y, y, y, y] + means) * mask."""
    return (torch.cat((y, y, y, y), dim=1) + means) * mask


def build_index_dec(scales, scale_min, scale_max, log_scale_min,
                    log_step_recip, skip_thres=None):
    """Quantize log-scale to a uint8 CDF index (truncating the cast).
    Returns (indexes uint8, keep mask or None): keep is scale > thres."""
    scales = torch.clamp(scales.float(), scale_min, scale_max)
    indexes = ((torch.log(scales) - log_scale_min)
               * log_step_recip).to(torch.uint8)
    keep = None if skip_thres is None else scales > skip_thres
    return indexes, keep


def build_index_enc(symbols, scales, scale_min, scale_max, log_scale_min,
                    log_step_recip, skip_thres=None):
    """Pack (int8 symbol << 8 | uint8 cdf index) into int16.  Returns
    (packed, keep mask or None)."""
    indexes, keep = build_index_dec(scales, scale_min, scale_max,
                                    log_scale_min, log_step_recip,
                                    skip_thres)
    packed = (symbols.to(torch.int16) << 8) + indexes.to(torch.int16)
    return packed, keep


def replicate_pad(x, pad_b, pad_r):
    """Edge-replicate pad bottom/right."""
    if pad_b == 0 and pad_r == 0:
        return x
    return F.pad(x, (0, pad_r, 0, pad_b), mode="replicate")


def pixel_shuffle_clamp(x, r=8):
    """depth_to_space + clamp to [0, 1]."""
    return torch.clamp(depth_to_space(x, r), 0.0, 1.0)


# ---------------------------------------------------------------------------
# checkerboard masks, (1, C, H, W)
# ---------------------------------------------------------------------------

def _parity(h, w, device):
    r = torch.arange(h, device=device)[:, None] % 2
    c = torch.arange(w, device=device)[None, :] % 2
    return r, c


def checkerboard_masks_2x(h, w, channels, dtype, device=None):
    """Two complementary masks: mask_0 = [even checker over the first C/2
    channels, odd checker over the rest]; mask_1 is the swap."""
    rp, cp = _parity(h, w, device)
    m0 = ((rp + cp) % 2 == 0).to(dtype)
    m1 = 1.0 - m0
    half = channels // 2
    a, b = m0.expand(half, h, w), m1.expand(half, h, w)
    return torch.cat((a, b))[None], torch.cat((b, a))[None]


def checkerboard_masks_4x(h, w, channels, dtype, device=None):
    """Four quadtree masks, channel quarters cycled per pass."""
    rp, cp = _parity(h, w, device)
    q = channels // 4
    m = [((rp == i) & (cp == j)).to(dtype).expand(q, h, w)
         for i, j in ((0, 0), (0, 1), (1, 0), (1, 1))]

    def build(order):
        return torch.cat([m[i] for i in order])[None]

    return (build((0, 1, 2, 3)), build((3, 2, 1, 0)), build((2, 3, 0, 1)),
            build((1, 0, 3, 2)))
