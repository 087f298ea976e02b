"""DCVC-FM building blocks as plain functions over parameter dicts (NCHW;
conv weights OIHW).

Counterpart of the JAX package's `layers/blocks_fm.py` and of the
EVC-generation blocks it takes from `layers/blocks_evc.py`, with the JAX
package's parameter names, so a JAX parameter tree converts mechanically
(`utils/params.py`).  LeakyReLU, ResidualBlockWithStride(2),
ResidualBlockUpsample and the 1x1 subpel conv are `blocks_evc`'s, taken
from there as the JAX package's `blocks_fm` takes them:
  * DepthConv (LeakyReLU 0.01 after its first 1x1 only) and the gated
    DepthConv2; ConvFFN (LeakyReLU 0.1), the gated ConvFFN2 and the
    two-slope ConvFFN3 (0.1 / 0.01); DCB / DCB2 / DCB3 / DCB4 pair them;
  * UNet (DCB2 blocks, strided 2x2 convs down) and UNet2 (DCB4 blocks,
    2x2 max pooling down), both up by 1x1 subpel convs;
  * the pre-activation ResBlock and ResidualBlockWithStride2;
  * SpyNet's ME_Basic and the 4-level coarse-to-fine flow.
Pooling is a reshape and a reduction, as in the JAX package.  `init`
functions draw from an explicit `torch.Generator` with the JAX package's
distributions (not its draws).
"""

import torch

from ..ops.warp import bilinear_resize_2x, flow_warp
from .blocks import conv_apply, conv_init
from .blocks_evc import (lrelu, res_block_stride_apply,  # noqa: F401
                         res_block_stride_init, res_block_upsample_apply,
                         res_block_upsample_init, subpel1x1_apply,
                         subpel1x1_init)


# ---------------------------------------------------------------------------
# DepthConv / ConvFFN / DepthConvBlocks
# ---------------------------------------------------------------------------

def depth_conv_init(gen, in_ch, out_ch):
    p = {"conv1": conv_init(gen, in_ch, in_ch, 1),
         "dw": conv_init(gen, in_ch, in_ch, 3, groups=in_ch),
         "conv2": conv_init(gen, in_ch, out_ch, 1)}
    if in_ch != out_ch:
        p["adaptor"] = conv_init(gen, in_ch, out_ch, 1)
    return p


def depth_conv_apply(p, x, slope=0.01):
    identity = x
    if "adaptor" in p:
        identity = conv_apply(p["adaptor"], x)
    out = lrelu(conv_apply(p["conv1"], x), slope)
    out = conv_apply(p["dw"], out, padding=1, groups=x.shape[1])
    return conv_apply(p["conv2"], out) + identity


def conv_ffn_init(gen, in_ch):
    internal = max(min(in_ch * 4, 1024), in_ch * 2)
    return {"c1": conv_init(gen, in_ch, internal, 1),
            "c2": conv_init(gen, internal, in_ch, 1)}


def conv_ffn_apply(p, x, slope=0.1):
    out = lrelu(conv_apply(p["c1"], x), slope)
    out = lrelu(conv_apply(p["c2"], out), slope)
    return x + out


def conv_ffn2_init(gen, in_ch):
    internal = in_ch * 2
    return {"c": conv_init(gen, in_ch, internal * 2, 1),
            "out": conv_init(gen, internal, in_ch, 1)}


def conv_ffn2_apply(p, x):
    h = conv_apply(p["c"], x)
    c = h.shape[1] // 2
    return x + conv_apply(p["out"], h[:, :c] * lrelu(h[:, c:], 0.1))


conv_ffn3_init = conv_ffn2_init


def conv_ffn3_apply(p, x):
    h = conv_apply(p["c"], x)
    c = h.shape[1] // 2
    out = lrelu(h[:, :c], 0.1) + lrelu(h[:, c:], 0.01)
    return x + conv_apply(p["out"], out)


def dcb_init(gen, in_ch, out_ch):
    return {"dc": depth_conv_init(gen, in_ch, out_ch),
            "ffn": conv_ffn_init(gen, out_ch)}


def dcb_apply(p, x):
    return conv_ffn_apply(p["ffn"], depth_conv_apply(p["dc"], x))


def dcb2_init(gen, in_ch, out_ch):
    return {"dc": depth_conv_init(gen, in_ch, out_ch),
            "ffn": conv_ffn2_init(gen, out_ch)}


def dcb2_apply(p, x):
    return conv_ffn2_apply(p["ffn"], depth_conv_apply(p["dc"], x))


def dcb4_init(gen, in_ch, out_ch):
    return {"dc": depth_conv_init(gen, in_ch, out_ch),
            "ffn": conv_ffn3_init(gen, out_ch)}


def dcb4_apply(p, x):
    return conv_ffn3_apply(p["ffn"], depth_conv_apply(p["dc"], x))


def depth_conv2_init(gen, in_ch, out_ch):
    """Gated DepthConv: out(lrelu(1x1) -> 3x3 dw, times a second 1x1)."""
    p = {"c1a": conv_init(gen, in_ch, out_ch, 1),
         "c1dw": conv_init(gen, out_ch, out_ch, 3, groups=out_ch),
         "c2": conv_init(gen, in_ch, out_ch, 1),
         "out": conv_init(gen, out_ch, out_ch, 1)}
    if in_ch != out_ch:
        p["adaptor"] = conv_init(gen, in_ch, out_ch, 1)
    return p


def depth_conv2_apply(p, x, slope=0.01):
    identity = x
    if "adaptor" in p:
        identity = conv_apply(p["adaptor"], x)
    c_out = p["c2"]["b"].shape[0]
    x1 = lrelu(conv_apply(p["c1a"], x), slope)
    x1 = conv_apply(p["c1dw"], x1, padding=1, groups=c_out)
    x2 = conv_apply(p["c2"], x)
    return identity + conv_apply(p["out"], x1 * x2)


def dcb3_init(gen, in_ch, out_ch):
    return {"dc": depth_conv2_init(gen, in_ch, out_ch),
            "ffn": conv_ffn2_init(gen, out_ch)}


def dcb3_apply(p, x):
    return conv_ffn2_apply(p["ffn"], depth_conv2_apply(p["dc"], x))


# ---------------------------------------------------------------------------
# UNet / UNet2, ResBlock, ResidualBlockWithStride2
# ---------------------------------------------------------------------------

def _pool2(x, reduce):
    b, c, h, w = x.shape
    return reduce(x.reshape(b, c, h // 2, 2, w // 2, 2))


def _max_pool2(x):
    return _pool2(x, lambda t: t.amax(dim=(3, 5)))


def _avg_pool2(x):
    return _pool2(x, lambda t: t.mean(dim=(3, 5)))


def unet_init(gen, in_ch, out_ch):
    return {
        "conv1": dcb2_init(gen, in_ch, 32),
        "down1": conv_init(gen, 32, 32, 2),
        "conv2": dcb2_init(gen, 32, 64),
        "down2": conv_init(gen, 64, 64, 2),
        "conv3": dcb2_init(gen, 64, 128),
        "refine": [dcb2_init(gen, 128, 128) for _ in range(4)],
        "up3": subpel1x1_init(gen, 128, 64),
        "up_conv3": dcb2_init(gen, 128, 64),
        "up2": subpel1x1_init(gen, 64, 32),
        "up_conv2": dcb2_init(gen, 64, out_ch),
    }


def unet_apply(p, x):
    x1 = dcb2_apply(p["conv1"], x)
    x2 = dcb2_apply(p["conv2"], conv_apply(p["down1"], x1, stride=2))
    x3 = dcb2_apply(p["conv3"], conv_apply(p["down2"], x2, stride=2))
    for rp in p["refine"]:
        x3 = dcb2_apply(rp, x3)
    d3 = subpel1x1_apply(p["up3"], x3)
    d3 = dcb2_apply(p["up_conv3"], torch.cat((x2, d3), dim=1))
    d2 = subpel1x1_apply(p["up2"], d3)
    return dcb2_apply(p["up_conv2"], torch.cat((x1, d2), dim=1))


def unet2_init(gen, in_ch, out_ch):
    return {
        "conv1": dcb4_init(gen, in_ch, 32),
        "conv2": dcb4_init(gen, 32, 64),
        "conv3": dcb4_init(gen, 64, 128),
        "refine": [dcb4_init(gen, 128, 128) for _ in range(4)],
        "up3": subpel1x1_init(gen, 128, 64),
        "up_conv3": dcb4_init(gen, 128, 64),
        "up2": subpel1x1_init(gen, 64, 32),
        "up_conv2": dcb4_init(gen, 64, out_ch),
    }


def unet2_apply(p, x):
    x1 = dcb4_apply(p["conv1"], x)
    x2 = dcb4_apply(p["conv2"], _max_pool2(x1))
    x3 = dcb4_apply(p["conv3"], _max_pool2(x2))
    for rp in p["refine"]:
        x3 = dcb4_apply(rp, x3)
    d3 = subpel1x1_apply(p["up3"], x3)
    d3 = dcb4_apply(p["up_conv3"], torch.cat((x2, d3), dim=1))
    d2 = subpel1x1_apply(p["up2"], d3)
    return dcb4_apply(p["up_conv2"], torch.cat((x1, d2), dim=1))


def res_block_init(gen, in_ch, out_ch):
    """Pre-activation ResBlock (in_ch channels throughout)."""
    return {"conv1": conv_init(gen, in_ch, in_ch, 3),
            "conv2": conv_init(gen, in_ch, in_ch, 3)}


def res_block_apply(p, x, slope=0.01):
    out = conv_apply(p["conv1"], lrelu(x, slope), padding=1)
    out = conv_apply(p["conv2"], lrelu(out, slope), padding=1)
    return x + out


def rbs2_init(gen, in_ch, out_ch):
    """ResidualBlockWithStride2: a 2x2 stride-2 conv, then a residual
    3x3 / 1x1 pair."""
    return {"down": conv_init(gen, in_ch, out_ch, 2),
            "c1": conv_init(gen, out_ch, out_ch, 3),
            "c2": conv_init(gen, out_ch, out_ch, 1)}


def rbs2_apply(p, x):
    x = conv_apply(p["down"], x, stride=2)
    out = lrelu(conv_apply(p["c1"], x, padding=1), 0.01)
    out = lrelu(conv_apply(p["c2"], out), 0.01)
    return x + out


# ---------------------------------------------------------------------------
# optical flow (SpyNet)
# ---------------------------------------------------------------------------

def me_basic_init(gen, ksize):
    return {"c1": conv_init(gen, 8, 32, ksize),
            "c2": conv_init(gen, 32, 64, ksize),
            "c3": conv_init(gen, 64, 32, ksize),
            "c4": conv_init(gen, 32, 16, ksize),
            "c5": conv_init(gen, 16, 2, ksize)}


def me_basic_apply(p, x, ksize):
    pad = ksize // 2
    for name in ("c1", "c2", "c3", "c4"):
        x = torch.relu(conv_apply(p[name], x, padding=pad))
    return conv_apply(p["c5"], x, padding=pad)


def spynet_init(gen):
    return {"me_8x": me_basic_init(gen, 7),
            "me_4x": me_basic_init(gen, 7),
            "me_2x": me_basic_init(gen, 5),
            "me_1x": me_basic_init(gen, 5)}


def spynet_apply(p, im1, im2):
    """4-level coarse-to-fine flow from im1 to im2 (NCHW, H and W
    multiples of 8); (B, 2, H, W) in pixel units."""
    im1_levels = [im1]
    im2_levels = [im2]
    for _ in range(3):
        im1_levels.append(_avg_pool2(im1_levels[-1]))
        im2_levels.append(_avg_pool2(im2_levels[-1]))

    b, _, h8, w8 = im1_levels[3].shape
    zero = torch.zeros((b, 2, h8, w8), dtype=im1.dtype, device=im1.device)
    flow = me_basic_apply(p["me_8x"], torch.cat(
        (im1_levels[3], im2_levels[3], zero), dim=1), 7)

    for name, ksize, lvl in (("me_4x", 7, 2), ("me_2x", 5, 1),
                             ("me_1x", 5, 0)):
        flow = bilinear_resize_2x(flow, up=True) * 2.0
        warped = flow_warp(im2_levels[lvl], flow)
        flow = flow + me_basic_apply(
            p[name], torch.cat((im1_levels[lvl], warped, flow), dim=1),
            ksize)
    return flow
