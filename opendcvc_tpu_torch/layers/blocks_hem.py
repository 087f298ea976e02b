"""DCVC-HEM/TCM/DC-generation building blocks as plain functions over
parameter dicts (NCHW; conv weights OIHW).

Counterpart of the JAX package's `layers/blocks_hem.py`, with its names
and parameter keys (`utils/params.py` converts a JAX tree): the
configurable ResBlock (slope, bottleneck, start/end activation), the
two-conv ResidualBlock, the SE layer, ConvBlockResidual and the UNet, the
plain encoder/decoder towers, the five-conv hyper towers, HEM's SpyNet
(four 7x7 MEBasic levels, each warping with the previous flow) and the
conv + LeakyReLU stack.  LeakyReLU, the residual stride / upsample
blocks and the subpel conv are `blocks_evc`'s, as in the JAX package.
`init` functions draw from an explicit `torch.Generator` with the JAX
package's distributions (not its draws).
"""

import math

import torch

from ..ops.warp import bilinear_resize_2x, flow_warp
from .blocks import _uniform, conv_apply, conv_init
from .blocks_evc import (lrelu, res_block_stride_apply,  # noqa: F401
                         res_block_stride_init, res_block_upsample_apply,
                         res_block_upsample_init, subpel1x1_apply,
                         subpel1x1_init)
from .blocks_fm import _avg_pool2, _max_pool2, me_basic_apply, me_basic_init


def res_block_init(gen, channel, bottleneck=False):
    mid = channel // 2 if bottleneck else channel
    return {"c1": conv_init(gen, channel, mid, 3),
            "c2": conv_init(gen, mid, channel, 3)}


def res_block_apply(p, x, slope=0.01, start_from_relu=True,
                    end_with_relu=False):
    def act(v):
        return torch.relu(v) if slope < 1e-4 else lrelu(v, slope)
    out = act(x) if start_from_relu else x
    out = act(conv_apply(p["c1"], out, padding=1))
    out = conv_apply(p["c2"], out, padding=1)
    if end_with_relu:
        out = act(out)
    return x + out


def residual_block_init(gen, in_ch, out_ch):
    """Two 3x3 convs with LeakyReLU and a 1x1 adaptor when the widths
    differ."""
    p = {"c1": conv_init(gen, in_ch, out_ch, 3),
         "c2": conv_init(gen, out_ch, out_ch, 3)}
    if in_ch != out_ch:
        p["adaptor"] = conv_init(gen, in_ch, out_ch, 1)
    return p


def residual_block_apply(p, x, slope=0.01):
    identity = x
    if "adaptor" in p:
        identity = conv_apply(p["adaptor"], x)
    out = lrelu(conv_apply(p["c1"], x, padding=1), slope)
    out = lrelu(conv_apply(p["c2"], out, padding=1), slope)
    return identity + out


def se_layer_init(gen, channel, reduction=16):
    """Two bias-free linear maps, (C, C/r) and (C/r, C), each
    U(+-1/sqrt(its input width))."""
    mid = channel // reduction
    return {"w1": _uniform(gen, (channel, mid), 1.0 / math.sqrt(channel)),
            "w2": _uniform(gen, (mid, channel), 1.0 / math.sqrt(mid))}


def se_layer_apply(p, x):
    """Squeeze (the spatial mean), a ReLU and a sigmoid gate, each matmul
    with its weights cast to x's dtype; x scaled per channel."""
    y = x.mean(dim=(2, 3))
    y = torch.relu(y @ p["w1"].to(x.dtype))
    y = torch.sigmoid(y @ p["w2"].to(x.dtype))
    return x * y[:, :, None, None]


def conv_block_residual_init(gen, ch_in, ch_out, se=True):
    p = {"c1": conv_init(gen, ch_in, ch_out, 3),
         "c2": conv_init(gen, ch_out, ch_out, 3),
         "up_dim": conv_init(gen, ch_in, ch_out, 1)}
    if se:
        p["se"] = se_layer_init(gen, ch_out)
    return p


def conv_block_residual_apply(p, x):
    out = lrelu(conv_apply(p["c1"], x, padding=1), 0.01)
    out = conv_apply(p["c2"], out, padding=1)
    if "se" in p:
        out = se_layer_apply(p["se"], out)
    return out + conv_apply(p["up_dim"], x)


def unet_init(gen, in_ch=64, out_ch=64):
    return {
        "conv1": conv_block_residual_init(gen, in_ch, 32),
        "conv2": conv_block_residual_init(gen, 32, 64),
        "conv3": conv_block_residual_init(gen, 64, 128),
        "refine": [res_block_init(gen, 128) for _ in range(4)],
        "up3": subpel1x1_init(gen, 128, 64),
        "up_conv3": conv_block_residual_init(gen, 128, 64),
        "up2": subpel1x1_init(gen, 64, 32),
        "up_conv2": conv_block_residual_init(gen, 64, out_ch),
    }


def unet_apply(p, x):
    x1 = conv_block_residual_apply(p["conv1"], x)
    x2 = conv_block_residual_apply(p["conv2"], _max_pool2(x1))
    x3 = conv_block_residual_apply(p["conv3"], _max_pool2(x2))
    for rp in p["refine"]:
        x3 = res_block_apply(rp, x3, slope=0.0)  # the ReLU form
    d3 = subpel1x1_apply(p["up3"], x3)
    d3 = conv_block_residual_apply(p["up_conv3"], torch.cat((x2, d3), dim=1))
    d2 = subpel1x1_apply(p["up2"], d3)
    return conv_block_residual_apply(p["up_conv2"],
                                     torch.cat((x1, d2), dim=1))


# ---------------------------------------------------------------------------
# encoder/decoder towers and hyper towers
# ---------------------------------------------------------------------------

def enc_tower_init(gen, in_ch, channel):
    return {
        "rbs1": res_block_stride_init(gen, in_ch, channel),
        "rb1": residual_block_init(gen, channel, channel),
        "rbs2": res_block_stride_init(gen, channel, channel),
        "rb2": residual_block_init(gen, channel, channel),
        "rbs3": res_block_stride_init(gen, channel, channel),
        "rb3": residual_block_init(gen, channel, channel),
        "down": conv_init(gen, channel, channel, 3),
    }


def enc_tower_apply(p, x):
    h = x
    for k in (1, 2, 3):
        h = res_block_stride_apply(p[f"rbs{k}"], h)
        h = residual_block_apply(p[f"rb{k}"], h)
    return conv_apply(p["down"], h, stride=2, padding=1)


def dec_tower_init(gen, out_ch, channel):
    p = {}
    for k in (1, 2, 3):
        p[f"rb{k}"] = residual_block_init(gen, channel, channel)
        p[f"rbu{k}"] = res_block_upsample_init(gen, channel, channel)
    p["rb4"] = residual_block_init(gen, channel, channel)
    p["subpel"] = subpel1x1_init(gen, channel, out_ch)
    return p


def dec_tower_apply(p, y):
    h = y
    for k in (1, 2, 3):
        h = residual_block_apply(p[f"rb{k}"], h)
        h = res_block_upsample_apply(p[f"rbu{k}"], h)
    h = residual_block_apply(p["rb4"], h)
    return subpel1x1_apply(p["subpel"], h)


def hyper_enc_init(gen, y_channel, z_channel):
    return [conv_init(gen, y_channel, z_channel, 3)] + [
        conv_init(gen, z_channel, z_channel, 3) for _ in range(4)]


def hyper_enc_apply(p, y):
    h = lrelu(conv_apply(p[0], y, padding=1), 0.01)
    h = lrelu(conv_apply(p[1], h, padding=1), 0.01)
    h = lrelu(conv_apply(p[2], h, stride=2, padding=1), 0.01)
    h = lrelu(conv_apply(p[3], h, padding=1), 0.01)
    return conv_apply(p[4], h, stride=2, padding=1)


def hyper_dec_init(gen, y_channel, z_channel, out_factor=2, mid=None):
    """mid defaults to the HEM generation's widening (y * 3 // 2); the DC
    generation keeps the tower uniform (mid = y)."""
    if mid is None:
        mid = y_channel * 3 // 2
    return {
        "c1": conv_init(gen, z_channel, y_channel, 3),
        "up1": subpel1x1_init(gen, y_channel, y_channel),
        "c2": conv_init(gen, y_channel, mid, 3),
        "up2": subpel1x1_init(gen, mid, mid),
        "c3": conv_init(gen, mid, y_channel * out_factor, 3),
    }


def hyper_dec_apply(p, z):
    h = lrelu(conv_apply(p["c1"], z, padding=1), 0.01)
    h = lrelu(subpel1x1_apply(p["up1"], h), 0.01)
    h = lrelu(conv_apply(p["c2"], h, padding=1), 0.01)
    h = lrelu(subpel1x1_apply(p["up2"], h), 0.01)
    return conv_apply(p["c3"], h, padding=1)


# ---------------------------------------------------------------------------
# HEM's SpyNet and the conv stack
# ---------------------------------------------------------------------------

def hem_spynet_init(gen):
    """Four identical 7x7 MEBasic levels (`moduleBasic`), unlike FM's
    SpyNet, which narrows to 5x5 at the finer levels."""
    return {"moduleBasic": [me_basic_init(gen, 7) for _ in range(4)]}


def hem_spynet_apply(p, im1, im2):
    """Coarse-to-fine flow from im1 to im2 (NCHW, H and W multiples of
    16); every level, the coarsest too, warps with the upsampled previous
    flow (zero at the start)."""
    im1_levels = [im1]
    im2_levels = [im2]
    for _ in range(3):
        im1_levels.append(_avg_pool2(im1_levels[-1]))
        im2_levels.append(_avg_pool2(im2_levels[-1]))
    b, _, h8, w8 = im1_levels[3].shape
    flow = torch.zeros((b, 2, h8 // 2, w8 // 2), dtype=im1.dtype,
                       device=im1.device)
    for level in range(4):
        idx = 3 - level
        flow_up = bilinear_resize_2x(flow, up=True) * 2.0
        flow = flow_up + me_basic_apply(
            p["moduleBasic"][level],
            torch.cat((im1_levels[idx], flow_warp(im2_levels[idx], flow_up),
                       flow_up), dim=1), 7)
    return flow


def conv_lrelu_stack_init(gen, channels, ksize=3):
    """[conv + LeakyReLU(0.2)] * (n - 1) + conv, the HEM prior fusion /
    spatial prior nets."""
    return [conv_init(gen, channels[i], channels[i + 1], ksize)
            for i in range(len(channels) - 1)]


def conv_lrelu_stack_apply(plist, x, slope=0.2):
    for i, p in enumerate(plist):
        x = conv_apply(p, x, padding=1)
        if i != len(plist) - 1:
            x = lrelu(x, slope)
    return x
