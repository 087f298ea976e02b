"""Plain building blocks of the DCVC-HEM reference (NCHW, float32): a
frozen copy of the measured package's `layers/blocks_hem.py`, plain torch
operations in the same order.  The EVC-generation blocks, the pools, the
SpyNet level, the warp and the 2x resize are `fm_blocks`'."""

import math

import torch
import torch.nn.functional as F

from .fm_blocks import (avg_pool2, bilinear_resize_2x, flow_warp,
                        lrelu, max_pool2, me_basic_apply, me_basic_init,
                        res_block_stride_apply, res_block_stride_init,
                        res_block_upsample_apply, res_block_upsample_init,
                        subpel1x1_apply, subpel1x1_init)
from .nn import conv_apply, conv_init


def d2s(x):
    return F.pixel_shuffle(x, 2)


# --- residual blocks, SE, UNet ----------------------------------------------

def res_block_init(gen, channel, bottleneck=False):
    mid = channel // 2 if bottleneck else channel
    return {"c1": conv_init(gen, channel, mid, 3),
            "c2": conv_init(gen, mid, channel, 3)}


def res_block_apply(p, x, slope=0.01, end_with_relu=False):
    """HEM's ResBlock, starting from its activation (a ReLU at slope 0)."""
    def act(v):
        return torch.relu(v) if slope < 1e-4 else lrelu(v, slope)
    out = act(conv_apply(p["c1"], act(x), padding=1))
    out = conv_apply(p["c2"], out, padding=1)
    if end_with_relu:
        out = act(out)
    return x + out


def residual_block_init(gen, in_ch, out_ch):
    p = {"c1": conv_init(gen, in_ch, out_ch, 3),
         "c2": conv_init(gen, out_ch, out_ch, 3)}
    if in_ch != out_ch:
        p["adaptor"] = conv_init(gen, in_ch, out_ch, 1)
    return p


def residual_block_apply(p, x, slope=0.01):
    identity = conv_apply(p["adaptor"], x) if "adaptor" in p else x
    out = lrelu(conv_apply(p["c1"], x, padding=1), slope)
    out = lrelu(conv_apply(p["c2"], out, padding=1), slope)
    return identity + out


def se_layer_init(gen, channel, reduction=16):
    mid = channel // reduction
    return {"w1": gen.uniform((channel, mid), 1.0 / math.sqrt(channel)),
            "w2": gen.uniform((mid, channel), 1.0 / math.sqrt(mid))}


def se_layer_apply(p, x):
    y = x.mean(dim=(2, 3))
    y = torch.relu(y @ p["w1"].to(x.dtype))
    y = torch.sigmoid(y @ p["w2"].to(x.dtype))
    return x * y[:, :, None, None]


def conv_block_residual_init(gen, ch_in, ch_out):
    return {"c1": conv_init(gen, ch_in, ch_out, 3),
            "c2": conv_init(gen, ch_out, ch_out, 3),
            "up_dim": conv_init(gen, ch_in, ch_out, 1),
            "se": se_layer_init(gen, ch_out)}


def conv_block_residual_apply(p, x):
    out = lrelu(conv_apply(p["c1"], x, padding=1), 0.01)
    out = se_layer_apply(p["se"], conv_apply(p["c2"], out, padding=1))
    return out + conv_apply(p["up_dim"], x)


def unet_init(gen, in_ch, out_ch):
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
    x2 = conv_block_residual_apply(p["conv2"], max_pool2(x1))
    x3 = conv_block_residual_apply(p["conv3"], max_pool2(x2))
    for rp in p["refine"]:
        x3 = res_block_apply(rp, x3, slope=0.0)
    d3 = subpel1x1_apply(p["up3"], x3)
    d3 = conv_block_residual_apply(p["up_conv3"], torch.cat((x2, d3), dim=1))
    d2 = subpel1x1_apply(p["up2"], d3)
    return conv_block_residual_apply(p["up_conv2"],
                                     torch.cat((x1, d2), dim=1))


# --- towers ------------------------------------------------------------------

def enc_tower_init(gen, in_ch, channel):
    p = {}
    for k in (1, 2, 3):
        p[f"rbs{k}"] = res_block_stride_init(gen, in_ch if k == 1
                                             else channel, channel)
        p[f"rb{k}"] = residual_block_init(gen, channel, channel)
    p["down"] = conv_init(gen, channel, channel, 3)
    return p


def enc_tower_apply(p, x):
    for k in (1, 2, 3):
        x = residual_block_apply(p[f"rb{k}"],
                                 res_block_stride_apply(p[f"rbs{k}"], x))
    return conv_apply(p["down"], x, stride=2, padding=1)


def dec_tower_init(gen, out_ch, channel):
    p = {}
    for k in (1, 2, 3):
        p[f"rb{k}"] = residual_block_init(gen, channel, channel)
        p[f"rbu{k}"] = res_block_upsample_init(gen, channel, channel)
    p["rb4"] = residual_block_init(gen, channel, channel)
    p["subpel"] = subpel1x1_init(gen, channel, out_ch)
    return p


def dec_tower_apply(p, y):
    for k in (1, 2, 3):
        y = res_block_upsample_apply(p[f"rbu{k}"],
                                     residual_block_apply(p[f"rb{k}"], y))
    return subpel1x1_apply(p["subpel"], residual_block_apply(p["rb4"], y))


def hyper_enc_init(gen, y_ch, z_ch):
    return [conv_init(gen, y_ch, z_ch, 3)] + \
        [conv_init(gen, z_ch, z_ch, 3) for _ in range(4)]


def hyper_enc_apply(p, y):
    """Five 3x3 convs, the third and the fifth of stride 2."""
    for i, stride in enumerate((1, 1, 2, 1)):
        y = lrelu(conv_apply(p[i], y, stride=stride, padding=1), 0.01)
    return conv_apply(p[4], y, stride=2, padding=1)


def hyper_dec_init(gen, y_ch, z_ch):
    mid = y_ch * 3 // 2
    return {"c1": conv_init(gen, z_ch, y_ch, 3),
            "up1": subpel1x1_init(gen, y_ch, y_ch),
            "c2": conv_init(gen, y_ch, mid, 3),
            "up2": subpel1x1_init(gen, mid, mid),
            "c3": conv_init(gen, mid, y_ch * 2, 3)}


def hyper_dec_apply(p, z):
    h = lrelu(conv_apply(p["c1"], z, padding=1), 0.01)
    h = lrelu(subpel1x1_apply(p["up1"], h), 0.01)
    h = lrelu(conv_apply(p["c2"], h, padding=1), 0.01)
    h = lrelu(subpel1x1_apply(p["up2"], h), 0.01)
    return conv_apply(p["c3"], h, padding=1)


def stack_init(gen, channels):
    """[3x3 conv + LeakyReLU(0.2)] x (n - 1) + a 3x3 conv."""
    return [conv_init(gen, channels[i], channels[i + 1], 3)
            for i in range(len(channels) - 1)]


def stack_apply(plist, x):
    for i, p in enumerate(plist):
        x = conv_apply(p, x, padding=1)
        if i != len(plist) - 1:
            x = lrelu(x, 0.2)
    return x


# --- HEM's SpyNet -----------------------------------------------------------

def spynet_init(gen):
    return {"moduleBasic": [me_basic_init(gen, 7) for _ in range(4)]}


def spynet_apply(p, im1, im2):
    """Four 7x7 levels, coarse to fine; each warps im2 by the upsampled
    flow of the level before (zero at the coarsest)."""
    im1_levels, im2_levels = [im1], [im2]
    for _ in range(3):
        im1_levels.append(avg_pool2(im1_levels[-1]))
        im2_levels.append(avg_pool2(im2_levels[-1]))
    b, _, h8, w8 = im1_levels[3].shape
    flow = torch.zeros((b, 2, h8 // 2, w8 // 2), dtype=im1.dtype,
                       device=im1.device)
    for level in range(4):
        idx = 3 - level
        up = bilinear_resize_2x(flow, up=True) * 2.0
        flow = up + me_basic_apply(
            p["moduleBasic"][level],
            torch.cat((im1_levels[idx], flow_warp(im2_levels[idx], up), up),
                      dim=1), 7)
    return flow
