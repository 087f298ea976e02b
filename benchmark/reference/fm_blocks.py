"""Plain building blocks of the DCVC-FM reference (NCHW, float32): a
frozen copy of the measured package's `layers/blocks_evc.py` (the parts
FM takes), `layers/blocks_fm.py` and `ops/warp.py`, plain torch
operations in the same order."""

import torch
import torch.nn.functional as F

from .nn import conv_apply, conv_init


def lrelu(x, slope=0.01):
    """where(x >= 0, x, slope * x), the slope rounded to x's dtype."""
    return F.leaky_relu(x, float(torch.tensor(slope, dtype=x.dtype)))


# --- EVC-generation blocks --------------------------------------------------

def res_block_stride_init(gen, in_ch, out_ch, stride=2):
    p = {"conv1": conv_init(gen, in_ch, out_ch, 3),
         "conv2": conv_init(gen, out_ch, out_ch, 3)}
    if stride != 1:
        p["down"] = conv_init(gen, in_ch, out_ch, 1)
    return p


def res_block_stride_apply(p, x, stride=2):
    out = lrelu(conv_apply(p["conv1"], x, stride=stride, padding=1), 0.01)
    out = lrelu(conv_apply(p["conv2"], out, padding=1), 0.1)
    identity = x
    if "down" in p:
        identity = conv_apply(p["down"], x, stride=stride)
    return out + identity


def subpel1x1_init(gen, in_ch, out_ch, r=2):
    return conv_init(gen, in_ch, out_ch * r * r, 1)


def subpel1x1_apply(p, x, r=2):
    return F.pixel_shuffle(conv_apply(p, x), r)


def res_block_upsample_init(gen, in_ch, out_ch):
    return {"subpel": subpel1x1_init(gen, in_ch, out_ch),
            "conv": conv_init(gen, out_ch, out_ch, 3),
            "up": subpel1x1_init(gen, in_ch, out_ch)}


def res_block_upsample_apply(p, x):
    out = lrelu(subpel1x1_apply(p["subpel"], x), 0.01)
    out = lrelu(conv_apply(p["conv"], out, padding=1), 0.1)
    return out + subpel1x1_apply(p["up"], x)


# --- DepthConv / ConvFFN / DepthConvBlocks ----------------------------------

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


# --- UNet / UNet2, ResBlock, ResidualBlockWithStride2 -----------------------

def _pool2(x, reduce):
    b, c, h, w = x.shape
    return reduce(x.reshape(b, c, h // 2, 2, w // 2, 2))


def max_pool2(x):
    return _pool2(x, lambda t: t.amax(dim=(3, 5)))


def avg_pool2(x):
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
    x2 = dcb4_apply(p["conv2"], max_pool2(x1))
    x3 = dcb4_apply(p["conv3"], max_pool2(x2))
    for rp in p["refine"]:
        x3 = dcb4_apply(rp, x3)
    d3 = subpel1x1_apply(p["up3"], x3)
    d3 = dcb4_apply(p["up_conv3"], torch.cat((x2, d3), dim=1))
    d2 = subpel1x1_apply(p["up2"], d3)
    return dcb4_apply(p["up_conv2"], torch.cat((x1, d2), dim=1))


def res_block_init(gen, in_ch, out_ch):
    return {"conv1": conv_init(gen, in_ch, in_ch, 3),
            "conv2": conv_init(gen, in_ch, in_ch, 3)}


def res_block_apply(p, x, slope=0.01):
    out = conv_apply(p["conv1"], lrelu(x, slope), padding=1)
    out = conv_apply(p["conv2"], lrelu(out, slope), padding=1)
    return x + out


def rbs2_init(gen, in_ch, out_ch):
    return {"down": conv_init(gen, in_ch, out_ch, 2),
            "c1": conv_init(gen, out_ch, out_ch, 3),
            "c2": conv_init(gen, out_ch, out_ch, 1)}


def rbs2_apply(p, x):
    x = conv_apply(p["down"], x, stride=2)
    out = lrelu(conv_apply(p["c1"], x, padding=1), 0.01)
    out = lrelu(conv_apply(p["c2"], out), 0.01)
    return x + out


# --- optical flow (SpyNet) and warping --------------------------------------

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
    im1_levels, im2_levels = [im1], [im2]
    for _ in range(3):
        im1_levels.append(avg_pool2(im1_levels[-1]))
        im2_levels.append(avg_pool2(im2_levels[-1]))
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


def flow_warp(im, flow):
    """Bilinear backward warp by (dx, dy) pixel offsets, border-clamped."""
    b, c, h, w = im.shape
    orig_dtype = im.dtype
    imf, fl = im.float(), flow.float()
    ys = torch.arange(h, dtype=torch.float32, device=im.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=im.device)[None, :]
    sx = torch.clamp(xs + fl[:, 0], 0.0, w - 1.0)
    sy = torch.clamp(ys + fl[:, 1], 0.0, h - 1.0)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = (sx - x0)[:, None], (sy - y0)[:, None]
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    flat = imf.reshape(b, c, h * w)

    def gather(yy, xx):
        idx = (yy * w + xx).reshape(b, 1, h * w).expand(b, c, h * w)
        return torch.gather(flat, 2, idx).reshape(b, c, h, w)

    out = (gather(y0, x0) * (1 - wx) * (1 - wy)
           + gather(y0, x1) * wx * (1 - wy)
           + gather(y1, x0) * (1 - wx) * wy
           + gather(y1, x1) * wx * wy)
    return out.to(orig_dtype)


def _up2_along(x, dim):
    n = x.shape[dim]
    xf = x.float()
    prev = torch.cat((xf.narrow(dim, 0, 1), xf.narrow(dim, 0, n - 1)), dim)
    nxt = torch.cat((xf.narrow(dim, 1, n - 1), xf.narrow(dim, n - 1, 1)),
                    dim)
    even = 0.25 * prev + 0.75 * xf
    odd = 0.75 * xf + 0.25 * nxt
    even.narrow(dim, 0, 1).copy_(xf.narrow(dim, 0, 1))
    odd.narrow(dim, n - 1, 1).copy_(xf.narrow(dim, n - 1, 1))
    out = torch.stack((even, odd), dim + 1)
    shape = list(x.shape)
    shape[dim] = 2 * n
    return out.reshape(shape).to(x.dtype)


def bilinear_resize_2x(x, up=True):
    b, c, h, w = x.shape
    if up:
        first, second = (3, 2) if w > h else (2, 3)
        return _up2_along(_up2_along(x, first), second)
    return x.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))
