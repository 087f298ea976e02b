"""NN building blocks of DCVC-RT as plain functions over parameter dicts
(NCHW; conv weights OIHW).

Counterpart of the JAX package's `layers/blocks.py`: WSiLU, WSiLUChunkAdd,
SubpelConv2x, DepthConvBlock, ResidualBlockWithStride2 and
ResidualBlockUpsample, with the JAX package's parameter names, so a JAX
parameter tree converts mechanically (`utils/params.py`).  Padding is
explicit and symmetric, as torch's conv takes it.  `init` functions draw
from an explicit `torch.Generator` with the JAX package's distributions.
"""

import math

import torch
import torch.nn.functional as F

from ..ops.fused import depth_to_space
from ..parallel.spatial import halo_exchange, split_rows


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def conv_init(gen, in_ch, out_ch, ksize=1, groups=1):
    """{w: (out, in/groups, k, k), b: (out,)}, U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt((in_ch // groups) * ksize * ksize)
    return {"w": _uniform(gen, (out_ch, in_ch // groups, ksize, ksize),
                          bound),
            "b": _uniform(gen, (out_ch,), bound)}


def conv_apply(p, x, stride=1, padding=0, groups=1):
    """The JAX package's `conv_apply`: the weights cast to x's dtype, the
    convolution rounded to that dtype, then the bias added and rounded
    again.  A bias fused into the convolution (oneDNN, ATen's depthwise
    CUDA kernel) rounds once and differs in bfloat16.  With the frame
    split in height (`parallel/spatial.py`), the `padding` rows above and
    below come from the neighbouring shards, and only the width is
    zero-padded here."""
    sh = split_rows() if padding else None
    if sh is not None:
        x = halo_exchange(x, padding, sh)
        padding = (0, padding)
    out = F.conv2d(x, p["w"].to(x.dtype), None, stride=stride,
                   padding=padding, groups=groups)
    return out.add_(p["b"].to(x.dtype)[:, None, None])


def conv_transpose2x_apply(p, x, torch_padding=None):
    """The JAX package's `conv_transpose2x_apply`: an exact 2x upsample,
    computed there as the correlation of the 2x zero-dilated input, padded
    (k-1-p, k-p) on each spatial axis, with the kernel as stored
    (unflipped; p the torch padding, default (k-1)//2), then the bias
    added and rounded separately, as in `conv_apply`.  torch's
    conv_transpose2d flips its kernel and swaps in/out channels, so it
    takes the flipped, transposed weight: conv_transpose2d(x, w', stride
    2, padding p, output_padding 1) is that same correlation."""
    w = p["w"].to(x.dtype)
    k = w.shape[-1]
    tp = torch_padding if torch_padding is not None else (k - 1) // 2
    out = F.conv_transpose2d(x, w.flip(2, 3).transpose(0, 1), None,
                             stride=2, padding=tp, output_padding=1)
    return out.add_(p["b"].to(x.dtype)[:, None, None])


def wsilu(x):
    """WSiLU(x) = x * sigmoid(4x)."""
    return x * torch.sigmoid(4.0 * x)


def wsilu_chunk_add(x):
    """WSiLU then the sum of the two channel halves."""
    y = wsilu(x)
    c = y.shape[1]
    return y[:, :c // 2] + y[:, c // 2:]


def subpel_conv2x_init(gen, in_ch, out_ch, ksize):
    return {"conv": conv_init(gen, in_ch, out_ch * 4, ksize)}


def subpel_conv2x_apply(p, x, padding=0):
    """conv -> PixelShuffle(2)."""
    return depth_to_space(conv_apply(p["conv"], x, padding=padding), 2)


def depth_conv_block_init(gen, in_ch, out_ch, force_adaptor=False):
    p = {}
    if in_ch != out_ch or force_adaptor:
        p["adaptor"] = conv_init(gen, in_ch, out_ch, 1)
    p["dc1"] = conv_init(gen, out_ch, out_ch, 1)
    p["dc_dw"] = conv_init(gen, out_ch, out_ch, 3, groups=out_ch)
    p["dc2"] = conv_init(gen, out_ch, out_ch, 1)
    p["ffn1"] = conv_init(gen, out_ch, out_ch * 4, 1)
    p["ffn2"] = conv_init(gen, out_ch * 2, out_ch, 1)
    return p


def depth_conv_block_apply(p, x, quant_step=None, shortcut=False):
    """[adaptor] ; dc = [1x1, WSiLU, 3x3 dw, 1x1] + x ;
    ffn = [1x1 -> 4C, WSiLUChunkAdd, 1x1] + out ; [+ x] ; [* quant_step]."""
    if "adaptor" in p:
        x = conv_apply(p["adaptor"], x)
    c = x.shape[1]
    h = wsilu(conv_apply(p["dc1"], x))
    h = conv_apply(p["dc_dw"], h, padding=1, groups=c)
    out = conv_apply(p["dc2"], h) + x
    f = conv_apply(p["ffn2"], wsilu_chunk_add(conv_apply(p["ffn1"], out)))
    out = f + out
    if shortcut:
        out = out + x
    if quant_step is not None:
        out = out * quant_step
    return out


def res_block_stride2_init(gen, in_ch, out_ch):
    return {"down": conv_init(gen, in_ch, out_ch, 2),
            "conv": depth_conv_block_init(gen, out_ch, out_ch)}


def res_block_stride2_apply(p, x):
    x = conv_apply(p["down"], x, stride=2)
    return depth_conv_block_apply(p["conv"], x, shortcut=True)


def res_block_upsample_init(gen, in_ch, out_ch):
    return {"up": subpel_conv2x_init(gen, in_ch, out_ch, 1),
            "conv": depth_conv_block_init(gen, out_ch, out_ch)}


def res_block_upsample_apply(p, x):
    x = subpel_conv2x_apply(p["up"], x)
    return depth_conv_block_apply(p["conv"], x, shortcut=True)
