"""EVC-generation building blocks (LeakyReLU) as plain functions over
parameter dicts (NCHW; conv weights OIHW).

Counterpart of the JAX package's `layers/blocks_evc.py`, with its names
and parameter keys, so a JAX parameter tree converts mechanically
(`utils/params.py`):
  * LeakyReLU; ResidualBlockWithStride (3x3 stride s, LeakyReLU 0.01, 3x3,
    LeakyReLU 0.1, plus a 1x1 stride-s shortcut), the 1x1 subpel conv and
    ResidualBlockUpsample;
  * the encoder/decoder DepthConvBlock (DepthConv activating after every
    conv, then ConvFFN with ReLU, width 4C);
  * the hyperprior DepthConvBlock (activating after its first 1x1 only,
    then ConvFFN with LeakyReLU 0.1, width clamped to [2C, min(4C,
    1024)]) and its subpel-upsampling form.
The FM and HEM generations take the LeakyReLU, residual and subpel blocks
from here, as the JAX package's do.  `init` functions draw from an
explicit `torch.Generator` with the JAX package's distributions (not its
draws).
"""

import functools

import torch
import torch.nn.functional as F

from ..ops.fused import depth_to_space
from .blocks import conv_apply, conv_init


@functools.lru_cache(maxsize=None)
def _slope_in(slope, dtype):
    """`slope` rounded to `dtype`: the JAX package's weak-typed `slope *
    x` multiplies by the slope in x's dtype."""
    return float(torch.tensor(slope, dtype=dtype))


def lrelu(x, slope=0.01):
    """The JAX package's where(x >= 0, x, slope * x), bit for bit, in one
    kernel: the slope is rounded to x's dtype (as JAX rounds it), and
    the product of two values of that dtype, exact in float, is rounded
    once (at -0.0 both give -0.0)."""
    return F.leaky_relu(x, _slope_in(slope, x.dtype))


# ---------------------------------------------------------------------------
# residual blocks
# ---------------------------------------------------------------------------

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
    return depth_to_space(conv_apply(p, x), r)


def res_block_upsample_init(gen, in_ch, out_ch):
    return {"subpel": subpel1x1_init(gen, in_ch, out_ch),
            "conv": conv_init(gen, out_ch, out_ch, 3),
            "up": subpel1x1_init(gen, in_ch, out_ch)}


def res_block_upsample_apply(p, x):
    out = lrelu(subpel1x1_apply(p["subpel"], x), 0.01)
    out = lrelu(conv_apply(p["conv"], out, padding=1), 0.1)
    return out + subpel1x1_apply(p["up"], x)


# ---------------------------------------------------------------------------
# encoder/decoder DepthConvBlock: an activation after every conv
# ---------------------------------------------------------------------------

def _depth_conv_params(gen, in_ch, out_ch, stride):
    p = {"conv1": conv_init(gen, in_ch, in_ch, 1),
         "dw": conv_init(gen, in_ch, in_ch, 3, groups=in_ch),
         "conv2": conv_init(gen, in_ch, out_ch, 1)}
    if stride != 1:
        p["adaptor"] = conv_init(gen, in_ch, out_ch, 2)
    elif in_ch != out_ch:
        p["adaptor"] = conv_init(gen, in_ch, out_ch, 1)
    return p


def depth_conv_init(gen, in_ch, out_ch, stride=1):
    return _depth_conv_params(gen, in_ch, out_ch, stride)


def depth_conv_apply(p, x, stride=1):
    identity = x
    if "adaptor" in p:
        identity = conv_apply(p["adaptor"], x, stride=stride)
    c = x.shape[1]
    out = lrelu(conv_apply(p["conv1"], x, stride=stride), 0.01)
    out = lrelu(conv_apply(p["dw"], out, padding=1, groups=c), 0.01)
    out = lrelu(conv_apply(p["conv2"], out), 0.01)
    return out + identity


def conv_ffn_init(gen, in_ch, internal_ch=None):
    internal = in_ch * 4 if internal_ch is None else internal_ch
    return {"c1": conv_init(gen, in_ch, internal, 1),
            "c2": conv_init(gen, internal, in_ch, 1)}


def conv_ffn_apply(p, x):
    out = torch.relu(conv_apply(p["c1"], x))
    out = torch.relu(conv_apply(p["c2"], out))
    return x + out


def dcb_init(gen, in_ch, out_ch, stride=1):
    return {"dc": depth_conv_init(gen, in_ch, out_ch, stride),
            "ffn": conv_ffn_init(gen, out_ch)}


def dcb_apply(p, x, stride=1):
    return conv_ffn_apply(p["ffn"], depth_conv_apply(p["dc"], x, stride))


# ---------------------------------------------------------------------------
# hyperprior DepthConvBlock: an activation after the first 1x1 only
# ---------------------------------------------------------------------------

def hp_depth_conv_init(gen, in_ch, out_ch, stride=1):
    return _depth_conv_params(gen, in_ch, out_ch, stride)


def hp_depth_conv_apply(p, x, stride=1):
    identity = x
    if "adaptor" in p:
        identity = conv_apply(p["adaptor"], x, stride=stride)
    c = x.shape[1]
    out = lrelu(conv_apply(p["conv1"], x, stride=stride), 0.01)
    out = conv_apply(p["dw"], out, padding=1, groups=c)
    out = conv_apply(p["conv2"], out)
    return out + identity


def hp_ffn_init(gen, in_ch):
    internal = max(min(in_ch * 4, 1024), in_ch * 2)
    return {"c1": conv_init(gen, in_ch, internal, 1),
            "c2": conv_init(gen, internal, in_ch, 1)}


def hp_ffn_apply(p, x):
    out = lrelu(conv_apply(p["c1"], x), 0.1)
    out = lrelu(conv_apply(p["c2"], out), 0.1)
    return x + out


def hp_dcb_init(gen, in_ch, out_ch, stride=1):
    return {"dc": hp_depth_conv_init(gen, in_ch, out_ch, stride),
            "ffn": hp_ffn_init(gen, out_ch)}


def hp_dcb_apply(p, x, stride=1):
    return hp_ffn_apply(p["ffn"], hp_depth_conv_apply(p["dc"], x, stride))


def hp_dcb_upsample_init(gen, in_ch, out_ch):
    return {"dcb": hp_dcb_init(gen, in_ch, out_ch),
            "subpel": conv_init(gen, out_ch, out_ch * 4, 1)}


def hp_dcb_upsample_apply(p, x):
    return depth_to_space(conv_apply(p["subpel"], hp_dcb_apply(p["dcb"], x)),
                          2)
