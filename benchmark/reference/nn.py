"""Plain building blocks of the reference codecs (NCHW, in float32 or
the configuration's precision, `dtype_of`).

A frozen copy of the DCVC-RT blocks, masks, quantization and prior
helpers, written from the measured package's `layers/blocks.py`,
`ops/fused.py` and `models/common.py`.  Only plain torch operations, in
the same order, so that on one device and with TF32 off the reference
computes the codec's floats bit for bit.  Init functions draw through a
`draws.Draws` recorder; `draws.materialize` fills every leaf on the
device from the seed in two calls.
"""

import math

import torch
import torch.nn.functional as F

QP_NUM = 64
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg):
    """The activations' type a configuration states (`precision`)."""
    return DTYPES[cfg.get("precision", "float32")]


def pin_precision(tf32=False):
    """Float32 convolutions and matmuls in full precision (TF32 off)
    unless `tf32`, on deterministic cuDNN algorithms chosen by heuristics,
    as the measured package pins them."""
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


# ---------------------------------------------------------------------------
# convolutions and DCVC-RT blocks
# ---------------------------------------------------------------------------

def conv_init(gen, in_ch, out_ch, ksize=1, groups=1):
    """{w: (out, in/groups, k, k), b: (out,)}, U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt((in_ch // groups) * ksize * ksize)
    return {"w": gen.uniform((out_ch, in_ch // groups, ksize, ksize), bound),
            "b": gen.uniform((out_ch,), bound)}


def conv_apply(p, x, stride=1, padding=0, groups=1):
    """Convolution without bias, then the bias added (two roundings)."""
    out = F.conv2d(x, p["w"].to(x.dtype), None, stride=stride,
                   padding=padding, groups=groups)
    return out.add_(p["b"].to(x.dtype)[:, None, None])


def wsilu(x):
    return x * torch.sigmoid(4.0 * x)


def wsilu_chunk_add(x):
    y = wsilu(x)
    c = y.shape[1]
    return y[:, :c // 2] + y[:, c // 2:]


def subpel_conv2x_init(gen, in_ch, out_ch, ksize):
    return {"conv": conv_init(gen, in_ch, out_ch * 4, ksize)}


def subpel_conv2x_apply(p, x, padding=0):
    return F.pixel_shuffle(conv_apply(p["conv"], x, padding=padding), 2)


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


def dcb_seq(params_list, x):
    for bp in params_list:
        x = depth_conv_block_apply(bp, x)
    return x


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


# ---------------------------------------------------------------------------
# factorized prior parameters (drawn, never evaluated by the reference)
# ---------------------------------------------------------------------------

def bitparm_init(gen, qp_num, channel, final=False):
    p = {"h": gen.normal((qp_num, channel), 0.01),
         "b": gen.normal((qp_num, channel), 0.01)}
    if not final:
        p["a"] = gen.normal((qp_num, channel), 0.01)
    return p


def bit_estimator_init(gen, qp_num, channel):
    return {"f1": bitparm_init(gen, qp_num, channel),
            "f2": bitparm_init(gen, qp_num, channel),
            "f3": bitparm_init(gen, qp_num, channel),
            "f4": bitparm_init(gen, qp_num, channel, final=True)}


# ---------------------------------------------------------------------------
# quantization, masks, layout
# ---------------------------------------------------------------------------

def round_and_to_int8(z):
    """Round half to even, clamp to the int8 range: (z_hat in z's dtype,
    z as int8)."""
    z_hat = torch.clamp(torch.round(z.float()), -128.0, 127.0)
    return z_hat.to(z.dtype), z_hat.to(torch.int8)


def process_with_mask(y, scales, means, mask, force_zero_thres=None):
    """Masked quantization: (y_q, y_hat); with force_zero_thres, symbols
    whose masked scale is at most the threshold are zero."""
    scales_hat = scales * mask
    means_hat = means * mask
    y_res = (y - means_hat) * mask
    y_q = torch.round(y_res.float())
    if force_zero_thres is not None:
        y_q = torch.where(scales_hat.float() > force_zero_thres, y_q, 0.0)
    y_q = torch.clamp(y_q, -128.0, 127.0).to(y.dtype)
    return y_q, y_q + means_hat


def replicate_pad(x, pad_b, pad_r):
    if pad_b == 0 and pad_r == 0:
        return x
    return F.pad(x, (0, pad_r, 0, pad_b), mode="replicate")


def pixel_shuffle_clamp(x, r=8):
    return torch.clamp(F.pixel_shuffle(x, r), 0.0, 1.0)


def _parity(h, w, device):
    r = torch.arange(h, device=device)[:, None] % 2
    c = torch.arange(w, device=device)[None, :] % 2
    return r, c


def checkerboard_masks_2x(h, w, channels, dtype, device=None):
    rp, cp = _parity(h, w, device)
    m0 = ((rp + cp) % 2 == 0).to(dtype)
    m1 = 1.0 - m0
    half = channels // 2
    a, b = m0.expand(half, h, w), m1.expand(half, h, w)
    return torch.cat((a, b))[None], torch.cat((b, a))[None]


def checkerboard_masks_4x(h, w, channels, dtype, device=None):
    rp, cp = _parity(h, w, device)
    q = channels // 4
    m = [((rp == i) & (cp == j)).to(dtype).expand(q, h, w)
         for i, j in ((0, 0), (0, 1), (1, 0), (1, 1))]

    def build(order):
        return torch.cat([m[i] for i in order])[None]

    return (build((0, 1, 2, 3)), build((3, 2, 1, 0)), build((2, 3, 0, 1)),
            build((1, 0, 3, 2)))


def masks_of(t, n):
    _, c, h, w = t.shape
    fn = checkerboard_masks_2x if n == 2 else checkerboard_masks_4x
    return fn(h, w, c, t.dtype, t.device)


# ---------------------------------------------------------------------------
# shapes and priors
# ---------------------------------------------------------------------------

def padding_size(height, width, p=64):
    """(padding_right, padding_bottom) to the next multiple of p."""
    new_h = (height + p - 1) // p * p
    new_w = (width + p - 1) // p * p
    return new_w - width, new_h - height


def downsampled_shape(height, width, p):
    return (height + p - 1) // p, (width + p - 1) // p


def pad_for_y(y):
    pr, pb = padding_size(y.shape[2], y.shape[3], 4)
    return replicate_pad(y, pb, pr)


def separate_prior_image(params):
    q = torch.sigmoid(params[:, :2]) * 1.5 + 0.5
    rest = params[:, 2:]
    c = rest.shape[1] // 2
    return q[:, 0:1], q[:, 1:2], rest[:, :c], rest[:, c:]


def separate_prior_video(params):
    """(q_dec clamped at 0.5, scales, means)."""
    c = params.shape[1] // 3
    return (torch.clamp_min(params[:, :c], 0.5), params[:, c:2 * c],
            params[:, 2 * c:])


def q_vec(bank, qp, dtype):
    return bank[qp][None, :, None, None].to(dtype)


def to_nchw(x):
    """(1, H, W, 3) NHWC frame on its device -> contiguous NCHW."""
    return x.permute(0, 3, 1, 2).contiguous()


def to_nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()
