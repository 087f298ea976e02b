"""Shared compression-model helpers (NCHW).

Counterpart of the JAX package's `models/common.py`.  Prior separation:
  video: params -> (quant_step, scales, means) channel thirds, quant_step
         clamped >= 0.5, y pre-multiplied by 1/quant_step at the encoder;
  image: channels [0:2] -> sigmoid*1.5+0.5 -> (q_enc, q_dec) maps,
         channels [2:] -> (scales, means).
"""

import os

import numpy as np
import torch

from ..ops.fused import replicate_pad
from ..utils.transfer import upload

QP_NUM = 64
#: the codecs' activation dtypes, by the name the harness and bench take
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_dtype(dtype, codec):
    """Raise NotImplementedError for an activation dtype the port does
    not run (one other than float32 and bfloat16)."""
    if dtype not in DTYPES.values():
        raise NotImplementedError(
            f"{codec}: dtype {dtype} is not ported; the port runs "
            f"float32 and bfloat16")


def ec_setting(value, name, default):
    """A device-EC staging setting: `value` when the caller gives one,
    else the environment variable `name` (the JAX package's
    OPENDCVC_TPU_EC_* knob), else `default`, cast to default's type."""
    if value is not None:
        return value
    return type(default)(os.environ.get(name, default))


def resolve_device(device):
    """torch.device for a codec; a CUDA device without CUDA raises (the
    port never moves to the CPU unless the caller asks for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def frame_to_nchw(x, device, dtype=torch.float32):
    """(1, H, W, 3) NHWC frame (numpy or tensor) -> NCHW `dtype` on
    `device`, cast once with round-to-nearest-even (`jnp.asarray(x,
    dtype)`'s rounding).  A host frame is cast on the host, so a bfloat16
    upload moves half the bytes; a frame already on the device is cast
    there."""
    x = torch.as_tensor(x)
    return x.to(dtype).to(device).permute(0, 3, 1, 2).contiguous()


def frame_to_nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


def get_padding_size(height, width, p=64):
    new_h = (height + p - 1) // p * p
    new_w = (width + p - 1) // p * p
    return new_w - width, new_h - height  # (padding_right, padding_bottom)


def get_downsampled_shape(height, width, p):
    new_h = (height + p - 1) // p * p
    new_w = (width + p - 1) // p * p
    return new_h // p, new_w // p


def pad_for_y(y):
    """Replicate-pad y to a multiple of 4 for the hyper path."""
    h, w = y.shape[2], y.shape[3]
    pr, pb = get_padding_size(h, w, 4)
    return replicate_pad(y, pb, pr)


def separate_prior_image(params):
    q = torch.sigmoid(params[:, :2]) * 1.5 + 0.5
    rest = params[:, 2:]
    c = rest.shape[1] // 2
    return q[:, 0:1], q[:, 1:2], rest[:, :c], rest[:, c:]


def separate_prior_video_encoding(params, y):
    c = params.shape[1] // 3
    q_dec = torch.clamp_min(params[:, :c], 0.5)
    y = y * (1.0 / q_dec)
    return y, q_dec, params[:, c:2 * c], params[:, 2 * c:]


def separate_prior_video_decoding(params):
    c = params.shape[1] // 3
    q_dec = torch.clamp_min(params[:, :c], 0.5)
    return q_dec, params[:, c:2 * c], params[:, 2 * c:]


def q_vec(bank, qp, dtype=None):
    """A qp's row of a bank as a (1, C, 1, 1) multiplier in `dtype`, the
    activation's (default: the bank's own): a float32 bank (a checkpoint
    loaded into a bfloat16 codec) must not promote the activation to
    float32.  qp is an int, or a (1,) int64 tensor on the bank's device
    (a CUDA graph's input): the same row, gathered without a host read."""
    row = bank.index_select(0, qp) if isinstance(qp, torch.Tensor) \
        else bank[qp][None]
    return row[:, :, None, None].to(dtype or bank.dtype)


# ---------------------------------------------------------------------------
# host-EC layout: the host coder takes planes flattened NHWC
# ---------------------------------------------------------------------------

def nhwc_flat(plane):
    """Flatten a (1, C, H, W) plane in NHWC order."""
    return plane.permute(0, 2, 3, 1).reshape(-1)


def pack_host(z_planes, y_planes, keeps=None):
    """One int16 buffer of a frame's symbols for the host coder, each
    plane flattened NHWC: the z planes (int8), the y planes packed
    (symbol << 8) + CDF index, then, when given, each y plane's keep
    mask."""
    return pack_planes(list(z_planes) + list(y_planes) + list(keeps or ()))


def unpack_host(buf, z_sizes, y_sizes, masked=False):
    """Inverse of pack_host on the host: ([z int8], [packed y], [keep
    mask, or None when not masked]) of the given sizes."""
    planes, at = [], 0
    for n in list(z_sizes) + list(y_sizes) * (2 if masked else 1):
        planes.append(buf[at:at + n])
        at += n
    nz, ny = len(z_sizes), len(y_sizes)
    keeps = [k.astype(bool) for k in planes[nz + ny:]] if masked else \
        [None] * ny
    return [z.astype(np.int8) for z in planes[:nz]], planes[nz:nz + ny], \
        keeps


def code_host(coder, z_coders, gaussian, buf, z_sizes, y_sizes,
              masked=False):
    """Host-code a frame's fetched pack_host buffer: each z plane with its
    (bit estimator, qp) of `z_coders`, then the y planes in pass order
    (their kept positions when masked); returns the stream."""
    zs, ys, keeps = unpack_host(buf, z_sizes, y_sizes, masked)
    coder.reset()
    for (bit_estimator, qp), z in zip(z_coders, zs):
        bit_estimator.encode_z(z, qp)
    for packed, keep in zip(ys, keeps):
        gaussian.encode_y_packed(packed, keep)
    coder.flush()
    return coder.get_encoded_stream()


def pack_planes(planes):
    """One int16 buffer of a frame's planes for the host coder, each
    flattened NHWC, in coding order (z planes int8, y planes packed)."""
    return torch.cat([nhwc_flat(p).to(torch.int16) for p in planes])


def code_host_ordered(coder, gaussian, buf, planes):
    """Host-code a frame's fetched pack_planes buffer whose z and y
    planes interleave in coding order: `planes` holds (size, (bit
    estimator, qp)) for a z plane and (size, None) for a packed y plane.
    Returns the stream."""
    coder.reset()
    at = 0
    for n, z_coder in planes:
        part = buf[at:at + n]
        at += n
        if z_coder is None:
            gaussian.encode_y_packed(part)
        else:
            z_coder[0].encode_z(part.astype(np.int8), z_coder[1])
    coder.flush()
    return coder.get_encoded_stream()


def decode_z_host(bit_estimator, qp, zh, zw, device, dtype):
    """Host-decode the (zh, zw) z plane next in the stream and upload it
    as (1, C, zh, zw) `dtype` on `device`."""
    bit_estimator.decode_z((zh, zw), qp)
    return from_host_nhwc(bit_estimator.get_z((zh, zw), np.int8), device,
                          dtype)


def index_buf(idx, keep=None):
    """A y pass's CDF indexes (and keep mask), flattened NHWC, as one
    uint8 buffer for the host decoder."""
    parts = [nhwc_flat(idx)]
    if keep is not None:
        parts.append(nhwc_flat(keep).to(torch.uint8))
    return torch.cat(parts)


def from_host_nhwc(a, device, dtype):
    """(1, H, W, C) numpy from the host coder -> (1, C, H, W) `dtype`
    tensor on `device` with default strides: the layout the encoder's
    stages saw, so convolutions take the same algorithms on both sides.
    (`.contiguous()` keeps a permuted 1x1 plane's channels-last strides,
    and a convolution then runs channels-last.)"""
    nchw = upload(a, device).permute(0, 3, 1, 2)
    return torch.empty(nchw.shape, dtype=dtype, device=device).copy_(nchw)


def decode_y_host(gaussian, fetch, shape, device, dtype, masked=False):
    """Host-decode one y pass: wait for its index_buf (`fetch`, from
    fetch_async; with a keep mask when masked), decode it with the
    GaussianEncoder `gaussian`, upload.  Returns the dense (1, C, H, W)
    symbols as `dtype` on `device`, zeros where skipped."""
    buf = fetch()
    n = buf.shape[0] // 2 if masked else buf.shape[0]
    keep = buf[n:].astype(bool) if masked else None
    gaussian.decode_y(buf[:n], keep)
    b, c, h, w = shape
    y = gaussian.get_y((b, h, w, c), keep, dtype=np.int8)
    return from_host_nhwc(y, device, dtype)
