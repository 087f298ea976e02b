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

QP_NUM = 64
#: the codecs' activation dtypes, by the name the harness and bench take
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def fetch_async(t):
    """Start copying a tensor to the host; returns a callable that waits
    for the copy and returns it as numpy.  A CUDA copy lands in pinned
    memory behind an event, so the device queue runs on meanwhile; the
    callable holds the pinned buffer, and the caching host allocator
    keeps it from reuse until the copy's event has passed."""
    if t.device.type != "cuda":
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return host.numpy()

    return wait


def upload(a, device):
    """numpy -> tensor on `device`; a CUDA upload goes through pinned
    memory and does not wait for the device."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


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
