"""Color transforms and chroma resampling (reference: src/utils/transforms.py).

Counterpart of the JAX package's `utils/transforms.py`: a numpy function
for the host IO path and torch functions on NHWC tensors for the device.
BT.709 weights.  The torch functions keep the JAX package's order of
operations, so their float32 results match XLA's as closely as the two
backends' rounding allows.
"""

import numpy as np
import scipy.ndimage
import torch

YCBCR_WEIGHTS = {"ITU-R_BT.709": (0.2126, 0.7152, 0.0722)}


def ycbcr420_to_444_np(y, uv, order=0):
    """y: (1,H,W), uv: (2,H/2,W/2) -> (3,H,W) float numpy (nearest by
    default, matching the reference's evaluation convention)."""
    uv = scipy.ndimage.zoom(uv, (1, 2, 2), order=order)
    return np.concatenate((y, uv), axis=0)


def rgb2ycbcr(rgb):
    """NHWC [0,1] RGB -> YCbCr, clamped."""
    r, g, b = rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]
    Kr, Kg, Kb = YCBCR_WEIGHTS["ITU-R_BT.709"]
    y = Kr * r + Kg * g + Kb * b
    cb = 0.5 * (b - y) / (1 - Kb) + 0.5
    cr = 0.5 * (r - y) / (1 - Kr) + 0.5
    return torch.clamp(torch.cat((y, cb, cr), dim=-1), 0.0, 1.0)


def ycbcr2rgb(ycbcr, clamp=True):
    """NHWC YCbCr -> RGB."""
    y, cb, cr = ycbcr[..., 0:1], ycbcr[..., 1:2], ycbcr[..., 2:3]
    Kr, Kg, Kb = YCBCR_WEIGHTS["ITU-R_BT.709"]
    r = y + (2 - 2 * Kr) * (cr - 0.5)
    b = y + (2 - 2 * Kb) * (cb - 0.5)
    g = (y - Kr * r - Kb * b) / Kg
    rgb = torch.cat((r, g, b), dim=-1)
    if clamp:
        rgb = torch.clamp(rgb, 0.0, 1.0)
    return rgb


def yuv_444_to_420(yuv):
    """NHWC 444 -> (y (B,H,W,1), uv (B,H/2,W/2,2)) via 2x2 average pool."""
    y = yuv[..., 0:1]
    uv = yuv[..., 1:3]
    b, h, w, c = uv.shape
    uv = uv.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))
    return y, uv
