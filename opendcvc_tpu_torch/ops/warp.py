"""Motion warping ops (NCHW).

Counterpart of the JAX package's `ops/warp.py`, written as the same
explicit arithmetic rather than through `F.grid_sample` /
`F.interpolate`, whose edge and rounding rules are their own:
  * `flow_warp`: a bilinear backward warp with the sample position
    clamped to the image border, four gathers from the flattened image
    and the same weighted sum, in float32 and cast back;
  * `bilinear_resize_2x`: up is `jax.image.resize(method="bilinear")` at
    scale 2 (half-pixel centers, taps 1/4 and 3/4, the weights
    renormalised at the border, where the edge sample is taken whole);
    down is the mean of each 2x2 block (torch's bilinear x1/2 without
    antialiasing).
"""

import torch


def flow_warp(im, flow):
    """im (B, C, H, W), flow (B, 2, H, W) of (dx, dy) pixel offsets: the
    sample of pixel (x, y) is at (x + dx, y + dy), clamped to the border.
    Returns (B, C, H, W) in im's dtype."""
    b, c, h, w = im.shape
    orig_dtype = im.dtype
    imf = im.float()
    fl = flow.float()
    ys = torch.arange(h, dtype=torch.float32, device=im.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=im.device)[None, :]
    sx = torch.clamp(xs + fl[:, 0], 0.0, w - 1.0)
    sy = torch.clamp(ys + fl[:, 1], 0.0, h - 1.0)

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = (sx - x0)[:, None]
    wy = (sy - y0)[:, None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
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
    """Bilinear x2 along `dim`: output 2k = 1/4 x[k-1] + 3/4 x[k], output
    2k+1 = 3/4 x[k] + 1/4 x[k+1]; the first and last outputs, whose outer
    tap falls off the edge, take the edge sample with weight 1."""
    n = x.shape[dim]
    prev = torch.cat((x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)), dim)
    nxt = torch.cat((x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)), dim)
    even = 0.25 * prev + 0.75 * x
    odd = 0.75 * x + 0.25 * nxt
    even.narrow(dim, 0, 1).copy_(x.narrow(dim, 0, 1))
    odd.narrow(dim, n - 1, 1).copy_(x.narrow(dim, n - 1, 1))
    out = torch.stack((even, odd), dim + 1)
    shape = list(x.shape)
    shape[dim] = 2 * n
    return out.reshape(shape)


def bilinear_resize_2x(x, up=True):
    """(B, C, H, W) -> (B, C, 2H, 2W) (up) or (B, C, H/2, W/2) (down)."""
    b, c, h, w = x.shape
    if up:
        return _up2_along(_up2_along(x, 2), 3)
    return x.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))
