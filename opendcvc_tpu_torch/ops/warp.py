"""Motion warping ops (NCHW).

Counterpart of the JAX package's `ops/warp.py`, written as the same
explicit arithmetic rather than through `F.grid_sample` /
`F.interpolate`, whose edge and rounding rules are their own:
  * `flow_warp`: a bilinear backward warp with the sample position
    clamped to the image border, optionally times a mask: the CUDA kernel
    W1 (`csrc/flow_warp.cu`) for CUDA tensors, its plain twin
    `flow_warp_plain` (four gathers from the flattened image and the same
    weighted sum, in float32 and cast back) for CPU tensors; the two are
    equal bit for bit, gradients included;
  * `bilinear_resize_2x`: up is `jax.image.resize(method="bilinear")` at
    scale 2 (half-pixel centers, taps 1/4 and 3/4, the weights
    renormalised at the border, where the edge sample is taken whole;
    each axis summed in float32 and rounded once to the input's dtype,
    the longer axis first, in `jax.image.resize`'s order);
    down is the mean of each 2x2 block (torch's bilinear x1/2 without
    antialiasing).
"""

import torch

from ..utils import trace

#: W1's dtype codes (csrc/flow_warp.cu)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_FN = []    # the ctypes function, looked up once


def flow_warp_plain(im, flow, mask=None):
    """im (B, C, H, W), flow (B, 2, H, W) of (dx, dy) pixel offsets: the
    sample of pixel (x, y) is at (x + dx, y + dy), clamped to the border.
    Returns (B, C, H, W) in im's dtype, times mask (B, 1, H, W) where one
    is given (the product rounded in the result's dtype)."""
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
    out = out.to(orig_dtype)
    return out if mask is None else out * mask


def _launch(im, flow, mask):
    """W1 on contiguous checked operands, on the current stream; a new
    output."""
    if not _FN:
        from . import _build
        _FN.append(_build.load_kernels()["flow_warp"].flow_warp_launch)
    b, c, h, w = im.shape
    out = torch.empty_like(im)
    err = _FN[0](im.data_ptr(), flow.data_ptr(),
                 None if mask is None else mask.data_ptr(), out.data_ptr(),
                 b, c, h, w, DTYPES[im.dtype], DTYPES[flow.dtype],
                 torch._C._cuda_getCurrentRawStream(im.get_device()))
    if err:
        raise RuntimeError(f"flow_warp launch failed: cudaError {err}")
    trace.count("warp.launch")
    return out


class _WarpFn(torch.autograd.Function):
    """W1 where autograd records; the backward differentiates the plain
    twin's graph, rebuilt on the saved operands, so the gradients are the
    twin's bit for bit."""

    @staticmethod
    def forward(ctx, im, flow, mask):
        ctx.save_for_backward(im, flow, mask)
        return _launch(im, flow, mask)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        ops = [None if t is None else t.detach().requires_grad_(n)
               for t, n in zip(saved, need)]
        wanted = [t for t, n in zip(ops, need) if n]
        with torch.enable_grad():
            out = flow_warp_plain(*ops)
        grads = iter(torch.autograd.grad(out, wanted, g))
        return tuple(next(grads) if n else None for n in need)


def _check(im, flow, mask):
    """Both paths: im NCHW; flow (B, 2, H, W) and mask (B, 1, H, W) on
    im's device."""
    if im.dim() != 4:
        raise ValueError(f"expected an NCHW image, got {im.dim()}-d")
    b, _, h, w = im.shape
    if tuple(flow.shape) != (b, 2, h, w) or flow.device != im.device:
        raise ValueError(f"flow must be ({b}, 2, {h}, {w}) on {im.device}, "
                         f"got {tuple(flow.shape)} on {flow.device}")
    if mask is not None and (tuple(mask.shape) != (b, 1, h, w) or
                             mask.device != im.device):
        raise ValueError(f"mask must be ({b}, 1, {h}, {w}) on {im.device}, "
                         f"got {tuple(mask.shape)} on {mask.device}")


def _check_w1(im, flow, mask):
    """What W1 takes besides: im and flow float32 / bfloat16, mask of
    im's dtype, all contiguous."""
    if im.dtype not in DTYPES or flow.dtype not in DTYPES:
        raise ValueError(f"flow_warp takes float32 or bfloat16 on CUDA, got "
                         f"im {im.dtype}, flow {flow.dtype}")
    if mask is not None and mask.dtype != im.dtype:
        raise ValueError(f"mask must be {im.dtype} on CUDA, got "
                         f"{mask.dtype}")
    if not (im.is_contiguous() and flow.is_contiguous() and
            (mask is None or mask.is_contiguous())):
        raise ValueError("flow_warp takes contiguous operands on CUDA")


def flow_warp(im, flow, mask=None):
    """flow_warp_plain(im, flow, mask): on W1 for CUDA tensors (through
    its autograd Function where autograd records), on the twin for CPU
    tensors, which takes any floating dtype and any strides.  Counts
    `warp.call`, and `warp.fused` on W1."""
    _check(im, flow, mask)
    trace.count("warp.call")
    if not im.is_cuda:
        return flow_warp_plain(im, flow, mask)
    _check_w1(im, flow, mask)
    trace.count("warp.fused")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (im, flow, mask)):
        return _WarpFn.apply(im, flow, mask)
    return _launch(im, flow, mask)


def _up2_along(x, dim):
    """Bilinear x2 along `dim`: output 2k = 1/4 x[k-1] + 3/4 x[k], output
    2k+1 = 3/4 x[k] + 1/4 x[k+1]; the first and last outputs, whose outer
    tap falls off the edge, take the edge sample with weight 1.  The taps
    are summed in float32 and the sum rounded once to x's dtype, as
    `jax.image.resize`'s contraction rounds it (a bfloat16 sum of
    bfloat16 products would round twice)."""
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
    """(B, C, H, W) -> (B, C, 2H, 2W) (up) or (B, C, H/2, W/2) (down)."""
    b, c, h, w = x.shape
    if up:
        # jax.image.resize's einsum contracts the longer axis first (the
        # height on a tie); each contraction rounds to x's dtype
        first, second = (3, 2) if w > h else (2, 3)
        return _up2_along(_up2_along(x, first), second)
    return x.reshape(b, c, h // 2, 2, w // 2, 2).mean(dim=(3, 5))
