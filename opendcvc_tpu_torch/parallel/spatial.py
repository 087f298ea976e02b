"""Halo exchanges for a frame split in height over the "spatial" axis.

GSPMD inserts a sharded convolution's halo exchange by itself; here it is
written by hand.  A rank holding rows [s h, (s + 1) h) of the frame
(NCHW) takes `rows` rows from the shard above and from the shard below
before a convolution with `rows` of vertical padding, and zero rows at
the frame's top and bottom edges, where the unsplit convolution pads
with zeros; the convolution then runs with vertical padding 0.  Stride 2
with padding 1 lines up when the shard heights are even.  The exchange
is one `batch_isend_irecv` of both directions; its backward sends each
halo's gradient to the rank that owns those rows, which adds it.

The hook is `layers/blocks.py::conv_nobias` (the convolution half of
`conv_apply`), which every DCVC-RT (DMC, DMCI) convolution goes through,
under `parallel/mesh.py::sharded` with a Shard whose `sp` is above 1.
"""

import torch
import torch.distributed as dist

from .mesh import active_shard


def _swap(sends, recvs, group):
    """Post every send and receive ((peer, tensor) pairs) at once, then
    wait for all of them."""
    ops = [dist.P2POp(dist.isend, t, peer, group) for peer, t in sends] \
        + [dist.P2POp(dist.irecv, t, peer, group) for peer, t in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


class _Halo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, rows, up, down, group):
        n, c, _, w = x.shape
        top = x.new_zeros((n, c, rows, w))
        bottom = x.new_zeros((n, c, rows, w))
        sends, recvs = [], []
        if up is not None:
            sends.append((up, x[:, :, :rows].contiguous()))
            recvs.append((up, top))
        if down is not None:
            sends.append((down, x[:, :, -rows:].contiguous()))
            recvs.append((down, bottom))
        _swap(sends, recvs, group)
        ctx.halo = (rows, up, down, group)
        return torch.cat((top, x, bottom), dim=2)

    @staticmethod
    def backward(ctx, grad):
        rows, up, down, group = ctx.halo
        grad_x = grad[:, :, rows:-rows].contiguous()
        from_up = torch.zeros_like(grad_x[:, :, :rows])
        from_down = torch.zeros_like(grad_x[:, :, :rows])
        sends, recvs = [], []
        if up is not None:
            # the top halo is the upper shard's last rows
            sends.append((up, grad[:, :, :rows].contiguous()))
            recvs.append((up, from_up))
        if down is not None:
            sends.append((down, grad[:, :, -rows:].contiguous()))
            recvs.append((down, from_down))
        _swap(sends, recvs, group)
        grad_x[:, :, :rows] += from_up
        grad_x[:, :, -rows:] += from_down
        return grad_x, None, None, None, None


def halo_exchange(x, rows, sh):
    """x (N, C, h, W), Shard sh's rows of the frame -> (N, C, h + 2 rows,
    W): the shard above's last `rows` rows on top, the shard below's first
    `rows` at the bottom, zeros at the frame's edges.  Every rank of sh's
    spatial line must call this in the same order.  Differentiable.
    Raises ValueError if h < rows."""
    if x.shape[2] < rows:
        raise ValueError(f"a shard of {x.shape[2]} rows cannot lend a halo "
                         f"of {rows}")
    ranks, s = sh.spatial_ranks, sh.s
    up = ranks[s - 1] if s > 0 else None
    down = ranks[s + 1] if s + 1 < len(ranks) else None
    return _Halo.apply(x, rows, up, down, sh.spatial_group)


def split_rows():
    """The active Shard when the frame is split in height, else None."""
    sh = active_shard()
    return sh if sh is not None and sh.sp > 1 else None
