"""Rank functions of the port's multi-process CPU tests
(`tests/test_torch_port_parallel_*.py`), run by
`opendcvc_tpu_torch/parallel/dryrun.py::run_ranks` in spawned gloo ranks.
A spawned rank imports this module to find its function, so it imports
neither JAX nor a test module; each function returns plain numbers and
numpy arrays."""

import os

import numpy as np
import torch
import torch.distributed as dist

from opendcvc_tpu_torch.layers import blocks as L
from opendcvc_tpu_torch.parallel.mesh import (Shard, make_mesh,
                                              replicate_sharding, sharded)

#: the halo cases: (in channels, out channels, kernel, stride, padding,
#: groups, subpel): DCVC-RT's padded convolutions (3x3 at stride 1 and,
#: as enc_down, 2; the DCB's depthwise 3x3; dec_up's subpel 2x)
HALO_CASES = {
    "pad1_stride1": (8, 6, 3, 1, 1, 1, False),
    "pad1_stride2": (8, 6, 3, 2, 1, 1, False),
    "depthwise": (8, 8, 3, 1, 1, 8, False),
    "subpel2x": (8, 3, 3, 1, 1, 1, True),
}
HALO_N, HALO_ROWS, HALO_W = 2, 8, 6


def halo_inputs(case, sp):
    """The unsplit (x, weight, bias, the loss's weights r) of a case."""
    cin, cout, k, stride, _, groups, subpel = HALO_CASES[case]
    rng = np.random.default_rng(sorted(HALO_CASES).index(case) + 10 * sp)
    h = HALO_ROWS * sp
    x = rng.normal(size=(HALO_N, cin, h, HALO_W)).astype(np.float32)
    w = rng.normal(size=(cout * (4 if subpel else 1), cin // groups, k,
                         k)).astype(np.float32)
    b = rng.normal(size=(w.shape[0],)).astype(np.float32)
    ho, wo = (2 * h, 2 * HALO_W) if subpel else \
        (h // stride, -(-HALO_W // stride))
    r = rng.normal(size=(HALO_N, cout, ho, wo)).astype(np.float32)
    return x, w, b, r


def halo_apply(case, x, w, b):
    """The case's convolution through conv_apply (the hook)."""
    _, _, _, stride, padding, groups, subpel = HALO_CASES[case]
    if subpel:
        return L.subpel_conv2x_apply({"conv": {"w": w, "b": b}}, x,
                                     padding=padding)
    return L.conv_apply({"w": w, "b": b}, x, stride=stride,
                        padding=padding, groups=groups)


def halo_grads(case, x, w, b, r):
    """(out, d loss/dx, /dw, /db) of loss = sum(out * r)."""
    x, w, b = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    out = halo_apply(case, x, w, b)
    gx, gw, gb = torch.autograd.grad(torch.sum(out * torch.from_numpy(r)),
                                     (x, w, b))
    return out.detach(), gx, gw, gb


def halo_rank(dev, sp):
    """Every halo case on this rank's rows of the frame (a (1, sp) mesh):
    {case: (out block, x's gradient block, w's and b's gradients summed
    over the ranks)}."""
    del dev
    mesh = make_mesh((1, sp))
    shard = Shard(mesh, spatial=True)
    s = mesh.index("spatial")
    out = {}
    for case in sorted(HALO_CASES):
        x, w, b, r = halo_inputs(case, sp)
        hx, hr = x.shape[2] // sp, r.shape[2] // sp
        with sharded(shard):
            o, gx, gw, gb = halo_grads(
                case, np.ascontiguousarray(x[:, :, s * hx:(s + 1) * hx]),
                w, b, np.ascontiguousarray(r[:, :, s * hr:(s + 1) * hr]))
        for g in (gw, gb):
            dist.all_reduce(g)
        out[case] = tuple(t.numpy() for t in (o, gx, gw, gb))
    return out


DEC_H, DEC_W, DEC_QP = 128, 64, 21


def _decode(p, y_hat, ctx):
    from opendcvc_tpu_torch.models import dmc as MV
    return MV._stage_recon_x(p, MV._stage_feature(p, y_hat, ctx, DEC_QP),
                             DEC_QP)


def _decode_grads(params, leaves, y_hat, ctx, r):
    y_hat, ctx = (t.clone().requires_grad_(True) for t in (y_hat, ctx))
    out = _decode(params, y_hat, ctx)
    grads = torch.autograd.grad(torch.sum(out * r), [y_hat, ctx] + leaves,
                                allow_unused=True)
    return out.detach(), [torch.zeros_like(t) if g is None else g
                          for t, g in zip([y_hat, ctx] + leaves, grads)]


def decode_rank(dev, sp):
    """DMC's decode stages (_stage_feature, then _stage_recon_x; the
    port's full-width init, seed 0) on this rank's rows of a DEC_H x
    DEC_W frame's latent and context, against the unsplit stages on rank
    0: returns rank 0's largest errors, each over max |reference|: the
    frame, y_hat's and ctx's gradients, and the worst parameter
    gradient (summed over the ranks)."""
    from opendcvc_tpu_torch.models.dmc import dmc_init
    from opendcvc_tpu_torch.training.train import tree_leaves
    del dev
    mesh = make_mesh((1, sp))
    s = mesh.index("spatial")
    params = dmc_init(torch.Generator().manual_seed(0))
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    rng = np.random.default_rng(0)
    y_hat = torch.from_numpy(rng.normal(
        size=(1, 128, DEC_H // 16, DEC_W // 16)).astype(np.float32))
    ctx = torch.from_numpy(rng.normal(
        size=(1, 256, DEC_H // 8, DEC_W // 8)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(1, 3, DEC_H, DEC_W))
                         .astype(np.float32))

    def rows(t, k):
        h = t.shape[2] // sp
        return t[:, :, k * h:(k + 1) * h]

    with sharded(Shard(mesh, spatial=True)):
        out, grads = _decode_grads(params, leaves, rows(y_hat, s),
                                   rows(ctx, s), rows(r, s))
    for g in grads[2:]:
        dist.all_reduce(g)
    parts = [out, grads[0], grads[1]]
    gathered = [[torch.zeros_like(t) for _ in range(sp)] for t in parts]
    for dst, t in zip(gathered, parts):
        dist.all_gather(dst, t.contiguous())
    if s != 0:
        return None
    ref_out, ref_grads = _decode_grads(params, leaves, y_hat, ctx, r)

    def err(got, ref):
        scale = float(ref.abs().max())
        return float((got - ref).abs().max()) / (scale or 1.0)

    got = [torch.cat(g, dim=2) for g in gathered]
    return {"x_hat": err(got[0], ref_out), "y_hat_grad": err(got[1],
                                                             ref_grads[0]),
            "ctx_grad": err(got[2], ref_grads[1]),
            "param_grad": max(err(g, w) for g, w in zip(grads[2:],
                                                        ref_grads[2:]))}


def train_video_rank(dev, argv):
    """train_video.main(argv) under OPENDCVC_TPU_DIST on this rank (the
    group is joined already); returns the final loss, or the error's type
    name and message if it raised."""
    from opendcvc_tpu_torch import train_video
    del dev
    os.environ["OPENDCVC_TPU_DIST"] = "1"
    try:
        res = train_video.main(argv)
    except ValueError as e:
        return ("ValueError", str(e))
    return {"loss": [m["loss"] for m in res["metrics"]],
            "same": replicate_sharding(None, res["params"])}
