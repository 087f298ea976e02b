"""The process grid on torch.distributed.

Counterpart of the JAX package's `parallel/mesh.py`.  JAX's Mesh of
devices becomes a grid of ranks, one process a card over NCCL (gloo only
where the caller asks for the CPU), and GSPMD's implicit collectives
become explicit ones: the train step all-reduces its gradients once a
step (`training/train.py::make_train_step(mesh=...)`), and a frame split
in height exchanges each convolution's halo rows (`parallel/spatial.py`).

`Shard` is what a rank holds of a step's global batch.  Inside
`sharded(shard)` the losses count every mean's elements and every rate's
pixels over the whole batch and frame, so each term adds up over the
ranks, and a noise draw takes the global shape from the shared generator
and keeps this rank's block (`training/forward.py`); the convolutions
exchange halos when the frame is split (`layers/blocks.py::conv_apply`).
"""

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from ..models.common import resolve_device
from ..utils.common import env_flag


def _env(*names):
    """The first of `names` set in the environment, else None."""
    for name in names:
        v = os.environ.get(name)
        if v is not None:
            return v
    return None


def _bound_device():
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None, device="cuda"):
    """Join the process group; returns the torch.device this process
    computes on.

    Arguments fall back to the environment in the JAX package's order:
    the coordinator (host:port) to OPENDCVC_TPU_COORDINATOR, then
    MASTER_ADDR:MASTER_PORT (port 1234 by default); the process count to
    OPENDCVC_TPU_NUM_PROCS, then SLURM_NTASKS; the process id to
    OPENDCVC_TPU_PROC_ID, then SLURM_PROCID.  torchrun's WORLD_SIZE and
    RANK come last, where `jax.distributed` autodetects a pod; a missing
    value raises ValueError.  device "cuda" joins over NCCL and binds the
    process to cuda:{local rank}: local_device_ids[0], else LOCAL_RANK,
    else SLURM_LOCALID, else the process id modulo the visible cards; it
    raises without CUDA.  device "cpu" joins over gloo.  Idempotent: once
    joined, a call returns the bound device."""
    if dist.is_initialized():
        return _bound_device()
    dev = resolve_device(device)
    if coordinator_address is None:
        coordinator_address = os.environ.get("OPENDCVC_TPU_COORDINATOR")
        if coordinator_address is None and os.environ.get("MASTER_ADDR"):
            coordinator_address = (os.environ["MASTER_ADDR"] + ":"
                                   + os.environ.get("MASTER_PORT", "1234"))
    if num_processes is None:
        v = _env("OPENDCVC_TPU_NUM_PROCS", "SLURM_NTASKS", "WORLD_SIZE")
        num_processes = int(v) if v is not None else None
    if process_id is None:
        v = _env("OPENDCVC_TPU_PROC_ID", "SLURM_PROCID", "RANK")
        process_id = int(v) if v is not None else None
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "init_distributed needs a coordinator (OPENDCVC_TPU_COORDINATOR "
            "or MASTER_ADDR[:MASTER_PORT]), a process count "
            "(OPENDCVC_TPU_NUM_PROCS, SLURM_NTASKS or WORLD_SIZE) and a "
            "process id (OPENDCVC_TPU_PROC_ID, SLURM_PROCID or RANK); got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r}")
    if dev.type == "cuda":
        if local_device_ids:
            local = int(local_device_ids[0])
        else:
            v = _env("LOCAL_RANK", "SLURM_LOCALID")
            local = int(v) if v is not None else \
                process_id % torch.cuda.device_count()
        torch.cuda.set_device(local)
        dev, backend = torch.device("cuda", local), "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dev


def maybe_init_distributed(device="cuda"):
    """init_distributed() iff OPENDCVC_TPU_DIST is truthy (the port's
    `utils/common.py::env_flag`); returns its device, else None.  Entry
    points call this, so a multi-process launch needs only the env."""
    if env_flag("OPENDCVC_TPU_DIST"):
        return init_distributed(device=device)
    return None


class Mesh:
    """A grid of ranks, row-major as JAX reshapes its device list.

    `shape` {axis: size}; `coords` {axis: this rank's index}; per axis,
    `ranks[axis]` the global ranks of this rank's line along it (those
    sharing its other coordinates, in axis order) and `groups[axis]` that
    line's process group (None for a line of one rank)."""

    def __init__(self, shape, coords, ranks, groups):
        self.shape, self.coords = shape, coords
        self.ranks, self.groups = ranks, groups

    def size(self, axis):
        return self.shape.get(axis, 1)

    def index(self, axis):
        return self.coords.get(axis, 0)


def make_mesh(axis_shapes=None, axis_names=("data", "spatial")):
    """The mesh over every rank of the process group (one rank when none
    is joined).  axis_shapes matches axis_names, -1 entries inferred;
    default: every rank on the first axis.  Raises ValueError where the
    JAX package asserts (the shape does not hold the ranks).  Every rank
    must call it, in the same order: it creates the lines' groups."""
    joined = dist.is_initialized()
    n = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    if axis_shapes is None:
        axis_shapes = (n,) + (1,) * (len(axis_names) - 1)
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"axis_shapes {axis_shapes} do not match "
                         f"axis_names {axis_names}")
    shapes = [int(s) for s in axis_shapes]
    if any(s == 0 or s < -1 for s in shapes):
        raise ValueError(f"mesh axis sizes must be positive or -1: "
                         f"{axis_shapes}")
    known = int(np.prod([s for s in shapes if s != -1]))
    shapes = [n // known if s == -1 else s for s in shapes]
    if int(np.prod(shapes)) != n:
        raise ValueError(f"a mesh of {dict(zip(axis_names, shapes))} does "
                         f"not hold the {n} ranks")
    grid = np.arange(n).reshape(shapes)
    coords = dict(zip(axis_names,
                      (int(c) for c in np.unravel_index(rank, shapes))))
    ranks, groups = {}, {}
    for ax, name in enumerate(axis_names):
        for line in np.moveaxis(grid, ax, -1).reshape(-1, shapes[ax]):
            members = [int(r) for r in line]
            group = dist.new_group(members) if len(members) > 1 else None
            if rank in members:
                ranks[name], groups[name] = members, group
    return Mesh(dict(zip(axis_names, shapes)), coords, ranks, groups)


def _block(x, dim, count, index):
    size = x.shape[dim]
    if size % count:
        raise ValueError(f"dimension {dim} of size {size} does not split "
                         f"over {count} ranks")
    step = size // count
    sl = [slice(None)] * x.ndim
    sl[dim] = slice(index * step, (index + 1) * step)
    return x[tuple(sl)]


def batch_sharding(mesh, x, spatial_dim=None):
    """This rank's block of a global batch `x` (a numpy array or a
    tensor): dim 0 split over "data"; with spatial_dim, that dim split
    over "spatial" too (1 for frames (B, H, W, 3), 2 for clips (B, T, H,
    W, 3)), else the spatial axis holds replicas.  A view; raises
    ValueError when a split dimension does not divide."""
    out = _block(x, 0, mesh.size("data"), mesh.index("data"))
    if spatial_dim is not None:
        out = _block(out, spatial_dim, mesh.size("spatial"),
                     mesh.index("spatial"))
    return out


def replicate_sharding(mesh, tree):
    """True on every rank iff every tensor leaf of `tree` is bit-identical
    on every rank of the mesh (rank 0's bytes broadcast and compared).
    Every rank must call it."""
    from ..training.train import tree_leaves    # train imports this module
    del mesh    # the check spans the whole process group
    flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in tree_leaves(tree)])
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return True
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    same = torch.tensor([int(torch.equal(ref, flat))], dtype=torch.int32,
                        device=flat.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same.item())


class Shard:
    """What a rank holds of a step's global batch: `dp` and `d` the data
    axis's size and this rank's index; `sp` and `s` the spatial axis's
    (1 and 0 unless the frames are split in height); `spatial_ranks` and
    `spatial_group` the spatial line's global ranks and group."""

    def __init__(self, mesh, spatial=False):
        self.dp, self.d = mesh.size("data"), mesh.index("data")
        if spatial and mesh.size("spatial") > 1:
            self.sp, self.s = mesh.size("spatial"), mesh.index("spatial")
            self.spatial_ranks = mesh.ranks["spatial"]
            self.spatial_group = mesh.groups["spatial"]
        else:
            self.sp, self.s = 1, 0
            self.spatial_ranks, self.spatial_group = None, None

    def global_shape(self, shape):
        """The global (N, C, H, W) of a local NCHW block's shape."""
        n, c, h, w = shape
        return (n * self.dp, c, h * self.sp, w)

    def block(self, t):
        """This rank's block of a global NCHW tensor."""
        n, h = t.shape[0] // self.dp, t.shape[2] // self.sp
        return t[self.d * n:(self.d + 1) * n, :,
                 self.s * h:(self.s + 1) * h]


_ACTIVE = None


@contextlib.contextmanager
def sharded(shard):
    """Run the enclosed forward as `shard`'s part of the global batch."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, shard
    try:
        yield shard
    finally:
        _ACTIVE = prev


def active_shard():
    """The Shard of the enclosing `sharded`, else None."""
    return _ACTIVE
