"""One sharded train step on a grid of ranks, held against the same step in
one process on the whole batch.

    python -m opendcvc_tpu_torch.parallel.dryrun N [--device cpu]

`dryrun_multichip(n)` is the port's counterpart of the JAX package's
`__graft_entry__.py::dryrun_multichip`: one full-width DMC train step
(lambda 256, Adam at 1e-4 with the global-norm clip, qp 21, two P-frames)
on a {data, spatial} grid of n ranks, spatial 2 when n is even, batch dp
and frames (dp, 3, 64 sp, 64 sp, 3) from default_rng(0), the batch split
over "data" and the frame height over "spatial" (halo exchanges,
`parallel/spatial.py`).  It holds the loss and the updated parameters to
the same step in one process with the JAX dryrun's bounds, |dloss| <
5e-4 max(1, |loss|) and max|dparam| < 5e-5, and the parameters to be
bit-identical on every rank.  The ranks are spawned processes: NCCL on n
cards (device "cuda", which raises without them), gloo on the CPU where
the caller asks for it.  `step_parity` is the same check for any of
train_video's models, on the data axis alone or split in height.
"""

import argparse
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..models import common as C
from ..training.train import (make_optimizer, make_train_step, tree_leaves,
                              trainable_leaves)
from ..utils import checkpoint as ckpt
from ..utils.params import from_jax, to_device, tree_map
from ..utils.transfer import upload
from .mesh import (batch_sharding, init_distributed, make_mesh,
                   replicate_sharding)

LMBDA, BASE_LR, QP = 256.0, 1e-4, 21
#: the JAX dryrun's bounds (__graft_entry__.py): |dloss| < LOSS_RTOL *
#: max(1, |loss|); max|dparam| < PARAM_ATOL (lr / 2: Adam's first step
#: is ~lr sign(g), so a real sharding fault moves coordinates by ~lr)
LOSS_RTOL = 5e-4
PARAM_ATOL = 5e-5


def free_port():
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, device, fn, args, results):
    try:
        if device == "cpu":
            torch.set_num_threads(1)
        dev = init_distributed(f"localhost:{port}", n, rank, [rank],
                               device=device)
        results.put((rank, None, fn(dev, *args)))
    except Exception:
        results.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(n, fn, args=(), device="cpu", timeout=300.0):
    """fn(device, *args) on n spawned ranks of one process group (NCCL on
    cards 0..n-1 for device "cuda", gloo on the CPU, one thread each);
    returns fn's results by rank (they cross a pipe: keep them plain
    numbers and numpy arrays).  A rank that raises, dies or outlasts
    `timeout` seconds kills every rank and raises RuntimeError with its
    traceback."""
    C.resolve_device(device)
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks need {n} cards, "
                           f"{torch.cuda.device_count()} visible")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, port, device, fn, args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"ranks {sorted(set(range(n)) - set(out))}"
                                   f" did not finish in {timeout} s")
            try:
                rank, err, res = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} failed:\n{err}")
            out[rank] = res
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(5)
    return [out[r] for r in range(n)]


def _parity_rank(dev, spec):
    """One rank of step_parity: the sharded step, the replication check,
    and on rank 0 the one-process step on the whole batch."""
    from ..train_video import build_model
    dp, sp = spec["axes"]
    mesh = make_mesh((dp, sp))
    init, loss_fn, grad_transform = build_model(
        spec["model"], quant_mode=spec["quant_mode"], lmbda=LMBDA)
    if spec["checkpoint"] is not None:
        init = from_jax(ckpt.load_params(spec["checkpoint"]))
    frames = np.random.default_rng(0).random(spec["shape"]) \
        .astype(np.float32)
    tx = make_optimizer(base_lr=BASE_LR)

    def run(mesh, batch):
        # the step updates the parameters in place: each run its own copy
        params = to_device(tree_map(torch.clone, init), dev)
        step = make_train_step(loss_fn, tx, grad_transform=grad_transform,
                               mesh=mesh, spatial=spec["spatial"])
        rng = torch.Generator(device=dev).manual_seed(2)
        batch = upload(np.ascontiguousarray(batch), dev)
        t0 = time.perf_counter()
        params, _, metrics = step(params, tx.init(trainable_leaves(params)),
                                  batch, QP, rng)
        loss = float(metrics["loss"])       # waits for the step
        return params, loss, (time.perf_counter() - t0) * 1e3

    local = batch_sharding(mesh, frames, 2 if spec["spatial"] else None)
    params, loss, ms = run(mesh, local)
    out = {"same": replicate_sharding(mesh, params), "loss": loss, "ms": ms}
    if dist.get_rank() != 0:
        return out
    ref, ref_loss, ref_ms = run(None, frames)
    out.update(ref_loss=ref_loss, ref_ms=ref_ms,
               dloss=abs(loss - ref_loss),
               max_dparam=max(float((a.detach() - b.detach()).abs().max())
                              for a, b in zip(tree_leaves(params),
                                              tree_leaves(ref))))
    return out


def step_parity(n, device="cuda", model="dmc", axes=None, spatial=False,
                shape=None, quant_mode="ste", checkpoint=None,
                timeout=300.0):
    """One train step of train_video's `model` (its init, seed 0, or the
    JAX-layout `checkpoint`; lambda 256, Adam at 1e-4, qp 21, noise seed
    2) on a grid `axes` (dp, sp) of n ranks, clips `shape` (B, T, H, W, 3)
    from default_rng(0) split over "data" (and, with spatial, H over
    "spatial"), against the same step in one process on the whole batch.
    Returns rank 0's {"mesh", "loss", "ref_loss", "dloss", "max_dparam",
    "ms", "ref_ms", "same"}; "same" is whether the parameters are
    bit-identical on every rank."""
    axes = tuple(axes or (n, 1))
    spec = {"model": model, "axes": axes, "spatial": spatial,
            "shape": tuple(shape), "quant_mode": quant_mode,
            "checkpoint": checkpoint}
    res = run_ranks(n, _parity_rank, (spec,), device=device,
                    timeout=timeout)
    out = dict(res[0], mesh={"data": axes[0], "spatial": axes[1]})
    out["same"] = all(r["same"] for r in res)
    return out


def check_parity(res):
    """Raise AssertionError unless `res` (step_parity's) holds the JAX
    dryrun's bounds and the parameters are bit-identical on every rank."""
    if not res["dloss"] < LOSS_RTOL * max(1.0, abs(res["ref_loss"])):
        raise AssertionError(f"sharded loss {res['loss']} != unsharded "
                             f"{res['ref_loss']}")
    if not res["max_dparam"] < PARAM_ATOL:
        raise AssertionError(f"sharded param update diverged: "
                             f"max|dparam|={res['max_dparam']:.3e}")
    if not res["same"]:
        raise AssertionError("the parameters differ between ranks")


def dryrun_multichip(n, device="cuda", checkpoint=None, timeout=600.0):
    """One full-width DMC train step on n ranks, data x spatial (spatial 2
    when n is even), held to the same step in one process (check_parity);
    prints the JAX dryrun's line and returns step_parity's dict.
    checkpoint: JAX-layout weights in place of the port's seed-0 init."""
    sp = 2 if n % 2 == 0 else 1
    dp = n // sp
    res = step_parity(n, device, "dmc", (dp, sp), spatial=True,
                      shape=(dp, 3, 64 * sp, 64 * sp, 3),
                      checkpoint=checkpoint, timeout=timeout)
    check_parity(res)
    print(f"dryrun_multichip: mesh={res['mesh']}, loss={res['loss']:.4f}, "
          f"parity ok (|dloss|={res['dloss']:.2e}, max|dparam|="
          f"{res['max_dparam']:.2e} vs 1-device)")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, n cards) or cpu (gloo)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
