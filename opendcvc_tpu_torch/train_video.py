"""RD training CLI of the port: DCVC-RT's DMCI or DMC, DCVC-TCM or DCVC,
on one device or on every rank of a process group.

    python -m opendcvc_tpu_torch.train_video --model dmci|dmc|tcm|dcvc [...]
    OPENDCVC_TPU_DIST=1 torchrun --nproc_per_node 4 \
        -m opendcvc_tpu_torch.train_video [...]

Counterpart of the JAX package's root `train_video.py`: the same options,
defaults, log line and checkpoint (`{save_dir}/{model}_latest.msgpack` in
the JAX package's layout, with extra {"step": n}); Vimeo-90k septuplets
under --dataset_root, else synthetic clips.  Weights come from the port's
own init drawn by torch.Generator from --seed (not the JAX package's for
the same seed), or from --resume, a JAX or a port checkpoint, whose saved
step the run resumes at (Adam's moments and the schedule restart, as in
the JAX package).  The qp of each step is drawn from
np.random.default_rng(seed + 1), as the JAX package draws it.

It runs on --device (default cuda; without CUDA that raises, and the CPU
runs only with --device cpu).  With OPENDCVC_TPU_DIST set it first joins
the process group (`parallel/mesh.py::maybe_init_distributed`: torchrun's
or SLURM's env, or OPENDCVC_TPU_COORDINATOR / _NUM_PROCS / _PROC_ID; NCCL
on the cards, gloo with --device cpu) and trains on a (d, world // d)
grid of ranks, d = --data_axis (-1: every rank): every rank draws the same
global batch and keeps its rows on "data" (the second axis holds
replicas, as in the JAX package), the gradients are summed over the ranks
once a step, and rank 0 alone logs and saves while the others wait.
Without OPENDCVC_TPU_DIST it trains on one device, and --data_axis must
be -1 or 1.  A --data_axis that does not split the ranks, or a
--batch_size it does not divide, raises ValueError.  --model tcm trains
on the cascaded TCM loss (the propagated feature carries the context
from frame to frame; --frames 3 gives two P-frames).  --model dcvc trains on DCVC's staged loss, --stage 1-4: 1 the
motion warm-up, 2 reconstruction and 3 reconstruction + y's rate with the
motion branch frozen, 4 end to end; the masked convolutions' causal masks
are never trained.
"""

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .models import common as C
from .models.dcvc import dcvc_init
from .models.dmc import dmc_init
from .models.dmc_tcm import dmc_tcm_init
from .models.dmci import dmci_init
from .parallel.mesh import batch_sharding, make_mesh, maybe_init_distributed
from .training.data import SyntheticVideoDataset, Vimeo90kSeptupletDataset
from .training.train import (dcvc_stage_grad_transform, make_dcvc_loss,
                             make_dmc_loss, make_dmci_loss, make_optimizer,
                             make_tcm_loss, make_train_step,
                             trainable_leaves)
from .utils import checkpoint as ckpt
from .utils.common import create_folder, str2bool
from .utils.params import from_jax, to_device
from .utils.transfer import upload


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="opendcvc_tpu_torch RD training (DMCI, DMC, TCM, DCVC)")
    p.add_argument("--model", choices=["dmci", "dmc", "dcvc", "tcm"],
                   default="dmc")
    p.add_argument("--stage", type=int, default=4, choices=[1, 2, 3, 4],
                   help="dcvc staged training: 1=ME warmup, 2=recon "
                        "(motion frozen), 3=+bits (motion frozen), "
                        "4=end-to-end")
    p.add_argument("--dataset_root", type=str, default=None,
                   help="vimeo_septuplet root; synthetic data if omitted")
    p.add_argument("--list_file", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--frames", type=int, default=2,
                   help="frames per training sample (>=2 for dmc)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lmbda", type=float, default=256.0)
    p.add_argument("--lmbda_max", type=float, default=None,
                   help="per-qp lambda ladder: log-interpolate "
                        "[lmbda, lmbda_max] over the 64 QPs")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--schedule", type=str, default="cosine",
                   choices=["constant", "step", "multistep", "cosine"])
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--quant_mode", choices=["ste", "noise"], default="ste")
    p.add_argument("--amp", type=str2bool, default=False,
                   help="bf16 forward/backward with f32 master weights")
    p.add_argument("--use_precomputed_refs", type=str2bool, default=False,
                   help="substitute ref.png (from preprocessing) for im1")
    p.add_argument("--qp_min", type=int, default=0)
    p.add_argument("--qp_max", type=int, default=63)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--save_dir", type=str, default="ckpt")
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_axis", type=int, default=-1,
                   help="ranks on the data axis (-1 = all; without "
                        "OPENDCVC_TPU_DIST one)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the CPU "
                        "path)")
    return p.parse_args(argv)


def _mark(device):
    """A point in the device's queue (host clock on the CPU)."""
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed_ms(a, b):
    return (b - a) * 1e3 if isinstance(a, float) else a.elapsed_time(b)


def _host_metrics(ms):
    """Metric dicts of device scalars -> dicts of floats, in one copy
    (which waits for the device, so every step's events have passed)."""
    keys = list(ms[0])
    vals = torch.stack([torch.stack([m[k].to(torch.float64) for k in keys])
                        for m in ms]).tolist()
    return [dict(zip(keys, v)) for v in vals]


def build_model(model, seed=0, lmbda=256.0, quant_mode="ste",
                lmbda_max=None, stage=4):
    """(params, loss_fn, grad_transform) of `--model`: the port's init
    drawn by torch.Generator(seed) on the CPU, the loss over clips (B, T,
    H, W, 3) and DCVC's stage freeze (else None)."""
    gen = torch.Generator().manual_seed(seed)
    grad_transform = None
    if model == "dmci":
        params = dmci_init(gen)
        loss_img = make_dmci_loss(lmbda, quant_mode=quant_mode,
                                  lmbda_max=lmbda_max)

        def loss_fn(params, frames, qp, rng):
            # the first frame of each clip, as an image
            return loss_img(params, frames[:, 0], qp, rng)
    elif model == "tcm":
        params = dmc_tcm_init(gen)
        loss_fn = make_tcm_loss(lmbda, quant_mode=quant_mode)
    elif model == "dcvc":
        params = dcvc_init(gen)
        loss_fn = make_dcvc_loss(lmbda, stage=stage, quant_mode=quant_mode)
        grad_transform = dcvc_stage_grad_transform(stage)
    else:
        params = dmc_init(gen)
        loss_fn = make_dmc_loss(lmbda, quant_mode=quant_mode,
                                lmbda_max=lmbda_max)
    return params, loss_fn, grad_transform


def _barrier(device):
    if device.type == "cuda":
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()


def main(argv=None):
    """Train; returns {"params", "opt_state", "step_ms", "metrics"} (the
    final params and Adam state, each step's ms from its start to its end
    in the device's queue, each step's global metrics as floats), on
    every rank.  The host waits for the device only to log, to save and
    at the end, so it queues the next step while the device runs this
    one."""
    args = parse_args(argv)
    device = maybe_init_distributed(args.device)
    joined = device is not None
    if not joined:
        device = C.resolve_device(args.device)
    world = dist.get_world_size() if joined else 1
    lead = not joined or dist.get_rank() == 0
    dp = world if args.data_axis < 0 else args.data_axis
    if dp < 1 or world % dp:
        raise ValueError(f"--data_axis {args.data_axis}: {world} rank(s) do "
                         f"not split into a data axis of {dp}")
    mesh = make_mesh((dp, world // dp)) if joined else None
    if args.batch_size % dp:
        raise ValueError(f"--batch_size {args.batch_size} does not split "
                         f"over a data axis of {dp}")
    log = print if lead else (lambda *a, **k: None)
    log(f"devices: {world}, mesh: {{'data': {dp}, 'spatial': "
        f"{world // dp}}}, device: {device}")

    params, loss_fn, grad_transform = build_model(
        args.model, args.seed, args.lmbda, args.quant_mode, args.lmbda_max,
        args.stage)
    start_step = 0
    if args.resume:
        payload = ckpt.load_checkpoint(args.resume)
        params = from_jax(payload["params"])
        if "extra" in payload and "step" in payload["extra"]:
            start_step = int(payload["extra"]["step"])
        log(f"resumed from {args.resume} at step {start_step}")
    params = to_device(params, device)

    tx = make_optimizer(args.lr, args.schedule, args.steps,
                        args.warmup_steps, args.grad_clip)
    opt_state = tx.init(trainable_leaves(params))
    step_fn = make_train_step(
        loss_fn, tx, compute_dtype=torch.bfloat16 if args.amp else None,
        grad_transform=grad_transform, mesh=mesh)

    if args.dataset_root:
        ds = Vimeo90kSeptupletDataset(
            args.dataset_root,
            args.list_file or os.path.join(args.dataset_root,
                                           "sep_trainlist.txt"),
            frames_per_sample=args.frames, crop=args.crop,
            rng=np.random.default_rng(args.seed),
            use_precomputed_refs=args.use_precomputed_refs)
    else:
        log("no dataset_root given: training on synthetic data")
        ds = SyntheticVideoDataset(frames_per_sample=args.frames,
                                   size=args.crop, seed=args.seed)

    create_folder(args.save_dir)
    qp_rng = np.random.default_rng(args.seed + 1)
    noise_rng = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.time()
    running, marks, history, step_ms = [], [], [], []

    def flush():
        """The steps since the last flush, to the host (one wait)."""
        logged = _host_metrics(running)
        history.extend(logged)
        step_ms.extend(_elapsed_ms(a, b) for a, b in marks)
        running.clear()
        marks.clear()
        return logged

    for step, batch in enumerate(
            ds.batches(args.batch_size, args.steps - start_step),
            start=start_step):
        qp = int(qp_rng.integers(args.qp_min, args.qp_max + 1))
        if mesh is not None:
            batch = np.ascontiguousarray(batch_sharding(mesh, batch))
        batch = upload(batch, device)
        start = _mark(device)
        params, opt_state, metrics = step_fn(params, opt_state, batch, qp,
                                             noise_rng)
        marks.append((start, _mark(device)))
        running.append(metrics)
        if (step + 1) % args.log_every == 0:
            logged = flush()
            avg = {k: sum(m[k] for m in logged) / len(logged)
                   for k in logged[0]}
            rate = args.log_every * args.batch_size / (time.time() - t0)
            log(f"step {step + 1}: loss={avg['loss']:.4f} "
                f"mse={avg['mse']:.5f} bpp={avg['bpp']:.4f} "
                f"({rate:.1f} samples/s)")
            t0 = time.time()
        if (step + 1) % args.save_every == 0 or step + 1 == args.steps:
            if lead:
                path = os.path.join(args.save_dir,
                                    f"{args.model}_latest.msgpack")
                ckpt.save_params(path, params,
                                 extra={"step": np.int64(step + 1)})
                print(f"saved {path}")
            if joined:
                _barrier(device)

    log("training done")
    if running:
        flush()
    return {"params": params, "opt_state": opt_state, "step_ms": step_ms,
            "metrics": history}

if __name__ == "__main__":
    main()
