"""RD training CLI of the port: DCVC-RT's DMCI or DMC, or DCVC-TCM, on
one device.

    python -m opendcvc_tpu_torch.train_video --model dmci|dmc|tcm [...]

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
runs only with --device cpu) and on one card: --data_axis other than -1 or
1 raises, as does --model dcvc (ROADMAP Queue 1 item 8f).  --model tcm
trains on the cascaded TCM loss (the propagated feature carries the
context from frame to frame; --frames 3 gives two P-frames).
"""

import argparse
import os
import time

import numpy as np
import torch

from .models import common as C
from .models.dmc import dmc_init
from .models.dmc_tcm import dmc_tcm_init
from .models.dmci import dmci_init
from .training.data import SyntheticVideoDataset, Vimeo90kSeptupletDataset
from .training.train import (make_dmc_loss, make_dmci_loss, make_optimizer,
                             make_tcm_loss, make_train_step, tree_leaves)
from .utils import checkpoint as ckpt
from .utils.common import create_folder, str2bool
from .utils.params import from_jax, to_device

NOT_PORTED = {
    "dcvc": "--model dcvc is not ported: the DCVC forward and staged loss "
            "wait for the family codecs (ROADMAP Queue 1 item 8f)",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="opendcvc_tpu_torch RD training (DMCI, DMC, TCM)")
    p.add_argument("--model", choices=["dmci", "dmc", "dcvc", "tcm"],
                   default="dmc")
    p.add_argument("--stage", type=int, default=4, choices=[1, 2, 3, 4],
                   help="dcvc staged training (not ported)")
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
                   help="devices on the data axis: one card (-1 or 1)")
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


def main(argv=None):
    """Train; returns {"params", "opt_state", "step_ms", "metrics"} (the
    final params and Adam state, each step's ms from its start to its end
    in the device's queue, each step's metrics as floats).  The host waits
    for the device only to log, to save and at the end, so it queues the
    next step while the device runs this one."""
    args = parse_args(argv)
    if args.model in NOT_PORTED:
        raise NotImplementedError(NOT_PORTED[args.model])
    if args.data_axis not in (-1, 1):
        raise ValueError(f"--data_axis {args.data_axis}: the port trains on "
                         f"one card (multi-GPU is ROADMAP Queue 1 item 9)")
    device = C.resolve_device(args.device)
    print(f"devices: 1, device: {device}")

    gen = torch.Generator().manual_seed(args.seed)
    if args.model == "dmci":
        params = dmci_init(gen)
        loss_img = make_dmci_loss(args.lmbda, quant_mode=args.quant_mode,
                                  lmbda_max=args.lmbda_max)

        def loss_fn(params, frames, qp, rng):
            # the first frame of each clip, as an image
            return loss_img(params, frames[:, 0], qp, rng)
    elif args.model == "tcm":
        params = dmc_tcm_init(gen)
        loss_fn = make_tcm_loss(args.lmbda, quant_mode=args.quant_mode)
    else:
        params = dmc_init(gen)
        loss_fn = make_dmc_loss(args.lmbda, quant_mode=args.quant_mode,
                                lmbda_max=args.lmbda_max)

    start_step = 0
    if args.resume:
        payload = ckpt.load_checkpoint(args.resume)
        params = from_jax(payload["params"])
        if "extra" in payload and "step" in payload["extra"]:
            start_step = int(payload["extra"]["step"])
        print(f"resumed from {args.resume} at step {start_step}")
    params = to_device(params, device)

    tx = make_optimizer(args.lr, args.schedule, args.steps,
                        args.warmup_steps, args.grad_clip)
    opt_state = tx.init(tree_leaves(params))
    step_fn = make_train_step(
        loss_fn, tx, compute_dtype=torch.bfloat16 if args.amp else None)

    if args.dataset_root:
        ds = Vimeo90kSeptupletDataset(
            args.dataset_root,
            args.list_file or os.path.join(args.dataset_root,
                                           "sep_trainlist.txt"),
            frames_per_sample=args.frames, crop=args.crop,
            rng=np.random.default_rng(args.seed),
            use_precomputed_refs=args.use_precomputed_refs)
    else:
        print("no dataset_root given: training on synthetic data")
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
        batch = C.upload(batch, device)
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
            print(f"step {step + 1}: loss={avg['loss']:.4f} "
                  f"mse={avg['mse']:.5f} bpp={avg['bpp']:.4f} "
                  f"({rate:.1f} samples/s)")
            t0 = time.time()
        if (step + 1) % args.save_every == 0 or step + 1 == args.steps:
            path = os.path.join(args.save_dir,
                                f"{args.model}_latest.msgpack")
            ckpt.save_params(path, params,
                             extra={"step": np.int64(step + 1)})
            print(f"saved {path}")

    print("training done")
    if running:
        flush()
    return {"params": params, "opt_state": opt_state, "step_ms": step_ms,
            "metrics": history}

if __name__ == "__main__":
    main()
