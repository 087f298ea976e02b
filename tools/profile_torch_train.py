#!/usr/bin/env python3
"""Where a training step of the PyTorch/CUDA port goes, on one GPU, and
what the package's cuDNN determinism pins cost it.

    python3 tools/profile_torch_train.py [--models dmci,dmc] [--amp 0,1]
        [--pins on,off,off,on] [--steps 5] [--trace-dir DIR]

At train_video's defaults (synthetic clips, batch 8, crop 256; DMC with
3 frames, so two P-frames through the feature chain; the port's init
from seed 0), with a constant lr of 1e-4 and qp 32, for each model and
precision (--amp 1: the bfloat16 compute policy), once for each entry of
--pins in that order in one process: the median ms of --steps steps
after 2 warm-up steps, each step alone (host clock, the device
synchronized before and after), and the mean ms of --steps steps queued
back to back as train_video runs them, with the host's ms in each
step's call. "on" is the package's pins (cudnn.deterministic, no
benchmark), "off" lets cuDNN pick its algorithms by timing
(benchmark=True, deterministic=False). Then, with the pins on, the
operations of one step that make the host wait for the device (torch's
sync debug mode), and 2 steps queued under torch.profiler: the device
time by kernel class (convolutions, the depthwise 3x3, elementwise, the
optimizer's foreach kernels, reductions, other), the top kernels and the
device busy and idle shares of the window.  The profiler slows the
host's launches, so the window's idle share overstates an unprofiled
step's.  Prints the card's name and power limit first and a JSON summary
last; with --trace-dir, writes each Chrome trace there.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from profile_torch_port import _kernel_class  # noqa: E402

BATCH, CROP, QP = 8, 256, 32


def _train_class(name):
    n = name.lower()
    if "multi_tensor" in n or "foreach" in n:
        return "optimizer (foreach: clip, Adam, update)"
    if "reduce" in n:
        return "reductions"
    return _kernel_class(name)


def _setup(model, dev):
    from opendcvc_tpu_torch.models.dmc import dmc_init
    from opendcvc_tpu_torch.models.dmci import dmci_init
    from opendcvc_tpu_torch.training import train as T
    from opendcvc_tpu_torch.training.data import SyntheticVideoDataset
    from opendcvc_tpu_torch.utils.params import to_device
    from opendcvc_tpu_torch.utils.transfer import upload
    gen = torch.Generator().manual_seed(0)
    if model == "dmci":
        params, loss_img = dmci_init(gen), T.make_dmci_loss(256.0)

        def loss_fn(p, frames, qp, rng):
            return loss_img(p, frames[:, 0], qp, rng)
        n_frames = 2
    else:
        params, loss_fn = dmc_init(gen), T.make_dmc_loss(256.0)
        n_frames = 3
    batch = upload(next(SyntheticVideoDataset(n_frames, CROP, seed=0)
                        .batches(BATCH, 1)), dev)
    return to_device(params, dev), loss_fn, batch


def _pins(on):
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = not on


def _steps(step, state, n):
    """2 + n steps, each on its own with the device synchronized: (median
    ms of the last n, every step's ms)."""
    params, opt, batch = state
    ms = []
    for _ in range(2 + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch, QP, None)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    state[0], state[1] = params, opt
    return (float(np.median(ms[2:])) if n else None), ms


def _queued(step, state, n):
    """n steps queued back to back, as train_video runs them (the host
    waits for the device only after the last): (mean ms a step, mean ms
    the host spends in a step's call).  The second is the host's dispatch
    time of a step while it runs ahead (a full launch queue would make it
    wait, and then it would count the device's time instead)."""
    params, opt, batch = state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = 0.0
    for _ in range(n):
        t1 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch, QP, None)
        host += time.perf_counter() - t1
    torch.cuda.synchronize()
    state[0], state[1] = params, opt
    return (time.perf_counter() - t0) * 1e3 / n, host * 1e3 / n


def _host_waits(step, state):
    """The operations of one step that make the host wait for the device,
    as torch's sync debug mode reports them."""
    params, opt, batch = state
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            params, opt, metrics = step(params, opt, batch, QP, None)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    state[0], state[1] = params, opt
    return [str(w.message)[:120] for w in caught
            if str(w.message).startswith("called a synchronizing")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default="dmci,dmc")
    ap.add_argument("--amp", default="0,1")
    ap.add_argument("--pins", default="on,off,off,on")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace-dir", default=None,
                    help="write each profiled run's Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_train: CUDA is not available")
    from torch.profiler import ProfilerActivity, profile
    import opendcvc_tpu_torch  # noqa: F401  (the pins)
    from opendcvc_tpu_torch.training import train as T

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    summary = []
    for model in args.models.split(","):
        for amp in (bool(int(a)) for a in args.amp.split(",")):
            params, loss_fn, batch = _setup(model, dev)
            tx = T.make_optimizer(1e-4)
            step = T.make_train_step(
                loss_fn, tx, compute_dtype=torch.bfloat16 if amp else None)
            state = [params, tx.init(T.tree_leaves(params)), batch]
            tag = f"{model} {'AMP' if amp else 'float32'}"
            rec = {"model": model, "amp": amp, "pins": []}
            for pin in args.pins.split(","):
                _pins(pin == "on")
                med, ms = _steps(step, state, args.steps)
                queued, host = _queued(step, state, args.steps)
                rec["pins"].append({"pins": pin, "median_ms": med,
                                    "ms": ms, "queued_ms": queued,
                                    "host_ms": host})
                print(f"{tag}, pins {pin}: {med:.2f} ms a step alone "
                      f"(median of {args.steps}; all " + " ".join(
                          f"{t:.1f}" for t in ms) + f"), {queued:.2f} ms a "
                      f"step queued ({args.steps} back to back; the host "
                      f"{host:.2f} ms in a step's call)")
            _pins(True)
            waits = _host_waits(step, state)
            rec["host_waits"] = waits
            print(f"{tag}: {len(waits)} host waits in a step"
                  + "".join(f"\n  {w}" for w in waits))
            _steps(step, state, 1)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                _queued(step, state, 2)
                window_us = (time.perf_counter() - t0) * 1e6
            kernels = {}
            for ev in prof.events():
                if ev.device_type == torch.autograd.DeviceType.CUDA:
                    kernels[ev.name] = kernels.get(ev.name, 0.0) + \
                        ev.time_range.elapsed_us()
            busy = sum(kernels.values())
            if busy == 0:
                sys.exit("profile_torch_train: the profiler recorded no "
                         "device time")
            classes = {}
            for name, us in kernels.items():
                c = _train_class(name)
                classes[c] = classes.get(c, 0.0) + us
            print(f"{tag}, pins on, 2 profiled steps queued: window "
                  f"{window_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} "
                  f"ms = {100 * busy / window_us:.1f} %")
            for c, us in sorted(classes.items(), key=lambda kv: -kv[1]):
                print(f"  {100 * us / busy:5.1f} %  {us / 1e3:9.3f} ms  {c}")
            for name, us in sorted(kernels.items(),
                                   key=lambda kv: -kv[1])[:12]:
                print(f"  {100 * us / busy:5.1f} %  {us / 1e3:9.3f} ms  "
                      f"{name[:100]}")
            rec.update({"window_ms": window_us / 1e3, "busy_ms": busy / 1e3,
                        "classes_ms": {c: us / 1e3
                                       for c, us in classes.items()}})
            if args.trace_dir:
                os.makedirs(args.trace_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    args.trace_dir,
                    f"train_{model}_{'amp' if amp else 'f32'}.json"))
            summary.append(rec)
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "runs": summary}))


if __name__ == "__main__":
    main()
