#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's P-frame goes, on one GPU.

    python3 tools/profile_torch_port.py [--frames 2] [--trace PATH]

Codes 1080p P-frames with DMC at full width on the device-EC path (random
weights from seed 1, flat q banks, force_zero_thres 0.12, as chip_smoke.py's
phase 4 does), warms up
with one frame, then profiles `--frames` encodes and their decodes with
torch.profiler.  Prints the per-frame host-clock times, the device time by
kernel (top 15) and by class (convolution, lane rANS, other), and the
device busy share of the window; writes the Chrome trace to --trace.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

H, W, QP, FZ = 1088, 1920, 21, 0.12


def _kernel_class(name):
    n = name.lower()
    if n.startswith("lr_") or "lr_encode" in n or "lr_decode" in n:
        return "lane rANS (K1/K2)"
    if any(s in n for s in ("conv", "gemm", "cudnn", "xmma", "cutlass",
                            "winograd", "implicit")):
        return "convolution"
    return "other (elementwise, copies, scatter, ...)"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--trace", default="chiprun_out/torch_port_trace.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_port: CUDA is not available")
    from torch.profiler import ProfilerActivity, profile
    from opendcvc_tpu_torch.models.dmc import DMC

    dev = torch.device("cuda", 0)
    nets = []
    for _ in range(2):
        net = DMC(device=dev, device_ec=True)
        if nets:
            net.load_params(nets[0].params)
        else:
            net.init_params(seed=1)
            net.params["q_encoder"] = torch.ones_like(
                net.params["q_encoder"]) * 0.25
            net.params["q_decoder"] = torch.ones_like(
                net.params["q_decoder"])
        net.update(force_zero_thres=FZ)
        nets.append(net)
    enc, dec = nets
    rng = np.random.default_rng(0)
    base = rng.random((1, H, W, 3), dtype=np.float32)
    frames = [np.roll(base, 4 * t, axis=2) for t in range(args.frames + 2)]
    for net in nets:
        net.add_ref_frame(None, frames[0])
    sps = {"height": H, "width": W}
    dec.decompress(enc.compress(frames[1], QP)["bit_stream"], sps, QP)
    torch.cuda.synchronize()

    enc_ms, dec_ms = [], []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_window = time.perf_counter()
        for x in frames[2:]:
            t0 = time.perf_counter()
            s = enc.compress(x, QP)["bit_stream"]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dec.decompress(s, sps, QP)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            enc_ms.append((t1 - t0) * 1e3)
            dec_ms.append((t2 - t1) * 1e3)
        window_us = (time.perf_counter() - t_window) * 1e6
    if not torch.equal(enc.dpb[0].feature, dec.dpb[0].feature):
        sys.exit("profile_torch_port: enc/dec feature chain diverged")

    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.time_range \
                .elapsed_us()
    busy_us = sum(kernels.values())
    if busy_us == 0:
        sys.exit("profile_torch_port: the profiler recorded no device time")
    print(f"P-frame enc ms {[round(t, 2) for t in enc_ms]} dec ms "
          f"{[round(t, 2) for t in dec_ms]} (host clock, synchronized)")
    print(f"window {window_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms = {100 * busy_us / window_us:.1f} %")
    classes = {}
    for name, us in kernels.items():
        c = _kernel_class(name)
        classes[c] = classes.get(c, 0.0) + us
    for c, us in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"  {100 * us / busy_us:5.1f} %  {us / 1e3:9.3f} ms  {c}")
    print("top kernels by device time:")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {100 * us / busy_us:5.1f} %  {us / 1e3:9.3f} ms  "
              f"{name[:100]}")
    os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
    prof.export_chrome_trace(args.trace)
    print(f"trace: {args.trace}")


if __name__ == "__main__":
    main()
