"""Per-stage timing of DCVC-RT's P-frame codec.

    python -m opendcvc_tpu_torch.eval.profiler [--height 1080 --width 1920]
        [--iters 10] [--json_out OUT.json] [--trace_dir DIR] [--device cpu]

Counterpart of the JAX package's `eval/profiler.py` (the reference's
per-module timing table): `profile_dmc` times each stage of DMC's encode
and decode paths (`models/dmc.py`) under the JAX package's stage names,
`iters` calls back to back after `warmup` calls, with CUDA events around
them on the card (the host's clock on the CPU), and can write a
torch.profiler chrome trace of one encoder and recon pass to
`trace_dir`.  The codec runs in float32 unless `dtype` says otherwise:
the JAX package's default (bfloat16 on a TPU, float32 elsewhere) follows
its backend, which has no counterpart here.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ..models import common as CM
from ..models import dmc as MV
from ..ops.fused import replicate_pad


def _time_fn(fn, device, iters=10, warmup=2):
    """ms a call of fn() over `iters` calls after `warmup` calls."""
    with torch.no_grad():
        for _ in range(warmup):
            fn()
        if device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) / iters * 1e3
        torch.cuda.synchronize(device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters


def profile_dmc(height=1080, width=1920, qp=21, iters=10,
                dtype=torch.float32, trace_dir=None, device="cuda"):
    """ms a call of every stage of the DMC encode / decode paths, on the
    port's seed-0 weights and random frames padded to a multiple of 16.
    Returns {stage: ms}."""
    net = MV.DMC(device=device, dtype=dtype)
    net.init_params(seed=0)
    dev = net.device

    pr, pb = CM.get_padding_size(height, width, 16)
    rng = np.random.default_rng(0)
    frames = [replicate_pad(CM.frame_to_nchw(
        rng.random((1, height, width, 3)).astype(np.float32), dev, dtype),
        pb, pr) for _ in range(2)]
    x, ref = frames
    p = net.params

    def timed(fn):
        return _time_fn(fn, dev, iters=iters)

    results = {}
    with torch.no_grad():
        feature = MV._stage_adaptor_i(p, ref)
        results["feature_adaptor_i"] = timed(
            lambda: MV._stage_adaptor_i(p, ref))
        results["feature_adaptor_p"] = timed(
            lambda: MV._stage_adaptor_p(p, feature))
        x1, ctx_t = MV._stage_fe_part1(p, feature, qp)
        results["feature_extractor_part1"] = timed(
            lambda: MV._stage_fe_part1(p, feature, qp))
        ctx = MV._stage_fe_part2(p, x1)
        results["feature_extractor_part2"] = timed(
            lambda: MV._stage_fe_part2(p, x1))
        y, z_hat, _ = MV._stage_encode_y(p, x, ctx, qp)
        results["encoder+hyper_enc"] = timed(
            lambda: MV._stage_encode_y(p, x, ctx, qp))
        prior = MV._stage_prior(p, z_hat, ctx_t)
        results["hyper_dec+prior_fusion"] = timed(
            lambda: MV._stage_prior(p, z_hat, ctx_t))
        y_div, _, _, _, y_hat_0 = MV._stage_enc_pass0(y, prior, None)
        results["enc_pass0(fused)"] = timed(
            lambda: MV._stage_enc_pass0(y, prior, None))
        s1, m1 = MV._stage_spatial(p, y_hat_0, prior)
        results["spatial_prior"] = timed(
            lambda: MV._stage_spatial(p, y_hat_0, prior))
        results["enc_pass1(fused)"] = timed(
            lambda: MV._stage_enc_pass1(y_div, s1, m1, None))
        feat_out = MV._stage_feature_out(p, y_hat_0, y_hat_0, prior, ctx,
                                         qp)
        results["latent_decoder(feature_out)"] = timed(
            lambda: MV._stage_feature_out(p, y_hat_0, y_hat_0, prior, ctx,
                                          qp))
        results["recon_generation"] = timed(
            lambda: MV._stage_recon_x(p, feat_out, qp))

        if trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                MV._stage_encode_y(p, x, ctx, qp)
                MV._stage_recon_x(p, feat_out, qp)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir,
                                                  "dmc_stages.json"))
    return results


def print_table(results, title="stage timings"):
    width = max(len(k) for k in results) + 2
    total = sum(results.values())
    print(f"== {title} ==")
    for k, v in sorted(results.items(), key=lambda kv: -kv[1]):
        print(f"  {k:<{width}} {v:8.3f} ms  ({100 * v / total:4.1f}%)")
    print(f"  {'TOTAL (device stages)':<{width}} {total:8.3f} ms")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--json_out", type=str, default=None)
    ap.add_argument("--trace_dir", type=str, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the CPU "
                         "path)")
    args = ap.parse_args(argv)
    res = profile_dmc(args.height, args.width, iters=args.iters,
                      trace_dir=args.trace_dir, device=args.device)
    print_table(res, f"DMC stages @ {args.width}x{args.height}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
