"""The control of the output check, and witnesses beside it, chosen by the
configuration's precision.  Not part of a run.

Control: the plain reference put in the measured package's place,
computed in the nearest precision below the configuration's, its
outputs at the sampled positions of one period judged by the cell's own
comparison (`core.checks`, the code that decides a run's `correct`):
decoded frames by their widest and worst mean gap, an encoder's symbols
plane by plane, each against the reference in the configuration's
precision and the cell's limits.  A sound check fails it on every seed.
- float32 with TF32 off: the reference in TF32.
- bfloat16: the bfloat16 reference with each convolution's output
  rounded through float8 (e4m3).

Witnesses: sound programs in the configuration's precision whose sums
may run in another order, what a later change that reorders them would
read.
- float32: cuDNN's algorithms picked by timing (`cudnn.benchmark`), and
  cuDNN off (ATen's own convolutions); the float32 checks pass both.
- bfloat16: cuDNN's algorithms picked by timing and every convolution in
  `channels_last` (the layout a later change would adopt), which the
  bfloat16 check passes; and cuDNN off (ATen's own convolutions), a true
  reorder of the bfloat16 sums, which it refuses: under random weights a
  frame's content moves its reconstruction less than a reorder's flipped
  symbols do, so no limit passes the reorder and refuses half a GOP chunk
  left out (PERF.md gives the readings).

For decoding cells each variant also reports the share of its compared
reconstruction elements that sit at 0 or 1 (`clamped_share`).

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3
"""

import argparse
import contextlib
import json
import os
import sys
import time

import torch

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


def _conv_outputs_in_float8(orig):
    def conv_apply(p, x, **kw):
        out = orig(p, x, **kw)
        return out.to(torch.float8_e4m3fn).to(out.dtype)
    return conv_apply


def _convs_in_channels_last(orig):
    def conv_apply(p, x, **kw):
        cl = torch.channels_last
        return orig({"w": p["w"].contiguous(memory_format=cl), "b": p["b"]},
                    x.contiguous(memory_format=cl), **kw)
    return conv_apply


# by precision, the control first
VARIANTS = {
    "float32": {
        "tf32": dict(tf32=True, benchmark=False),
        "float32_timed_algorithms": dict(tf32=False, benchmark=True),
        "float32_no_cudnn": dict(tf32=False, benchmark=False, cudnn=False),
    },
    "bfloat16": {
        "float8_conv_outputs": dict(tf32=False, benchmark=False,
                                    conv=_conv_outputs_in_float8),
        "bfloat16_timed_algorithms": dict(tf32=False, benchmark=True),
        "bfloat16_channels_last": dict(tf32=False, benchmark=False,
                                       conv=_convs_in_channels_last),
        "bfloat16_no_cudnn": dict(tf32=False, benchmark=False, cudnn=False),
    },
}


def variants(cfg):
    return VARIANTS[cfg.get("precision", "float32")]


def control_of(cfg):
    """The name of the control variant of a configuration."""
    return next(iter(variants(cfg)))


@contextlib.contextmanager
def _computed_as(ref, how):
    """The reference computed as variant `how`: TF32, cuDNN's choice of
    algorithms and cuDNN itself set, every convolution wrapped."""
    from reference import nn as N
    orig = N.conv_apply
    try:
        ref.pin_precision(tf32=how["tf32"])
        torch.backends.cudnn.benchmark = how["benchmark"]
        torch.backends.cudnn.enabled = how.get("cudnn", True)
        if "conv" in how:
            N.conv_apply = how["conv"](orig)
        yield
    finally:
        N.conv_apply = orig
        ref.pin_precision(tf32=False)
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.enabled = True


def clamped_share(samples):
    """Share of the elements of reconstructions {pos: [frames]} at 0 or
    1."""
    n = k = 0
    for outs in samples.values():
        for x in outs:
            n += x.numel()
            k += int(((x == 0) | (x == 1)).sum())
    return k / n if n else None


def readings(name, seed, device, overrides=None):
    """{variant: the cell's checks of that variant in the measured
    package's place}, the outputs compared, the seconds of one check as a
    run makes it (the reference and the comparison), and for a decoding
    cell {variant: its clamped share}."""
    import run
    from core import checks, content
    from core.spec import Cell
    run._environment()
    cell = Cell(name)
    for key, val in (overrides or {}).get("config", {}).items():
        cell.config[key] = val
    for key, val in (overrides or {}).get("workload", {}).items():
        cell.workload[key] = val
    cfg, wl = cell.config, cell.workload
    by_symbols = "symbol_mismatches" in wl["check"]["limits"]
    dev = torch.device(device)
    ref = cell.reference()
    keep = set(run.sample_positions(seed, wl["intra_period"],
                                    wl["check"]["samples"]))
    weights = content.make_weights(cfg, ref, dev)
    frames = content.make_frames(cfg, seed, wl["intra_period"], dev)
    compute = ref.reference_symbols if by_symbols else ref.reference_sequence
    judge = checks.encoded_symbols if by_symbols else checks.decoded_frames
    # the propagated features a bfloat16 decoding cell also compares
    feats = {1, wl["intra_period"] - 1} \
        if "feature_mean_gap" in wl["check"]["limits"] else None
    got, secs, clamped = {}, None, {}
    for variant, how in variants(cfg).items():
        kw = {} if feats is None else {"features": dict.fromkeys(feats)}
        with _computed_as(ref, how), torch.no_grad():
            out = compute(weights, frames, cfg, wl, keep=keep, **kw)
        samples = {p: [checks.symbol_planes(out[p]) if by_symbols
                       else out[p]] for p in keep}
        del out
        if not by_symbols:
            clamped[variant] = clamped_share(samples)
        t0 = time.perf_counter()
        got[variant] = judge(cell, ref, weights, frames, samples, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs = secs or time.perf_counter() - t0
    return got, len(keep), secs, clamped


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path.insert(0, BENCH_DIR)
    for seed in args.seeds:
        got, n, secs, clamped = readings(args.workload, seed, "cuda")
        line = {"workload": args.workload, "seed": seed, "compared": n,
                "check_s": secs}
        for v, cs in got.items():
            line[f"{v}.fails"] = any(c["value"] > c["limit"] for c in cs)
            line.update({f"{v}.{c['name']}": c["value"] for c in cs})
            if v in clamped:
                line[f"{v}.clamped_share"] = clamped[v]
        line.update({f"limit.{c['name']}": c["limit"]
                     for c in next(iter(got.values()))})
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
