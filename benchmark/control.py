"""The control of the output check, and witnesses beside it.  Not part
of a run.

Control: the plain reference put in the measured package's place,
computed in the nearest precision below the configuration's (float32
with TF32 off -> TF32), its outputs at the sampled positions of one
period judged by the cell's own comparison (`core.checks`, the code that
decides a run's `correct`): decoded frames by their widest and worst
mean gap, an encoder's symbols plane by plane, each against the float32
reference and the cell's limits.  A sound check fails it on every seed.

Witnesses: the reference in float32 on cuDNN algorithms picked by
timing (`cudnn.benchmark`), and in float32 with cuDNN off (ATen's own
convolutions): sound float32 programs whose sums may run in another
order, what a later change that reorders float32 sums would read.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))

VARIANTS = {
    "tf32": dict(tf32=True, benchmark=False),
    "float32_timed_algorithms": dict(tf32=False, benchmark=True),
    "float32_no_cudnn": dict(tf32=False, benchmark=False, cudnn=False),
}


def readings(name, seed, device, overrides=None):
    """{variant: the cell's checks of that variant in the measured
    package's place}, the outputs compared, and the seconds of one check
    as a run makes it (the float32 reference and the comparison)."""
    import torch
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
    got, secs = {}, None
    for variant, how in VARIANTS.items():
        try:
            ref.pin_precision(tf32=how["tf32"])
            torch.backends.cudnn.benchmark = how["benchmark"]
            torch.backends.cudnn.enabled = how.get("cudnn", True)
            with torch.no_grad():
                out = compute(weights, frames, cfg, wl, keep=keep)
        finally:
            ref.pin_precision(tf32=False)
            torch.backends.cudnn.benchmark = False
            torch.backends.cudnn.enabled = True
        samples = {p: [checks.symbol_planes(out[p]) if by_symbols
                       else out[p]] for p in keep}
        del out
        t0 = time.perf_counter()
        got[variant] = judge(cell, ref, weights, frames, samples)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs = secs or time.perf_counter() - t0
    return got, len(keep), secs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path.insert(0, BENCH_DIR)
    for seed in args.seeds:
        got, n, secs = readings(args.workload, seed, "cuda")
        line = {"workload": args.workload, "seed": seed, "compared": n,
                "check_s": secs}
        for v, cs in got.items():
            line[f"{v}.fails"] = any(c["value"] > c["limit"] for c in cs)
            line.update({f"{v}.{c['name']}": c["value"] for c in cs})
        line.update({f"limit.{c['name']}": c["limit"] for c in got["tf32"]})
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
