#!/usr/bin/env python3
"""Compare the port's bench line between two checkouts on one GPU.

    python3 tools/compare_bench.py --dirs OLD,NEW [--dtypes float32,bfloat16]
        [--order 0110]

Runs `python -m opendcvc_tpu_torch.bench` at bench.py's defaults in each
checkout (each in a fresh process, with its own kernel build), for each
dtype (BENCH_DTYPE), in the order --order gives (0 = the first of --dirs,
1 = the second; the default interleaves old, new, new, old so that a
drift of the card or its host does not favour one side), and prints
each run's JSON line with its checkout and dtype, then, for each dtype
and side, the median of the bench line's fps fields (the mean of
the two middle runs for an even count).  Prints the card's
name and power limit first.  Exits nonzero when a run fails.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

FIELDS = ("enc_fps", "dec_fps", "intra_enc_fps", "intra_dec_fps", "bpp")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dirs", required=True)
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--order", default="0110")
    args = ap.parse_args()
    dirs = [os.path.abspath(d) for d in args.dirs.split(",")]
    if len(dirs) != 2:
        sys.exit("compare_bench: --dirs takes two checkouts")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    lines = {}
    for dtype in args.dtypes.split(","):
        for side in (int(c) for c in args.order):
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith(("BENCH_", "OPENDCVC_TPU_EC_"))}
            env["BENCH_DTYPE"] = dtype
            run = subprocess.run(
                [sys.executable, "-m", "opendcvc_tpu_torch.bench"],
                cwd=dirs[side], env=env, capture_output=True, text=True,
                timeout=900)
            if run.returncode != 0:
                sys.stderr.write(run.stdout[-4000:] + run.stderr[-4000:])
                sys.exit(f"compare_bench: the bench failed in {dirs[side]}")
            line = json.loads(run.stdout.strip().splitlines()[-1])
            lines.setdefault((dtype, side), []).append(line)
            print(f"{dtype} {os.path.basename(dirs[side])}: "
                  + json.dumps(line), flush=True)
    for (dtype, side), got in sorted(lines.items()):
        med = {f: statistics.median(x[f] for x in got) for f in FIELDS}
        print(f"median {dtype} {os.path.basename(dirs[side])} "
              f"({len(got)} runs): " + json.dumps(med))


if __name__ == "__main__":
    main()
