#!/usr/bin/env python3
"""Where K2's time goes on the card: its fixed cost and its cost a step.

    python3 tools/probe_k2.py [--sass PATH]

Times K2 (ops/lane_rans.py decode_scan) at 4096 lanes over a 128-row
random table, as the median of 20 launches with CUDA events queued behind
a sleep (device time alone): K = 0 (launch, table fill and prologue
only), then K = 64 and 256 with every slot coded and with every slot
skipped.  A skipped slot runs the same branch-free step but keeps the
state, so coded minus skipped is what the data-dependent part of the
search costs.  --sass writes the kernels' SASS (cuobjdump) there.
Needs one CUDA card; prints the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from opendcvc_tpu_torch.ops import _build  # noqa: E402
from opendcvc_tpu_torch.ops import lane_rans as LR  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", help="write the kernels' SASS to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_k2: no CUDA card")
    dev = torch.device("cuda", 0)
    libs = _build.build_kernels()
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(_build._nvcc()),
                                 "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", libs["lane_rans"]],
                              capture_output=True, text=True, check=True)
        with open(args.sass, "w") as f:
            f.write(sass.stdout)

    rng = np.random.default_rng(0)
    L, n_rows = 4096, 128
    table = LR.prepare_decode_table(
        torch.from_numpy(CS.random_tables(rng, n_rows)).to(dev))
    data = torch.from_numpy(rng.integers(0, 1 << 16, (L, 512))
                            .astype(np.int32)).to(dev)
    state = torch.from_numpy(rng.integers(1 << 16, 1 << 32, L)).to(dev)
    ptr = torch.zeros((L,), dtype=torch.int32, device=dev)

    def time_rows(rows):
        rows = rows.to(torch.int32).to(dev).contiguous()
        return CS.median_ms(
            lambda: LR.decode_scan(data, rows, table, state, ptr), dev,
            queued=True)

    fixed = time_rows(torch.zeros((0, L)))
    print(f"K2 K=0 (launch, fill, prologue): {fixed:.4f} ms")
    for k in (64, 256):
        coded = time_rows(torch.from_numpy(rng.integers(0, n_rows, (k, L))))
        skipped = time_rows(torch.full((k, L), 255))
        print(f"K2 K={k}: coded {coded:.4f} ms "
              f"({(coded - fixed) / k * 1e3:.4f} us a step), all skipped "
              f"{skipped:.4f} ms ({(skipped - fixed) / k * 1e3:.4f} us a "
              f"step)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    print(card.stdout.strip())


if __name__ == "__main__":
    main()
