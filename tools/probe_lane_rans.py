#!/usr/bin/env python3
"""Where the lane rANS kernels' time goes on the card: the fixed cost and
the cost a step of K1 (encode) and K2 (decode).

    python3 tools/probe_lane_rans.py [--kernel k1|k2|both] [--sass PATH]

Each kernel is timed at 4096 lanes as the median of 20 launches with CUDA
events queued behind a sleep (device time alone): at K = 0 (launch and
prologue only), then at K = 64 and 256 with every slot coded (uniform
symbols over random rows) and with every slot skipped.  A skipped slot
runs the same branch-free step, so coded minus skipped is what the
data-dependent part of a step costs.
  K1 (ops/lane_rans.py encode_scan): a 256-row random prepared table, a
  staging width of 260 words (the prologue zeroes the staging; K = 0 is
  also timed with 8 words, which leaves the zeroing out).  A skipped
  slot's entry is the identity, whose copy reads nothing, so coded minus
  skipped is the entry gathers and the emitted words.  A second of
  launches comes first, so that no timing meets a cold card.
  K2 (decode_scan): a 128-row random table, K = 0 being launch, table
  fill and prologue; a skipped slot keeps the state, so coded minus
  skipped is the search's data-dependent part.
Last, a one-element PyTorch add timed the same way gives the floor of
this measure.  --sass writes the kernels' SASS (cuobjdump) there.
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

L = 4096


def _report(name, fixed, coded_at, skipped_at):
    """Print the coded and skipped costs at K = 64 and 256 above the
    fixed cost (K = 0)."""
    for k in (64, 256):
        coded, skipped = coded_at(k), skipped_at(k)
        print(f"{name} K={k}: coded {coded:.4f} ms "
              f"({(coded - fixed) / k * 1e3:.4f} us a step), all skipped "
              f"{skipped:.4f} ms ({(skipped - fixed) / k * 1e3:.4f} us a "
              f"step)")


def probe_k1(dev, rng):
    n_rows, mw = 256, 260
    table = LR.prepare_encode_table(
        torch.from_numpy(CS.random_tables(rng, n_rows)).to(dev))

    def time_packed(sym, rows, width=mw):
        packed = LR.pack_operand(torch.from_numpy(sym),
                                 torch.from_numpy(rows)).to(dev)
        return CS.median_ms(lambda: LR.encode_scan(packed, table, width),
                            dev, queued=True)

    # a second of launches first, so no timing below meets a cold card
    wrng = np.random.default_rng(1)
    warm = LR.pack_operand(
        torch.from_numpy(wrng.integers(-128, 128, (256, L))),
        torch.from_numpy(wrng.integers(0, n_rows, (256, L)))).to(dev)
    for _ in range(20000):
        LR.encode_scan(warm, table, mw)
    torch.cuda.synchronize(dev)
    empty = np.zeros((0, L), np.int64)
    fixed = time_packed(empty, empty)
    print(f"K1 K=0 (launch, prologue): {fixed:.4f} ms; with an "
          f"8-word staging {time_packed(empty, empty, 8):.4f} ms")
    _report("K1", fixed,
            lambda k: time_packed(rng.integers(-128, 128, (k, L)),
                                  rng.integers(0, n_rows, (k, L))),
            lambda k: time_packed(np.zeros((k, L), np.int64),
                                  np.full((k, L), LR.ENC_SKIP)))


def probe_k2(dev, rng):
    n_rows = 128
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
    _report("K2", fixed,
            lambda k: time_rows(torch.from_numpy(
                rng.integers(0, n_rows, (k, L)))),
            lambda k: time_rows(torch.full((k, L), 255)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("k1", "k2", "both"),
                    default="both", help="which kernel to time")
    ap.add_argument("--sass", help="write the kernels' SASS to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_lane_rans: no CUDA card")
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
    if args.kernel in ("k1", "both"):
        probe_k1(dev, rng)
    if args.kernel in ("k2", "both"):
        probe_k2(dev, rng)
    one = torch.zeros(1, device=dev)
    print(f"a one-element PyTorch add, timed the same way (the floor of "
          f"this measure): "
          f"{CS.median_ms(lambda: one.add_(1), dev, queued=True):.4f} ms")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    print(card.stdout.strip())


if __name__ == "__main__":
    main()
