#!/usr/bin/env python3
"""Round-5 BD-rate artifact on the PyTorch port: sweep a trained DMCI
over the QP ladder on real bitstreams and score against the published
EVC Kodak anchor (reference DCVC-family/EVC/results/RD_numbers.py:3-16).

The counterpart of `tools/bd_r5.py`, with its flags, defaults, printed
lines and JSON layout, on `opendcvc_tpu_torch` alone (no JAX), plus
`--device` (default cuda; cpu for a run without a card).  The
checkpoint is a JAX-layout `save_params` file, which the port reads.

Content caveat (documented in the artifact): the environment ships no
photographic corpora, so the sweep runs on HELD-OUT natural-statistics
synthetic content (training/syndata.natural_images, disjoint seed) at
Kodak geometry (512x768); the anchor numbers are the published Kodak
measurements.  `bd_rate` fits a cubic, so a sweep needs four QPs or
more.

Usage:
    python tools/bd_r5_torch.py --ckpt ckpt/dmci_r5.msgpack \
        --out docs/bd_rate_r5.json [--qps 8,16,24,32,40,48,56,63]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import opendcvc_tpu_torch  # noqa: F401,E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", default="docs/bd_rate_r5.json")
    ap.add_argument("--qps", default="4,12,20,28,36,44,52,60,63")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--n_images", type=int, default=4)
    ap.add_argument("--seed", type=int, default=424242,
                    help="held-out content seed (training bank uses 0)")
    ap.add_argument("--step", type=int, default=None,
                    help="training step of the ckpt, recorded as-is")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from opendcvc_tpu_torch.eval.published_results import EVC_KODAK, bd_rate
    from opendcvc_tpu_torch.eval.rd_evidence import measure
    from opendcvc_tpu_torch.training.syndata import natural_images

    qps = [int(q) for q in args.qps.split(",")]
    points = measure(args.ckpt, qps=qps, size=args.size,
                     n_images=args.n_images, seed=args.seed,
                     width=args.width, gen=natural_images,
                     device=args.device)
    for p in points:
        print(json.dumps(p), flush=True)

    anchor = EVC_KODAK["EncL_DecL"]
    a_bpp, a_psnr = anchor["bpp"], anchor["psnr"]
    o_bpp = [p["bpp_stream"] for p in points]
    o_psnr = [p["psnr"] for p in points]
    # keep a monotone-in-psnr subsequence for the cubic fit
    order = sorted(range(len(o_psnr)), key=lambda i: o_psnr[i])
    o_bpp = [o_bpp[i] for i in order]
    o_psnr = [o_psnr[i] for i in order]
    bd = float(bd_rate(a_bpp, a_psnr, o_bpp, o_psnr))

    out = {
        "anchor": ("EVC Kodak EncL_DecL (published, reference "
                   "DCVC-family/EVC/results/RD_numbers.py)"),
        "ours": (f"full-size DMCI ({args.ckpt}"
                 + (f", step {args.step}" if args.step else "")
                 + "), held-out natural-statistics content "
                 f"{args.size}x{args.width} seed {args.seed} "
                 "(anchor is published Kodak — content domains differ; "
                 "no photographic corpus ships in this environment)"),
        "anchor_points": {"bpp": a_bpp, "psnr": a_psnr},
        "our_points": {"bpp": o_bpp, "psnr": o_psnr},
        "points": points,
        "bd_rate_vs_anchor_pct": round(bd, 1),
    }
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"BD-rate vs EVC EncL anchor: {bd:+.1f}%  -> {args.out}")
    return out


if __name__ == "__main__":
    main()
