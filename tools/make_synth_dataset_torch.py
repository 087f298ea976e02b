#!/usr/bin/env python3
"""Generate a synthetic UVG-style PNG video dataset + harness config, on
the PyTorch port.

The counterpart of `tools/make_synth_dataset.py`, with its flags,
defaults, printed lines, PNG files and config.json, on
`opendcvc_tpu_torch` alone (no JAX; the content is numpy, so no card
is needed).  The environment ships no test corpora (UVG/HEVC-B), so the
round-5 P-frame RD artifact runs the eval harness (NAL bitstreams,
decode, reference-format JSON; the port's is `python -m
opendcvc_tpu_torch.eval.harness`) on natural-statistics synthetic
sequences (training/syndata.natural_seqs with a held-out seed).

Usage:
    python tools/make_synth_dataset_torch.py --root /tmp/synth_ds \
        [--seqs 3 --frames 33 --height 1080 --width 1920]
Writes <root>/synth_png/<seq>/im00001.png... and <root>/config.json.
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--seqs", type=int, default=3)
    ap.add_argument("--frames", type=int, default=33)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--intra_period", type=int, default=32)
    ap.add_argument("--seed", type=int, default=31415926,
                    help="held-out seed (training banks use 0-range)")
    args = ap.parse_args(argv)

    from opendcvc_tpu_torch.training.syndata import natural_seqs
    from opendcvc_tpu_torch.utils.io import PNGWriter

    base = os.path.join(args.root, "synth_png")
    seqs_cfg = {}
    for i in range(args.seqs):
        # generate at HxH then mirror-tile to W to bound the FFT cost
        seq = natural_seqs(1, args.height, t=args.frames,
                           seed=args.seed + i * 1000)[0]
        if seq.shape[2] < args.width:
            # tile horizontally (mirror) to reach the target width
            reps = -(-args.width // seq.shape[2])
            tiles = [seq if j % 2 == 0 else seq[:, :, ::-1]
                     for j in range(reps)]
            seq = np.concatenate(tiles, axis=2)[:, :, :args.width]
        name = f"synth_{i:02d}_{args.width}x{args.height}"
        wr = PNGWriter(os.path.join(base, name), args.width,
                       args.height)
        for t in range(args.frames):
            frame = np.round(seq[t] * 255).astype(np.uint8)
            wr.write_one_frame(frame.transpose(2, 0, 1))
        seqs_cfg[name] = {"width": args.width, "height": args.height,
                          "frames": args.frames,
                          "intra_period": args.intra_period}
        print(f"wrote {name}", flush=True)

    cfg = {"root_path": args.root,
           "test_classes": {"SYNTH": {"test": 1, "base_path": "synth_png",
                                      "src_type": "png",
                                      "sequences": seqs_cfg}}}
    cfg_path = os.path.join(args.root, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=1)
    print(f"config -> {cfg_path}")
    return cfg_path


if __name__ == "__main__":
    main()
