"""Model complexity: parameter counts and FLOPs.

    python -m opendcvc_tpu_torch.eval.complexity [--height 768 --width 512]
        [--device cpu]

Counterpart of the JAX package's `eval/complexity.py` (the reference's
ptflops tool).  `flops_of` counts with torch's FlopCounterMode, which
counts the FLOPs of matrix products and convolutions (2 a
multiply-accumulate) and nothing else; the JAX package's count is XLA's
cost analysis, which adds elementwise operations, so the two counts of
one function differ (tests/test_torch_port_eval_extras.py states the
measured ratio).
"""

import argparse

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..models import common as C
from ..models.dmci import _stage_enc_front, dmci_init
from ..training.train import tree_leaves
from ..utils.params import to_device


def count_params(params):
    """Elements over every leaf of a parameter tree."""
    return sum(t.numel() for t in tree_leaves(params))


def flops_of(fn, *args):
    """FLOPs of one call fn(*args) (matrix products and convolutions)."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def report_dmci(height=768, width=512, device="cuda"):
    """The full-size DMCI's parameter count and the FLOPs of its encoder
    front (frame -> y, z) on a height x width frame."""
    device = C.resolve_device(device)
    params = to_device(dmci_init(torch.Generator().manual_seed(0)), device)
    x = torch.zeros((1, 3, height, width), device=device)
    fl = flops_of(_stage_enc_front, params, x, 32)
    return {"model": "DMCI", "input": f"{width}x{height}",
            "params": count_params(params), "enc_front_flops": fl,
            "enc_front_gmacs": fl / 2e9}


def report_fn(name, fn, params, *args):
    return {"model": name, "params": count_params(params),
            "flops": flops_of(fn, params, *args)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=768)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the CPU "
                         "path)")
    args = ap.parse_args(argv)
    rep = report_dmci(args.height, args.width, args.device)
    for k, v in rep.items():
        print(f"{k}: {v}")
    return rep


if __name__ == "__main__":
    main()
