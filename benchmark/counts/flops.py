"""NN FLOPs a frame, counted once per configuration and frame size with
`torch.utils.flop_counter.FlopCounterMode` over the plain reference's
stages on meta tensors (shapes only, no arithmetic), and kept in
`flops_<config>.json` beside this file, so no change to the measured
package moves them and a new configuration adds a file of its own.  Each
configuration's reference module lists what an encoder and a decoder of
each frame kind run (`FLOP_WORK`).

    python3 benchmark/counts/flops.py dcvc_rt     # writes flops_dcvc_rt.json
"""

import json
import os
import sys

from torch.utils.flop_counter import FlopCounterMode

HERE = os.path.dirname(os.path.abspath(__file__))


def path_of(config):
    return os.path.join(HERE, f"flops_{config}.json")


def count(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def frame_flops(ref, cfg, height, width):
    """{kind: {"enc": n, "dec": n}} at a padded frame size, from the
    reference's FLOP_WORK on meta tensors."""
    from reference import draws
    d = draws.Draws("meta")
    w = {role: ref.INIT[role](d) for role in ("intra", "inter")}
    return {kind: {side: count(lambda f=fn: f(w, cfg, height, width))
                   for side, fn in sides.items()}
            for kind, sides in ref.FLOP_WORK.items()}


def padded(cfg):
    return -(-cfg["height"] // 16) * 16, -(-cfg["width"] // 16) * 16


def main(names):
    import importlib
    bench_dir = os.path.dirname(HERE)
    sys.path.insert(0, bench_dir)
    for name in names:
        with open(os.path.join(bench_dir, "configs", f"{name}.json")) as f:
            cfg = json.load(f)
        ref = importlib.import_module(f"reference.{cfg['reference']}")
        h, w = padded(cfg)
        with open(path_of(name), "w") as f:
            json.dump({f"{h}x{w}": frame_flops(ref, cfg, h, w)}, f,
                      indent=1, sort_keys=True)
            f.write("\n")


if __name__ == "__main__":
    main(sys.argv[1:])
