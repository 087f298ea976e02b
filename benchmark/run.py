"""The port's benchmark: one cell, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Loads the cell's files by name (BENCHMARK.json, `configs/`, `workloads/`,
`modes/`, `metrics/`), draws the weights (from the configuration's seed)
and the frames (from the run's seed) on the card, lets the cell's mode
set up and warm up (set-up, `setup_s`), runs the mode's passes for
`--seconds` (the window), and, with `--trace 1`,
profiles one more pass (the slice) for the per-layer metrics.  Then it
reads the peak memory, frees the measured codecs, computes the plain
reference of the sampled outputs, looks for modules of JAX or the JAX
package (a result is printed only where none is loaded) and prints one
JSON line.  Without a
CUDA device it prints no result and exits with 2; it never falls back to
the CPU.  `execute()` is the entry the CPU tests drive at tiny sizes.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
BUILD_DIR = os.path.join(BENCH_DIR, "_build")
FORBIDDEN = ("jax", "jaxlib", "flax", "opendcvc_tpu")


def _environment():
    """Builds and kernel caches at fixed paths inside the checkout; keep
    libraries from loading JAX by themselves."""
    os.environ["OPENDCVC_TPU_BUILD_DIR"] = BUILD_DIR
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD_DIR, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD_DIR, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT, BENCH_DIR):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules():
    """Modules loaded whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Result:
    """What the per-layer readers read: the window's spans and frames, the
    traced slice, and the yardstick's counts for this cell's work."""

    def __init__(self, rec, window_s, trace, slice_frames, counts):
        self.rec, self.window_s = rec, window_s
        self.trace, self.slice_frames = trace, slice_frames
        self.counts = counts


def _counts(cell, mode_run):
    """FLOPs of the window's frames and bytes of the slice's kernels, from
    `counts/`."""
    from counts import flops, lane_rans
    from core.spec import load_json
    size = f"{mode_run.size[0]}x{mode_run.size[1]}"
    path = flops.path_of(cell.config["name"])
    per = load_json(path).get(size) if os.path.exists(path) else None
    peaks = load_json(os.path.join(BENCH_DIR, "counts", "peaks.json"))
    return {"flops": per, "peaks": peaks,
            "k2_bytes_pass": lane_rans.k2_pass_bytes(mode_run.k2_launches)
            if getattr(mode_run, "k2_launches", None) else None,
            "k1_bytes_pass": lane_rans.k1_pass_bytes(mode_run.k1_launches)
            if getattr(mode_run, "k1_launches", None) else None}


def _window_flops(per, rec, work):
    if per is None:
        return None
    return sum(n * sum(per[role][op] for role, op in work[kind])
               for kind, n in rec.frames.items())


def _attempt(run, rec):
    """One pass of the mode; a frame the measured package refuses (its
    decoder raises on a stream that is not the frame's symbols) fails,
    with the rest of its pass.  Returns the frames that failed."""
    done = rec.n_frames()
    try:
        run.run_pass()
    except (ValueError, RuntimeError, OverflowError) as e:
        rec.errors.append(repr(e))
        return max(1, run.period - (rec.n_frames() - done))
    return 0


def sample_positions(seed, period, k):
    """The period positions whose outputs are compared: the I-frame, the
    last frame (the longest chain) and k - 2 others drawn from the seed."""
    inner = list(range(1, period - 1))
    drawn = random.Random(int(seed)).sample(inner, min(len(inner), k - 2))
    return sorted({0, period - 1} | set(drawn))


def execute(name, seed, seconds, trace, device, overrides=None):
    """Run cell `name` on `device`; returns (result dict, checks list).
    `overrides` replace configuration and workload keys (the CPU tests'
    tiny sizes)."""
    _environment()
    import torch
    from core import content
    from core.record import Recorder
    from core.spec import Cell
    from core.trace import profiled

    cell = Cell(name)
    for key, val in (overrides or {}).get("config", {}).items():
        cell.config[key] = val
    for key, val in (overrides or {}).get("workload", {}).items():
        cell.workload[key] = val
    dev = torch.device(device)
    ref = cell.reference()
    ref.pin_precision(tf32=False)
    rec = Recorder()
    weights = content.make_weights(cell.config, ref, dev)
    run = cell.mode().Run(cell, weights, seed, dev, rec)
    if run.period != cell.workload["intra_period"]:
        raise ValueError(f"{name}: the mode codes periods of {run.period} "
                         f"frames, the workload says "
                         f"{cell.workload['intra_period']}")
    run.sample_at(sample_positions(seed, run.period,
                                   cell.workload["check"]["samples"]))
    run.setup()
    failed = _attempt(run, rec)     # warms every shape the window uses
    run.sync()
    for v in run.samples.values():
        v.clear()
    setup_s = time.perf_counter() - T_START

    rec.counting = True
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        failed += _attempt(run, rec)
    run.sync()
    window_s = time.perf_counter() - t0
    rec.counting = False
    tr = None
    if trace:
        with profiled(rec, dev) as got:
            failed += _attempt(run, rec)
        tr = got[0]
    for e in rec.errors[:5]:
        print(f"benchmark: a pass failed: {e}", file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    res = Result(rec, window_s, tr, run.period, _counts(cell, run))
    res.counts["window_flops"] = _window_flops(res.counts["flops"], rec,
                                               run.work)
    metrics = {}
    entries = cell.per_layer() if trace else cell.end_to_end()
    for m in entries:
        v = setup_s if m["name"] == "setup_s" else \
            cell.reader(m["name"]).read(res)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    samples = run.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    frames = content.make_frames(cell.config, seed, run.period, dev)
    checks = run.compare(ref, weights, frames, samples)
    out = {"correct": failed == 0 and all(c["value"] <= c["limit"]
                                          for c in checks),
           "attempted": rec.n_frames() + failed, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu",
                      "count": 1, "memory_peak_bytes": peak}}
    if tr is not None:
        out["device"]["busy_s"] = tr.busy_s
        out["device"]["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                            "idle_gaps": [list(x) for x in tr.idle_gaps]}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return out, checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    try:
        import torch
        from core.spec import Cell
        chips = Cell(args.workload).entry["chips"]
        import opendcvc_tpu_torch  # noqa: F401  (the measured package)
    except (ImportError, FileNotFoundError, KeyError) as e:
        print(f"benchmark: cannot load the cell or the measured package: "
              f"{e!r}", file=sys.stderr)
        return 1
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s), this "
              f"machine has {have}", file=sys.stderr)
        return 2
    out, checks = execute(args.workload, args.seed, args.seconds,
                          args.trace, "cuda")
    line = json.dumps(out)
    found = forbidden_modules()     # the last step before the result
    if found:
        print(f"benchmark: modules of JAX or the JAX package loaded: "
              f"{found}; no result", file=sys.stderr)
        return 1
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}, "
              f"{c['compared']} outputs compared)", file=sys.stderr)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
