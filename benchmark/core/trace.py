"""The profiled slice of a traced run, reduced to what the per-layer
readers need: device intervals by class, the device's busy time as the
union of its intervals, the slice's length, the top device operations and
the longest idle gaps named by the benchmark span the host was in."""

import contextlib
import time

import torch

SLICE = "bench_slice"


def kernel_class(name):
    """A device operation's class: a frozen copy of the measured
    package's profiling tool's classifier (tools/profile_torch_port.py)."""
    n = name.lower()
    if n.startswith("lr_") or "lr_encode" in n or "lr_decode" in n:
        return "lane_rans"
    if "memcpy htod" in n:
        return "upload"
    if "memcpy dtoh" in n:
        return "fetch"
    if "memcpy" in n or "memset" in n:
        return "copy_other"
    if "nchwtonhwc" in n or "nhwctonchw" in n:
        return "transpose"
    if "conv_depthwise" in n:
        return "depthwise"
    if any(s in n for s in ("conv", "gemm", "cudnn", "xmma", "cutlass",
                            "winograd", "implicit", "nvjet")):
        return "convolution"
    if "gather" in n:
        return "gather"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    return "other"


def _ns(ev, what):
    fn = getattr(ev, f"{what}_ns", None)
    return fn() if fn is not None else getattr(ev, f"{what}_us")() * 1000


def _union(intervals):
    """Total length of the union of (start, end) intervals, and the gaps
    between the merged runs."""
    total, gaps, cur = 0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s <= cur[1]:
            cur[1] = max(cur[1], e)
        else:
            total += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


class Trace:
    """Per-class device seconds of the slice, its busy and window seconds,
    the K1/K2 launch times in order, and the breakdown lists."""

    def __init__(self, device_events, annotations, window_s):
        self.window_s = window_s
        bounds = [(s, e) for n, s, e in annotations if n == SLICE]
        if bounds:
            lo, hi = bounds[0]
        else:
            lo = min((s for _, s, _ in device_events), default=0)
            hi = max((e for _, _, e in device_events), default=0)
        evs = [(n, max(s, lo), min(e, hi)) for n, s, e in device_events
               if e > lo and s < hi]
        self.by_class, by_name = {}, {}
        self.lane_rans = []
        for n, s, e in evs:
            k = kernel_class(n)
            self.by_class[k] = self.by_class.get(k, 0.0) + (e - s) * 1e-9
            by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
            if k == "lane_rans":
                self.lane_rans.append((n, (e - s) * 1e-9))
        busy_ns, gaps = _union([(s, e) for _, s, e in evs])
        self.busy_s = busy_ns * 1e-9
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        spans = [(n, s, e) for n, s, e in annotations if n != SLICE]
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        self.idle_gaps = [(_host_label(spans, a, b), (b - a) * 1e-9)
                          for a, b in longest]

    def seconds(self, *classes):
        return sum(self.by_class.get(k, 0.0) for k in classes)

    def nn_seconds(self):
        """Every device operation but copies and the lane rANS kernels."""
        return sum(v for k, v in self.by_class.items()
                   if k not in ("lane_rans", "upload", "fetch",
                                "copy_other"))


def _host_label(spans, a, b):
    """The innermost benchmark span that covers most of the gap [a, b)."""
    best, best_cover, best_len = "no span", 0, None
    for n, s, e in spans:
        cover = min(e, b) - max(s, a)
        if cover > 0 and (cover > best_cover or (cover == best_cover and
                                                 e - s < best_len)):
            best, best_cover, best_len = n, cover, e - s
    return best


@contextlib.contextmanager
def profiled(rec, device):
    """Profile the body as the traced slice; yields a one-element list
    that holds the Trace once the body has ended (synchronized)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    out = []
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    rec.annotate = True
    try:
        with profile(activities=acts, record_shapes=False) as prof:
            t0 = time.perf_counter()
            with record_function(SLICE):
                yield out
                if cuda:
                    torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
    finally:
        rec.annotate = False
    dev_events, notes = [], []
    for ev in prof.profiler.kineto_results.events():
        s = _ns(ev, "start")
        e = s + _ns(ev, "duration")
        on_device = ev.device_type() == torch.autograd.DeviceType.CUDA
        if ev.is_user_annotation():
            # a span's copy on the device's timeline is no device work
            if not on_device:
                notes.append((ev.name(), s, e))
        elif on_device:
            dev_events.append((ev.name(), s, e))
    spans = {n for n, _, _ in notes} | {SLICE}
    out.append(Trace([d for d in dev_events if d[0] not in spans], notes,
                     window_s))
