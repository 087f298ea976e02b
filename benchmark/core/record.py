"""What a run records from the benchmark's own side: host-time spans
around the calls into the measured package, the host coder's time and
the frames each window coded.

Spans are kept in memory as totals by name; while the profiler runs each
span is also a `record_function` range, so the trace can say what the
host was doing in an idle gap of the device."""

import contextlib
import time

import torch

# the host coder's calls (the measured package's entropy/coder.py)
CODER_CALLS = ("reset", "encode_y", "encode_z", "flush",
               "get_encoded_stream", "set_stream", "decode_y", "decode_z",
               "get_decoded_tensor")


class Recorder:
    def __init__(self):
        self.ms = {}          # span name -> total host ms in the window
        self.frames = {}      # frame kind -> frames in the window
        self.errors = []      # what a failed pass raised
        self.annotate = False
        self.counting = False

    @contextlib.contextmanager
    def span(self, name):
        rf = torch.profiler.record_function(name) if self.annotate \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                if self.counting:
                    self.ms[name] = self.ms.get(name, 0.0) + \
                        (time.perf_counter() - t0) * 1e3

    def frame(self, kind, n=1):
        if self.counting:
            self.frames[kind] = self.frames.get(kind, 0) + n

    def n_frames(self):
        return sum(self.frames.values())


def clock_coder(coder, rec, name="host_coder"):
    """Wrap an EntropyCoder's calls so each adds its host time to the span
    `name` of `rec` (a copy of the measured package's chip smoke test's
    coder clock)."""
    for call in CODER_CALLS:
        def timed(*args, _fn=getattr(coder, call), **kwargs):
            with rec.span(name):
                return _fn(*args, **kwargs)
        setattr(coder, call, timed)
