"""The port's spans and counters: one trace that the codecs' entry points,
NN stages, device waits, uploads and host coder report to.

    from opendcvc_tpu_torch.utils import trace
    with trace.span("dmc.decompress", 1):     # an entry point: 1 frame
        ...
    trace.count("slim.miss")

A session is an enable() ... disable() interval or a torch.profiler
recording, which this module finds by itself: a span or counter that finds
a profiler recording and no session open opens one (fresh totals); once
the profiler has stopped, the next span, counter or last_session() closes
it, and its totals stay for last_session() until the next session opens.
So any profiler run gets the port's spans, on the clock of the device's
events, with no flag.

Outside a session `span()` checks one module variable and torch's
Python-level profiler flag (set for every thread while a profiler records)
and returns a shared null context: no range, no clock, no lock.  In a
session a span adds its host time (perf_counter_ns) and a count to the
session's totals, under a lock (chunks settle on pool threads), and, while
a profiler records, is a profiler range (a user annotation) whose args
carry its frame ids ("12", "12-19"); the profiler keeps the ranges of the
threads it records (all of them with its `profile_all_threads`).

Frame ids: an entry point's span passes the frames it codes as `frame`
(an int).  The outermost such span on a thread takes that many ids from a
process counter and counts them in the session's `frames`; the spans
nested in it carry its ids, and an entry span nested in it counts nothing.
`frame_ids()` gives a thread's ids for a span on another thread (a chunk's
settle) to carry as `frame` (a range).

Counters are process totals, always on (`counters()`, `reset_counters()`),
and are added to an open session too.  Inside `counted_into(d)` a
thread's counts go to the dict `d` alone: a CUDA graph's capture counts
nothing, and each replay adds what its capture would have counted
(`add_counts`), so counters read as if every frame ran eagerly, and
adds it again under `graph.replay.<name>`.

Names (PERF.md's contract):
  * entry points `dmci.compress`, `dmci.decompress`, `dmc.compress`,
    `dmc.compress_gop`, `dmc.upload_gop`, `dmc.decompress_gop`,
    `dmc.decompress`, `dmci_fm.compress`, `dmci_fm.decompress`,
    `dmc_fm.compress`, `dmc_fm.decompress`, `intra_no_ar.compress`,
    `intra_no_ar.decompress`, `dmc_hem.compress`, `dmc_hem.decompress`;
    the settle of a queued stream `dmc.finish`, `dmci.finish`;
  * `nn.<stage>` around the codecs' NN stages (`spanned()`);
  * `wait.<what>` where the host waits for the device (`wait()`):
    `wait.fetch` (utils/transfer.py::fetch_async), `wait.staging` (a
    staging's copy, entropy/device_rans.py);
  * `upload` (the host's part of an upload, utils/transfer.py),
    `coder.<call>` (the host rANS coder's calls, entropy/coder.py);
  * counters `k1.launch`, `k2.launch`, `slim.fetch`, `slim.miss`,
    `ec.rerun` (the device-EC ladders' reruns), `wait`; `d2h_bytes`,
    `h2d_bytes` (the bytes of every copy utils/transfer.py makes, host
    EC, device EC and training alike); `warp.call` (every
    `ops/warp.py::flow_warp` call), `warp.fused` (those on the CUDA
    kernel W1), `warp.launch` (W1's launches); `graph.call` (every frame
    through a body utils/graph.py can replay: DMC's device-EC decoder),
    `graph.replay` (those replayed from a CUDA graph), `graph.capture`
    (the graphs captured), `graph.replay.<name>` (the share of counter
    `<name>`, such as `graph.replay.k2.launch`, that replays added from
    their capture's counts rather than a host call).
"""

import contextlib
import functools
import threading
import time

import torch

_AP = torch.autograd.profiler     # ._is_profiler_enabled: any thread's
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()   # .ids (range or None), .entry (bool), .into

_session = None        # the open session's totals, or None
_by_profiler = False   # the open session follows a profiler recording
_last = None           # the last closed session's totals
_next_id = 1           # the next frame id
_totals = {}           # process counters


def _new_session():
    return {"frames": 0, "spans": {}, "counters": {}}


def _sync():
    """Open a session for a profiler that records, close one whose
    profiler has stopped; returns the open session or None."""
    global _session, _by_profiler, _last
    s = _session
    if s is not None:
        if _by_profiler and not _AP._is_profiler_enabled:
            with _lock:
                if _session is s:
                    _last, _session = s, None
            return None
        return s
    if not _AP._is_profiler_enabled:
        return None
    with _lock:
        if _session is None:
            _session, _by_profiler = _new_session(), True
        return _session


def enable():
    """Open a fresh session (closing an open one)."""
    global _session, _by_profiler, _last
    with _lock:
        if _session is not None:
            _last = _session
        _session, _by_profiler = _new_session(), False


def disable():
    """Close the open session; its totals stay for last_session()."""
    global _session, _last
    with _lock:
        if _session is not None:
            _last, _session = _session, None


def last_session():
    """{"frames", "spans": {name: {"ms", "n"}}, "counters": {name: n}} of
    the open session so far, else of the last closed one; None before any
    session."""
    _sync()
    with _lock:
        s = _session if _session is not None else _last
        if s is None:
            return None
        return {"frames": s["frames"],
                "spans": {k: {"ms": ns * 1e-6, "n": n}
                          for k, (ns, n) in s["spans"].items()},
                "counters": dict(s["counters"])}


def counters():
    """The process totals of every counter."""
    with _lock:
        return dict(_totals)


def reset_counters():
    with _lock:
        _totals.clear()


def count(name, n=1):
    """Add n to counter `name`: the process total and an open session's,
    or, inside counted_into(d) on this thread, d's alone."""
    into = getattr(_local, "into", None)
    if into is not None:
        into[name] = into.get(name, 0) + n
        return
    s = _sync() if _session is not None or _AP._is_profiler_enabled \
        else None
    with _lock:
        _totals[name] = _totals.get(name, 0) + n
        if s is not None:
            s["counters"][name] = s["counters"].get(name, 0) + n


def add_counts(counts):
    """Add each counter's n in `counts` ({name: n}) under one lock, to the
    process totals and an open session (a replay's counts)."""
    s = _sync() if _session is not None or _AP._is_profiler_enabled \
        else None
    with _lock:
        for name, n in counts.items():
            _totals[name] = _totals.get(name, 0) + n
            if s is not None:
                s["counters"][name] = s["counters"].get(name, 0) + n


@contextlib.contextmanager
def counted_into(counts):
    """Send this thread's counts to the dict `counts` alone while the body
    runs (a CUDA graph's capture)."""
    prev = getattr(_local, "into", None)
    _local.into = counts
    try:
        yield counts
    finally:
        _local.into = prev


def frame_ids():
    """This thread's current frame ids (a range), or None."""
    return getattr(_local, "ids", None)


def _range(name, ids):
    """A profiler range (a user annotation) for `name`, its frame ids in
    its args."""
    args = None if not ids else str(ids.start) if len(ids) == 1 else \
        f"{ids.start}-{ids[-1]}"
    return torch.profiler.record_function(name, args)


class _Span:
    __slots__ = ("name", "frame", "s", "prev", "rng", "t0")

    def __init__(self, name, frame):
        self.name, self.frame = name, frame

    def __enter__(self):
        global _next_id
        self.s = s = _sync()
        if s is None:
            return self
        self.prev = prev = (getattr(_local, "ids", None),
                            getattr(_local, "entry", False))
        f = self.frame
        if f is None or (isinstance(f, int) and prev[1]):
            ids = prev[0]
        elif isinstance(f, int):
            with _lock:
                ids = range(_next_id, _next_id + f)
                _next_id += f
                s["frames"] += f
            _local.entry = True
        else:
            ids = f
            _local.entry = True
        _local.ids = ids
        self.rng = _range(self.name, ids) if _AP._is_profiler_enabled \
            else None
        if self.rng is not None:
            self.rng.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        s = self.s
        if s is None:
            return False
        ns = time.perf_counter_ns() - self.t0
        if self.rng is not None:
            self.rng.__exit__(*exc)
        _local.ids, _local.entry = self.prev
        with _lock:
            got = s["spans"].get(self.name)
            s["spans"][self.name] = (ns, 1) if got is None else \
                (got[0] + ns, got[1] + 1)
        return False


def span(name, frame=None):
    """A context manager that records span `name` in a session (nothing
    outside one).  `frame`: an int, the frames an entry point codes; a
    range, ids that frame_ids() gave on another thread; None, the
    thread's current ids."""
    if _session is None and not _AP._is_profiler_enabled:
        return _NULL
    return _Span(name, frame)


def wait(name):
    """span(name) for a host wait on the device (`wait.<what>`), counted
    in `wait` whether or not a session is open."""
    count("wait")
    return span(name)


def spanned(name, frame=None):
    """Decorate a function (an NN stage, an entry point): each call is a
    span(name, frame)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _session is None and not _AP._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name, frame):
                return fn(*args, **kwargs)
        return call
    return wrap
