"""A codec body replayed from CUDA graphs, one captured per key.

A body of static shapes with no host read (DMC's device-EC decoder, whose
launches are cuDNN's and cuBLAS's and the port's own K2 and D1-D4) costs
the host a launch per kernel; replayed from a graph it costs one launch a
frame, so the device, not the host's dispatch, sets the pace.

    graphs = BodyGraphs()
    feature, x_hat = graphs.run(key, body, (staging, feature, qp),
                                params, (None, x_slot))

`run` counts `graph.call` and calls `body(*inputs)` eagerly (the twin)
for tensors off CUDA and where autograd would record (grad mode on and an
input or a weight requiring grad).  On a card, the first call of a key
runs the body eagerly on a side stream, which gives this call's outputs
and makes the libraries' handles, workspaces and the kernels' one-time
set-up happen outside a capture, then captures the body on that stream
(`capture_error_mode="thread_local"`) against static copies of the
inputs, counting `graph.capture`.  Each later call of the key copies its
inputs into the static buffers on the current stream, replays the graph
there and hands out the static outputs as copies, counting
`graph.replay`: each into the tensor `out` gives for it (a slot of the
caller's, any strides), else into a clone, so nothing the caller gets is
overwritten by the next replay.  The eager path copies into `out` too.

The key is the caller's: everything that fixes the captured work (shapes,
dtype, device, the body's constants); `run` adds whether inference mode
is on.  Counters read as if every call ran eagerly: the capture's counts
(`k2.launch`, `dcb.*`) go to the graph (`trace.counted_into`), and each
replay adds them, and adds them again under `graph.replay.<name>`: no
host call launched those (phases 4 and 26 of chip_smoke.py hold them to
the kernels a profiler lists in replayed frames).  A cache keeps
`CACHE_SIZE` keys, dropping the one used longest ago, so a caller that
walks many sizes or container rungs holds a few graphs' memory pools; a
value that changes from frame to frame belongs in the inputs as a device
tensor (DMC's qp), not in the key.  The body reads its weights and
tables by address: `clear()` drops every graph, as a codec must do
whenever it loads weights or rebuilds its tables.  Whether autograd
would record is looked at on every call, weights included.

Within `eager()` every body runs eagerly, as on the CPU: a profile that
splits a body's device time by its stages needs that (a replay's kernels
all go to the one host call that launched the graph), and so does a
timing of the eager twin.
"""

import collections
import contextlib

import torch

from . import trace
from .params import tree_map

#: the keys a BodyGraphs keeps captured (DMC's staging ladder has four
#: rungs, bps 0.5, 1, 2 and 3)
CACHE_SIZE = 4

_eager = [0]     # the depth of eager() blocks open


def _on_card(t):
    return t.is_cuda


@contextlib.contextmanager
def eager():
    """Every body run within takes its eager twin, on any device."""
    _eager[0] += 1
    try:
        yield
    finally:
        _eager[0] -= 1


class _Graph:
    """One body's CUDA graph, with the side stream (from PyTorch's pool)
    of its warm-up and capture."""

    def __init__(self, device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.graph = torch.cuda.CUDAGraph()

    def warm(self, fn):
        """fn() run eagerly on the side stream, ordered after the current
        stream's queue and before its later work."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        for o in out:
            o.record_stream(cur)
        return out

    def capture(self, fn):
        """Capture fn(); returns its outputs, the graph's static
        buffers."""
        with torch.cuda.graph(self.graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            return fn()

    def replay(self):
        self.graph.replay()


_Captured = collections.namedtuple("_Captured",
                                   "graph inputs outputs counts")


def _replay_counts(counts):
    """A capture's counts as a replay adds them: each under its name and
    under `graph.replay.<name>`, which tells them from counts of launches
    the host made."""
    out = dict(counts)
    out.update(("graph.replay." + k, n) for k, n in counts.items())
    return out


def _handed(outputs, out, fresh):
    """Output i copied into out[i] where that is a tensor, else the output
    itself where it is `fresh` (the eager body's), else its clone."""
    return tuple(d.copy_(o) if d is not None else o if fresh else o.clone()
                 for o, d in zip(outputs, out))


def _leaves(tree):
    """The tensors of a tree of dicts, lists and tuples."""
    out = []
    tree_map(lambda t: out.append(t) if isinstance(t, torch.Tensor)
             else None, tree)
    return out


class BodyGraphs:
    """The captured graphs of one codec's body, by key (the oldest dropped
    past CACHE_SIZE)."""

    def __init__(self):
        self._graphs = collections.OrderedDict()
        self._weights = (None, ())   # a weights tree and its tensors

    def __len__(self):
        return len(self._graphs)

    def clear(self):
        self._graphs.clear()
        self._weights = (None, ())

    def _records(self, inputs, weights):
        """Whether autograd would record the body: grad mode on and an
        input or a weight requiring grad, looked at on every call (the
        tree's tensors are listed once for each tree)."""
        if not torch.is_grad_enabled():
            return False
        if self._weights[0] is not weights:
            self._weights = (weights, _leaves(weights))
        return any(t.requires_grad for t in inputs) or \
            any(t.requires_grad for t in self._weights[1])

    def run(self, key, body, inputs, weights, out):
        """body(*inputs) -> a tuple of tensors, eagerly or replayed from the
        key's graph (captured at its first call); output i is copied into
        out[i] where that is a tensor, else handed out as it is (eager) or
        cloned (replayed)."""
        trace.count("graph.call")
        if _eager[0] or not _on_card(inputs[0]) or \
                self._records(inputs, weights):
            return _handed(body(*inputs), out, True)
        key = key + (torch.is_inference_mode_enabled(),)
        got = self._graphs.get(key)
        if got is None:
            return _handed(self._capture(key, body, inputs), out, True)
        self._graphs.move_to_end(key)
        for static, t in zip(got.inputs, inputs):
            static.copy_(t)
        got.graph.replay()
        trace.add_counts(got.counts)
        trace.count("graph.replay")
        return _handed(got.outputs, out, False)

    def _capture(self, key, body, inputs):
        graph = _Graph(inputs[0].device)
        out = graph.warm(lambda: body(*inputs))
        static = tuple(t.clone() for t in inputs)
        counts = {}
        with trace.counted_into(counts):
            outputs = graph.capture(lambda: body(*static))
        self._graphs[key] = _Captured(graph, static, tuple(outputs),
                                      _replay_counts(counts))
        # the capture synchronized the device: no dropped graph still runs
        while len(self._graphs) > CACHE_SIZE:
            self._graphs.popitem(last=False)
        trace.count("graph.capture")
        return out
