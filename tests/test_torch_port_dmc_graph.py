"""DMC's device-EC decoder body replayed from CUDA graphs
(`utils/graph.py::BodyGraphs`, `models/dmc.py::DMC._decode_staged`).

On the CPU a stand-in for the graph class (`_FakeGraph`) records the body
at its capture and re-runs it on replay into its static outputs, so the
cache's logic runs here: a repeated key replays and a changed kyc, MW
or frame size captures anew, while frames at other qps replay (qp is an
input of the graph, a device tensor); the cache drops its oldest key
past its size; what a decode hands out (x_hat, the DPB's feature) never shares
storage with a graph's static buffers, nor with the previous call's;
counters after replays read as the eager frames' would, with
`graph.call`, `graph.replay` and `graph.capture` as counted; the eager
twin runs on the CPU, within `eager()` and where autograd records
(looked at on every call).  Tests marked `card` hold the replay against
the eager twin bit for bit at 1080p (a first P-frame and a GOP chunk of
8, float32 and bfloat16, x_hat and feature), on a skip-compacted
stream, a chunk of mixed rungs and a chunk at the harness's cycle of
qps, and the decoder's features against the encoder's; they skip without a card.  This file
imports no JAX, so they run on a card's machine with

    python3 -m pytest --noconftest -p no:cacheprovider -q -m card \\
        tests/test_torch_port_dmc_graph.py
"""

import numpy as np
import pytest
import torch

from opendcvc_tpu_torch.entropy import device_rans as PD
from opendcvc_tpu_torch.models import dmc as PDMC
from opendcvc_tpu_torch.utils import graph as G
from opendcvc_tpu_torch.utils import trace
from test_torch_port_dcb_epilogue import card  # noqa: F401  (fixture)
from test_torch_port_dcb_epilogue import _one_thread  # noqa: F401

H = W = 64
SPS = {"height": H, "width": W}
QP = 21
GRAPH = ("graph.call", "graph.replay", "graph.capture")
NO_OUT = (None, None)


class _FakeGraph:
    """utils/graph.py::_Graph on the CPU: the warm-up runs the body;
    the capture runs it once (leaving the outputs a capture leaves, the
    static buffers) and keeps it; a replay runs it again into those
    buffers, counting nothing itself, as a graph's launch counts
    nothing."""

    def __init__(self, device):
        self.fn = self.outputs = None

    def warm(self, fn):
        return fn()

    def capture(self, fn):
        self.fn, self.outputs = fn, fn()
        return self.outputs

    def replay(self):
        with trace.counted_into({}):
            new = self.fn()
        for o, n in zip(self.outputs, new):
            o.copy_(n)


@pytest.fixture
def graphs_here(monkeypatch):
    """The graph path on the CPU, through the stand-in."""
    monkeypatch.setattr(G, "_Graph", _FakeGraph)
    monkeypatch.setattr(G, "_on_card", lambda t: True)


def _delta(before, names=GRAPH, now=None):
    now = trace.counters() if now is None else now
    return tuple(now.get(k, 0) - before.get(k, 0) for k in names)


def _frames(h, w, n, seed=11):
    rng = np.random.default_rng(seed)
    x0 = rng.random((1, h, w, 3), dtype=np.float32)
    frames, prev = [], x0
    for _ in range(n):
        prev = np.clip(prev + rng.normal(0, 0.02, prev.shape)
                       .astype(np.float32), 0, 1)
        frames.append(prev)
    return x0, frames


def _codec(device="cpu", dtype=torch.float32, fz=None, params=None, **kw):
    net = PDMC.DMC(device=device, device_ec=True, dtype=dtype, **kw)
    if params is None:
        net.init_params(seed=1)
        net.params["q_encoder"] = torch.ones_like(
            net.params["q_encoder"]) * 0.25
        net.params["q_decoder"] = torch.ones_like(net.params["q_decoder"])
    else:
        net.load_params(params)
    net.update(force_zero_thres=fz)
    return net


def _encode(enc, x0, frames, qps):
    """The first P-frame alone, then the rest as one GOP chunk; returns
    (first stream, chunk streams, the encoder's feature after the first
    frame and after the chunk)."""
    enc.add_ref_frame(None, torch.as_tensor(x0).to(enc.device))
    s1 = enc.compress(frames[0], qps[0])["bit_stream"]
    f1 = enc.dpb[0].feature
    chunk = enc.compress_gop(frames[1:], qps[1:])["bit_streams"]
    return s1, chunk, f1, enc.dpb[0].feature


def _decode(dec, x0, s1, chunk, sps, qps):
    """Decode the first P-frame, then the chunk (upload_gop +
    decompress_gop_uploaded, or the per-frame fallback); returns (the
    first x_hat, its DPB feature, the chunk's x_hats, the final DPB
    feature)."""
    dec.clear_dpb()
    dec.add_ref_frame(None, torch.as_tensor(x0).to(dec.device))
    x1 = dec.decompress(s1, sps, qps[0])["x_hat"]
    f1 = dec.dpb[0].feature
    xs = dec.decompress_gop(chunk, sps, qps[1:])["x_hat"]
    return x1, f1, xs, dec.dpb[0].feature


@pytest.fixture(scope="module")
def coded():
    """Default widths at 64x64: a first P-frame and a chunk of 3."""
    qps = [QP, 29, 25, 29]
    x0, frames = _frames(H, W, len(qps))
    enc = _codec()
    s1, chunk, f1, f_last = _encode(enc, x0, frames, qps)
    return enc.params, x0, s1, chunk, qps, f1, f_last


def _storages(*ts):
    return {t.untyped_storage().data_ptr() for t in ts}


# ---------------------------------------------------------------------------
# the cache on a plain body
# ---------------------------------------------------------------------------

def _body(a, b):
    trace.count("k2.launch")
    trace.count("dcb.block", 2)
    return a * 2 + b, a - b


def _ins(n=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=g), torch.randn(n, generator=g)


def test_repeated_key_replays_the_capture(graphs_here):
    """The first call of a key runs the body (the warm-up's outputs) and
    captures it, counting nothing from the capture; each later call
    copies its inputs into the static buffers and replays, adding the
    capture's counts, and gives the eager outputs."""
    cache = G.BodyGraphs()
    names = GRAPH + ("k2.launch", "dcb.block", "graph.replay.k2.launch",
                     "graph.replay.dcb.block")
    before = trace.counters()
    for i in range(5):
        a, b = _ins(seed=i)
        slot = torch.empty(8)[::2]          # a strided slot of the caller's
        got = cache.run(("k",), _body, (a, b), {}, (None, slot))
        assert got[1] is slot
        for g, w in zip(got, _body(a, b)):
            assert torch.equal(g, w)
    # 5 calls of the body here, 5 through the cache (1 warm-up, 4
    # replays); the capture counts nothing; the replays' share is told
    # apart under graph.replay.*
    assert _delta(before, names) == (5, 4, 1, 10, 20, 4, 8)
    assert len(cache) == 1


def test_cache_drops_its_oldest_key(graphs_here, monkeypatch):
    """Past its size the cache drops the key used longest ago: that key
    captures again, the others replay."""
    monkeypatch.setattr(G, "CACHE_SIZE", 2)
    cache = G.BodyGraphs()
    a, b = _ins()
    before = trace.counters()
    for k in ("k1", "k2", "k1", "k3"):      # k2 is now the oldest
        cache.run((k,), _body, (a, b), {}, NO_OUT)
    assert len(cache) == 2
    assert _delta(before) == (4, 1, 3)
    cache.run(("k1",), _body, (a, b), {}, NO_OUT)   # kept: replays
    cache.run(("k2",), _body, (a, b), {}, NO_OUT)   # dropped: captures again
    assert _delta(before) == (6, 2, 4)
    cache.clear()
    assert len(cache) == 0


def test_eager_twin_off_the_card_and_under_autograd(graphs_here,
                                                    monkeypatch):
    """Where autograd records (grad mode on and an input or a weight
    requiring grad) the body runs eagerly, gradients and all; under
    no_grad, or once the weights are cleared of grad, it takes the
    graph.  A weight's flag set in place is seen at the next call, with
    no clear().  Off the card, and within eager(), it always runs
    eagerly."""
    a, b = _ins()
    before = trace.counters()
    ga = a.clone().requires_grad_()
    out = G.BodyGraphs().run(("k",), _body, (ga, b), {}, NO_OUT)
    out[0].sum().backward()
    assert torch.equal(ga.grad, torch.full_like(a, 2.0))
    cache = G.BodyGraphs()
    w = {"w": [torch.ones(2, requires_grad=True)]}
    cache.run(("k",), _body, (a, b), w, NO_OUT)
    assert _delta(before) == (2, 0, 0)
    with torch.no_grad():
        cache.run(("k",), _body, (a, b), w, NO_OUT)
    assert _delta(before) == (3, 0, 1)
    w["w"][0].requires_grad_(False)     # in place: no clear()
    cache.run(("k",), _body, (a, b), w, NO_OUT)
    assert _delta(before) == (4, 1, 1)
    w["w"][0].requires_grad_(True)
    out = cache.run(("k",), _body, (a, b), w, NO_OUT)
    assert _delta(before) == (5, 1, 1)
    w["w"][0].requires_grad_(False)
    with G.eager():
        cache.run(("k",), _body, (a, b), w, NO_OUT)
    assert _delta(before) == (6, 1, 1)
    cache.run(("k",), _body, (a, b), w, NO_OUT)
    assert _delta(before) == (7, 2, 1)
    monkeypatch.setattr(G, "_on_card", lambda t: t.is_cuda)
    cache.run(("k",), _body, (a, b), w, NO_OUT)
    assert _delta(before) == (8, 2, 1)


def test_counted_into_keeps_counts_off_the_totals():
    """A thread's counts inside counted_into go to its dict alone;
    add_counts adds a dict's counts to the totals."""
    before = trace.counters()
    with trace.counted_into({}) as got:
        trace.count("k2.launch", 3)
        trace.count("dcb.block")
    assert got == {"k2.launch": 3, "dcb.block": 1}
    assert _delta(before, ("k2.launch", "dcb.block")) == (0, 0)
    trace.add_counts(got)
    assert _delta(before, ("k2.launch", "dcb.block")) == (3, 1)


# ---------------------------------------------------------------------------
# DMC's decoder on the graph path
# ---------------------------------------------------------------------------

def test_dmc_replay_equals_the_eager_decoder(coded, graphs_here,
                                             monkeypatch):
    """A first P-frame and a chunk of 3 at qps 21, 29, 25, 29 decoded
    through the graph path (one key: qp is an input) give the eager
    decoder's x_hats and features bit for bit, and the encoder's
    features; counters read as the eager frames'."""
    params, x0, s1, chunk, qps, f1, f_last = coded
    names = ("dcb.block", "k2.launch")
    monkeypatch.setattr(G, "_on_card", lambda t: False)
    before = trace.counters()
    want = _decode(_codec(params=params), x0, s1, chunk, SPS, qps)
    eager = _delta(before, GRAPH + names)
    assert eager[:3] == (4, 0, 0)
    monkeypatch.setattr(G, "_on_card", lambda t: True)
    before = trace.counters()
    dec = _codec(params=params)
    got = _decode(dec, x0, s1, chunk, SPS, qps)
    # one key: the first frame captures, the rest replay at their qps
    assert _delta(before, GRAPH + names) == (4, 3, 1) + eager[3:]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[1], f1) and torch.equal(got[3], f_last)
    # the same chunk again replays every frame
    before = trace.counters()
    again = _decode(dec, x0, s1, chunk, SPS, qps)
    assert _delta(before, GRAPH + names) == (4, 4, 0) + eager[3:]
    for g, w in zip(again, want):
        assert torch.equal(g, w)


def test_dmc_hands_out_no_static_buffer(coded, graphs_here):
    """x_hat and the DPB's feature never share storage with a graph's
    static inputs or outputs, and two calls hand out distinct storage."""
    params, x0, s1, chunk, qps, _, _ = coded
    dec = _codec(params=params)
    dec.add_ref_frame(None, torch.as_tensor(x0))
    outs = []
    for _ in range(2):
        dec.clear_dpb()
        dec.add_ref_frame(None, torch.as_tensor(x0))
        x = dec.decompress(s1, SPS, qps[0])["x_hat"]
        outs.append((x, dec.dpb[0].feature))
    static = set()
    for got in dec._graphs._graphs.values():
        static |= _storages(*got.inputs, *got.outputs)
    assert len(dec._graphs) == 1
    handed = [_storages(*o) for o in outs]
    assert not (handed[0] | handed[1]) & static
    assert not handed[0] & handed[1]
    xs = dec.decompress_gop(chunk, SPS, qps[1:])["x_hat"]
    static = set()
    for got in dec._graphs._graphs.values():
        static |= _storages(*got.inputs, *got.outputs)
    assert not _storages(xs, dec.dpb[0].feature) & static


def test_dmc_key_takes_size_qp_and_container(graphs_here, monkeypatch):
    """DMC's key: a repeated (size, L, MW, cap, kyc) replays, at any qp,
    since the qp goes in as a device tensor and reaches the body; a
    change of kyc, MW or size captures anew; update() drops the
    graphs."""
    def core(p, staging, feature, qp, dec_table, n_y_rows, zh, zw, lanes,
             cap, mw, fz=None, kyc=0):
        assert isinstance(qp, torch.Tensor) and qp.shape == (1,)
        return feature * 2, feature[:, :3] + qp

    monkeypatch.setattr(PDMC, "_decompress_frame_core", core)
    net = _codec()
    meta = {"L": 256, "MW": 12, "cap": 4096, "kyc": 0}
    staging = torch.zeros(meta["cap"] + 3 * meta["L"], dtype=torch.int32)

    def call(meta=meta, qp=QP, h=H, w=W):
        feature = torch.ones((1, 8, h // 8, w // 8))
        x_out = torch.empty((1, h // 8, w // 8, 3))
        net._decode_staged(meta, staging, feature,
                           {"height": h, "width": w}, qp, x_out)
        return x_out

    before = trace.counters()
    assert torch.all(call() == 1 + QP)
    assert torch.all(call() == 1 + QP)
    assert _delta(before) == (2, 1, 1)
    assert torch.all(call(qp=29) == 30)       # replayed at its own qp
    assert _delta(before) == (3, 2, 1)
    call(meta=dict(meta, kyc=8))
    call(meta=dict(meta, MW=20))
    call(h=128)
    call(w=128)
    assert _delta(before) == (7, 2, 5)
    assert len(net._graphs) == G.CACHE_SIZE
    net.update()
    assert len(net._graphs) == 0
    call(h=128)
    assert _delta(before) == (8, 2, 6)


def test_device_qp_takes_the_int_qps_rows():
    """The decoder body's qp as a (1,) int64 tensor gathers the very rows
    an int qp slices: every bank's multiplier (float32 and bfloat16) and
    the z rows of the prepared decode table."""
    net = _codec()
    for qp in (0, QP, 29, net._qp_ids.shape[0] - 1):
        t = net._qp_ids[qp].reshape(1)
        for name in ("q_feature", "q_decoder", "q_recon"):
            for dtype in (torch.float32, torch.bfloat16):
                a = PDMC.C.q_vec(net.params[name], qp, dtype)
                b = PDMC.C.q_vec(net.params[name], t, dtype)
                assert a.shape == b.shape and a.dtype == b.dtype
                assert torch.equal(a, b)
        a = PDMC._z_table(net.dec_table, net.n_y_rows, qp)
        b = PDMC._z_table(net.dec_table, net.n_y_rows, t)
        assert torch.equal(a, b) and b.is_contiguous()
    with pytest.raises(IndexError):
        net._qp_ids[net._qp_ids.shape[0]]


def test_x_hat_takes_the_padded_size(coded, graphs_here):
    """A picture smaller than its padded frame (the sps's 60x56 inside
    64x64, as the harness codes 1080p in 1088 rows) decodes to the padded
    frame, as before: the x_hat buffers take the feature's size, not the
    sps's."""
    params, x0, s1, chunk, qps, _, f_last = coded
    want = _decode(_codec(params=params), x0, s1, chunk, SPS, qps)
    got = _decode(_codec(params=params), x0, s1, chunk,
                  {"height": 60, "width": 56}, qps)
    assert got[0].shape == (1, H, W, 3) and got[2].shape == (3, 1, H, W, 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[3], f_last)


def test_eager_twin_on_the_cpu(coded):
    """Off the card every frame runs eagerly: counted in `graph.call`,
    neither captured nor replayed."""
    params, x0, s1, chunk, qps, _, f_last = coded
    dec = _codec(params=params)
    before = trace.counters()
    got = _decode(dec, x0, s1, chunk, SPS, qps)
    assert _delta(before) == (4, 0, 0)
    assert len(dec._graphs) == 0
    assert torch.equal(got[3], f_last)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

HD = (1088, 1920)
HD_SPS = {"height": HD[0], "width": HD[1]}
HD_QPS = [QP] * 9
#: the harness's qps of frames 1-9 (`eval/harness.py`'s index_map on
#: qp_p 21: shifts 0, 8 and 4)
HARNESS_QPS = [QP + PDMC.QP_SHIFT[[0, 1, 0, 2, 0, 2, 0, 2][i % 8]]
               for i in range(1, 10)]


def _hd(dev, dtype, fz=None, qps=HD_QPS, **kw):
    x0, frames = _frames(*HD, len(qps), seed=3)
    cast = [torch.from_numpy(f).to(dtype).to(dev) for f in [x0] + frames]
    enc = _codec(dev, dtype, fz, **kw)
    coded = _encode(enc, cast[0], cast[1:], qps)
    return enc.params, cast[0], coded


def _twin_and_replay(dev, dtype, params, x0, s1, chunk, fz=None,
                     qps=HD_QPS, **kw):
    """The eager twin's decode, then the graph path's twice (the first
    captures, the second replays every frame); returns (the twin's, the
    first's, the second's, the first's and the second's graph
    counters)."""
    with G.eager():
        want = _decode(_codec(dev, dtype, fz, params, **kw), x0, s1, chunk,
                       HD_SPS, qps)
    dec = _codec(dev, dtype, fz, params, **kw)
    before = trace.counters()
    first = _decode(dec, x0, s1, chunk, HD_SPS, qps)
    mid = trace.counters()
    again = _decode(dec, x0, s1, chunk, HD_SPS, qps)
    return want, first, again, (_delta(before, GRAPH, mid), _delta(mid))


def _bits_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _rungs(s1, chunk):
    return {tuple(PD.parse_frame_parts(s)[0][k]
                  for k in ("L", "MW", "cap", "kyc")) for s in [s1] + chunk}


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_card_replay_equals_eager_at_1080p(card, dtype):  # noqa: F811
    """A first P-frame and a chunk of 8 at 1088x1920: the replayed decode
    gives the eager twin's x_hats and features bit for bit, and the
    encoder's features exactly; the second decode replays all 9."""
    params, x0, (s1, chunk, f1, f_last) = _hd(card, dtype)
    want, first, again, counts = _twin_and_replay(
        card, dtype, params, x0, s1, chunk)
    _bits_equal(first, want)
    _bits_equal(again, want)
    assert torch.equal(again[1], f1) and torch.equal(again[3], f_last)
    assert counts[1] == (9, 9, 0)


@pytest.mark.card
def test_card_replay_skip_compacted(card, monkeypatch):  # noqa: F811
    """The same on a skip-compacted stream (kyc > 0)."""
    monkeypatch.setenv("OPENDCVC_TPU_EC_SKIP_COMPACT", "1")
    params, x0, (s1, chunk, f1, f_last) = _hd(card, torch.float32, fz=0.12)
    assert PD.parse_frame_parts(chunk[0])[0]["kyc"] > 0
    want, first, again, counts = _twin_and_replay(
        card, torch.float32, params, x0, s1, chunk, fz=0.12)
    _bits_equal(first, want)
    _bits_equal(again, want)
    assert torch.equal(again[3], f_last)
    assert counts[1] == (9, 9, 0)


@pytest.mark.card
def test_card_replay_mixed_rung_chunk(card):  # noqa: F811
    """A chunk whose containers were written at two ladder rungs takes
    the per-frame fallback: each rung its own key, every frame bit for
    bit the eager twin's."""
    params, x0, (s1, low, _, _) = _hd(card, torch.float32)
    top = _codec(card, torch.float32, None, params, bytes_per_symbol=3.0)
    _, frames = _frames(*HD, len(HD_QPS), seed=3)
    cast = [torch.from_numpy(f).to(card) for f in frames]
    _, high, _, _ = _encode(top, x0, cast, HD_QPS)
    chunk = [low[i] if i % 2 else high[i] for i in range(len(low))]
    metas = [PD.parse_frame_parts(s)[0] for s in chunk]
    assert len({(m["MW"], m["cap"]) for m in metas}) == 2
    want, first, again, counts = _twin_and_replay(
        card, torch.float32, params, x0, s1, chunk)
    _bits_equal(first, want)
    _bits_equal(again, want)
    assert counts[0][2] == len(_rungs(s1, chunk))
    assert counts[1] == (9, 9, 0)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_card_replay_harness_qp_cycle(card, dtype):  # noqa: F811
    """Frames at the harness's cycle of qps (21, 29, 25) share a graph:
    the first decode captures once for each container rung the streams
    hold, not for each qp, and every frame is the eager twin's bit for
    bit; the second decode replays all 9."""
    params, x0, (s1, chunk, f1, f_last) = _hd(card, dtype, qps=HARNESS_QPS)
    want, first, again, counts = _twin_and_replay(
        card, dtype, params, x0, s1, chunk, qps=HARNESS_QPS)
    _bits_equal(first, want)
    _bits_equal(again, want)
    assert torch.equal(again[1], f1) and torch.equal(again[3], f_last)
    assert counts[0][0] == 9 and counts[0][2] == len(_rungs(s1, chunk))
    assert counts[1] == (9, 9, 0)
