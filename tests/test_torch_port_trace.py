"""The port's trace (`opendcvc_tpu_torch/utils/trace.py`) on the CPU.

Weights: the port's `init_params` (DMCI 0, DMC 1, DMCIFM 0, DMCFM 1) at
64x64.  The RT pass codes, on device EC, an I-frame (DMCI), a P-frame
alone and a GOP chunk of 3 (DMC, the chunk settled on a pool thread),
then decodes them (`decompress`, then `decompress_gop`): 10 frames.  The
FM pass codes an I- and a P-frame on the host coder and decodes them: 4
frames.  Held:
  * with no session a span is the shared null context, the codecs build
    no profiler range and the last session stays as it was;
  * streams and decoded frames are bit for bit the same with tracing off,
    under `enable()` and under torch.profiler;
  * under torch.profiler the kineto events hold every documented span
    name of both passes, each span's args carry its entry point's frame
    ids, `frames` counts the frames coded, the `coder.*` spans count the
    coder's calls, and the chunk's `dmc.finish` on the pool thread lands
    in the session;
  * `ec.rerun` counts the ladder's reruns (a 128x128 frame at 0.05 bytes
    a symbol): one frame's K1 calls less one, and a forced window miss counts
    one `slim.miss` of one `slim.fetch`, in the process totals and the
    session alike;
  * spans and counters from many threads at once lose no update.
"""

import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from opendcvc_tpu_torch.entropy import device_rans as PD
from opendcvc_tpu_torch.models import dmc as PDMC
from opendcvc_tpu_torch.models import dmc_fm as PDMCFM
from opendcvc_tpu_torch.models import dmci as PDMCI
from opendcvc_tpu_torch.models import dmci_fm as PDMCIFM
from opendcvc_tpu_torch.utils import trace
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

H = W = 64
QP = 21
QPS = [21, 29, 25, 29]      # a P-frame alone, then a GOP chunk of 3
SPS = {"sps_id": 0, "height": H, "width": W, "ec_part": 0, "use_ada_i": 0}
FM_SPS = {"height": H, "width": W, "qp": QP}
CODER_CALLS = ("reset", "encode_y", "encode_z", "flush",
               "get_encoded_stream", "set_stream", "decode_y", "decode_z",
               "get_decoded_tensor")
ENTRIES = {"dmci.compress", "dmci.decompress", "dmc.compress",
           "dmc.compress_gop", "dmc.upload_gop", "dmc.decompress_gop",
           "dmc.decompress", "dmci_fm.compress", "dmci_fm.decompress",
           "dmc_fm.compress", "dmc_fm.decompress", "dmc.finish",
           "dmci.finish"}
RT_SPANS = {"dmci.compress", "dmci.finish", "dmc.compress", "dmc.finish",
            "dmc.compress_gop", "dmci.decompress", "dmc.decompress",
            "dmc.upload_gop", "dmc.decompress_gop", "wait.staging", "upload",
            "nn.enc_front", "nn.prior", "nn.spatial", "nn.fold_index",
            "nn.enc_pass", "nn.dec_restore", "nn.recon",
            "nn.feature_adaptor_i", "nn.feature_adaptor_p",
            "nn.feature_extractor_part1", "nn.feature_extractor_part2",
            "nn.encoder+hyper_enc", "nn.hyper_dec+prior_fusion",
            "nn.enc_pass0(fused)", "nn.spatial_prior", "nn.enc_pass1(fused)",
            "nn.latent_decoder(feature_out)", "nn.recon_generation",
            "nn.dec_index0", "nn.fold_index_2x", "nn.dec_restore_2x"}
FM_SPANS = {"dmci_fm.compress", "dmci_fm.decompress", "dmc_fm.compress",
            "dmc_fm.decompress", "wait.fetch", "upload", "nn.enc_front",
            "nn.prior", "nn.spatial", "nn.recon", "nn.mv_enc", "nn.mv_prior",
            "nn.mv_dec", "nn.motion_comp", "nn.ctx_enc", "nn.ctx_prior",
            "nn.mv_spatial", "nn.y_spatial"} \
    | {f"coder.{c}" for c in CODER_CALLS}


def _frames(n, seed=11):
    rng = np.random.default_rng(seed)
    xs = [rng.random((1, H, W, 3), dtype=np.float32)]
    for _ in range(n):
        xs.append(np.clip(xs[-1] + rng.normal(0, 0.02, xs[-1].shape)
                          .astype(np.float32), 0, 1))
    return xs


@pytest.fixture(scope="module")
def trees():
    return {"i": PDMCI.DMCI(device="cpu").init_params(seed=0),
            "p": PDMC.DMC(device="cpu").init_params(seed=1),
            "ifm": PDMCIFM.DMCIFM(device="cpu",
                                  device_ec=False).init_params(seed=0),
            "pfm": PDMCFM.DMCFM(device="cpu",
                                device_ec=False).init_params(seed=1)}


def _net(cls, tree, **kw):
    net = cls(device="cpu", **kw)
    net.load_params(tree)
    net.update()
    return net


def _rt_pass(trees):
    """The RT pass: (streams, decoded frames)."""
    xs = _frames(4)
    i_enc = _net(PDMCI.DMCI, trees["i"], device_ec=True)
    e = i_enc.compress(xs[0], QP)
    p_enc = _net(PDMC.DMC, trees["p"], device_ec=True)
    p_enc.add_ref_frame(None, e["x_hat"])
    streams = [e["bit_stream"], p_enc.compress(xs[1], QPS[0])["bit_stream"]]
    finish = p_enc.compress_gop_async(xs[2:], QPS[1:])
    with ThreadPoolExecutor(1) as pool:
        streams += pool.submit(finish).result()
    x_i = _net(PDMCI.DMCI, trees["i"], device_ec=True).decompress(
        streams[0], SPS, QP)["x_hat"]
    p_dec = _net(PDMC.DMC, trees["p"], device_ec=True)
    p_dec.add_ref_frame(None, x_i)
    xs_hat = [x_i, p_dec.decompress(streams[1], SPS, QPS[0])["x_hat"]]
    xs_hat += list(p_dec.decompress_gop(streams[2:], SPS, QPS[1:])["x_hat"])
    return streams, xs_hat


def _count_calls(coder, calls):
    """Count the coder's calls in `calls` (name -> n)."""
    for name in CODER_CALLS:
        def counted(*args, _fn=getattr(coder, name), _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*args, **kwargs)
        setattr(coder, name, counted)


def _fm_dpb(frame):
    return {"ref_frame": frame, "ref_feature": None, "ref_mv_feature": None,
            "ref_y": None, "ref_mv_y": None}


def _fm_pass(trees, calls=None):
    """The FM pass on the host coder: (streams, decoded frames); counts
    every coder call in `calls`."""
    xs = _frames(1, seed=3)
    nets = [_net(PDMCIFM.DMCIFM, trees["ifm"], device_ec=False),
            _net(PDMCFM.DMCFM, trees["pfm"], device_ec=False),
            _net(PDMCIFM.DMCIFM, trees["ifm"], device_ec=False),
            _net(PDMCFM.DMCFM, trees["pfm"], device_ec=False)]
    if calls is not None:
        for net in nets:
            _count_calls(net.entropy_coder, calls)
    i_enc, p_enc, i_dec, p_dec = nets
    e = i_enc.compress(xs[0], QP)
    p = p_enc.compress(xs[1], _fm_dpb(e["x_hat"]), QP, 0)
    x_i = i_dec.decompress(e["bit_stream"], FM_SPS)["x_hat"]
    x_p = p_dec.decompress(p["bit_stream"], _fm_dpb(x_i),
                           dict(FM_SPS, fa_idx=0))["dpb"]["ref_frame"]
    return [e["bit_stream"], p["bit_stream"]], [x_i, x_p]


class _Ranges:
    """Records each profiler range the trace builds: (name, args)."""

    def __init__(self, monkeypatch):
        self.made = []
        real = torch.profiler.record_function
        made = self.made

        class Recording(real):
            def __init__(self, name, args=None):
                made.append((name, args))
                super().__init__(name, args)

        monkeypatch.setattr(torch.profiler, "record_function", Recording)


def _profiled(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    names = {ev.name() for ev in prof.profiler.kineto_results.events()
             if ev.is_user_annotation()}
    return out, names, trace.last_session()


@pytest.fixture(scope="module")
def off(trees):
    return {"rt": _rt_pass(trees), "fm": _fm_pass(trees)}


@pytest.fixture(scope="module")
def traced(trees):
    with pytest.MonkeyPatch.context() as mp:
        ranges = _Ranges(mp)
        calls = {}
        rt, rt_names, rt_session = _profiled(_rt_pass, trees)
        rt_ranges = list(ranges.made)
        fm, fm_names, fm_session = _profiled(_fm_pass, trees, calls)
    trace.enable()
    try:
        enabled = {"rt": _rt_pass(trees), "fm": _fm_pass(trees)}
    finally:
        trace.disable()
    return {"rt": rt, "fm": fm, "rt_names": rt_names, "fm_names": fm_names,
            "rt_session": rt_session, "fm_session": fm_session,
            "rt_ranges": rt_ranges, "calls": calls, "enabled": enabled}


def _same(a, b):
    assert a[0] == b[0]
    assert len(a[1]) == len(b[1])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)


def test_no_session_records_nothing(trees, monkeypatch):
    trace.disable()
    assert trace.span("a") is trace.span("b", 1)
    before = trace.last_session()
    ranges = _Ranges(monkeypatch)
    _rt_pass(trees)
    _fm_pass(trees)
    assert ranges.made == []
    assert trace.last_session() == before


@pytest.mark.parametrize("path", ["rt", "fm"])
def test_tracing_changes_no_bit(off, traced, path):
    _same(off[path], traced[path])
    _same(off[path], traced["enabled"][path])


def test_profiler_holds_every_span_name(traced):
    assert RT_SPANS <= traced["rt_names"], RT_SPANS - traced["rt_names"]
    assert FM_SPANS <= traced["fm_names"], FM_SPANS - traced["fm_names"]


def test_spans_carry_their_entry_points_frame_ids(traced):
    """Each range's args are its entry point's ids, in coding order: the
    I-frame, the P-frame, the chunk of 3, then the same on the decoder."""
    made = traced["rt_ranges"]
    first = int(made[0][1])
    want = [str(first), str(first + 1), f"{first + 2}-{first + 4}",
            str(first + 5), str(first + 6), f"{first + 7}-{first + 9}"]
    seen, current = [], None
    for name, args in made:
        assert args is not None, name
        if name in ENTRIES:
            if args != current:
                seen.append(args)
            current = args
        assert args == current, (name, args, current)
    assert seen == want


def test_session_counts_frames_spans_and_coder_calls(traced):
    rt, fm = traced["rt_session"], traced["fm_session"]
    assert rt["frames"] == 10 and fm["frames"] == 4
    coder_n = sum(v["n"] for k, v in fm["spans"].items()
                  if k.startswith("coder."))
    assert coder_n == sum(traced["calls"].values()) > 0
    for name, n in traced["calls"].items():
        assert fm["spans"][f"coder.{name}"]["n"] == n
    assert not any(k.startswith("coder.") for k in rt["spans"])


def test_pool_thread_finish_lands_in_the_session(traced):
    """Two `dmc.finish` spans, the P-frame's on the main thread and the
    chunk's on the pool thread (a thread this profiler does not record),
    and one `dmci.finish`; each staging wait is a span and counted."""
    spans = traced["rt_session"]["spans"]
    assert spans["dmc.finish"]["n"] == 2
    assert spans["dmci.finish"]["n"] == 1
    assert spans["wait.staging"]["n"] >= 3
    assert traced["rt_session"]["counters"]["wait"] == \
        spans["wait.staging"]["n"]


def _rerun_codec(trees, **kw):
    net = PDMC.DMC(device="cpu", device_ec=True, **kw)
    net.load_params(trees["p"])
    net.update()
    rng = np.random.default_rng(5)
    net.add_ref_frame(None, torch.from_numpy(
        rng.random((1, 128, 128, 3), dtype=np.float32)))
    return net, rng.random((1, 128, 128, 3), dtype=np.float32)


def test_ec_rerun_counts_the_ladders_reruns(trees, monkeypatch):
    """The witness counts the frame's calls of K1's wrapper `encode_scan`
    (one a launch; `k1.launch` counts the CUDA launches only)."""
    net, x = _rerun_codec(trees, bytes_per_symbol=0.05)
    scan, calls = PDMC.encode_scan, []

    def counted(*args):
        calls.append(1)
        return scan(*args)

    monkeypatch.setattr(PDMC, "encode_scan", counted)
    c0 = trace.counters().get("ec.rerun", 0)
    trace.enable()
    try:
        net.compress(x, QP)
    finally:
        trace.disable()
    reruns = len(calls) - 1
    assert reruns >= 1
    assert trace.counters()["ec.rerun"] - c0 == reruns
    assert trace.last_session()["counters"]["ec.rerun"] == reruns


def test_forced_miss_counts_one_miss_of_one_fetch(trees, monkeypatch):
    monkeypatch.delenv("OPENDCVC_TPU_EC_SLIM", raising=False)
    monkeypatch.setattr(PD, "WINDOW_STEP", 64)
    net, x = _rerun_codec(trees)
    plan = net._plan_device_ec(128, 128)
    cap = net._rung(plan.lanes, plan.steps(), net.bytes_per_symbol)[1]
    net._fetch_windows[cap] = 8
    before = trace.counters()
    trace.enable()
    try:
        net.compress(x, QP)
    finally:
        trace.disable()
    after, session = trace.counters(), trace.last_session()["counters"]
    for name in ("slim.fetch", "slim.miss"):
        assert after[name] - before.get(name, 0) == session[name] == 1
    assert net._fetch_windows[cap] > 8


def test_threads_lose_no_update():
    """16 threads, each 300 spans and counts in one session, with a short
    switch interval: every span and count lands."""
    n_threads, n = 16, 300
    c0 = trace.counters().get("stress", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.enable()
    try:
        def work():
            for _ in range(n):
                with trace.span("stress.span"):
                    trace.count("stress")
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        trace.disable()
        sys.setswitchinterval(interval)
    s = trace.last_session()
    assert s["spans"]["stress.span"]["n"] == n_threads * n
    assert s["counters"]["stress"] == n_threads * n
    assert trace.counters()["stress"] - c0 == n_threads * n
