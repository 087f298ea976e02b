"""The port's DCVC-HEM (`models/intra_no_ar.py`, `models/dmc_hem.py`)
against the benchmark's plain reference (`benchmark/reference/hem.py`),
and the HEM spans of the port's trace, on the CPU.

Weights: the reference's init rules (`INIT`) drawn by the benchmark's
`core.content.make_weights` from the configuration `dcvc_hem` (its spread
q anchors set), loaded into the port.  Frames: the benchmark's content
generator.  The chain: an IntraNoAR I-frame, then 3 DMCHEM P-frames from
the DPB {ref_frame: x_hat, the rest None}, at the configuration's rung.

Held:
  * the reference's init gives the port's parameter trees, key for key
    and leaf shape for leaf shape;
  * at 64x64 and 128x128: the port's encoder DPB and a second codec
    pair's decoder (x_hat and all four DPB entries) equal the
    reference's bit for bit, frame by frame;
  * in a trace session around each call: the call's entry span (one
    frame), its `nn.*` stage spans, and one `wait.fetch` for each host
    trip (an encode's one copy, an I decode's two passes, a P decode's
    four: motion pass 0 and 1, y pass 0 and 1); the spans change no
    bit of the call's output.
"""

import os
import sys

import pytest
import torch

from opendcvc_tpu_torch.models import dmc_hem as PH
from opendcvc_tpu_torch.models import intra_no_ar as PI
from opendcvc_tpu_torch.utils import trace
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)

from core import content  # noqa: E402
from core.spec import Cell  # noqa: E402
from reference import draws  # noqa: E402
from reference import hem as REF  # noqa: E402
from reference import nn as REF_N  # noqa: E402

CPU = torch.device("cpu")
N_P = 3
DPB_KEYS = ("ref_frame", "ref_feature", "ref_y", "ref_mv_y")


def _cfg(h, w):
    return dict(Cell("hem_dec_host_ec").config, height=h, width=w)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("role,port_init", [
    ("intra", PI.intra_no_ar_init), ("inter", PH.dmc_hem_init)])
def test_reference_init_gives_the_ports_tree(role, port_init):
    assert _shapes(REF.INIT[role](draws.Draws("meta"))) == \
        _shapes(port_init(torch.Generator().manual_seed(0)))


def _codecs(wts):
    nets = []
    for cls, role in ((PI.IntraNoAR, "intra"), (PH.DMCHEM, "inter")) * 2:
        net = cls(device="cpu")
        net.load_params(wts[role])
        net.update()
        nets.append(net)
    return nets


@pytest.mark.parametrize("h,w", [(64, 64), (128, 128)])
def test_port_chain_equals_the_reference(h, w):
    cfg = _cfg(h, w)
    seed = 2026 + h
    wts = content.make_weights(cfg, REF, CPU, seed)
    frames = content.make_frames(cfg, seed, N_P + 1, CPU)
    q_i, (mv_q, y_q) = REF.rates(cfg, wts)
    i_enc, p_enc, i_dec, p_dec = _codecs(wts)
    y_l, mv_l = p_dec.get_interpolated_q_scales(cfg["rate"]["num"])
    assert (float(mv_l[1]), float(y_l[1])) == (mv_q, y_q)
    assert 0.5 < y_q < 2.0

    x_ref, _ = REF.i_frame(wts["intra"], REF_N.to_nchw(frames[0]), q_i)
    enc = i_enc.compress(frames[0], q_i)
    x_dec = i_dec.decompress(enc["bit_stream"], h, w, q_i)["x_hat"]
    assert torch.equal(enc["x_hat"], REF_N.to_nhwc(x_ref))
    assert torch.equal(x_dec, REF_N.to_nhwc(x_ref))
    ref_dpb = REF.fresh_dpb(x_ref)
    enc_dpb, dec_dpb = REF.fresh_dpb(enc["x_hat"]), REF.fresh_dpb(x_dec)
    for t in range(1, N_P + 1):
        ref_dpb = REF.p_frame(wts["inter"], REF_N.to_nchw(frames[t]),
                              ref_dpb, mv_q, y_q)
        out = p_enc.compress(frames[t], enc_dpb, mv_q, y_q)
        enc_dpb = out["dpb"]
        dec_dpb = p_dec.decompress(dec_dpb, out["bit_stream"], h, w, mv_q,
                                   y_q)["dpb"]
        want = dict(ref_dpb, ref_frame=REF_N.to_nhwc(ref_dpb["ref_frame"]))
        for key in DPB_KEYS:
            assert torch.equal(enc_dpb[key], want[key]), (t, key)
            assert torch.equal(dec_dpb[key], want[key]), (t, key)


# ---------------------------------------------------------------------------
# the HEM spans of the port's trace
# ---------------------------------------------------------------------------

I_NN = {"nn.enc_front", "nn.prior", "nn.spatial", "nn.recon"}
P_NN = {"nn.mv_enc", "nn.mv_prior", "nn.spatial", "nn.mv_dec",
        "nn.motion_comp", "nn.ctx_enc", "nn.ctx_prior", "nn.recon"}
ENC_ONLY = {"nn.enc_front", "nn.mv_enc", "nn.ctx_enc"}
# call -> (its entry span, its nn.* spans, its wait.fetch spans)
CALLS = {
    "i_enc": ("intra_no_ar.compress", I_NN, 1),
    "p_enc": ("dmc_hem.compress", P_NN, 1),
    "i_dec": ("intra_no_ar.decompress", I_NN - ENC_ONLY, 2),
    "p_dec": ("dmc_hem.decompress", P_NN - ENC_ONLY, 4),
}


@pytest.fixture(scope="module")
def sessions():
    """{call: (the trace session of that call, its output, its output
    with no session)} for an I-frame and a P-frame at 64x64, each call
    in a session of its own."""
    h = w = 64
    cfg = _cfg(h, w)
    wts = content.make_weights(cfg, REF, CPU, 5)
    frames = content.make_frames(cfg, 5, 2, CPU)
    q_i, (mv_q, y_q) = REF.rates(cfg, wts)
    i_enc, p_enc, i_dec, p_dec = _codecs(wts)
    got = {}

    def call(name, fn, traced):
        if not traced:
            return fn()
        trace.enable()
        try:
            return fn()
        finally:
            trace.disable()
            got[name] = trace.last_session()

    def chain(traced):
        enc = call("i_enc", lambda: i_enc.compress(frames[0], q_i), traced)
        p = call("p_enc", lambda: p_enc.compress(
            frames[1], REF.fresh_dpb(enc["x_hat"]), mv_q, y_q), traced)
        x = call("i_dec", lambda: i_dec.decompress(
            enc["bit_stream"], h, w, q_i), traced)["x_hat"]
        d = call("p_dec", lambda: p_dec.decompress(
            REF.fresh_dpb(x), p["bit_stream"], h, w, mv_q, y_q),
            traced)["dpb"]
        return {"i_enc": (enc["bit_stream"], enc["x_hat"]),
                "p_enc": (p["bit_stream"], p["dpb"]["ref_frame"]),
                "i_dec": x, "p_dec": d["ref_frame"]}

    plain, traced = chain(False), chain(True)
    return {k: (got[k], traced[k], plain[k]) for k in CALLS}


def _same(a, b):
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b, strict=True))
    return a == b if isinstance(a, bytes) else torch.equal(a, b)


@pytest.mark.parametrize("call", sorted(CALLS))
def test_hem_calls_report_their_spans(sessions, call):
    session, traced, plain = sessions[call]
    entry, nn, fetches = CALLS[call]
    spans = session["spans"]
    assert session["frames"] == 1
    assert spans[entry]["n"] == 1
    assert {n for n in spans if n.startswith("nn.")} == nn
    assert {n for n in spans if n.startswith("wait.")} == {"wait.fetch"}
    assert spans["wait.fetch"]["n"] == fetches
    assert session["counters"]["wait"] == fetches
    assert _same(traced, plain)
