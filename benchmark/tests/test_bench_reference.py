"""The plain reference against the measured package, on the CPU.

Same weights and frames on both sides.  Every comparison is exact: the
reference is the codecs' float32 stages as plain torch operations in the
same order, so on one device its floats are the package's bit for bit,
and a symbol that rounded the other way would move every later frame of
the chain.  (The card's runs hold the same comparison at 1080p; a
lower-precision reference fails it there, see `test_bench_control.py`.)
"""

import pytest
import torch

from bench_tiny import overrides
from core import content
from reference import fm as REF_FM
from reference import nn as REF_N
from reference import rt as REF_RT

SIZES = [(64, 64), (128, 128)]
CPU = torch.device("cpu")


def _cfg(name, h, w):
    from core.spec import Cell
    cell = Cell({"dcvc_rt": "rt_gop_dec", "dcvc_fm": "fm_dec_host_ec"}[name])
    cfg = dict(cell.config, height=h, width=w)
    return cfg, cell.workload


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("role,ref_init,port", [
    ("intra", REF_RT.dmci_init, "opendcvc_tpu_torch.models.dmci:dmci_init"),
    ("inter", REF_RT.dmc_init, "opendcvc_tpu_torch.models.dmc:dmc_init"),
    ("intra", REF_FM.dmci_fm_init,
     "opendcvc_tpu_torch.models.dmci_fm:dmci_fm_init"),
    ("inter", REF_FM.dmc_fm_init,
     "opendcvc_tpu_torch.models.dmc_fm:dmc_fm_init")])
def test_weight_tree_is_the_packages(role, ref_init, port):
    """The reference's init rules give the package's tree: every key and
    every leaf's shape (the values are the benchmark's own draws)."""
    import importlib
    from reference import draws
    mod, fn = port.split(":")
    theirs = getattr(importlib.import_module(mod), fn)(
        torch.Generator().manual_seed(0))
    assert _shapes(ref_init(draws.Draws("meta"))) == _shapes(theirs)


def _rt_sides(h, w, seed=20251018):
    from opendcvc_tpu_torch.models import dmc as D
    from opendcvc_tpu_torch.models import dmci as DI
    cfg, _ = _cfg("dcvc_rt", h, w)
    wts = content.make_weights(cfg, REF_RT, CPU, seed)
    frames = content.make_frames(cfg, seed, 3, CPU)
    return cfg, wts, frames, D, DI


@pytest.mark.parametrize("h,w", SIZES)
def test_rt_symbols_and_reconstructions(h, w):
    cfg, wts, frames, D, DI = _rt_sides(h, w)
    qp, fz = cfg["qp"], cfg["force_zero_thres"]
    pi, pp = wts["intra"], wts["inter"]
    x0 = REF_N.to_nchw(frames[0])
    x_hat, z, planes = DI._encode_stages_i(pi, x0, qp, fz)
    r_hat, r_syms = REF_RT.i_frame(pi, x0, qp, fz)
    assert torch.equal(x_hat, r_hat)
    assert torch.equal(z, r_syms[0])
    for (sym, _, _), (y_q, _) in zip(planes, r_syms[1:]):
        assert torch.equal(sym, REF_FOLD(y_q, 4))
    feat, r_feat = None, None
    for t in (1, 2):
        x = REF_N.to_nchw(frames[t])
        adapted = (D._stage_adaptor_i(pp, x_hat) if feat is None
                   else D._stage_adaptor_p(pp, feat))
        r_adapted = REF_RT.p_adapt(pp, frame=r_hat, feature=r_feat)
        assert torch.equal(adapted, r_adapted)
        feat, z, planes = D._encode_stages(pp, x, adapted, qp, fz)
        r_feat, r_hat, r_syms = REF_RT.p_frame(pp, x, r_adapted, qp, fz)
        assert torch.equal(feat, r_feat)
        assert torch.equal(z, r_syms[0])
        for (sym, _, _), (y_q, _) in zip(planes, r_syms[1:]):
            assert torch.equal(sym, REF_FOLD(y_q, 2))
        assert torch.equal(D._stage_recon_x(pp, feat, qp), r_hat)
        x_hat = r_hat


def REF_FOLD(y_q, parts):
    """Sum of a masked plane's channel parts (the coded symbols)."""
    c = y_q.shape[1] // parts
    out = y_q[:, :c]
    for k in range(1, parts):
        out = out + y_q[:, k * c:(k + 1) * c]
    return out.to(torch.int32)


@pytest.mark.parametrize("device_ec", [False, True])
@pytest.mark.parametrize("h,w", SIZES)
def test_rt_codecs_on_both_coders(h, w, device_ec):
    """DCVC-RT frame by frame: the package's encoder and a second codec
    pair's decoder, on the host coder and on device EC (the kernels' plain
    versions), rebuild the reference's frames on both sides."""
    from opendcvc_tpu_torch.models.dmc import DMC
    from opendcvc_tpu_torch.models.dmci import DMCI
    cfg, wl = _cfg("dcvc_rt", h, w)
    n, qp = 4, cfg["qp"]
    wts = content.make_weights(cfg, REF_RT, CPU, 78)
    frames = content.make_frames(cfg, 78, n, CPU)
    want = REF_RT.reference_sequence(wts, frames, cfg, wl)
    nets = []
    for cls, role in ((DMCI, "intra"), (DMC, "inter"), (DMCI, "intra"),
                      (DMC, "inter")):
        net = cls(device="cpu", device_ec=device_ec)
        net.load_params(wts[role])
        net.update(force_zero_thres=cfg["force_zero_thres"])
        nets.append(net)
    i_enc, p_enc, i_dec, p_dec = nets
    sps = {"sps_id": 0, "height": h, "width": w, "ec_part": 0,
           "use_ada_i": 0}
    enc = i_enc.compress(frames[0], qp)
    x_hat = i_dec.decompress(enc["bit_stream"], sps, qp)["x_hat"]
    assert torch.equal(enc["x_hat"], want[0])
    assert torch.equal(x_hat, want[0])
    for net, ref in ((p_enc, enc["x_hat"]), (p_dec, x_hat)):
        net.clear_dpb()
        net.set_curr_poc(0)
        net.add_ref_frame(None, ref)
    for t in range(1, n):
        stream = p_enc.compress(frames[t], qp)["bit_stream"]
        assert torch.equal(p_dec.decompress(stream, sps, qp)["x_hat"],
                           want[t])


@pytest.mark.parametrize("device_ec", [False, True])
@pytest.mark.parametrize("h,w", SIZES)
def test_fm_codecs_on_both_coders(h, w, device_ec):
    """DCVC-FM: the package's encoder DPB and its decoder's frames, on the
    host coder and on device EC (the kernels' plain versions), equal the
    reference's; the I-frame's symbols equal the reference's."""
    from opendcvc_tpu_torch.models import dmci_fm as DIF
    from opendcvc_tpu_torch.models.dmc_fm import DMCFM
    cfg, wl = _cfg("dcvc_fm", h, w)
    n = 5
    wts = content.make_weights(cfg, REF_FM, CPU, 77)
    frames = content.make_frames(cfg, 77, n, CPU)
    want = REF_FM.reference_sequence(wts, frames, cfg, wl)
    i_net = DIF.DMCIFM(device="cpu", device_ec=device_ec)
    p_net = DMCFM(device="cpu", device_ec=device_ec)
    i_dec = DIF.DMCIFM(device="cpu", device_ec=device_ec)
    p_dec = DMCFM(device="cpu", device_ec=device_ec)
    for net, role in ((i_net, "intra"), (p_net, "inter"), (i_dec, "intra"),
                      (p_dec, "inter")):
        net.load_params(wts[role])
        net.update()
    x0 = REF_N.to_nchw(frames[0])
    _, z, packed = DIF.encode_stages_ifm(wts["intra"], i_net._stages, x0,
                                         cfg["qp_i"])
    y, z_hat, r_z = REF_FM.i_front(wts["intra"], x0, cfg["qp_i"])
    _, r_syms = REF_FM.i_back(wts["intra"], y, z_hat, cfg["qp_i"])
    assert torch.equal(z, r_z)
    for pk, y_q in zip(packed, r_syms):
        assert torch.equal((pk.to(torch.int32) - (pk.to(torch.int32) & 255))
                           // 256, REF_FOLD(y_q, 4))
    enc_dpb = dec_dpb = None
    for t in range(n):
        qp, fa = REF_FM.schedule(t, cfg["qp_i"], cfg["qp_p"],
                                 cfg["reset_interval"])
        sps = {"height": h, "width": w, "qp": qp, "fa_idx": min(fa, 2)}
        if t == 0:
            enc = i_net.compress(frames[0], qp)
            enc_dpb = REF_FM._reset({"ref_frame": enc["x_hat"]})
            dec_dpb = REF_FM._reset({"ref_frame": i_dec.decompress(
                enc["bit_stream"], sps)["x_hat"]})
        else:
            if fa == 3:
                enc_dpb, dec_dpb = (REF_FM._reset(enc_dpb),
                                    REF_FM._reset(dec_dpb))
            enc = p_net.compress(frames[t], enc_dpb, qp, min(fa, 2))
            enc_dpb = enc["dpb"]
            dec_dpb = p_dec.decompress(enc["bit_stream"], dec_dpb,
                                       sps)["dpb"]
        assert torch.equal(enc_dpb["ref_frame"], want[t])
        assert torch.equal(dec_dpb["ref_frame"], want[t])


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("cell", ["rt_gop_dec", "rt_gop_enc",
                                  "fm_dec_host_ec", "rt_gop_dec_bf16"])
def test_cells_are_correct_on_the_cpu(cell, h, w):
    """Each cell's run, driven on the CPU at a tiny size (device EC on the
    kernels' plain versions), compares its sampled outputs with the
    reference and finds them equal; in bfloat16 the reference computes in
    bfloat16, and the decoder also equals the set-up encoder at the
    I-frame and at the features after the first P-frame and the last
    chunk (`dec_enc_max_gap` 0)."""
    import run
    out, checks = run.execute(cell, 4294967311 + h, 0.2, 0, "cpu",
                              overrides(cell, h, w))
    assert out["correct"], checks
    assert checks[0]["value"] == 0.0 and checks[0]["compared"] >= 4
    by_name = {c["name"]: c for c in checks}
    if "dec_enc_max_gap" in by_name:
        assert {c["name"]: c["value"] for c in checks} == dict.fromkeys(
            ("x_hat_max_gap", "x_hat_mean_gap", "feature_max_gap",
             "feature_mean_gap", "dec_enc_max_gap"), 0.0)
        assert by_name["dec_enc_max_gap"]["compared"] >= 6


# the package's FLOPs a pixel at 256x256 (FlopCounterMode over its calls
# on the CPU), by configuration, frame kind and side
PORT_KFLOP_PX = {
    ("dcvc_rt", "inter_first"): (298.6, 347.0),
    ("dcvc_rt", "intra"): (972.7, 724.4),
    ("dcvc_fm", "inter"): (2257.2, 1718.6),
}


@pytest.mark.parametrize("config,kind", sorted(PORT_KFLOP_PX))
def test_flop_counts_are_the_packages(config, kind):
    """The yardstick's FLOPs (the reference's stages on meta tensors) equal
    the package's own count of its calls at 256x256, and
    counts/flops_<config>.json holds the reference's count at 1088x1920."""
    import json
    from counts.flops import frame_flops, path_of
    ref = {"dcvc_rt": REF_RT, "dcvc_fm": REF_FM}[config]
    cfg, _ = _cfg(config, 256, 256)
    mine = frame_flops(ref, cfg, 256, 256)[kind]
    enc, dec = (round(mine[s] / 65536 / 1e3, 1) for s in ("enc", "dec"))
    assert (enc, dec) == PORT_KFLOP_PX[(config, kind)]
    with open(path_of(config)) as f:
        kept = json.load(f)["1088x1920"]
    assert kept == frame_flops(ref, dict(cfg, height=1088, width=1920),
                               1088, 1920)


def test_flop_counts_equal_the_package_calls():
    """The package's calls, counted by FlopCounterMode on the CPU at
    256x256: DMCI encode / decode and the first DMC P-frame after it."""
    from torch.utils.flop_counter import FlopCounterMode
    from counts.flops import frame_flops
    from opendcvc_tpu_torch.models.dmc import DMC
    from opendcvc_tpu_torch.models.dmci import DMCI
    cfg, _ = _cfg("dcvc_rt", 256, 256)
    wts = content.make_weights(cfg, REF_RT, CPU, 5)
    x = content.make_frames(cfg, 5, 2, CPU)
    nets = {}
    for name, cls, role in (("ie", DMCI, "intra"), ("id", DMCI, "intra"),
                            ("pe", DMC, "inter"), ("pd", DMC, "inter")):
        nets[name] = cls(device="cpu")
        nets[name].load_params(wts[role])
        nets[name].update(force_zero_thres=cfg["force_zero_thres"])
    sps = {"sps_id": 0, "height": 256, "width": 256, "ec_part": 0,
           "use_ada_i": 0}
    counts = {}

    def counted(key, fn):
        with FlopCounterMode(display=False) as fc:
            out = fn()
        counts[key] = fc.get_total_flops()
        return out

    enc = counted("intra_enc", lambda: nets["ie"].compress(x[0], 21))
    counted("intra_dec", lambda: nets["id"].decompress(enc["bit_stream"],
                                                       sps, 21))
    for side in ("pe", "pd"):
        nets[side].add_ref_frame(None, enc["x_hat"])
    s = counted("p_enc", lambda: nets["pe"].compress(x[1], 21))["bit_stream"]
    counted("p_dec", lambda: nets["pd"].decompress(s, sps, 21))
    mine = frame_flops(REF_RT, cfg, 256, 256)
    assert counts == {"intra_enc": mine["intra"]["enc"],
                      "intra_dec": mine["intra"]["dec"],
                      "p_enc": mine["inter_first"]["enc"],
                      "p_dec": mine["inter_first"]["dec"]}
