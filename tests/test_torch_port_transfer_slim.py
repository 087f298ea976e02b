"""Transfer slimming (OPENDCVC_TPU_EC_SLIM, on by default) in the port's
device-EC codecs, against the JAX package (CPU, float32).

At these test sizes a staging's capacity is below the JAX package's 8192
word WINDOW_STEP, so every window and bucket would quantize straight to
cap; "slim on" runs with the port's WINDOW_STEP at SMALL_STEP words (as
tests/test_device_rans.py does for its bucketed decode), so windows and
buckets really are cut.  Weights: the port's `init_params` (DMCI 0, DMC
1, DMCIFM 0, DMCFM 1), carried to the JAX package with `to_jax`.  Held:
  * the primitives (fetch_window / restore_window, staging_from_parts at
    a bucket width + expand_staging, quantize_window) equal the JAX
    package's on the arrays of tests/test_device_rans.py:729;
  * the streams with slim on, with slim off and the JAX package's
    device-EC streams are one, for DMCI (64x64, qp 21), a DMC GOP chunk
    (a P-frame alone, then a chunk of 3), compacted DMC
    (OPENDCVC_TPU_EC_SKIP_COMPACT at tests/test_torch_port_skip_compact.py's
    first rung, 96x96) and DMCIFM + DMCFM (64x64, 256 lanes, qp 32);
    slim on made windowed fetches and slim off none; every decoder, its
    uploads bucketed with slim on, gives the encoder's frame;
  * a forced miss (window 8, tests/test_device_rans.py:776) on a frame
    and on a GOP chunk: exactly one miss, the window grown, the same
    bytes; two GOP chunks settled at once on pool threads write the
    streams of the sequential run.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.entropy import device_rans as JD
from opendcvc_tpu.models import dmc as JDMC
from opendcvc_tpu.models import dmc_fm as JDMCFM
from opendcvc_tpu.models import dmci as JDMCI
from opendcvc_tpu.models import dmci_fm as JDMCIFM
from opendcvc_tpu_torch.entropy import device_rans as PD
from opendcvc_tpu_torch.models import dmc as PDMC
from opendcvc_tpu_torch.models import dmc_fm as PDMCFM
from opendcvc_tpu_torch.models import dmci as PDMCI
from opendcvc_tpu_torch.models import dmci_fm as PDMCIFM
from opendcvc_tpu_torch.utils import trace
from opendcvc_tpu_torch.utils.params import to_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

SMALL_STEP = 64
H = W = 64
QP = 21
QPS = [21, 29, 25, 29]      # a P-frame alone, then a GOP chunk of 3
SPS = {"sps_id": 0, "height": H, "width": W, "ec_part": 0, "use_ada_i": 0}
CH, CW = 96, 96             # compaction: frac 0.25, fz 0.3 -> kyc 8 < 9
C_SPS = dict(SPS, height=CH, width=CW)
C_FRAC, C_FZ = "0.25", 0.3
FM_LANES, FM_QP = "256", 32
MODES = ["on", "off"]


def _frames(h, w, n, seed=11):
    rng = np.random.default_rng(seed)
    xs = [rng.random((1, h, w, 3), dtype=np.float32)]
    for _ in range(n):
        xs.append(np.clip(xs[-1] + rng.normal(0, 0.02, xs[-1].shape)
                          .astype(np.float32), 0, 1))
    return xs


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, cls, seed in (("i", PDMCI.DMCI, 0), ("p", PDMC.DMC, 1),
                            ("ifm", PDMCIFM.DMCIFM, 0),
                            ("pfm", PDMCFM.DMCFM, 1)):
        kw = {} if name in ("i", "p") else {"device_ec": False}
        out[name] = cls(device="cpu", **kw).init_params(seed=seed)
    return out


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, to_jax(tree))


def _slim(mp, mode):
    """Slim on with SMALL_STEP words, or OPENDCVC_TPU_EC_SLIM=0; the
    trace's counters zeroed."""
    if mode == "on":
        mp.delenv("OPENDCVC_TPU_EC_SLIM", raising=False)
        mp.setattr(PD, "WINDOW_STEP", SMALL_STEP)
    else:
        mp.setenv("OPENDCVC_TPU_EC_SLIM", "0")
    trace.reset_counters()


def _stats():
    """The slimming counters of the trace: windowed fetches, misses, and
    the bytes moved each way."""
    c = trace.counters()
    return {k: c.get(k, 0) for k in ("slim.fetch", "slim.miss", "d2h_bytes",
                                     "h2d_bytes")}


def _env(mp, compact=False, fm=False):
    mp.setenv("OPENDCVC_TPU_DEVICE_EC", "1")
    if compact:
        mp.setenv("OPENDCVC_TPU_EC_SKIP_COMPACT", "1")
        mp.setenv("OPENDCVC_TPU_EC_SKIP_FRAC", C_FRAC)
    if fm:
        mp.setenv("OPENDCVC_TPU_EC_LANES", FM_LANES)
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")


def _port_dmc(tree, x0, fz=None, compact=False):
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, compact)
        net = PDMC.DMC(device="cpu", device_ec=True)
    net.load_params(tree)
    net.update(force_zero_thres=fz)
    net.add_ref_frame(None, torch.from_numpy(x0))
    return net


def _port_dmci(tree):
    net = PDMCI.DMCI(device="cpu", device_ec=True)
    net.load_params(tree)
    net.update()
    return net


def _port_fm(cls, tree):
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, fm=True)
        net = cls(device="cpu", device_ec=True)
    net.load_params(tree)
    net.update()
    return net


def _fm_dpb(frame):
    return {"ref_frame": frame, "ref_feature": None, "ref_mv_feature": None,
            "ref_y": None, "ref_mv_y": None}


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------

def _packed(rng, L, cap, tail, lens):
    total = int(lens.sum())
    packed = np.zeros(cap + tail, np.uint16)
    packed[:total] = rng.integers(1, 1 << 16, total, np.uint16)
    packed[cap:cap + L] = lens
    packed[cap + L:] = rng.integers(0, 1 << 16, tail - L, np.uint16)
    return packed


def _dev(a):
    return torch.from_numpy(a.astype(np.int32))


@pytest.mark.parametrize("tail_extra", [2, 0], ids=["rt", "fm"])
def test_fetch_window_and_restore_match_jax(tail_extra):
    rng = np.random.default_rng(3)
    L, cap, w = 8, 64, 32
    tail = 3 * L + tail_extra
    packed = _packed(rng, L, cap, tail,
                     rng.integers(0, 5, L).astype(np.uint16))
    win = PD.fetch_window(_dev(packed), w, cap, tail).numpy()
    j_win = np.asarray(JD.fetch_window(jnp.asarray(packed), w, cap, tail))
    np.testing.assert_array_equal(win, j_win)
    rest = PD.restore_window(win.astype(np.uint16), w, cap, L, tail)
    np.testing.assert_array_equal(rest, packed)
    np.testing.assert_array_equal(
        rest, JD.restore_window(j_win, w, cap, L, tail))
    # the miss signal: lens summing past w
    packed[cap:cap + L] = 40
    win = PD.fetch_window(_dev(packed), w, cap, tail).numpy()
    assert PD.restore_window(win.astype(np.uint16), w, cap, L, tail) is None
    assert JD.restore_window(win.astype(np.uint16), w, cap, L, tail) is None
    # a stack keeps its leading axis
    stack = PD.fetch_window(torch.stack([_dev(packed)] * 3), w, cap, tail)
    assert tuple(stack.shape) == (3, w + tail)


def test_bucketed_upload_form_matches_jax():
    rng = np.random.default_rng(3)
    L, cap, bucket = 8, 64, 32
    dense = np.zeros(cap, np.uint16)
    dense[:20] = rng.integers(1, 1 << 16, 20, np.uint16)
    lens = rng.integers(0, 5, L).astype(np.uint16)
    states = rng.integers(1, 1 << 32, L).astype(np.uint32)
    full = PD.staging_from_parts(dense, lens, states, cap)
    np.testing.assert_array_equal(
        full, JD.staging_from_parts(dense, lens, states, cap))
    st_b = PD.staging_from_parts(dense[:20], lens, states, cap,
                                 width=bucket)
    np.testing.assert_array_equal(
        st_b, JD.staging_from_parts(dense[:20], lens, states, cap,
                                    width=bucket))
    out = PD.expand_staging(_dev(st_b), bucket, cap).numpy()
    np.testing.assert_array_equal(out, full)
    np.testing.assert_array_equal(out, np.asarray(
        JD.expand_staging(jnp.asarray(st_b), bucket, cap)))
    two = PD.expand_staging(torch.stack([_dev(st_b)] * 2), bucket, cap)
    np.testing.assert_array_equal(two.numpy(), np.stack([full] * 2))


def test_quantize_window_and_flag_match_jax(monkeypatch):
    for words in (0, 1, 8191, 8192, 8193, 30000, 10 ** 6):
        for cap in (4096, 8192, 20000, 10 ** 6):
            assert PD.quantize_window(words, cap) == \
                JD.quantize_window(words, cap)
            assert PD.quantize_window(words, cap, 64) == \
                JD.quantize_window(words, cap, 64)
    assert PD.WINDOW_STEP == JD.WINDOW_STEP
    for value in (None, "0", "1", "false", "yes", ""):
        if value is None:
            monkeypatch.delenv("OPENDCVC_TPU_EC_SLIM", raising=False)
        else:
            monkeypatch.setenv("OPENDCVC_TPU_EC_SLIM", value)
        assert PD.slim_enabled() == JD.slim_enabled(), value
    monkeypatch.delenv("OPENDCVC_TPU_EC_SLIM")
    windows = {}
    assert PD.fetch_w_for(windows, 10 ** 6) == JD.fetch_w_for({}, 10 ** 6)
    PD.grow_fetch_w(windows, 10 ** 6, 100000)
    jw = {}
    JD.fetch_w_for(jw, 10 ** 6)
    JD.grow_fetch_w(jw, 10 ** 6, 100000)
    assert windows == jw


# ---------------------------------------------------------------------------
# the codecs: slim on == slim off == the JAX package
# ---------------------------------------------------------------------------

def _run_port(trees, mode):
    """Every device-EC path of the port with slim on or off: streams,
    decoded frames, the encoders' frames, the slimming counters after each
    part, and
    whether each stream's upload bucket is below its capacity."""
    xs, cs, fs = _frames(H, W, 4), _frames(CH, CW, 1), _frames(H, W, 1, 3)
    out, stats = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        _slim(mp, mode)
        net = _port_dmci(trees["i"])
        e = net.compress(xs[0], QP)
        out["i"] = e["bit_stream"]
        out["i_pair"] = (net.decompress(e["bit_stream"], SPS, QP)["x_hat"],
                         e["x_hat"])
        stats["i"] = _stats()

        enc = _port_dmc(trees["p"], xs[0])
        first = enc.compress(xs[1], QPS[0])["bit_stream"]
        out["p"] = [first] + enc.compress_gop(xs[2:], QPS[1:])[
            "bit_streams"]
        dec = _port_dmc(trees["p"], xs[0])
        out["p_dec"] = [dec.decompress(first, SPS, QPS[0])["x_hat"]]
        out["p_dec"] += list(dec.decompress_gop(out["p"][1:], SPS, QPS[1:])
                             ["x_hat"])
        out["p_pair"] = (dec.dpb[0].feature, enc.dpb[0].feature)
        stats["p"] = _stats()

        enc = _port_dmc(trees["p"], cs[0], C_FZ, compact=True)
        out["compact"] = enc.compress(cs[1], QP)["bit_stream"]
        dec = _port_dmc(trees["p"], cs[0], C_FZ, compact=True)
        out["compact_dec"] = dec.decompress(out["compact"], C_SPS,
                                            QP)["x_hat"]
        out["compact_pair"] = (dec.dpb[0].feature, enc.dpb[0].feature)

        inet = _port_fm(PDMCIFM.DMCIFM, trees["ifm"])
        pnet = _port_fm(PDMCFM.DMCFM, trees["pfm"])
        e = inet.compress(fs[0], FM_QP)
        out["ifm"], out["ifm_x"] = e["bit_stream"], e["x_hat"]
        out["ifm_pair"] = (inet.decompress(
            e["bit_stream"], {"height": H, "width": W, "qp": FM_QP})["x_hat"],
            e["x_hat"])
        po = pnet.compress(fs[1], _fm_dpb(e["x_hat"]), FM_QP, 0)
        out["pfm"] = po["bit_stream"]
        out["pfm_pair"] = (pnet.decompress(
            po["bit_stream"], _fm_dpb(e["x_hat"]),
            {"height": H, "width": W, "qp": FM_QP, "fa_idx": 0})["dpb"][
                "ref_frame"], po["dpb"]["ref_frame"])
        stats["all"] = _stats()
        metas = [PD.parse_frame_parts(st)[0] for st in
                 [out["i"], out["compact"], out["ifm"], out["pfm"]]
                 + out["p"]]
        bucketed = [PD.quantize_window(m["total"], m["cap"]) < m["cap"]
                    for m in metas]
    return {"out": out, "stats": stats, "bucketed": bucketed}


@pytest.fixture(scope="module")
def ports(trees):
    return {mode: _run_port(trees, mode) for mode in MODES}


@pytest.fixture(scope="module")
def jax_streams(trees, ports):
    """The JAX package's device-EC streams (its default, slim on); its
    DMCFM codes the P-frame from the port's I-frame, as the port does."""
    xs, cs, fs = _frames(H, W, 4), _frames(CH, CW, 1), _frames(H, W, 1, 3)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _env(mp)
        net = JDMCI.DMCI()
        net.load_params(_jax_tree(trees["i"]))
        net.update()
        out["i"] = net.compress(jnp.asarray(xs[0]), QP)["bit_stream"]
        net = JDMC.DMC()
        net.load_params(_jax_tree(trees["p"]))
        net.update()
        net.add_ref_frame(None, jnp.asarray(xs[0]))
        out["p"] = [net.compress(jnp.asarray(x), q)["bit_stream"]
                    for x, q in zip(xs[1:], QPS)]
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, compact=True)
        net = JDMC.DMC()
        net.load_params(_jax_tree(trees["p"]))
        net.update(force_zero_thres=C_FZ)
        net.add_ref_frame(None, jnp.asarray(cs[0]))
        out["compact"] = net.compress(jnp.asarray(cs[1]), QP)["bit_stream"]
    with pytest.MonkeyPatch.context() as mp:
        _env(mp, fm=True)
        inet = JDMCIFM.DMCIFM()
        inet.load_params(_jax_tree(trees["ifm"]))
        inet.update()
        pnet = JDMCFM.DMCFM()
        pnet.load_params(_jax_tree(trees["pfm"]))
        pnet.update()
    out["ifm"] = inet.compress(jnp.asarray(fs[0]), FM_QP)["bit_stream"]
    dpb = _fm_dpb(jnp.asarray(ports["off"]["out"]["ifm_x"].numpy()))
    out["pfm"] = pnet.compress(jnp.asarray(fs[1]), dpb, FM_QP,
                               0)["bit_stream"]
    return out


@pytest.mark.parametrize("mode", MODES)
def test_streams_equal_jax(mode, ports, jax_streams):
    out = ports[mode]["out"]
    for key in ("i", "p", "compact", "ifm", "pfm"):
        assert out[key] == jax_streams[key], key
    assert PD.parse_frame_parts(out["compact"])[0]["kyc"] == 8


@pytest.mark.parametrize("mode", MODES)
def test_windows_are_cut_only_with_slim_on(mode, ports):
    stats = ports[mode]["stats"]
    print(mode, stats)
    if mode == "on":
        assert stats["i"]["slim.fetch"] == 1
        assert stats["p"]["slim.fetch"] == 3   # + the P-frame and the chunk
        assert stats["all"]["slim.fetch"] == 6  # + compacted DMC, FM I, P
        assert all(ports[mode]["bucketed"]), ports[mode]["bucketed"]
        off = ports["off"]["stats"]["all"]
        assert stats["all"]["d2h_bytes"] < off["d2h_bytes"]
        assert stats["all"]["h2d_bytes"] < off["h2d_bytes"]
    else:
        assert stats["all"]["slim.fetch"] == stats["all"]["slim.miss"] == 0


@pytest.mark.parametrize("mode", MODES)
def test_decoders_give_the_encoders_frames(mode, ports):
    out = ports[mode]["out"]
    for key in ("i_pair", "p_pair", "compact_pair", "ifm_pair", "pfm_pair"):
        got, want = out[key]
        assert torch.equal(got, want), key


def test_decoded_frames_do_not_depend_on_slim(ports):
    on, off = ports["on"]["out"], ports["off"]["out"]
    for key in ("i_pair", "compact_dec", "ifm_pair", "pfm_pair", "p_dec"):
        a, b = on[key], off[key]
        for x, y in zip(a if isinstance(a, (list, tuple)) else [a],
                        b if isinstance(b, (list, tuple)) else [b]):
            assert torch.equal(x, y), key


# ---------------------------------------------------------------------------
# a forced miss
# ---------------------------------------------------------------------------

def _cap(net):
    plan = net._plan_device_ec(H, W)
    return net._rung(plan.lanes, plan.steps(), net.bytes_per_symbol)[1]


def test_forced_miss_falls_back_once_and_grows(trees, monkeypatch):
    xs = _frames(H, W, 4)
    monkeypatch.setenv("OPENDCVC_TPU_EC_SLIM", "0")
    ref = _port_dmc(trees["p"], xs[0])
    want = [ref.compress(xs[1], QPS[0])["bit_stream"]]
    want += ref.compress_gop(xs[2:], QPS[1:])["bit_streams"]

    monkeypatch.delenv("OPENDCVC_TPU_EC_SLIM")
    _slim(monkeypatch, "on")
    net = _port_dmc(trees["p"], xs[0])
    cap = _cap(net)
    net._fetch_windows[cap] = 8
    got = [net.compress(xs[1], QPS[0])["bit_stream"]]
    assert _stats()["slim.miss"] == 1 and _stats()["slim.fetch"] == 1
    assert net._fetch_windows[cap] > 8
    net._fetch_windows[cap] = 8               # the chunk misses once too
    got += net.compress_gop(xs[2:], QPS[1:])["bit_streams"]
    assert _stats()["slim.miss"] == 2 and _stats()["slim.fetch"] == 2
    total = max(PD.parse_frame_parts(s)[0]["total"] for s in got[1:])
    assert net._fetch_windows[cap] == PD.quantize_window(
        total + total // 4, cap)
    assert got == want


def test_chunks_settled_on_threads_write_sequential_streams(trees,
                                                            monkeypatch):
    xs = _frames(H, W, 7)
    _slim(monkeypatch, "on")
    seq = _port_dmc(trees["p"], xs[0])
    want = [seq.compress(xs[1], QPS[0])["bit_stream"]]
    for chunk in (xs[2:5], xs[5:8]):
        want += seq.compress_gop(chunk, QPS[1:])["bit_streams"]
    net = _port_dmc(trees["p"], xs[0])
    got = [net.compress(xs[1], QPS[0])["bit_stream"]]
    finishers = [net.compress_gop_async(chunk, QPS[1:])
                 for chunk in (xs[2:5], xs[5:8])]
    with ThreadPoolExecutor(2) as pool:
        for streams in pool.map(lambda f: f(), finishers):
            got += streams
    assert got == want
