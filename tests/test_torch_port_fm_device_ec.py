"""DCVC-FM on device EC in the port (DMCIFM + DMCFM through K1/K2's plain
versions on the CPU) against the JAX package's FM device EC
(OPENDCVC_TPU_DEVICE_EC=1, its XLA scans), and K2's plain version at
FM's 256-row y table.

Weights: the JAX package's init_params(0) (DMCIFM) and (1) (DMCFM),
written by its save_params and read by the port's JAX-free checkpoint
reader.  Both packages code with at most 256 lanes
(OPENDCVC_TPU_EC_LANES=256, read in the constructors) at the JAX
package's own test sizes: DMCIFM a 64x96 frame at qp 12 and 40
(tests/test_device_rans.py), DMCFM at 64x64 an I-frame and three
P-frames at qp 32 (fa_idx 0, then 1 on the propagated DPB, then a
refresh with fa_idx 2).  Frames come from numpy (default_rng(3)): noise,
then mild noise added frame to frame.  The port's encoder drives the
chain and the JAX encoder codes each frame from the port's DPB, so every
frame is its own comparison.

The JAX package's device EC takes CDF index 255 (a scale clipped to 64)
for its scans' skip row: it codes such a symbol at zero rate and decodes
it as 0.  The port's kernels skip on their own sentinel (511) and code
row 255.  So the streams are held equal only on frames with no y or
motion-y index 255 (each test prints the count); one P-frame made to have
such indexes (DMCFM's weights with 100 added to the bias of the last
y_fusion and mv_fusion convolutions on their first scale channel, 128
and 64) is held to an exact port decoder and a stream that differs from
the JAX package's.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.entropy import device_rans as JD
from opendcvc_tpu.eval import fm_harness as JH
from opendcvc_tpu.models import dmc_fm as JDMC
from opendcvc_tpu.models import dmci_fm as JDMCI
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch.entropy import device_rans as PD
from opendcvc_tpu_torch.eval import fm_harness as PH
from opendcvc_tpu_torch.models import dmc_fm as PDMC
from opendcvc_tpu_torch.models import dmci_fm as PDMCI
from opendcvc_tpu_torch.ops import _build
from opendcvc_tpu_torch.ops import lane_rans as LR
from opendcvc_tpu_torch.utils import trace
from opendcvc_tpu_torch.utils.params import from_jax
from test_torch_port_fm_harness import _argv, _dataset, _outputs
from test_torch_port_lane_rans import _hl, _tables
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

LANES = "256"
DPB_KEYS = ("ref_frame", "ref_feature", "ref_mv_feature", "ref_y",
            "ref_mv_y")
# DMCFM's chain after the I-frame: (fa_idx, refresh before the frame)
CHAIN = [(0, False), (1, False), (2, True)]
QP_P = 32
# the codecs' float agreement (test_torch_port_fm_codec)
REL_TOL = 1e-4


# ---------------------------------------------------------------------------
# (a) K2's plain version at 256 rows
# ---------------------------------------------------------------------------

def _k2_payload(seed, rows_hi):
    """A 256-row table, 64 lanes x 48 steps of row ids in [0, rows_hi)
    (DEC_SKIP on ~20 % of the slots) and symbols, coded by K1's plain
    version from a fresh carry; returns the table, the decode-order (K,
    L) row ids and symbols, and the lanes' words in decode order with the
    final states."""
    rng = np.random.default_rng(seed)
    lanes, k = 64, 48
    table = _tables(rng, 256)
    rows = rng.integers(0, rows_hi, (k, lanes))
    rows[rng.random(rows.shape) < 0.2] = LR.DEC_SKIP
    rows[0, :8] = 255                        # row 255 coded, on every run
    rows = np.where(rows == LR.DEC_SKIP, LR.DEC_SKIP,
                    np.minimum(rows, rows_hi - 1))
    sym = np.where(rows == LR.DEC_SKIP, 0,
                   rng.integers(-128, 128, (k, lanes)))
    packed = LR.pack_operand(torch.from_numpy(sym[::-1].copy()),
                             torch.from_numpy(rows[::-1].copy()))
    buf, lens, states = LR.encode_scan_plain(
        packed, LR.prepare_encode_table(torch.from_numpy(table)), k + 4)
    assert int(lens.max()) <= k
    data = np.zeros((lanes, k + 4), np.int32)
    for lane in range(lanes):
        n = int(lens[lane])
        data[lane, :n] = buf[lane, :n].numpy()[::-1]
    return table, rows.astype(np.int32), sym, data, states.numpy()


def _plain_decode(table, rows, data, states):
    return LR.decode_scan(
        torch.from_numpy(data), torch.from_numpy(rows),
        LR.prepare_decode_table(torch.from_numpy(table)),
        torch.from_numpy(states.astype(np.int64)),
        torch.zeros(rows.shape[1], dtype=torch.int32))


def test_k2_plain_256_rows_roundtrips_with_row_255_coded():
    table, rows, sym, data, states = _k2_payload(0, 256)
    syms, _, ptr = _plain_decode(table, rows, data, states)
    n255 = int((rows == 255).sum())
    print(f"{n255} slots on row 255, {int((rows == LR.DEC_SKIP).sum())} "
          f"skipped")
    assert n255 >= 8
    np.testing.assert_array_equal(syms.numpy(), sym)
    coded = (rows != LR.DEC_SKIP).sum(axis=0)
    assert (ptr.numpy() <= coded).all()


def test_k2_plain_256_rows_matches_the_jax_scan_without_row_255():
    """On rows 0-254 (the JAX scans skip row 255) the plain K2 is the JAX
    package's _decode_scan_carry bit for bit, symbols and carry."""
    table, rows, _, data, states = _k2_payload(1, 255)
    syms, st, ptr = _plain_decode(table, rows, data, states)
    j_rows = np.where(rows == LR.DEC_SKIP, JD.SKIP_ROW, rows)
    j_syms, (j_st, j_ptr) = JD._decode_scan_carry(
        jnp.asarray(data), jnp.asarray(np.ascontiguousarray(j_rows.T)),
        _hl(table), (jnp.asarray(states.astype(np.uint32)),
                     jnp.zeros(rows.shape[1], jnp.int32)))
    np.testing.assert_array_equal(syms.numpy(), np.asarray(j_syms).T)
    np.testing.assert_array_equal(st.numpy(), np.asarray(j_st))
    np.testing.assert_array_equal(ptr.numpy(), np.asarray(j_ptr))


def test_k2_plain_256_rows_matches_the_host_shim():
    """The kernel's own step (lr_dec_lane_step, built with g++) at nr =
    256: row 255 coded, DEC_SKIP skipped, the carry exact."""
    table, rows, sym, data, states = _k2_payload(2, 256)
    syms, st, ptr = _plain_decode(table, rows, data, states)
    k, lanes = rows.shape
    dtab = LR.prepare_decode_table(torch.from_numpy(table)).numpy()
    h_syms = np.zeros((k, lanes), np.int32)
    h_st = np.zeros(lanes, np.int64)
    h_ptr = np.zeros(lanes, np.int32)
    st_in = states.astype(np.int64)
    ptr_in = np.zeros(lanes, np.int32)
    _build.load_host_shim().lr_decode_host(
        data.ctypes.data, rows.ctypes.data, dtab.ctypes.data,
        st_in.ctypes.data, ptr_in.ctypes.data, h_syms.ctypes.data,
        h_st.ctypes.data, h_ptr.ctypes.data, k, lanes, 256, data.shape[1])
    np.testing.assert_array_equal(h_syms, syms.numpy())
    np.testing.assert_array_equal(h_syms, sym)
    np.testing.assert_array_equal(h_st, st.numpy())
    np.testing.assert_array_equal(h_ptr, ptr.numpy())


# ---------------------------------------------------------------------------
# the codecs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX package's init_params(0) / (1), their save_params files,
    and DMCFM's tree with the biases that make index-255 scales."""
    d = tmp_path_factory.mktemp("fm_dev_weights")
    trees = {"i": JDMCI.DMCIFM().init_params(seed=0),
             "p": JDMC.DMCFM().init_params(seed=1)}
    paths = {k: str(d / f"{k}.msgpack") for k in trees}
    for k, tree in trees.items():
        JCK.save_params(paths[k], tree)
    hot = jax.tree_util.tree_map(np.array, trees["p"])
    for name, ch in (("y_fusion", 128), ("mv_fusion", 64)):
        hot[name][-1]["ffn"]["c2"]["b"][ch] += 100.0
    trees["p_hot"] = hot
    return {"trees": trees, "paths": paths}


def _jax_codec(cls, tree, device_ec=True, **env):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENDCVC_TPU_DEVICE_EC", "1" if device_ec else "0")
        mp.setenv("OPENDCVC_TPU_EC_LANES", LANES)
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        for k, v in env.items():
            mp.setenv(k, v)
        net = cls()
        net.load_params(jax.tree_util.tree_map(jnp.asarray, tree))
        net.update()
    assert net.device_ec == device_ec
    return net


def _port_codec(cls, tree, device_ec=True, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENDCVC_TPU_EC_LANES", LANES)
        net = cls(device="cpu", device_ec=device_ec, **kw)
    assert net.lanes == int(LANES)
    net.load_params(from_jax(jax.tree_util.tree_map(np.asarray, tree)))
    net.update()
    return net


@contextlib.contextmanager
def _counting_top_index():
    """Counts, per plane, the y and motion-y CDF indexes of 255 that the
    port's device-EC encoders code (`y_operand` wrapped in both FM
    modules); yields the list of counts."""
    seen = []
    orig = PDMCI.y_operand

    def counting(packed, lanes):
        seen.append(int(((packed.to(torch.int32) & 255) == 255).sum()))
        return orig(packed, lanes)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PDMCI, "y_operand", counting)
        mp.setattr(PDMC, "y_operand", counting)
        yield seen


@pytest.fixture
def top_index():
    with _counting_top_index() as seen:
        yield seen


def _np(dpb):
    """A DPB as NHWC numpy (the port's frame NHWC, its other entries
    NCHW; the JAX package's all NHWC)."""
    out = {}
    for k in DPB_KEYS:
        v = dpb[k]
        if isinstance(v, torch.Tensor):
            v = (v if k == "ref_frame" else v.permute(0, 2, 3, 1)).numpy()
        out[k] = None if v is None else np.asarray(v)
    return out


def _to_jax(dpb):
    return {k: None if v is None else jnp.asarray(v)
            for k, v in _np(dpb).items()}


def _fresh(frame):
    return dict(dict.fromkeys(DPB_KEYS), ref_frame=frame)


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=REL_TOL * float(np.abs(ref).max()),
                               err_msg=what)


def _frames(h, w, n):
    rng = np.random.default_rng(3)
    xs = [rng.random((1, h, w, 3), dtype=np.float32)]
    for _ in range(n - 1):
        xs.append(np.clip(xs[-1] + rng.normal(0, 0.02, (1, h, w, 3))
                          .astype(np.float32), 0, 1))
    return xs


@pytest.fixture(scope="module")
def intra(weights):
    """DMCIFM at 64x96, qp 12 and 40: the port on device EC and on host
    EC, the JAX package on device EC, each side's decoder on the other's
    stream.  The port's indexes of 255 are counted per frame."""
    tree = weights["trees"]["i"]
    x = _frames(64, 96, 1)[0]
    port, host = (_port_codec(PDMCI.DMCIFM, tree, t) for t in (True, False))
    jax_net = _jax_codec(JDMCI.DMCIFM, tree)
    out = []
    for qp in (12, 40):
        sps = {"height": 64, "width": 96, "qp": qp}
        with _counting_top_index() as n255:
            pe = port.compress(x, qp)
        je = jax_net.compress(jnp.asarray(x), qp)
        out.append({
            "qp": qp, "n255": sum(n255), "port": pe, "jax": je,
            "host": host.compress(x, qp),
            "port_dec": port.decompress(pe["bit_stream"], sps)["x_hat"],
            "host_dec": host.decompress(host.compress(x, qp)["bit_stream"],
                                        sps)["x_hat"],
            "jax_dec_port": np.asarray(jax_net.decompress(
                pe["bit_stream"], sps)["x_hat"]),
            "port_dec_jax": port.decompress(je["bit_stream"],
                                            sps)["x_hat"]})
    return out


def test_fm_intra_device_streams_match_jax(intra):
    for r in intra:
        print(f"DMCIFM qp {r['qp']}: {r['n255']} y indexes of 255")
        assert r["n255"] == 0
        assert r["port"]["bit_stream"] == r["jax"]["bit_stream"]


def test_fm_intra_device_decoders_cross(intra):
    for r in intra:
        ref = r["port"]["x_hat"].numpy()
        np.testing.assert_array_equal(r["port_dec"].numpy(), ref)
        np.testing.assert_array_equal(r["port_dec_jax"].numpy(), ref)
        _close(r["jax_dec_port"], ref, f"JAX on the port's qp {r['qp']}")


def test_fm_intra_host_ec_equals_device_ec(intra):
    for r in intra:
        np.testing.assert_array_equal(r["host"]["x_hat"].numpy(),
                                      r["port"]["x_hat"].numpy())
        np.testing.assert_array_equal(r["host_dec"].numpy(),
                                      r["port_dec"].numpy())


@pytest.fixture(scope="module")
def chain(weights):
    """DMCFM at 64x64: the port's device-EC encoder drives the chain (I,
    then CHAIN); per P-frame the port's host-EC encoder and the JAX
    package's device-EC encoder code the same frame from the port's DPB,
    the port's decoder follows its own DPB, each package decodes the
    other's stream from the port's reference."""
    trees = weights["trees"]
    xs = _frames(64, 64, len(CHAIN) + 1)
    i_net = _port_codec(PDMCI.DMCIFM, trees["i"])
    enc, dec, dec_jax = (_port_codec(PDMC.DMCFM, trees["p"])
                         for _ in range(3))
    host_enc, host_dec = (_port_codec(PDMC.DMCFM, trees["p"], False)
                          for _ in range(2))
    j_enc, j_dec = (_jax_codec(JDMC.DMCFM, trees["p"]) for _ in range(2))
    frames = []
    with _counting_top_index() as n255:
        e = i_net.compress(xs[0], QP_P)
        enc_dpb = dec_dpb = host_dpb = _fresh(e["x_hat"])
        for (fa, refresh), x in zip(CHAIN, xs[1:]):
            if refresh:
                enc_dpb, dec_dpb, host_dpb = (
                    _fresh(d["ref_frame"]) for d in (enc_dpb, dec_dpb,
                                                     host_dpb))
            sps = {"height": 64, "width": 64, "qp": QP_P, "fa_idx": fa}
            n255.clear()
            po = enc.compress(x, enc_dpb, QP_P, fa)
            ho = host_enc.compress(x, enc_dpb, QP_P, fa)
            jo = j_enc.compress(jnp.asarray(x), _to_jax(enc_dpb), QP_P, fa)
            f = {"fa": fa, "n255": sum(n255), "port": po, "jax": jo,
                 "host": ho,
                 "host_dec": host_dec.decompress(ho["bit_stream"], host_dpb,
                                                 sps)["dpb"],
                 "jax_dec_port": j_dec.decompress(
                     po["bit_stream"], _to_jax(enc_dpb), sps)["dpb"],
                 "port_dec_jax": dec_jax.decompress(
                     jo["bit_stream"], enc_dpb, sps)["dpb"]}
            f["port_dec"] = dec.decompress(po["bit_stream"], dec_dpb,
                                           sps)["dpb"]
            frames.append(f)
            enc_dpb, dec_dpb, host_dpb = po["dpb"], f["port_dec"], \
                f["host_dec"]
    return frames


def test_fm_p_device_streams_match_jax(chain):
    for t, f in enumerate(chain, 1):
        print(f"DMCFM P-frame {t} (fa_idx {f['fa']}): {f['n255']} y and "
              f"motion-y indexes of 255, {len(f['port']['bit_stream'])} B")
        assert f["n255"] == 0
        assert f["port"]["bit_stream"] == f["jax"]["bit_stream"]


def test_fm_p_device_decoder_exact(chain):
    for t, f in enumerate(chain, 1):
        enc, dec = _np(f["port"]["dpb"]), _np(f["port_dec"])
        for k in DPB_KEYS:
            np.testing.assert_array_equal(dec[k], enc[k],
                                          err_msg=f"frame {t} {k}")


def test_fm_p_device_decoders_cross(chain):
    for t, f in enumerate(chain, 1):
        enc = _np(f["port"]["dpb"])
        mine, theirs = _np(f["port_dec_jax"]), _np(f["jax_dec_port"])
        for k in DPB_KEYS:
            np.testing.assert_array_equal(mine[k], enc[k],
                                          err_msg=f"frame {t} {k}")
            _close(theirs[k], enc[k], f"JAX on the port's frame {t} {k}")


def test_fm_p_host_ec_equals_device_ec(chain):
    for t, f in enumerate(chain, 1):
        dev, host = _np(f["port"]["dpb"]), _np(f["host"]["dpb"])
        dev_d, host_d = _np(f["port_dec"]), _np(f["host_dec"])
        for k in DPB_KEYS:
            np.testing.assert_array_equal(host[k], dev[k],
                                          err_msg=f"frame {t} {k}")
            np.testing.assert_array_equal(host_d[k], dev_d[k],
                                          err_msg=f"frame {t} {k}")


def test_fm_index_255_frame_decodes_exactly(weights, top_index):
    """(c) DMCFM with the index-255 biases: one P-frame from a 64x64
    I-frame reference.  The port codes every index-255 symbol, its
    decoder is exact; the JAX package's stream skips them, so the two
    differ."""
    tree = weights["trees"]["p_hot"]
    x0, x1 = _frames(64, 64, 2)
    dpb = _fresh(torch.from_numpy(x0))
    enc, dec = (_port_codec(PDMC.DMCFM, tree) for _ in range(2))
    po = enc.compress(x1, dpb, QP_P, 0)
    print(f"index-255 frame: {top_index} indexes of 255 by plane (y3..y0, "
          f"mv3..mv0)")
    assert sum(top_index) > 0 and sum(top_index[:4]) and \
        sum(top_index[4:])
    out = dec.decompress(po["bit_stream"], dpb,
                         {"height": 64, "width": 64, "qp": QP_P,
                          "fa_idx": 0})["dpb"]
    for k in DPB_KEYS:
        assert torch.equal(out[k], po["dpb"][k]), k
    jo = _jax_codec(JDMC.DMCFM, tree).compress(
        jnp.asarray(x1), _to_jax(dpb), QP_P, 0)
    assert jo["bit_stream"] != po["bit_stream"]


def test_fm_ladder_rerun_container_matches_jax(weights):
    """(e) DMCIFM at 128x192, qp 0, from OPENDCVC_TPU_EC_BPS=0.0625: the
    frame reruns up the FM ladder (0.0625, 0.125, 0.25) and its container,
    rung included, is the JAX package's."""
    tree = weights["trees"]["i"]
    x = np.random.default_rng(0).random((1, 128, 192, 3), dtype=np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENDCVC_TPU_EC_BPS", "0.0625")
        mp.setenv("OPENDCVC_TPU_EC_LANES", LANES)
        port = PDMCI.DMCIFM(device="cpu", device_ec=True)
        port.load_params(from_jax(jax.tree_util.tree_map(np.asarray, tree)))
        port.update()
    assert (port.lanes, port.bytes_per_symbol) == (256, 0.0625)
    r0 = trace.counters().get("ec.rerun", 0)
    pe = port.compress(x, 0)
    reruns = trace.counters().get("ec.rerun", 0) - r0
    meta = PD.parse_frame_parts(pe["bit_stream"])[0]
    print(f"ladder: {reruns} reruns, container {meta}")
    assert reruns >= 1
    jax_net = _jax_codec(JDMCI.DMCIFM, tree,
                         OPENDCVC_TPU_EC_BPS="0.0625")
    assert pe["bit_stream"] == jax_net.compress(jnp.asarray(x),
                                                0)["bit_stream"]
    sps = {"height": 128, "width": 192, "qp": 0}
    np.testing.assert_array_equal(
        port.decompress(pe["bit_stream"], sps)["x_hat"].numpy(),
        pe["x_hat"].numpy())


def test_fm_harness_device_ec_bin_matches_jax(weights, tmp_path,
                                              top_index):
    """(f) Both FM harnesses under OPENDCVC_TPU_DEVICE_EC=1 on the 4-frame
    64x64 YUV420 clip of test_torch_port_fm_harness (qp 21, refreshes at
    frames 1 and 3): the same .bin, byte for byte, and the same bits."""
    cfg = _dataset(tmp_path, "yuv420")
    paths = weights["paths"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENDCVC_TPU_DEVICE_EC", "1")
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        JH.main(_argv(cfg, tmp_path, "jax", "--model_path_i", paths["i"],
                      "--model_path_p", paths["p"]))
        mp.delenv("OPENDCVC_TPU_FORCE_PY_RANS")
        PH.main(_argv(cfg, tmp_path, "port", "--device", "cpu",
                      "--model_path_i", paths["i"],
                      "--model_path_p", paths["p"]))
    print(f"harness: {sum(top_index)} y and motion-y indexes of 255")
    assert sum(top_index) == 0
    j, p = _outputs(tmp_path, "jax"), _outputs(tmp_path, "port")
    assert p["bin"] == j["bin"]
    assert p["log"]["ave_all_frame_bpp"] == j["log"]["ave_all_frame_bpp"]
    n = p["log"]["i_frame_num"] + p["log"]["p_frame_num"]
    assert round(p["log"]["ave_all_frame_bpp"] * n
                 * p["log"]["frame_pixel_num"]) == 8 * len(p["bin"])


# ---------------------------------------------------------------------------
# the FM codecs' coder options
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["i", "p"])
def test_fm_two_entropy_coders_match_jax(weights, codec):
    """set_use_two_entropy_coders(True) on both packages' host-EC codecs:
    the same dual-coder stream, decoded exactly by the port."""
    trees = weights["trees"]
    x0, x1 = _frames(64, 64, 2)
    if codec == "i":
        nets = [_port_codec(PDMCI.DMCIFM, trees["i"], False)
                for _ in range(2)]
        j = _jax_codec(JDMCI.DMCIFM, trees["i"], False)
    else:
        nets = [_port_codec(PDMC.DMCFM, trees["p"], False) for _ in range(2)]
        j = _jax_codec(JDMC.DMCFM, trees["p"], False)
    for net in nets + [j]:
        net.set_use_two_entropy_coders(True)
    enc, dec = nets
    if codec == "i":
        out = enc.compress(x0, 21)
        ref = out["x_hat"]
        got = dec.decompress(out["bit_stream"], {"height": 64, "width": 64,
                                                 "qp": 21})["x_hat"]
        jst = j.compress(jnp.asarray(x0), 21)["bit_stream"]
    else:
        dpb = _fresh(torch.from_numpy(x0))
        out = enc.compress(x1, dpb, 21, 0)
        ref = out["dpb"]["ref_frame"]
        got = dec.decompress(out["bit_stream"], dpb,
                             {"height": 64, "width": 64, "qp": 21,
                              "fa_idx": 0})["dpb"]["ref_frame"]
        jst = j.compress(jnp.asarray(x1), _to_jax(dpb), 21, 0)["bit_stream"]
    assert out["bit_stream"] == jst
    assert torch.equal(got, ref)


@pytest.mark.parametrize("device_ec", [False, True],
                         ids=["host_ec", "device_ec"])
@pytest.mark.parametrize("codec", ["i", "p"])
def test_fm_two_entropy_coders_need_update(weights, codec, device_ec):
    """set_use_two_entropy_coders before update() fails in both packages
    (the JAX codec has no coder yet, the port says so); after update() it
    is taken by both, and has no effect on device EC."""
    jcls, pcls = ((JDMCI.DMCIFM, PDMCI.DMCIFM) if codec == "i"
                  else (JDMC.DMCFM, PDMC.DMCFM))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENDCVC_TPU_DEVICE_EC", "1" if device_ec else "0")
        with pytest.raises(AttributeError):
            jcls().set_use_two_entropy_coders(True)
    with pytest.raises(RuntimeError, match="update"):
        pcls(device="cpu",
             device_ec=device_ec).set_use_two_entropy_coders(True)
    tree = weights["trees"][codec]
    port = _port_codec(pcls, tree, device_ec)
    for net in (_jax_codec(jcls, tree, device_ec), port):
        net.set_use_two_entropy_coders(True)
    assert (port.entropy_coder is None) == device_ec


def test_fm_ec_thread_matches_jax(weights):
    """DMCFM(stream_part=2, ec_thread=True): each part's coder on a worker
    thread, the JAX package's 2-part stream byte for byte, decoded
    exactly; two coders are refused with two parts."""
    tree = weights["trees"]["p"]
    x0, x1 = _frames(64, 64, 2)
    enc, dec = (_port_codec(PDMC.DMCFM, tree, False, stream_part=2,
                            ec_thread=True) for _ in range(2))
    assert all(p.encoder.threaded for p in enc.entropy_coder.parts)
    with pytest.raises(ValueError, match="stream_part"):
        enc.set_use_two_entropy_coders(True)
    dpb = _fresh(torch.from_numpy(x0))
    out = enc.compress(x1, dpb, 21, 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENDCVC_TPU_DEVICE_EC", "0")
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        j = JDMC.DMCFM(stream_part=2, ec_thread=True)
        j.load_params(tree)
        j.update()
    assert out["bit_stream"] == j.compress(jnp.asarray(x1), _to_jax(dpb),
                                           21, 0)["bit_stream"]
    got = dec.decompress(out["bit_stream"], dpb,
                         {"height": 64, "width": 64, "qp": 21,
                          "fa_idx": 0})["dpb"]
    for k in DPB_KEYS:
        assert torch.equal(got[k], out["dpb"][k]), k
