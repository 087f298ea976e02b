"""Port DMC GOP coding (device EC) against its per-frame path and the JAX
package (CPU, float32).

Default widths on 64x64 frames, weights from the JAX package's
`init_params(seed=1)` carried across, a pixel reference and frames from
numpy (default_rng), force_zero_thres in {None, 0.12}: one P-frame at qp
21 alone, then a GOP of 3 at qps [29, 25, 29].  Held exactly unless
stated:
  * the port's GOP streams equal its per-frame streams and the JAX
    package's per-frame device-EC streams, and the encoders end at the
    same feature;
  * the JAX package decodes the port's GOP streams frame by frame, and
    the port's `decompress_gop` decodes the JAX package's streams (floats
    within atol = 1e-4 * max|ref|, as tests/test_torch_port_codec.py);
  * `decompress_gop` and `upload_gop` + `decompress_gop_uploaded` give
    the per-frame decoder's x_hats and final feature, which is the
    encoder's;
  * a frame that overflows its staging inside a GOP (128x128 at 0.05
    bytes per symbol) re-runs alone and writes the per-frame bytes, also
    when two chunks settle at once on pool threads; a chunk of mixed
    ladder rungs decodes frame by frame.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.models import dmc as JDMC
from opendcvc_tpu_torch.entropy import device_rans as PD
from opendcvc_tpu_torch.models import dmc as PDMC
from opendcvc_tpu_torch.utils.params import from_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)


H = W = 64
SPS = {"height": H, "width": W}
QPS = [21, 29, 25, 29]     # the first P-frame alone, then a GOP of 3
FZS = [None, 0.12]


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))


def _jax_dmc():
    prev = os.environ.get("OPENDCVC_TPU_DEVICE_EC")
    os.environ["OPENDCVC_TPU_DEVICE_EC"] = "1"
    try:
        return JDMC.DMC()
    finally:
        if prev is None:
            os.environ.pop("OPENDCVC_TPU_DEVICE_EC")
        else:
            os.environ["OPENDCVC_TPU_DEVICE_EC"] = prev


@pytest.fixture(scope="module")
def jax_params():
    return _jax_dmc().init_params(seed=1)


def _frames(h, w, seed=11, n=4):
    rng = np.random.default_rng(seed)
    x0 = rng.random((1, h, w, 3), dtype=np.float32)
    frames, prev = [], x0
    for _ in range(n):
        prev = np.clip(prev + rng.normal(0, 0.02, prev.shape)
                       .astype(np.float32), 0, 1)
        frames.append(prev)
    return x0, frames


def _port(params, fz, x0, **kw):
    """A port device-EC DMC with the pixel reference x0 in its DPB."""
    net = PDMC.DMC(device="cpu", device_ec=True, **kw)
    net.load_params(params)
    net.update(force_zero_thres=fz)
    net.add_ref_frame(None, torch.from_numpy(x0))
    return net


def _jax(params, fz, x0):
    net = _jax_dmc()
    net.load_params(params)
    net.update(force_zero_thres=fz)
    net.add_ref_frame(None, jnp.asarray(x0))
    return net


@pytest.fixture(scope="module", params=FZS, ids=["fz_none", "fz_0.12"])
def run(request, jax_params):
    fz = request.param
    params = from_jax(jax_params)
    x0, frames = _frames(H, W)
    out = {}

    single = _port(params, fz, x0)
    out["single"] = [single.compress(x, q)["bit_stream"]
                     for x, q in zip(frames, QPS)]
    out["single_feat"] = single.dpb[0].feature
    out["single_poc"] = single.curr_poc

    gop = _port(params, fz, x0)
    first = gop.compress(frames[0], QPS[0])["bit_stream"]
    out["gop"] = [first] + gop.compress_gop(frames[1:], QPS[1:])[
        "bit_streams"]
    out["gop_feat"] = gop.dpb[0].feature
    out["gop_poc"] = gop.curr_poc

    jenc = _jax(jax_params, fz, x0)
    out["jax"] = [jenc.compress(jnp.asarray(x), q)["bit_stream"]
                  for x, q in zip(frames, QPS)]
    # the JAX package decodes the port's GOP streams frame by frame
    jdec = _jax(jax_params, fz, x0)
    out["jax_dec_x"] = [np.asarray(jdec.decompress(s, SPS, q)["x_hat"])
                        for s, q in zip(out["gop"], QPS)]

    per = _port(params, fz, x0)
    out["per_x"] = [per.decompress(s, SPS, q)["x_hat"]
                    for s, q in zip(out["gop"], QPS)]
    out["per_feat"] = per.dpb[0].feature

    def gop_decode(streams, uploaded):
        net = _port(params, fz, x0)
        net.decompress(streams[0], SPS, QPS[0])
        if uploaded:
            x = net.decompress_gop_uploaded(net.upload_gop(streams[1:], SPS),
                                            SPS, QPS[1:])["x_hat"]
        else:
            x = net.decompress_gop(streams[1:], SPS, QPS[1:])["x_hat"]
        return x, net.dpb[0].feature, net.curr_poc, net.dpb[0].frame

    out["gop_dec"] = gop_decode(out["gop"], False)
    out["gop_dec_up"] = gop_decode(out["gop"], True)
    out["gop_dec_jax"] = gop_decode(out["jax"], False)
    return out


def test_gop_streams_equal_per_frame(run):
    assert run["gop"] == run["single"]
    assert torch.equal(run["gop_feat"], run["single_feat"])
    assert run["gop_poc"] == run["single_poc"]


def test_gop_streams_equal_jax(run):
    for i, (a, b) in enumerate(zip(run["gop"], run["jax"])):
        assert a == b, f"P-frame {i}"


def test_jax_decodes_port_gop_streams(run):
    for got, ref in zip(run["jax_dec_x"], run["per_x"]):
        _close(got, ref.numpy())


def test_port_decompress_gop_decodes_jax_streams(run):
    x, feat, _, _ = run["gop_dec_jax"]
    for i in range(3):
        assert torch.equal(x[i], run["per_x"][i + 1])
        _close(x[i].numpy(), run["jax_dec_x"][i + 1])
    assert torch.equal(feat, run["per_feat"])


def test_gop_decode_equals_per_frame(run):
    x, feat, poc, frame = run["gop_dec"]
    assert x.shape == (3, 1, H, W, 3)
    for i in range(3):
        assert torch.equal(x[i], run["per_x"][i + 1])
    assert torch.equal(frame, run["per_x"][-1])
    assert torch.equal(feat, run["per_feat"])
    assert torch.equal(feat, run["gop_feat"])      # the enc/dec chain
    assert poc == run["single_poc"]


def test_upload_gop_equals_decompress_gop(run):
    x, feat, poc, _ = run["gop_dec_up"]
    assert torch.equal(x, run["gop_dec"][0])
    assert torch.equal(feat, run["gop_dec"][1])
    assert poc == run["gop_dec"][2]


@pytest.fixture(scope="module")
def overflow(jax_params):
    """128x128 at 0.05 bytes per symbol, where P-frames overflow the first
    rung: the weights, frames, the feature after frame 0, and the
    per-frame path's streams and final feature.  (At 64x64 nothing
    overflows: 9 steps a lane fit staging_width's 12-word floor.)"""
    params = from_jax(jax_params)
    x0, frames = _frames(128, 128, seed=5)
    single = _port(params, None, x0, bytes_per_symbol=0.05)
    streams = [single.compress(frames[0], QPS[0])["bit_stream"]]
    feat0 = single.dpb[0].feature
    streams += [single.compress(x, q)["bit_stream"]
                for x, q in zip(frames[1:], QPS[1:])]
    return params, frames, feat0, streams, single.dpb[0].feature


def _overflow_codec(params, feat0):
    net = PDMC.DMC(device="cpu", device_ec=True, bytes_per_symbol=0.05)
    net.load_params(params)
    net.update()
    net.add_ref_frame(feat0, None)
    return net


def test_gop_rerun_writes_per_frame_bytes(overflow):
    """The GOP's frames overflow the first rung, re-run alone from their
    carry-in features, and write the bytes the per-frame path writes; the
    DPB ends at the per-frame path's feature."""
    params, frames, feat0, streams, feat_last = overflow
    gop = _overflow_codec(params, feat0)
    got = gop.compress_gop(frames[1:], QPS[1:])["bit_streams"]
    assert gop._ec_rerun_count >= len(got)
    assert gop._ec_learned[(128, 128)] > 0.05
    assert got == streams[1:]
    assert torch.equal(gop.dpb[0].feature, feat_last)


def test_gop_chunks_settle_on_pool_threads(overflow):
    """Two chunks queued back to back and settled at once on pool threads,
    the interpreter switching threads every microsecond: each overflowing
    frame re-runs from its own carry-in feature, and the streams, rerun
    count and learned rate are those of settling the chunks one after
    the other (a lost update to the codec's counters would show)."""
    params, frames, feat0, streams, _ = overflow
    chunks = [(frames[1:3], QPS[1:3]), (frames[3:], QPS[3:])]
    serial = _overflow_codec(params, feat0)
    want = [fin() for fin in [serial.compress_gop_async(x, q)
                              for x, q in chunks]]
    net = _overflow_codec(params, feat0)
    fins = [net.compress_gop_async(x, q) for x, q in chunks]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=4) as pool:
            handles = [pool.submit(fin) for fin in fins]
            got = [h.result(timeout=300) for h in handles]
    finally:
        sys.setswitchinterval(interval)
    assert got == want
    assert got[0] + got[1] == streams[1:]
    assert net._ec_rerun_count == serial._ec_rerun_count >= len(streams) - 1
    assert net._ec_learned == serial._ec_learned


def test_mixed_rung_chunk_takes_per_frame_fallback(jax_params):
    """A chunk whose containers were written at different ladder rungs
    (a codec serializing from the top rung) decodes frame by frame, to
    the per-frame decoder's frames."""
    params = from_jax(jax_params)
    x0, frames = _frames(H, W)
    low = _port(params, None, x0)
    top = _port(params, None, x0, bytes_per_symbol=3.0)
    s_low = [low.compress(x, q)["bit_stream"] for x, q in zip(frames, QPS)]
    s_top = [top.compress(x, q)["bit_stream"] for x, q in zip(frames, QPS)]
    chunk = [s_low[1], s_top[2], s_low[3]]
    metas = [PD.parse_frame_parts(s)[0] for s in chunk]
    assert len({(m["MW"], m["cap"]) for m in metas}) == 2

    dec = _port(params, None, x0)
    dec.decompress(s_low[0], SPS, QPS[0])
    assert dec.upload_gop(chunk, SPS) is None
    x = dec.decompress_gop(chunk, SPS, QPS[1:])["x_hat"]
    per = _port(params, None, x0)
    ref = [per.decompress(s, SPS, q)["x_hat"] for s, q in zip(s_low, QPS)]
    for i in range(3):
        assert torch.equal(x[i], ref[i + 1])
    assert torch.equal(dec.dpb[0].feature, per.dpb[0].feature)
    assert dec.curr_poc == per.curr_poc


def test_upload_stagings_parses_and_widens():
    """upload_stagings stacks the stagings parse_frame gives, as int32;
    containers of different rungs give None and the metas."""
    rng = np.random.default_rng(2)
    streams = []
    for mw, cap in ((12, 4096), (12, 4096), (17, 4352)):
        lens = rng.integers(0, mw - 2, 256).astype(np.uint16)
        dense = rng.integers(0, 1 << 16, int(lens.sum())).astype(np.uint16)
        states = rng.integers(1 << 16, 1 << 32, 256).astype(np.uint32)
        streams.append(PD.serialize_frame_dense(dense, lens, states, 2304,
                                                9, mw, cap))
    metas, st = PD.upload_stagings(streams[:2], torch.device("cpu"))
    assert st.dtype == torch.int32 and st.shape == (2, 4096 + 3 * 256)
    for i in range(2):
        meta, ref, _ = PD.parse_frame(streams[i])
        assert metas[i] == meta
        np.testing.assert_array_equal(st[i].numpy(), ref.astype(np.int32))
    metas, st = PD.upload_stagings(streams, torch.device("cpu"))
    assert st is None and [m["MW"] for m in metas] == [12, 12, 17]


def test_gop_needs_device_ec_and_a_feature(jax_params):
    params = from_jax(jax_params)
    x0, frames = _frames(H, W)
    host = PDMC.DMC(device="cpu")
    host.load_params(params)
    host.update()
    host.add_ref_frame(torch.ones(1), None)
    for call in (lambda: host.compress_gop_async(frames, QPS),
                 lambda: host.decompress_gop([], SPS, [])):
        with pytest.raises(ValueError, match="device-EC"):
            call()
    net = _port(params, None, x0)       # a pixel reference only
    for call in (lambda: net.compress_gop_async(frames, QPS),
                 lambda: net.decompress_gop([], SPS, []),
                 lambda: net.decompress_gop_uploaded(None, SPS, [])):
        with pytest.raises(ValueError, match="feature reference"):
            call()
