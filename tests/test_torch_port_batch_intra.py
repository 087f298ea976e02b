"""Port DMCI batched intra coding (device EC) against its single-frame path
and the JAX package (CPU, float32).

Default widths on three 64x96 frames from numpy (default_rng) at qps [12,
28, 40], weights from the JAX package's `init_params(seed=0)` carried
across, force_zero_thres in {None, 0.12}.  Held exactly unless stated:
`compress_batch` (from a list and from a stacked array) writes the streams
and x_hats of `compress` frame by frame, and the JAX package's streams;
`compress_async` equals `compress`; `decompress_batch` equals `decompress`
frame by frame; the JAX package decodes the batch's streams (floats within
atol = 1e-4 * max|ref|, as tests/test_torch_port_codec.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.models import dmci as JDMCI
from opendcvc_tpu_torch.entropy import device_rans as PD
from opendcvc_tpu_torch.models import dmci as PDMCI
from opendcvc_tpu_torch.utils.params import from_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)


H, W = 64, 96
SPS = {"height": H, "width": W}
QPS = [12, 28, 40]
FZS = [None, 0.12]


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))


def _jax_dmci():
    prev = os.environ.get("OPENDCVC_TPU_DEVICE_EC")
    os.environ["OPENDCVC_TPU_DEVICE_EC"] = "1"
    try:
        return JDMCI.DMCI()
    finally:
        if prev is None:
            os.environ.pop("OPENDCVC_TPU_DEVICE_EC")
        else:
            os.environ["OPENDCVC_TPU_DEVICE_EC"] = prev


@pytest.fixture(scope="module")
def jax_params():
    return _jax_dmci().init_params(seed=0)


def _frames():
    rng = np.random.default_rng(4)
    return [rng.random((1, H, W, 3), dtype=np.float32) for _ in QPS]


def _port(params, fz, **kw):
    net = PDMCI.DMCI(device="cpu", device_ec=True, **kw)
    net.load_params(params)
    net.update(force_zero_thres=fz)
    return net


@pytest.fixture(scope="module", params=FZS, ids=["fz_none", "fz_0.12"])
def run(request, jax_params):
    fz = request.param
    params = from_jax(jax_params)
    xs = _frames()
    net = _port(params, fz)
    out = {"single": [net.compress(x, q) for x, q in zip(xs, QPS)]}
    out["batch"] = net.compress_batch(xs, QPS)
    out["batch_stacked"] = net.compress_batch(np.stack(xs), QPS)
    out["async"] = []
    for x, q in zip(xs, QPS):
        x_hat, finish = net.compress_async(x, q)
        out["async"].append({"x_hat": x_hat, "bit_stream": finish()})
    out["reruns"] = net._ec_rerun_count

    streams = out["batch"]["bit_streams"]
    dec = _port(params, fz)
    out["per_dec"] = [dec.decompress(s, SPS, q)["x_hat"]
                      for s, q in zip(streams, QPS)]
    out["batch_dec"] = dec.decompress_batch(streams, SPS, QPS)["x_hat"]

    jnet = _jax_dmci()
    jnet.load_params(jax_params)
    jnet.update(force_zero_thres=fz)
    out["jax"] = [jnet.compress(jnp.asarray(x), q)["bit_stream"]
                  for x, q in zip(xs, QPS)]
    out["jax_dec"] = [np.asarray(jnet.decompress(s, SPS, q)["x_hat"])
                      for s, q in zip(streams, QPS)]
    return out


def test_compress_batch_equals_compress(run):
    for key in ("batch", "batch_stacked"):
        b = run[key]
        assert b["x_hat"].shape == (len(QPS), 1, H, W, 3)
        assert b["bit_streams"] == [s["bit_stream"] for s in run["single"]]
        for i, s in enumerate(run["single"]):
            assert torch.equal(b["x_hat"][i], s["x_hat"])


def test_compress_batch_equals_jax(run):
    for i, (a, b) in enumerate(zip(run["batch"]["bit_streams"], run["jax"])):
        assert a == b, f"frame {i} (qp {QPS[i]})"


def test_compress_async_equals_compress(run):
    for a, s in zip(run["async"], run["single"]):
        assert a["bit_stream"] == s["bit_stream"]
        assert torch.equal(a["x_hat"], s["x_hat"])


def test_decompress_batch_equals_decompress(run):
    assert run["batch_dec"].shape == (len(QPS), 1, H, W, 3)
    for i, (per, s) in enumerate(zip(run["per_dec"], run["single"])):
        assert torch.equal(run["batch_dec"][i], per)
        assert torch.equal(per, s["x_hat"])


def test_jax_decodes_batch_streams(run):
    for got, s in zip(run["jax_dec"], run["single"]):
        _close(got, s["x_hat"].numpy())


def test_batch_overflow_reruns_alone(jax_params):
    """At 0.05 bytes per symbol every frame of a batch overflows the first
    rung and re-runs alone; the streams are compress()'s."""
    params = from_jax(jax_params)
    xs = _frames()
    single = _port(params, None, bytes_per_symbol=0.05)
    ref = [single.compress(x, q)["bit_stream"] for x, q in zip(xs, QPS)]
    net = _port(params, None, bytes_per_symbol=0.05)
    got = net.compress_batch(xs, QPS)["bit_streams"]
    assert net._ec_rerun_count >= len(xs)
    assert got == ref


def test_decompress_batch_mixed_rungs_fall_back(jax_params):
    params = from_jax(jax_params)
    xs = _frames()
    low, top = _port(params, None), _port(params, None, bytes_per_symbol=3.0)
    streams = [low.compress(xs[0], QPS[0])["bit_stream"],
               top.compress(xs[1], QPS[1])["bit_stream"]]
    metas = [PD.parse_frame_parts(s)[0] for s in streams]
    assert metas[0]["cap"] != metas[1]["cap"]
    x = low.decompress_batch(streams, SPS, QPS[:2])["x_hat"]
    for i, s in enumerate(streams):
        assert torch.equal(x[i], low.decompress(s, SPS, QPS[i])["x_hat"])


def test_batch_paths_need_device_ec(jax_params):
    net = PDMCI.DMCI(device="cpu")
    net.load_params(from_jax(jax_params))
    net.update()
    x = _frames()[0]
    for call in (lambda: net.compress_async(x, 21),
                 lambda: net.compress_batch([x], 21),
                 lambda: net.decompress_batch([b""], SPS, 21)):
        with pytest.raises(ValueError, match="device-EC"):
            call()
