"""The port's host<->device copies (`opendcvc_tpu_torch/utils/transfer.py`)
on the CPU.

A host-EC DMC P-frame at 64x64 (the port's init, seed 1), coded and
decoded in a session of the port's trace: the encode waits for one copy
to the host (`wait.fetch`) and uploads nothing; the decode waits for two
(one a y pass) and makes three uploads (z and the two y passes).  The
counters `d2h_bytes` / `h2d_bytes` grow by the bytes of the buffers the
codec fetched and uploaded, each recorded by a wrapper around the
codec's own calls.
"""

import numpy as np
import pytest
import torch

from opendcvc_tpu_torch.models import common as PC
from opendcvc_tpu_torch.models import dmc as PDMC
from opendcvc_tpu_torch.utils import trace
from opendcvc_tpu_torch.utils import transfer as T
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

H = W = 64
QP = 21
SPS = {"height": H, "width": W, "ec_part": 0}


@pytest.fixture(scope="module")
def pair():
    """(encoder, decoder, P-frame): host-EC DMCs on one reference."""
    rng = np.random.default_rng(7)
    x0 = torch.from_numpy(rng.random((1, H, W, 3), dtype=np.float32))
    x1 = np.clip(x0.numpy() + rng.normal(0, 0.02, x0.shape), 0, 1) \
        .astype(np.float32)
    params = PDMC.DMC(device="cpu").init_params(seed=1)
    nets = []
    for _ in range(2):
        net = PDMC.DMC(device="cpu")
        net.load_params(params)
        net.update()
        net.add_ref_frame(None, x0)
        nets.append(net)
    return nets[0], nets[1], x1


def _recorded(monkeypatch):
    """Wrap the codec's fetch_async and upload: the bytes each fetch gave
    the host and each upload took, in the order of the calls."""
    got = {"d2h": [], "h2d": []}

    def fetch_async(t, *args):
        wait = T.fetch_async(t, *args)

        def done():
            arr = wait()
            got["d2h"].append(arr.nbytes)
            return arr
        return done

    def upload(a, device):
        got["h2d"].append(a.nbytes)
        return T.upload(a, device)

    monkeypatch.setattr(PDMC, "fetch_async", fetch_async)
    monkeypatch.setattr(PC, "upload", upload)
    return got


def _in_session(fn):
    """fn() in a trace session: (spans' counts, counters' deltas)."""
    c0 = trace.counters()
    trace.enable()
    try:
        fn()
    finally:
        trace.disable()
    s = trace.last_session()
    c1 = trace.counters()
    n = {k: s["spans"].get(k, {"n": 0})["n"] for k in ("wait.fetch",
                                                        "upload")}
    moved = {k: c1.get(k, 0) - c0.get(k, 0) for k in ("d2h_bytes",
                                                      "h2d_bytes")}
    assert moved == {k: s["counters"].get(k, 0) for k in moved}
    return n, moved


def test_host_ec_p_frame_copies(pair, monkeypatch):
    enc, dec, x1 = pair
    got = _recorded(monkeypatch)
    out = {}
    n, moved = _in_session(
        lambda: out.update(s=enc.compress(x1, QP)["bit_stream"]))
    assert n == {"wait.fetch": 1, "upload": 0}
    assert len(got["d2h"]) == 1 and not got["h2d"]
    assert moved == {"d2h_bytes": got["d2h"][0], "h2d_bytes": 0}

    got["d2h"].clear()
    n, moved = _in_session(lambda: dec.decompress(out["s"], SPS, QP))
    assert n == {"wait.fetch": 2, "upload": 3}
    assert (len(got["d2h"]), len(got["h2d"])) == (2, 3)
    assert moved == {"d2h_bytes": sum(got["d2h"]),
                     "h2d_bytes": sum(got["h2d"])}
    assert torch.equal(dec.dpb[0].feature, enc.dpb[0].feature)


def test_upload_takes_arrays_and_tensors():
    """upload takes a numpy array or a host tensor alike, and counts each
    one's bytes."""
    a = np.arange(12, dtype=np.int16).reshape(3, 4)[:, ::2]
    c0 = trace.counters().get("h2d_bytes", 0)
    t = T.upload(a, torch.device("cpu"))
    assert torch.equal(t, torch.from_numpy(np.ascontiguousarray(a)))
    u = T.upload(torch.from_numpy(a.copy()), torch.device("cpu"))
    assert torch.equal(u, t)
    assert trace.counters()["h2d_bytes"] - c0 == 2 * a.nbytes
