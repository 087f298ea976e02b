"""The port's host rANS decoder stops at the stream's end.

A stream cut short, corrupted or padded must raise ValueError, in one- and
two-coder mode, from the coder alone and from the codecs' host-EC decode:
no read past the stream's end, no hang, and no frame decoded from a stream
that is not exactly the encoder's.  Whole streams still decode and pass
the end check.  Each decode runs on a worker thread joined with a timeout,
so a decoder that spins fails the test instead of hanging it.
"""

import threading

import numpy as np
import pytest
import torch

from opendcvc_tpu_torch.entropy import models as PM
from opendcvc_tpu_torch.entropy.coder import EntropyCoder
from opendcvc_tpu_torch.models import dmc as PDMC
from opendcvc_tpu_torch.models import dmci as PDMCI
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

TWOS = [False, True]
TWO_IDS = ["one_coder", "two_coders"]
Z_C, Z_QP = 16, 1
N_Y, N_Z = 2000, Z_C * 24
JOIN_S = 60


def _coder():
    gen = torch.Generator().manual_seed(11)
    coder = EntropyCoder()
    coder.add_cdf(*PM.GaussianEncoder().update(), build_lut=True)
    coder.add_cdf(*PM.BitEstimator(2, Z_C).update(
        PM.bit_estimator_init(gen, 2, Z_C)))
    return coder


def _symbols():
    """y symbols within +-20 (escapes past most rows' support), z +-30."""
    rng = np.random.default_rng(4)
    y_sym = rng.integers(-20, 21, N_Y)
    y_idx = rng.integers(0, 128, N_Y).astype(np.uint8)
    packed = (y_sym * 256 + y_idx).astype(np.int16)
    return packed, y_idx, rng.integers(-30, 31, N_Z).astype(np.int8)


@pytest.fixture(scope="module", params=TWOS, ids=TWO_IDS)
def coded(request):
    """(two, stream, y indexes) of z then y coded by one or two coders."""
    two = request.param
    packed, y_idx, z = _symbols()
    coder = _coder()
    coder.set_use_two_entropy_coders(two)
    coder.reset()
    coder.encode_z(z, 1, Z_QP * Z_C, Z_C)
    coder.encode_y(packed, 0)
    coder.flush()
    return two, coder.get_encoded_stream(), y_idx


def _in_thread(fn):
    """Run fn on a worker thread; fails if it does not end within JOIN_S.
    Returns what fn raised (or None)."""
    out = {}

    def run():
        try:
            fn()
        except ValueError as e:
            out["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), "the decoder did not finish"
    return out.get("err")


def _decode_all(two, stream, y_idx):
    coder = _coder()
    coder.set_use_two_entropy_coders(two)
    coder.set_stream(stream)
    coder.decode_z(N_Z, 1, Z_QP * Z_C, Z_C)
    coder.get_decoded_tensor()
    coder.decode_and_get_y(y_idx, 0)
    coder.check_stream_end()


def test_whole_stream_passes_the_end_check(coded):
    two, stream, y_idx = coded
    assert _in_thread(lambda: _decode_all(two, stream, y_idx)) is None


@pytest.mark.parametrize("cut", [1, 2, 5, 64, "half", "all_but_3"])
def test_truncated_stream_raises(coded, cut):
    two, stream, y_idx = coded
    keep = {"half": len(stream) // 2, "all_but_3": 3}.get(cut)
    short = stream[:len(stream) - cut if keep is None else keep]
    err = _in_thread(lambda: _decode_all(two, short, y_idx))
    assert isinstance(err, ValueError)


@pytest.mark.parametrize("at", ["state", "second_byte", "third", "middle",
                                "last"])
def test_corrupted_stream_raises(coded, at):
    two, stream, y_idx = coded
    n = len(stream)
    pos = {"state": 1, "second_byte": 5, "third": n // 3, "middle": n // 2,
           "last": n - 1}[at]
    bad = bytearray(stream)
    bad[pos] ^= 0x5A
    err = _in_thread(lambda: _decode_all(two, bytes(bad), y_idx))
    assert isinstance(err, ValueError)


def test_padded_stream_raises(coded):
    """Bytes after the stream's end are not the frame's: they raise."""
    two, stream, y_idx = coded
    padded = stream + bytes(16) if two else stream + b"\x01"
    err = _in_thread(lambda: _decode_all(two, padded, y_idx))
    assert isinstance(err, ValueError)


# ---------------------------------------------------------------------------
# the codecs' host-EC decode
# ---------------------------------------------------------------------------

def _codec(cls, seed, **kw):
    net = cls(device="cpu", **kw)
    net.init_params(seed=seed)
    net.update(force_zero_thres=0.12)
    return net


@pytest.fixture(scope="module")
def frame():
    return np.random.default_rng(2).random((1, 64, 64, 3), dtype=np.float32)


@pytest.mark.parametrize("two", TWOS, ids=TWO_IDS)
def test_dmci_decode_of_a_cut_stream_raises(frame, two):
    enc = _codec(PDMCI.DMCI, 0, N=16, z_channel=16, enc_dec_ch=16)
    dec = _codec(PDMCI.DMCI, 0, N=16, z_channel=16, enc_dec_ch=16)
    enc.set_use_two_entropy_coders(two)
    coded = enc.compress(frame, 30)
    stream = coded["bit_stream"]
    sps = {"height": 64, "width": 64, "ec_part": int(two)}
    assert torch.equal(dec.decompress(stream, sps, 30)["x_hat"],
                       coded["x_hat"])
    err = _in_thread(lambda: dec.decompress(stream[:-2], sps, 30))
    assert isinstance(err, ValueError)


@pytest.mark.parametrize("two", TWOS, ids=TWO_IDS)
def test_dmc_decode_of_a_cut_stream_raises(frame, two):
    enc, dec = _codec(PDMC.DMC, 1), _codec(PDMC.DMC, 1)
    for net in (enc, dec):
        net.set_use_two_entropy_coders(two)
        net.add_ref_frame(None, frame)
    stream = enc.compress(np.roll(frame, 2, axis=2), 25)["bit_stream"]
    sps = {"height": 64, "width": 64, "ec_part": int(two)}
    err = _in_thread(lambda: dec.decompress(stream[:-2], sps, 25))
    assert isinstance(err, ValueError)
