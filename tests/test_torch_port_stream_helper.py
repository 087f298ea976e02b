"""The port's stream syntax against the JAX package's, byte for byte.

Adaptive uints at the width edges, an SPS + I + P sequence written as the
video harness writes it (SPS dedup by (height, width, use_ada_i,
ec_part)), the flat intra container and the rate ladder: each writes the
JAX package's bytes and reads back to the values written.
"""

import io

import numpy as np
import pytest

from opendcvc_tpu.utils import stream_helper as J
from opendcvc_tpu_torch.utils import stream_helper as P


@pytest.mark.parametrize("v", [0, 127, 128, 16383, 16384, (1 << 30) - 1])
def test_uint_adaptive_matches_jax(v):
    bufs = {m: io.BytesIO() for m in (P, J)}
    sizes = {m: m.write_uint_adaptive(b, v) for m, b in bufs.items()}
    assert sizes[P] == sizes[J] == (1 if v < 128 else 2 if v < 16384 else 4)
    assert bufs[P].getvalue() == bufs[J].getvalue()
    for reader in (P, J):
        assert reader.read_uint_adaptive(io.BytesIO(bufs[P].getvalue())) == v


@pytest.mark.parametrize("v", [-1, 1 << 30])
def test_uint_adaptive_refuses_out_of_range(v):
    with pytest.raises(ValueError):
        P.write_uint_adaptive(io.BytesIO(), v)


def _write_sequence(m, frames):
    """The harness's writer loop: an SPS when new, then the frame."""
    buf, helper = io.BytesIO(), m.SPSHelper()
    for is_i, sps, qp, payload in frames:
        sps = dict(sps, sps_id=-1)
        sps_id, new = helper.get_sps_id(sps)
        sps["sps_id"] = sps_id
        if new:
            m.write_sps(buf, sps)
        m.write_ip(buf, is_i, sps_id, qp, payload)
    return buf.getvalue()


def _read_sequence(m, data, n):
    """The harness's reader loop; returns (is_i, sps, qp, payload)s."""
    buf, helper, out = io.BytesIO(data), m.SPSHelper(), []
    for _ in range(n):
        header = m.read_header(buf)
        while header["nal_type"] == m.NalType.NAL_SPS:
            helper.add_sps_by_id(m.read_sps_remaining(buf,
                                                      header["sps_id"]))
            header = m.read_header(buf)
        sps = helper.get_sps_by_id(header["sps_id"])
        qp, payload = m.read_ip_remaining(buf)
        out.append((header["nal_type"] == m.NalType.NAL_I, sps, qp,
                    payload))
    assert buf.read() == b""
    return out


def test_sps_i_p_sequence_matches_jax():
    rng = np.random.default_rng(0)
    base = {"height": 1080, "width": 1920, "ec_part": 1, "use_ada_i": 0}
    frames = [(True, base, 21, rng.bytes(20000)),
              (False, base, 29, rng.bytes(300)),
              (False, dict(base, use_ada_i=1), 21, rng.bytes(100)),
              (False, base, 25, b""),
              (True, dict(base, height=64, ec_part=0), 37, rng.bytes(5))]
    data = _write_sequence(P, frames)
    assert data == _write_sequence(J, frames)
    assert data[0] >> 4 == int(P.NalType.NAL_SPS)
    for reader in (P, J):
        got = _read_sequence(reader, data, len(frames))
        for (is_i, sps, qp, payload), (g_i, g_sps, g_qp, g_pl) in zip(
                frames, got):
            assert (g_i, g_qp, g_pl) == (is_i, qp, payload)
            assert {k: g_sps[k] for k in sps} == sps


def test_flat_intra_container_matches_jax(tmp_path):
    payload = np.random.default_rng(1).bytes(777)
    for m in (P, J):
        m.encode_i(1080, 1920, 4321, payload, tmp_path / f"{m.__name__}.bin")
    files = [tmp_path / f"{m.__name__}.bin" for m in (P, J)]
    assert files[0].read_bytes() == files[1].read_bytes()
    assert P.filesize(files[0]) == 14 + len(payload)
    for reader in (P, J):
        assert reader.decode_i(files[0]) == (1080, 1920, 4321, payload)


def test_rate_helpers_match_jax():
    assert P.get_rounded_q(1.234567) == J.get_rounded_q(1.234567)
    assert P.get_rounded_q(1e4) == J.get_rounded_q(1e4) == (655.0, 65500)
    np.testing.assert_array_equal(P.interpolate_log(0.5, 12.0, 6),
                                  J.interpolate_log(0.5, 12.0, 6))
    np.testing.assert_array_equal(
        P.interpolate_log(0.5, 12.0, 6, decending=False),
        J.interpolate_log(0.5, 12.0, 6, decending=False))
