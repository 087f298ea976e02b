"""Port lane rANS scans (K1/K2 plain versions and the kernels' per-lane
arithmetic built on the host) against the JAX package's XLA scans and its
Pallas kernels in interpret mode; CDF tables against the JAX package's.

Everything here is integer arithmetic: every comparison is exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.entropy import device_rans as JD
from opendcvc_tpu.entropy import models as JM
from opendcvc_tpu.ops import pallas_rans as JP
from opendcvc_tpu_torch.entropy import device_rans as PD
from opendcvc_tpu_torch.entropy import models as PM
from opendcvc_tpu_torch.ops import _build
from opendcvc_tpu_torch.ops import lane_rans as LR
from opendcvc_tpu_torch.utils.params import from_jax


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs in parallel worker processes,
    and workers that each take a thread per core slow one another down
    many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


L, K = 128, 40


@pytest.fixture
def interpret_mode():
    """Pallas kernels in interpret mode, set per test (other modules save
    and restore the same variable around their own Pallas runs)."""
    prev = os.environ.get("OPENDCVC_TPU_PALLAS_INTERPRET")
    os.environ["OPENDCVC_TPU_PALLAS_INTERPRET"] = "1"
    yield
    if prev is None:
        os.environ.pop("OPENDCVC_TPU_PALLAS_INTERPRET", None)
    else:
        os.environ["OPENDCVC_TPU_PALLAS_INTERPRET"] = prev


def _tables(rng, nr):
    """(nr, 257) int32 valid cumulative rows (freq >= 1, sum 2^16)."""
    rows = []
    for _ in range(nr):
        freqs = rng.integers(1, 600, 256).astype(np.int64)
        freqs = freqs * (65536 - 256) // freqs.sum() + 1
        freqs[0] += 65536 - freqs.sum()
        rows.append(np.concatenate([[0], np.cumsum(freqs)]))
    return np.stack(rows).astype(np.int32)


def _hl(table):
    return JD._split_hi_lo_bf16(table)


# Each case: segments coded back to back per lane (encode order), each
# (table id, steps, skip fraction), the tables' row counts and the staging
# width.  "carry" chains three segments over two 128-row tables: the port
# codes them with ONE operand against their 256-row combined table.
CASES = {
    "plain": ([(0, K, 0.0)], [24], 96),
    "skip": ([(0, K, 0.6)], [24], 96),
    "carry": ([(0, 24, 0.3), (0, 24, 0.3), (1, 8, 0.0)], [128, 128], 96),
    "overflow": ([(0, K, 0.0)], [24], 8),
}


_PAYLOADS = {}


def _payload(name):
    if name in _PAYLOADS:
        return _PAYLOADS[name]
    segs_spec, nrs, mw = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    tables = [_tables(rng, nr) for nr in nrs]
    offs = np.cumsum([0] + nrs[:-1])
    segs = []
    for t, k, skip_frac in segs_spec:
        sym = rng.integers(-128, 128, (L, k)).astype(np.int32)
        rows = rng.integers(0, nrs[t], (L, k)).astype(np.int32)
        skip = rng.random((L, k)) < skip_frac
        segs.append((t, np.where(skip, 0, sym),
                     np.where(skip, JD.SKIP_ROW, rows)))
    packed = np.ascontiguousarray(np.concatenate([
        ((s.T + 128) << LR.ENC_ROW_BITS)
        | np.where(r.T == JD.SKIP_ROW, LR.ENC_SKIP, r.T + offs[t])
        for t, s, r in segs]), np.int32)
    _PAYLOADS[name] = {"name": name, "tables": tables, "segs": segs,
                       "mw": mw, "packed": packed,
                       "combined": np.concatenate(tables)}
    return _PAYLOADS[name]


@pytest.fixture(params=sorted(CASES))
def payload(request):
    return _payload(request.param)


#: an overflowed staging is not decodable
@pytest.fixture(params=["carry", "plain", "skip"])
def dec_payload(request):
    return _payload(request.param)


def _jax_encode(pl):
    carry = JD.encode_carry_init(L, pl["mw"])
    for t, s, r in pl["segs"]:
        carry = JD._encode_scan_carry(jnp.asarray(s), jnp.asarray(r),
                                      _hl(pl["tables"][t]), carry)
    state, cursors, buf = (np.asarray(a) for a in carry)
    return buf, cursors, state


def _enc_table(pl):
    return LR.prepare_encode_table(torch.from_numpy(pl["combined"]))


def _port_encode(pl):
    buf, lens, states = LR.encode_scan(torch.from_numpy(pl["packed"]),
                                       _enc_table(pl), pl["mw"])
    return buf.numpy(), lens.numpy(), states.numpy()


def _host_encode(pl):
    """The kernel's own per-lane code (csrc/lane_rans_step.cuh), g++, on
    the prepared table."""
    lib = _build.load_host_shim()
    packed, table = pl["packed"], _enc_table(pl).numpy()
    buf = np.full((L, pl["mw"]), -1, np.int32)
    lens = np.zeros(L, np.int32)
    states = np.zeros(L, np.int64)
    lib.lr_encode_host(packed.ctypes.data, table.ctypes.data,
                       buf.ctypes.data, lens.ctypes.data, states.ctypes.data,
                       packed.shape[0], L, table.shape[0], pl["mw"])
    return buf, lens, states


def _assert_enc_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x).astype(np.int64),
                                      np.asarray(y).astype(np.int64))


def test_encode_plain_matches_xla_scan(payload):
    _assert_enc_equal(_port_encode(payload), _jax_encode(payload))


def test_encode_plain_matches_pallas_interpret(payload, interpret_mode):
    buf, lens, states = JP.encode_scan_pallas_packed(
        jnp.asarray(payload["packed"]), _hl(payload["combined"]),
        payload["mw"])
    _assert_enc_equal(_port_encode(payload), (buf, lens, states))


def test_encode_host_build_matches_plain(payload):
    _assert_enc_equal(_host_encode(payload), _port_encode(payload))


def test_overflow_counts_dropped_words():
    pl = _payload("overflow")
    _, lens, _ = _port_encode(pl)
    assert lens.max() > pl["mw"]


def _decode_inputs(pl):
    """Encode with the JAX scan, then lay the words out in decode order;
    rows per segment in decode order (segments reversed)."""
    buf, lens, states = _jax_encode(pl)
    mw = pl["mw"]
    data = np.zeros((L, mw), np.int32)
    for lane in range(L):
        data[lane, :lens[lane]] = buf[lane, :lens[lane]][::-1]
    segs = [(t, s[:, ::-1], r[:, ::-1]) for t, s, r in pl["segs"][::-1]]
    return data, states, segs


def _decode_all(pl, decode_one):
    """Decode every segment with a carried (state, ptr); returns the
    per-segment (symbols (L, k), state, ptr)."""
    data, states, segs = _decode_inputs(pl)
    carry = (states.astype(np.int64), np.zeros(L, np.int32))
    outs = []
    for t, _, r in segs:
        syms, st, ptr = decode_one(data, r, pl["tables"][t], *carry)
        carry = (np.asarray(st).astype(np.int64), np.asarray(ptr))
        outs.append((np.asarray(syms), carry[0], carry[1]))
    return outs, segs


def _k2_rows(rows):
    """The JAX package's decode-order (L, k) row ids as K2's (k, L): its
    skip row (SKIP_ROW, 255) becomes K2's DEC_SKIP."""
    return np.ascontiguousarray(
        np.where(rows == JD.SKIP_ROW, LR.DEC_SKIP, rows).T).astype(np.int32)


def _port_decode_one(data, rows, table, state, ptr):
    syms, st, p = LR.decode_scan(
        torch.from_numpy(data), torch.from_numpy(_k2_rows(rows)),
        LR.prepare_decode_table(torch.from_numpy(table)),
        torch.from_numpy(state), torch.from_numpy(ptr))
    return syms.numpy().T, st.numpy(), p.numpy()


def _jax_decode_one(data, rows, table, state, ptr):
    syms, (st, p) = JD._decode_scan_carry(
        jnp.asarray(data), jnp.asarray(rows.copy()), _hl(table),
        (jnp.asarray(state.astype(np.uint32)), jnp.asarray(ptr)))
    return syms, st, p


def _pallas_decode_one(data, rows, table, state, ptr):
    syms, st, p = JP.decode_scan_pallas(
        jnp.asarray(data), jnp.asarray(rows.T.copy()), rows.shape[1],
        _hl(table), jnp.asarray(state.astype(np.uint32)),
        jnp.asarray(ptr))
    return np.asarray(syms).T, st, p


def _host_decode_one(data, rows, table, state, ptr):
    lib = _build.load_host_shim()
    dtab = LR.prepare_decode_table(torch.from_numpy(table)).numpy()
    rows_t = _k2_rows(rows)
    k = rows_t.shape[0]
    syms = np.zeros((k, L), np.int32)
    st = np.zeros(L, np.int64)
    p = np.zeros(L, np.int32)
    state = np.ascontiguousarray(state, np.int64)
    ptr = np.ascontiguousarray(ptr, np.int32)
    lib.lr_decode_host(data.ctypes.data, rows_t.ctypes.data,
                       dtab.ctypes.data, state.ctypes.data, ptr.ctypes.data,
                       syms.ctypes.data, st.ctypes.data, p.ctypes.data, k, L,
                       dtab.shape[0], data.shape[1])
    return syms.T, st, p


def _assert_dec_equal(a, b):
    for (s1, st1, p1), (s2, st2, p2) in zip(a, b):
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(st1, st2)
        np.testing.assert_array_equal(p1, p2)


def test_decode_plain_matches_xla_scan_and_roundtrips(dec_payload):
    port, segs = _decode_all(dec_payload, _port_decode_one)
    ref, _ = _decode_all(dec_payload, _jax_decode_one)
    _assert_dec_equal(port, ref)
    for (syms, _, _), (_, s, r) in zip(port, segs):
        np.testing.assert_array_equal(
            syms, np.where(r == JD.SKIP_ROW, 0, s))


def test_decode_plain_matches_pallas_interpret(dec_payload, interpret_mode):
    port, _ = _decode_all(dec_payload, _port_decode_one)
    ref, _ = _decode_all(dec_payload, _pallas_decode_one)
    _assert_dec_equal(port, ref)


def test_decode_host_build_matches_plain(dec_payload):
    port, _ = _decode_all(dec_payload, _port_decode_one)
    host, _ = _decode_all(dec_payload, _host_decode_one)
    _assert_dec_equal(host, port)


def test_densify_roundtrip_matches_jax():
    """densify_segment / _undensify_device and the container helpers give
    the JAX package's layouts."""
    rng = np.random.default_rng(9)
    table = _tables(rng, 24)
    sym = rng.integers(-128, 128, (L, K)).astype(np.int32)
    rows = rng.integers(0, 24, (L, K)).astype(np.int32)
    buf, lens, states = (np.array(a) for a in JD._encode_scan(
        jnp.asarray(sym), jnp.asarray(rows), _hl(table), 96))
    cap = int(lens.sum()) + 64
    ref = np.asarray(JD.densify_segment(jnp.asarray(buf.astype(np.int32)),
                                        jnp.asarray(lens),
                                        jnp.asarray(states), cap))
    got = PD.densify_segment(torch.from_numpy(buf.astype(np.int32)),
                             torch.from_numpy(lens),
                             torch.from_numpy(states.astype(np.int64)), cap)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    staging = ref.astype(np.uint16)
    data_ref, st_ref = JD._undensify_device(jnp.asarray(staging), cap, L, 96)
    data, st = PD._undensify_device(
        torch.from_numpy(staging.astype(np.int32)), cap, L, 96)
    np.testing.assert_array_equal(data.numpy(), np.asarray(data_ref))
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_ref))
    dense, ln, s = PD.undensify_packed(staging, cap, L)
    stream = PD.serialize_frame_dense(dense, ln, s, L * K, K, 96, cap)
    assert stream == JD.serialize_frame_dense(dense, ln, s, L * K, K, 96,
                                              cap)
    meta, st_p, _ = PD.parse_frame(stream)
    meta_j, st_j, _ = JD.parse_frame(stream)
    assert meta == meta_j
    np.testing.assert_array_equal(st_p, st_j)


class _NoCoder:
    """Stands in for the JAX host coder: only its tables are compared."""

    def add_cdf(self, *args, **kwargs):
        return 0


@pytest.mark.parametrize("fz", [None, 0.12])
def test_gaussian_tables_match_jax(fz):
    ref = JM.GaussianEncoder()
    ref.update(_NoCoder(), fz)
    got = PM.GaussianEncoder()
    got.update()
    for a, b in zip(got.cdf_info, ref.cdf_info):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(PD.full_range_cdf_rows(*got.cdf_info),
                                  JD.full_range_cdf_rows(*ref.cdf_info))


def test_bit_estimator_tables_match_jax():
    import jax
    params = JM.bit_estimator_init(jax.random.PRNGKey(5), 72, 128)
    ref = JM.BitEstimator(72, 128)
    ref.update(params, _NoCoder())
    got = PM.BitEstimator(72, 128)
    got.update(from_jax(params))
    for a, b in zip(got.cdf_info, ref.cdf_info):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(PD.full_range_cdf_rows(*got.cdf_info),
                                  JD.full_range_cdf_rows(*ref.cdf_info))


def test_container_rejects_unknown_magic():
    with pytest.raises(ValueError, match="magic"):
        PD.parse_frame(b"\x01" + b"\x00" * 32)


def test_wrappers_reject_bad_operands():
    cum = torch.from_numpy(_tables(np.random.default_rng(0), 4))
    table = LR.prepare_encode_table(cum)
    packed = torch.zeros((K, L), dtype=torch.int32)
    LR.encode_scan(packed, table, 8)
    with pytest.raises(ValueError):
        LR.encode_scan(packed.to(torch.int64), table, 8)
    with pytest.raises(ValueError):
        LR.encode_scan(packed.t(), table, 8)      # not contiguous
    with pytest.raises(ValueError):
        LR.encode_scan(packed, cum, 8)            # rows not prepared
    with pytest.raises(ValueError):
        LR.decode_scan(torch.zeros((L, 8), dtype=torch.int32), packed,
                       torch.zeros((300, LR.DEC_ROW_WORDS),
                                   dtype=torch.int32),
                       torch.zeros(L, dtype=torch.int64),
                       torch.zeros(L, dtype=torch.int32))
