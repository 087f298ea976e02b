"""K1's prepared encode table (`prepare_encode_table`) and the kernel's
exact division and per-lane encode step built on the host with g++.

The division by a magic multiply is held against numpy's // and % at
every quotient boundary of a sample of divisors (the approximation is
monotone in x, so the boundaries decide it), and on every entry of the
tables K2's tests use.  Everything is integer: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from opendcvc_tpu_torch.ops import _build
from opendcvc_tpu_torch.ops import lane_rans as LR

from test_torch_port_k2 import _broken, table  # noqa: F401  (fixture)
from test_torch_port_lane_rans import _one_thread, _tables  # noqa: F401


def _divmod_host(d, m, x):
    """lr_divmod_host (g++): x // d and x % d by K1's division, from d's
    magic m (int64, split into its two 32-bit words)."""
    m = np.asarray(m, np.int64)
    d, ml, mh, x = (np.ascontiguousarray(a, np.uint32)
                    for a in (d, m & 0xFFFFFFFF, m >> 32, x))
    q = np.empty_like(x)
    r = np.empty_like(x)
    _build.load_host_shim().lr_divmod_host(
        d.ctypes.data, ml.ctypes.data, mh.ctypes.data, x.ctypes.data, x.size,
        q.ctypes.data, r.ctypes.data)
    return q, r


def _assert_divides(d, m, x):
    q, r = _divmod_host(d, m, x)
    x = x.astype(np.uint64)
    d = np.broadcast_to(d, x.shape).astype(np.uint64)
    np.testing.assert_array_equal(q, x // d)
    np.testing.assert_array_equal(r, x % d)


def test_encode_table_matches_rows_and_divides(table):
    """start and freq of every entry are the rows' bins, and the entry's
    magic divides exactly at the edges of the encoder's domain [0, freq
    << 16) and at random points in it."""
    enc = LR.prepare_encode_table(torch.from_numpy(table))
    assert enc.dtype == torch.int32
    assert tuple(enc.shape) == (len(table), LR.ENC_ROW_WORDS)
    start, freq, magic = (a.numpy() for a in LR.encode_table_entries(enc))
    cum = table.astype(np.int64)
    np.testing.assert_array_equal(start, cum[:, :256])
    np.testing.assert_array_equal(freq, cum[:, 1:] - cum[:, :256])

    f = freq.reshape(-1, 1).astype(np.uint64)
    m = np.broadcast_to(magic.reshape(-1, 1), (f.size, 16))
    rng = np.random.default_rng(len(table))
    top = f << 16
    x = np.concatenate([
        np.zeros_like(f), f - 1, f, 2 * f - 1, 2 * f, top - f - 1,
        top - f, top - 1,
        (rng.random((f.size, 8)) * top).astype(np.uint64)], axis=1)
    _assert_divides(np.broadcast_to(f, x.shape), m, x)


def _freq_sample(which):
    if which == "edges":
        pow2 = 1 << np.arange(17)
        f = np.concatenate([[1, 2, 3, 65281], pow2 - 1, pow2, pow2 + 1])
        return np.unique(f[(f >= 1) & (f <= 65536)])
    seeded = np.random.default_rng(7).integers(1, 65282, 200)
    return seeded[:100] if which == "seeded_a" else seeded[100:]


@pytest.mark.parametrize("which", ["edges", "seeded_a", "seeded_b"])
def test_div_exact_at_quotient_boundaries(which):
    """For each d: x = k d - 1 and k d over the whole domain x < d << 16,
    and 10^5 random x there."""
    rng = np.random.default_rng(11)
    k = np.arange(1, 1 << 16, dtype=np.uint64)
    for d in map(int, _freq_sample(which)):
        m = int(LR.div_magic(torch.tensor([d]))[0])
        x = np.concatenate([k * np.uint64(d) - 1, k * np.uint64(d),
                            np.array([0, (d << 16) - 1], np.uint64),
                            rng.integers(0, d << 16, 100_000, np.uint64)])
        _assert_divides(np.full(x.shape, d), np.full(x.shape, m), x)


@pytest.mark.parametrize("kind", ["zero_freq", "total", "first_bin",
                                  "shape"])
def test_prepare_encode_table_rejects_invalid_rows(kind):
    with pytest.raises(ValueError):
        LR.prepare_encode_table(_broken(kind))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_encode_matches_plain_at_contract_edges(seed):
    """The kernel's encode step (g++) == encode_scan's plain version with
    row ids past the table (clamped), skip slots (the identity entry), a
    lane count that is no multiple of 32 and a staging too narrow for
    some lanes (dropped words, the cursor counting on)."""
    rng = np.random.default_rng(seed)
    lanes, k, nr, mw = 100, 48, 24, 20
    enc = LR.prepare_encode_table(torch.from_numpy(_tables(rng, nr)))
    rows = rng.integers(0, nr + 8, (k, lanes))
    rows[rng.random((k, lanes)) < 0.2] = LR.ENC_SKIP
    packed = LR.pack_operand(torch.from_numpy(rng.integers(-128, 128,
                                                           (k, lanes))),
                             torch.from_numpy(rows))
    buf, lens, states = LR.encode_scan(packed, enc, mw)
    assert int(lens.max()) > mw
    h_buf = np.full((lanes, mw), -1, np.int32)
    h_lens = np.zeros(lanes, np.int32)
    h_states = np.zeros(lanes, np.int64)
    p, e = packed.numpy(), enc.numpy()
    _build.load_host_shim().lr_encode_host(
        p.ctypes.data, e.ctypes.data, h_buf.ctypes.data, h_lens.ctypes.data,
        h_states.ctypes.data, k, lanes, nr, mw)
    np.testing.assert_array_equal(h_buf, buf.numpy())
    np.testing.assert_array_equal(h_lens, lens.numpy())
    np.testing.assert_array_equal(h_states, states.numpy())
