"""K2's compact decode table (`prepare_decode_table`) and the kernel's
per-lane decode step built on the host with g++.

The compact lookup (bucket index, then a short search over u16 bins) is
held against the plain search (the last bin with cum <= f) for every one
of the 65,536 slot values of the port's own y and z tables and of rows
that stress the buckets.  Everything is integer: every comparison is
exact.
"""

import numpy as np
import pytest
import torch

from opendcvc_tpu_torch.entropy import device_rans as PD
from opendcvc_tpu_torch.entropy import models as PM
from opendcvc_tpu_torch.ops import _build
from opendcvc_tpu_torch.ops import lane_rans as LR

from test_torch_port_lane_rans import _tables
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)


def _rows_of(freqs):
    freqs = np.asarray(freqs, np.int64)
    assert (freqs.sum(axis=1) == 65536).all()
    return np.concatenate([np.zeros((len(freqs), 1), np.int64),
                           np.cumsum(freqs, axis=1)], axis=1).astype(np.int32)


def _heavy_rows():
    """One symbol holds 65,281 slots, every other one 1; the heavy symbol
    first, in the middle and last."""
    freqs = np.ones((3, 256), np.int64)
    for r, s in enumerate((0, 128, 255)):
        freqs[r, s] = 65536 - 255
    return _rows_of(freqs)


def _y_rows():
    return PD.full_range_cdf_rows(*PM.GaussianEncoder().update())


def _z_rows():
    gen = torch.Generator().manual_seed(5)
    return PD.full_range_cdf_rows(*PM.BitEstimator(1, 128).update(
        PM.bit_estimator_init(gen, 1, 128)))


TABLES = {
    "y_gaussian": _y_rows,
    "z_bit_estimator": _z_rows,
    "random16": lambda: _tables(np.random.default_rng(16), 16),
    "heavy": _heavy_rows,
    "uniform": lambda: _rows_of(np.full((1, 256), 256)),
}


@pytest.fixture(params=sorted(TABLES))
def table(request):
    return TABLES[request.param]()


def test_compact_lookup_matches_plain_search(table):
    """lr_find_sym_compact (g++) == the last bin with cum <= f, with its
    start and next bins, for every f in [0, 65536) of every row."""
    lib = _build.load_host_shim()
    dtab = LR.prepare_decode_table(torch.from_numpy(table)).numpy()
    f = np.arange(65536)
    for a in range(0, len(table), 16):
        cum = table[a:a + 16].astype(np.int64)
        part = np.ascontiguousarray(dtab[a:a + 16])
        n = len(part)
        sym, start, nxt = (np.empty((n, 65536), np.int32) for _ in range(3))
        lib.lr_lookup_host(part.ctypes.data, n, sym.ctypes.data,
                           start.ctypes.data, nxt.ctypes.data)
        ref = np.stack([np.searchsorted(c, f, side="right") - 1 for c in cum])
        np.testing.assert_array_equal(sym, ref)
        np.testing.assert_array_equal(start, np.take_along_axis(cum, ref, 1))
        np.testing.assert_array_equal(nxt,
                                      np.take_along_axis(cum, ref + 1, 1))


def test_decode_table_expands_back(table):
    dtab = LR.prepare_decode_table(torch.from_numpy(table))
    assert dtab.dtype == torch.int32
    assert tuple(dtab.shape) == (len(table), LR.DEC_ROW_WORDS)
    np.testing.assert_array_equal(LR.expand_decode_table(dtab).numpy(),
                                  table.astype(np.int64))


def _broken(kind):
    t = _tables(np.random.default_rng(1), 4)
    if kind == "zero_freq":
        t[2, 6] = t[2, 5]
    elif kind == "total":
        t[1, 256] = 65535
    elif kind == "first_bin":
        t[3, 0] = 1
    elif kind == "shape":
        t = np.ascontiguousarray(t[:, :256])
    return torch.from_numpy(t)


@pytest.mark.parametrize("kind", ["zero_freq", "total", "first_bin",
                                  "shape"])
def test_prepare_decode_table_rejects_invalid_rows(kind):
    with pytest.raises(ValueError):
        LR.prepare_decode_table(_broken(kind))


def test_decode_scan_rejects_a_255_row_slice():
    """A model table may hold thousands of rows; one launch takes at most
    DEC_MAX_ROWS (256, DCVC-FM's y table): a 257-row slice is refused, a
    255-row and a 256-row one are taken (the skip sentinel, 511, lies
    outside every table)."""
    dtab = LR.prepare_decode_table(
        torch.from_numpy(_tables(np.random.default_rng(2), 257)))
    lanes, k = 8, 4
    assert LR.DEC_MAX_ROWS == 256 and LR.DEC_SKIP > LR.DEC_MAX_ROWS
    with pytest.raises(ValueError, match="dec_table"):
        LR.decode_scan(torch.zeros((lanes, 4), dtype=torch.int32),
                       torch.zeros((k, lanes), dtype=torch.int32), dtab,
                       torch.full((lanes,), 1 << 16, dtype=torch.int64),
                       torch.zeros(lanes, dtype=torch.int32))
    for nr in (255, 256):
        LR.decode_scan(torch.zeros((lanes, 4), dtype=torch.int32),
                       torch.full((k, lanes), nr - 1, dtype=torch.int32),
                       dtab[:nr].contiguous(),
                       torch.full((lanes,), 1 << 16, dtype=torch.int64),
                       torch.zeros(lanes, dtype=torch.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_decode_matches_plain_at_contract_edges(seed):
    """The kernel's decode step (g++) == decode_scan's plain version on
    arbitrary words: row ids past the table clamp, the skip row decodes 0
    and keeps the state, a word read before or past a lane's row is 0."""
    rng = np.random.default_rng(seed)
    lanes, k, nr, mw = 64, 48, 24, 20
    dtab = LR.prepare_decode_table(torch.from_numpy(_tables(rng, nr)))
    data = rng.integers(0, 1 << 16, (lanes, mw)).astype(np.int32)
    rows = rng.integers(0, nr + 8, (k, lanes)).astype(np.int32)
    rows[rng.random((k, lanes)) < 0.2] = LR.DEC_SKIP
    state = rng.integers(1 << 16, 1 << 32, lanes).astype(np.int64)
    ptr = rng.integers(-3, mw + 3, lanes).astype(np.int32)
    syms, st, p = LR.decode_scan(*(torch.from_numpy(a) for a in
                                   (data, rows)), dtab,
                                 torch.from_numpy(state),
                                 torch.from_numpy(ptr))
    lib = _build.load_host_shim()
    h_syms = np.zeros((k, lanes), np.int32)
    h_st = np.zeros(lanes, np.int64)
    h_p = np.zeros(lanes, np.int32)
    dt = dtab.numpy()
    lib.lr_decode_host(data.ctypes.data, rows.ctypes.data, dt.ctypes.data,
                       state.ctypes.data, ptr.ctypes.data, h_syms.ctypes.data,
                       h_st.ctypes.data, h_p.ctypes.data, k, lanes, nr, mw)
    np.testing.assert_array_equal(h_syms, syms.numpy())
    np.testing.assert_array_equal(h_st, st.numpy())
    np.testing.assert_array_equal(h_p, p.numpy())
    assert (syms.numpy()[rows == LR.DEC_SKIP] == 0).all()
