"""Host rANS coder front-end over the native library (csrc/rans.cpp).

Counterpart of the JAX package's `entropy/rans.py`: RansEncoder /
RansDecoder with the same methods, an `interleaved` channel-index mode for
NHWC z planes and a `build_lut` flag for O(1) symbol lookup in the
decoder.  Native only: a failed build or load raises (there is no quiet
fallback to the plain Python coder, `rans_py.py`, which only the tests
use).  Every CDF row a call names is checked against the registered
group before a pointer crosses to C++, which does not check.  The decoder
never reads past the stream's end: a truncated or corrupt stream raises
ValueError, at the latest from `check_stream_end` after its last symbol.
"""

import ctypes
import os

import numpy as np

from ..ops._build import load_host_rans


def _threaded_default():
    """OPENDCVC_TPU_RANS_THREADS forces the worker thread off ("0",
    "false", "False") or on (any other value), as in the JAX package;
    unset, a worker thread per coder is used only when there is a spare
    core."""
    v = os.environ.get("OPENDCVC_TPU_RANS_THREADS")
    if v is not None:
        return v not in ("0", "false", "False")
    return (os.cpu_count() or 1) > 1


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _cdf_arrays(cdfs, cdf_sizes, offsets):
    cdfs = np.ascontiguousarray(cdfs, dtype=np.int32)
    sizes = np.ascontiguousarray(cdf_sizes, dtype=np.int32).reshape(-1)
    offs = np.ascontiguousarray(offsets, dtype=np.int32).reshape(-1)
    if cdfs.ndim != 2 or not len(sizes) == len(offs) == cdfs.shape[0]:
        raise ValueError("add_cdf needs (n, row_len) rows with n sizes and "
                         "n offsets")
    if sizes.min(initial=2) < 2 or sizes.max(initial=0) > cdfs.shape[1]:
        raise ValueError("a CDF size lies outside its row")
    return cdfs, sizes, offs


def _z_rows_ok(n, start_offset, per_channel, interleaved, idx_base, n_rows):
    """True when every row id of a z call lies in a group of n_rows."""
    if n == 0:
        return True
    if per_channel <= 0 or start_offset < 0 or idx_base < 0:
        return False
    last = (per_channel - 1 if interleaved
            else (idx_base + n - 1) // per_channel)
    return start_offset + last < n_rows


class _Coder:
    """Shared part of the two ends: the native handle and the row count of
    each registered CDF group."""

    _new = _free = None

    def __init__(self, threaded=None):
        if threaded is None:
            threaded = _threaded_default()
        self.threaded = bool(threaded)
        self._lib = load_host_rans()
        self._h = getattr(self._lib, self._new)(1 if threaded else 0)
        self._rows = []

    def close(self):
        if getattr(self, "_h", None):
            getattr(self._lib, self._free)(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def _add_cdf(self, fn, cdfs, cdf_sizes, offsets, build_lut):
        cdfs, sizes, offs = _cdf_arrays(cdfs, cdf_sizes, offsets)
        idx = fn(self._h, _ptr(cdfs, ctypes.c_int32), cdfs.shape[0],
                 cdfs.shape[1], _ptr(sizes, ctypes.c_int32),
                 _ptr(offs, ctypes.c_int32), 1 if build_lut else 0)
        self._rows.append(cdfs.shape[0])
        return idx

    def _group_rows(self, group):
        if not 0 <= group < len(self._rows):
            raise IndexError(f"CDF group {group} is not registered")
        return self._rows[group]

    def _check_z(self, n, group, start_offset, per_channel, interleaved,
                 idx_base):
        if not _z_rows_ok(n, start_offset, per_channel, interleaved,
                          idx_base, self._group_rows(group)):
            raise IndexError("z rows past the CDF group")


class RansEncoder(_Coder):
    _new, _free = "rve_enc_new", "rve_enc_free"

    def add_cdf(self, cdfs, cdf_sizes, offsets, build_lut=False):
        return self._add_cdf(self._lib.rve_enc_add_cdf, cdfs, cdf_sizes,
                             offsets, build_lut)

    def set_use_two_encoders(self, b):
        self._lib.rve_enc_set_two(self._h, 1 if b else 0)

    def reset(self):
        self._lib.rve_enc_reset(self._h)

    def encode_y(self, symbols, cdf_group_index):
        """symbols: int16 (symbol << 8) + row id; the native call copies
        them before it returns."""
        symbols = np.ascontiguousarray(symbols, dtype=np.int16).reshape(-1)
        n_rows = self._group_rows(cdf_group_index)
        if symbols.size and int((symbols & 0xFF).max()) >= n_rows:
            raise IndexError("y row ids past the CDF group")
        self._lib.rve_enc_y(self._h, _ptr(symbols, ctypes.c_int16),
                            symbols.size, cdf_group_index)

    def encode_z(self, symbols, cdf_group_index, start_offset,
                 per_channel_size, interleaved=False, idx_base=0):
        symbols = np.ascontiguousarray(symbols, dtype=np.int8).reshape(-1)
        self._check_z(symbols.size, cdf_group_index, start_offset,
                      per_channel_size, interleaved, idx_base)
        self._lib.rve_enc_z(self._h, _ptr(symbols, ctypes.c_int8),
                            symbols.size, cdf_group_index, start_offset,
                            per_channel_size, 1 if interleaved else 0,
                            idx_base)

    def flush(self):
        self._lib.rve_enc_flush(self._h)

    def get_encoded_stream(self):
        """Waits for the flush; returns the bytes."""
        n = self._lib.rve_enc_stream_size(self._h)
        out = np.zeros(n, dtype=np.uint8)
        if n:
            self._lib.rve_enc_get_stream(self._h, _ptr(out, ctypes.c_uint8))
        return out.tobytes()


class RansDecoder(_Coder):
    _new, _free = "rve_dec_new", "rve_dec_free"

    def add_cdf(self, cdfs, cdf_sizes, offsets, build_lut=False):
        return self._add_cdf(self._lib.rve_dec_add_cdf, cdfs, cdf_sizes,
                             offsets, build_lut)

    def set_use_two_decoders(self, b):
        """Set before set_stream: the second decoder reads the stream
        from its end."""
        self._lib.rve_dec_set_two(self._h, 1 if b else 0)

    def set_stream(self, stream):
        data = np.frombuffer(bytes(stream), dtype=np.uint8)
        if data.size < 4:
            raise ValueError("a rANS stream starts with a 4-byte state")
        self._lib.rve_dec_set_stream(self._h, _ptr(data, ctypes.c_uint8),
                                     data.size)

    def decode_y(self, indexes, cdf_group_index):
        """Queues the decode of len(indexes) symbols (on the worker thread
        when threaded); get_decoded_tensor waits for them."""
        indexes = np.ascontiguousarray(indexes, dtype=np.uint8).reshape(-1)
        n_rows = self._group_rows(cdf_group_index)
        if indexes.size and int(indexes.max()) >= n_rows:
            raise IndexError("y row ids past the CDF group")
        self._lib.rve_dec_y(self._h, _ptr(indexes, ctypes.c_uint8),
                            indexes.size, cdf_group_index)

    def decode_z(self, total_size, cdf_group_index, start_offset,
                 per_channel_size, interleaved=False, idx_base=0):
        self._check_z(total_size, cdf_group_index, start_offset,
                      per_channel_size, interleaved, idx_base)
        self._lib.rve_dec_z(self._h, total_size, cdf_group_index,
                            start_offset, per_channel_size,
                            1 if interleaved else 0, idx_base)

    def get_decoded_tensor(self):
        """Waits for the queued decodes; returns the int8 symbols.  Raises
        ValueError when a decoder read past the stream's end or met an
        escape no int8 symbol makes (a truncated or corrupt stream)."""
        n = self._lib.rve_dec_size(self._h)
        if n < 0:
            raise ValueError("the rANS stream ended before its symbols did, "
                             "or is corrupt")
        out = np.zeros(n, dtype=np.int8)
        if n:
            self._lib.rve_dec_get(self._h, _ptr(out, ctypes.c_int8))
        return out

    def check_stream_end(self):
        """After a stream's last symbol: raises ValueError unless the
        decoders read every byte of it exactly once (two coders may share
        the encoder's trimmed tail) and each ended in the state its encoder
        started from.  A truncated, padded or corrupt stream fails."""
        rc = self._lib.rve_dec_check_end(self._h)
        if rc:
            raise ValueError(_END_ERRORS.get(rc, f"rANS stream check {rc}"))


_END_ERRORS = {
    -1: "the rANS stream ended before its symbols did, or is corrupt",
    -2: "the rANS stream's length does not match the bytes its symbols "
        "took",
    -3: "the rANS stream did not decode back to its initial state: it is "
        "corrupt",
}
