"""Pure-Python rANS coder — the plain version of the host coder.

Bit-exact with the native C++ runtime (csrc/rans.cpp); the tests hold the
native coder against it.  The port's codecs never fall back to it: a
codec that cannot build the native coder raises.  Counterpart of the JAX
package's `entropy/rans_py.py`.  Format semantics follow the DCVC-family
stream format (the DCVC sources' src/cpp/py_rans/rans_byte.h and
rans.cpp): 16-bit probabilities, 23-bit renorm bound, byte-aligned
emission, 2-bit bypass escapes, reverse deferred encoding, optional
dual-coder head-to-head packing.
"""

import numpy as np

SCALE_BITS = 16
SHIFT_BITS = 23
LOW_BOUND = 1 << SHIFT_BITS
ENC_RENORM_SHIFT = SHIFT_BITS - SCALE_BITS + 8
DEC_MASK = (1 << SCALE_BITS) - 1
BYPASS_BITS = 2
MAX_BYPASS_VAL = (1 << BYPASS_BITS) - 1
MASK32 = 0xFFFFFFFF


class _Encoder:
    """Single-stream deferred rANS encoder."""

    def __init__(self):
        self.groups = []  # (cdfs list-of-list, sizes, offsets)
        self.tasks = []
        self.stream = b""

    def add_cdf(self, cdfs, sizes, offsets):
        self.groups.append((
            [list(map(int, row)) for row in cdfs],
            list(map(int, sizes)),
            list(map(int, offsets)),
        ))
        return len(self.groups) - 1

    def clear_cdfs(self):
        self.groups = []

    def reset(self):
        self.tasks = []
        self.stream = b""

    def encode_y(self, symbols, group):
        self.tasks.append(("y", np.asarray(symbols, dtype=np.int16), group,
                           0, 0, 0, 0))

    def encode_z(self, symbols, group, start_offset, per_channel, idx_base,
                 interleaved):
        self.tasks.append(("z", np.asarray(symbols, dtype=np.int8), group,
                           start_offset, per_channel, idx_base, interleaved))

    def _put(self, out, state, start, freq):
        x_max = freq << ENC_RENORM_SHIFT
        while state >= x_max:
            out.append(state & 0xFF)
            state >>= 8
        return ((state // freq) << SCALE_BITS) + (state % freq) + start

    def _put_bits(self, out, state, val):
        freq = 1 << (SCALE_BITS - BYPASS_BITS)
        x_max = freq << ENC_RENORM_SHIFT
        while state >= x_max:
            out.append(state & 0xFF)
            state >>= 8
        return ((state << BYPASS_BITS) | val) & MASK32

    def _encode_one(self, out, state, symbol, cdf, cdf_size, offset):
        max_value = cdf_size - 2
        value = symbol - offset
        raw_val = 0
        if value < 0:
            raw_val = -2 * value - 1
            value = max_value
        elif value >= max_value:
            raw_val = 2 * (value - max_value)
            value = max_value
        if value == max_value:
            bins = []
            n_bypass = 0
            while (raw_val >> (n_bypass * BYPASS_BITS)) != 0:
                n_bypass += 1
            val = n_bypass
            while val >= MAX_BYPASS_VAL:
                bins.append(MAX_BYPASS_VAL)
                val -= MAX_BYPASS_VAL
            bins.append(val)
            for j in range(n_bypass):
                bins.append((raw_val >> (j * BYPASS_BITS)) & MAX_BYPASS_VAL)
            for b in reversed(bins):
                state = self._put_bits(out, state, b)
        start = cdf[value]
        freq = cdf[value + 1] - cdf[value]
        return self._put(out, state, start, freq)

    def flush(self):
        total = sum(len(t[1]) for t in self.tasks)
        if total == 0:
            self.stream = b""
            return
        out = bytearray()  # emitted in reverse; reversed at the end
        state = LOW_BOUND
        for kind, syms, group, start_offset, per_channel, idx_base, \
                interleaved in reversed(self.tasks):
            cdfs, sizes, offsets = self.groups[group]
            if kind == "y":
                for i in range(len(syms) - 1, -1, -1):
                    combined = int(syms[i])
                    cdf_idx = combined & 0xFF
                    s = combined >> 8
                    state = self._encode_one(out, state, s, cdfs[cdf_idx],
                                             sizes[cdf_idx], offsets[cdf_idx])
            else:
                for i in range(len(syms) - 1, -1, -1):
                    if interleaved:
                        cdf_idx = (idx_base + i) % per_channel + start_offset
                    else:
                        cdf_idx = (idx_base + i) // per_channel + start_offset
                    state = self._encode_one(out, state, int(syms[i]),
                                             cdfs[cdf_idx], sizes[cdf_idx],
                                             offsets[cdf_idx])
        # flush the 4-byte state (little-endian, prepended)
        for shift in (24, 16, 8, 0):
            out.append((state >> shift) & 0xFF)
        out.reverse()
        self.stream = bytes(out)
        self.tasks = []

    def get_stream(self):
        return self.stream


class _Decoder:
    """Single-stream rANS decoder."""

    def __init__(self):
        self.groups = []
        self.stream = b""
        self.pos = 0
        self.state = 0
        self.decoded = np.zeros(0, dtype=np.int8)

    def add_cdf(self, cdfs, sizes, offsets):
        self.groups.append((
            [list(map(int, row)) for row in cdfs],
            list(map(int, sizes)),
            list(map(int, offsets)),
        ))
        return len(self.groups) - 1

    def clear_cdfs(self):
        self.groups = []

    def set_stream(self, data):
        self.stream = bytes(data)
        self.pos = 4
        self.state = int.from_bytes(self.stream[:4], "little")

    def _get_bits(self):
        val = self.state & MAX_BYPASS_VAL
        self.state >>= BYPASS_BITS
        if self.state < LOW_BOUND:
            self.state = (self.state << 8) | self.stream[self.pos]
            self.pos += 1
        return val

    def _decode_one(self, cdf, cdf_size, offset):
        max_value = cdf_size - 2
        f = self.state & DEC_MASK
        s = 1
        while cdf[s] <= f:
            s += 1
        s -= 1
        start = cdf[s]
        freq = cdf[s + 1] - cdf[s]
        self.state = freq * (self.state >> SCALE_BITS) + f - start
        while self.state < LOW_BOUND:
            self.state = (self.state << 8) | self.stream[self.pos]
            self.pos += 1
        value = s
        if value == max_value:
            val = self._get_bits()
            n_bypass = val
            while val == MAX_BYPASS_VAL:
                val = self._get_bits()
                n_bypass += val
            raw_val = 0
            for j in range(n_bypass):
                raw_val |= self._get_bits() << (j * BYPASS_BITS)
            value = raw_val >> 1
            if raw_val & 1:
                value = -value - 1
            else:
                value += max_value
        # modular int8 wrap, matching the C static_cast<int8_t>
        return ((value + offset + 128) % 256) - 128

    def decode_y(self, indexes, group):
        cdfs, sizes, offsets = self.groups[group]
        out = np.zeros(len(indexes), dtype=np.int8)
        for i, idx in enumerate(np.asarray(indexes, dtype=np.uint8)):
            out[i] = self._decode_one(cdfs[idx], sizes[idx], offsets[idx])
        self.decoded = out

    def decode_z(self, total, group, start_offset, per_channel, idx_base,
                 interleaved):
        cdfs, sizes, offsets = self.groups[group]
        out = np.zeros(total, dtype=np.int8)
        for i in range(total):
            if interleaved:
                cdf_idx = (idx_base + i) % per_channel + start_offset
            else:
                cdf_idx = (idx_base + i) // per_channel + start_offset
            out[i] = self._decode_one(cdfs[cdf_idx], sizes[cdf_idx],
                                      offsets[cdf_idx])
        self.decoded = out

    def get_decoded(self):
        return self.decoded


def pack_two_streams(s0, s1):
    """Head-to-head packing with trailing-identical-byte trim."""
    n0, n1 = len(s0), len(s1)
    identical = 0
    for i in range(min(n0, n1, 8)):
        if s0[n0 - 1 - i] != 0 or s1[n1 - 1 - i] != 0:
            break
        identical += 1
    if identical == 0 and n0 > 0 and n1 > 0 and s0[-1] == s1[-1]:
        identical = 1
    return s0 + bytes(reversed(s1[: n1 - identical]))


class PyEncoderPair:
    """Pure-Python mirror of the native EncoderPair."""

    def __init__(self, threaded=False):
        self.e0 = _Encoder()
        self.e1 = _Encoder()
        self.use_two = False

    def add_cdf(self, cdfs, sizes, offsets, build_lut=False):
        idx = self.e0.add_cdf(cdfs, sizes, offsets)
        self.e1.add_cdf(cdfs, sizes, offsets)
        return idx

    def clear_cdfs(self):
        self.e0.clear_cdfs()
        self.e1.clear_cdfs()

    def set_two(self, two):
        self.use_two = bool(two)

    def reset(self):
        self.e0.reset()
        self.e1.reset()

    def encode_y(self, symbols, group):
        symbols = np.asarray(symbols, dtype=np.int16).reshape(-1)
        if self.use_two:
            n0 = len(symbols) // 2
            self.e0.encode_y(symbols[:n0], group)
            self.e1.encode_y(symbols[n0:], group)
        else:
            self.e0.encode_y(symbols, group)

    def encode_z(self, symbols, group, start_offset, per_channel,
                 interleaved=0, idx_base=0):
        symbols = np.asarray(symbols, dtype=np.int8).reshape(-1)
        if self.use_two:
            n0 = len(symbols) // 2
            self.e0.encode_z(symbols[:n0], group, start_offset, per_channel,
                             idx_base, interleaved)
            self.e1.encode_z(symbols[n0:], group, start_offset, per_channel,
                             idx_base + n0, interleaved)
        else:
            self.e0.encode_z(symbols, group, start_offset, per_channel,
                             idx_base, interleaved)

    def flush(self):
        self.e0.flush()
        self.e1.flush()

    def get_stream(self):
        if self.use_two:
            return pack_two_streams(self.e0.get_stream(),
                                    self.e1.get_stream())
        return self.e0.get_stream()


class PyDecoderPair:
    """Pure-Python mirror of the native DecoderPair."""

    def __init__(self, threaded=False):
        self.d0 = _Decoder()
        self.d1 = _Decoder()
        self.use_two = False
        self._pending = []

    def add_cdf(self, cdfs, sizes, offsets, build_lut=False):
        idx = self.d0.add_cdf(cdfs, sizes, offsets)
        self.d1.add_cdf(cdfs, sizes, offsets)
        return idx

    def clear_cdfs(self):
        self.d0.clear_cdfs()
        self.d1.clear_cdfs()

    def set_two(self, two):
        self.use_two = bool(two)

    def set_stream(self, data):
        data = bytes(data)
        self.d0.set_stream(data)
        if self.use_two:
            self.d1.set_stream(bytes(reversed(data)))

    def decode_y(self, indexes, group):
        indexes = np.asarray(indexes, dtype=np.uint8).reshape(-1)
        if self.use_two:
            n0 = len(indexes) // 2
            self.d0.decode_y(indexes[:n0], group)
            self.d1.decode_y(indexes[n0:], group)
        else:
            self.d0.decode_y(indexes, group)

    def decode_z(self, total, group, start_offset, per_channel,
                 interleaved=0, idx_base=0):
        if self.use_two:
            n0 = total // 2
            self.d0.decode_z(n0, group, start_offset, per_channel,
                             idx_base, interleaved)
            self.d1.decode_z(total - n0, group, start_offset, per_channel,
                             idx_base + n0, interleaved)
        else:
            self.d0.decode_z(total, group, start_offset, per_channel,
                             idx_base, interleaved)

    def get_decoded(self):
        if self.use_two:
            return np.concatenate([self.d0.get_decoded(),
                                   self.d1.get_decoded()])
        return self.d0.get_decoded()
