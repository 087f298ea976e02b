"""N-part entropy-coder stream split (the DC/FM generation).

Counterpart of the JAX package's `entropy/nparts.py` (reference: the
DCVC-DC/FM native coder's `streamPart` mode).  Each coding call divides
its symbols across N independent host rANS coders, contiguously and as
evenly as possible (n // N each, the last part takes the remainder), and
the frame's stream packs as

  flag u8 = ((N - 1) << 4) | (1 if every part but the last fits a u16)
  N - 1 part sizes (u16 or u32, little-endian)
  the part streams back to back

With stream_part=1 the flag byte still leads.  A z plane's parts start
mid channel cycle, so each part passes its absolute start offset
(`idx_base`) to its coder and picks the same CDF row per element as one
coder over the whole plane.  Each part is an `EntropyCoder` (its own
worker thread when the coder is threaded); threading changes no byte.
"""

import numpy as np

from .coder import EntropyCoder


def _split_sizes(n, parts):
    each = n // parts
    return [each] * (parts - 1) + [n - each * (parts - 1)]


class NPartEntropyCoder:
    """EntropyCoder's interface over `stream_part` coders and the N-part
    container."""

    def __init__(self, stream_part=1, threaded=None):
        if stream_part < 1 or stream_part > 16:
            raise ValueError(f"stream_part {stream_part} outside [1, 16]")
        self.stream_part = stream_part
        self.parts = [EntropyCoder(threaded=threaded)
                      for _ in range(stream_part)]

    # -- shared setup --------------------------------------------------------

    def add_cdf(self, cdf, cdf_length, offset, build_lut=False):
        idx = None
        for p in self.parts:
            idx = p.add_cdf(cdf, cdf_length, offset, build_lut=build_lut)
        return idx

    def reset(self):
        for p in self.parts:
            p.reset()

    def set_use_two_entropy_coders(self, b):
        """The dual-coder split is the RT generation's; the N-part split
        takes its place, so more than one part refuses it (as the JAX
        package's NPartEntropyCoder asserts)."""
        if b and self.stream_part > 1:
            raise ValueError(f"two entropy coders with stream_part "
                             f"{self.stream_part}: the N-part split takes "
                             f"the dual coders' place")

    # -- encode --------------------------------------------------------------

    def encode_y(self, packed_symbols, cdf_group_index):
        symbols = np.asarray(packed_symbols, dtype=np.int16).reshape(-1)
        off = 0
        for p, sz in zip(self.parts,
                         _split_sizes(symbols.size, self.stream_part)):
            p.encode_y(symbols[off:off + sz], cdf_group_index)
            off += sz

    def encode_z(self, symbols, cdf_group_index, start_offset, channels):
        symbols = np.asarray(symbols, dtype=np.int8).reshape(-1)
        off = 0
        for p, sz in zip(self.parts,
                         _split_sizes(symbols.size, self.stream_part)):
            p.encode_z(symbols[off:off + sz], cdf_group_index,
                       start_offset, channels, idx_base=off)
            off += sz

    def flush(self):
        for p in self.parts:
            p.flush()

    def get_encoded_stream(self):
        streams = [p.get_encoded_stream() for p in self.parts]
        max_head = max((len(s) for s in streams[:-1]), default=0)
        per_head = 4 if max_head > 65535 else 2
        flag = ((self.stream_part - 1) << 4) | (1 if per_head == 2 else 0)
        size_type = "<u2" if per_head == 2 else "<u4"
        out = [bytes([flag])]
        out += [np.array(len(s), size_type).tobytes() for s in streams[:-1]]
        out += streams
        return b"".join(out)

    # -- decode --------------------------------------------------------------

    def set_stream(self, stream):
        """Split a frame's stream into its parts; a stream of another part
        count or shorter than its header says raises ValueError."""
        stream = bytes(stream)
        if not stream:
            raise ValueError("empty N-part stream")
        flag = stream[0]
        n = (flag >> 4) + 1
        if n != self.stream_part:
            raise ValueError(f"a {n}-part stream for a {self.stream_part}"
                             f"-part coder")
        per_head = 2 if (flag & 1) else 4
        off = 1 + (n - 1) * per_head
        if len(stream) < off:
            raise ValueError("N-part stream ends inside its header")
        sizes = [int.from_bytes(stream[1 + i * per_head:
                                       1 + (i + 1) * per_head], "little")
                 for i in range(n - 1)]
        if off + sum(sizes) > len(stream):
            raise ValueError("N-part stream shorter than its part sizes")
        for i, p in enumerate(self.parts):
            end = off + sizes[i] if i < n - 1 else len(stream)
            p.set_stream(stream[off:end])
            off = end

    def decode_y(self, indexes, cdf_group_index):
        indexes = np.asarray(indexes, dtype=np.uint8).reshape(-1)
        off = 0
        for p, sz in zip(self.parts,
                         _split_sizes(indexes.size, self.stream_part)):
            p.decode_y(indexes[off:off + sz], cdf_group_index)
            off += sz

    def decode_z(self, total_size, cdf_group_index, start_offset,
                 channels):
        off = 0
        for p, sz in zip(self.parts,
                         _split_sizes(total_size, self.stream_part)):
            p.decode_z(sz, cdf_group_index, start_offset, channels,
                       idx_base=off)
            off += sz

    def get_decoded_tensor(self):
        """The last decode's symbols, the parts' concatenated."""
        return np.concatenate([p.get_decoded_tensor() for p in self.parts])

    def check_stream_end(self):
        for p in self.parts:
            p.check_stream_end()
