"""EntropyCoder: a paired host rANS encoder/decoder with one CDF registry.

Counterpart of the JAX package's `entropy/coder.py`.  Symbol conventions:
  * y symbols arrive packed as int16 = (int8 symbol << 8) + uint8 CDF
    index; the codecs pack them on the device so one small int16 buffer
    crosses to the host;
  * z symbols are int8, flattened NHWC; the CDF row of element i is
    i % C + qp * C (interleaved mode).
Each coding call is a trace span `coder.<call>` (utils/trace.py), so every
codec's host coder is timed where it runs.
"""

import numpy as np

from ..utils import trace
from .rans import RansDecoder, RansEncoder


class EntropyCoder:
    def __init__(self, threaded=None):
        self.encoder = RansEncoder(threaded=threaded)
        self.decoder = RansDecoder(threaded=threaded)

    def add_cdf(self, cdf, cdf_length, offset, build_lut=False):
        enc_idx = self.encoder.add_cdf(cdf, cdf_length, offset,
                                       build_lut=False)
        dec_idx = self.decoder.add_cdf(cdf, cdf_length, offset,
                                       build_lut=build_lut)
        if enc_idx != dec_idx:
            raise RuntimeError("encoder and decoder CDF registries differ")
        return enc_idx

    @trace.spanned("coder.reset")
    def reset(self):
        self.encoder.reset()

    def set_use_two_entropy_coders(self, b):
        self.encoder.set_use_two_encoders(b)
        self.decoder.set_use_two_decoders(b)

    @trace.spanned("coder.encode_y")
    def encode_y(self, packed_symbols, cdf_group_index):
        symbols = np.asarray(packed_symbols)
        if symbols.dtype != np.int16:
            raise TypeError("y symbols are packed int16")
        self.encoder.encode_y(symbols, cdf_group_index)

    @trace.spanned("coder.encode_z")
    def encode_z(self, symbols, cdf_group_index, start_offset, channels,
                 idx_base=0):
        self.encoder.encode_z(np.asarray(symbols, dtype=np.int8),
                              cdf_group_index, start_offset, channels,
                              interleaved=True, idx_base=idx_base)

    @trace.spanned("coder.flush")
    def flush(self):
        self.encoder.flush()

    @trace.spanned("coder.get_encoded_stream")
    def get_encoded_stream(self):
        return self.encoder.get_encoded_stream()

    @trace.spanned("coder.set_stream")
    def set_stream(self, stream):
        self.decoder.set_stream(stream)

    @trace.spanned("coder.decode_y")
    def decode_y(self, indexes, cdf_group_index):
        self.decoder.decode_y(np.asarray(indexes, dtype=np.uint8),
                              cdf_group_index)

    def decode_and_get_y(self, indexes, cdf_group_index):
        self.decode_y(indexes, cdf_group_index)
        return self.get_decoded_tensor()

    @trace.spanned("coder.decode_z")
    def decode_z(self, total_size, cdf_group_index, start_offset, channels,
                 idx_base=0):
        self.decoder.decode_z(total_size, cdf_group_index, start_offset,
                              channels, interleaved=True,
                              idx_base=idx_base)

    @trace.spanned("coder.get_decoded_tensor")
    def get_decoded_tensor(self):
        return self.decoder.get_decoded_tensor()

    def check_stream_end(self):
        self.decoder.check_stream_end()
