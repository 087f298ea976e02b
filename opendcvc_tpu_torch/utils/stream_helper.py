"""NAL-style bitstream syntax.

Byte-compatible with the reference stream container (reference:
src/utils/stream_helper.py:68-217): adaptive 1/2/4-byte uints, NAL header
nibbles, SPS dedup by (height, width, use_ada_i, ec_part), per-frame
payload = [flag byte | qp byte | adaptive length | rANS bytes].
Counterpart of the JAX package's `utils/stream_helper.py`, byte for byte.
"""

import enum
import struct
from pathlib import Path

import numpy as np


def filesize(filepath):
    if not Path(filepath).is_file():
        raise ValueError(f'Invalid file "{filepath}".')
    return Path(filepath).stat().st_size


def _check(cond, msg):
    if not cond:
        raise ValueError(msg)


def write_uchars(fd, values):
    fd.write(struct.pack(f">{len(values)}B", *values))
    return len(values)


def read_uchars(fd, n):
    return struct.unpack(f">{n}B", fd.read(n))


def write_bytes(fd, values):
    if len(values) == 0:
        return 0
    fd.write(values)
    return len(values)


def read_bytes(fd, n):
    return fd.read(n)


def write_uint_adaptive(f, a):
    """1 byte below 2^7, 2 bytes below 2^14, else 4 bytes (< 2^30)."""
    _check(0 <= a < (1 << 30), f"adaptive uint {a} outside [0, 2^30)")
    if a < (1 << 7):
        write_uchars(f, (a & 0xFF,))
        return 1
    if a < (1 << 14):
        a0 = a & 0xFF
        a1 = ((a >> 8) & 0xFF) | (0x02 << 6)
        write_uchars(f, (a1, a0))
        return 2
    a0 = a & 0xFF
    a1 = (a >> 8) & 0xFF
    a2 = (a >> 16) & 0xFF
    a3 = ((a >> 24) & 0xFF) | (0x03 << 6)
    write_uchars(f, (a3, a2, a1, a0))
    return 4


def read_uint_adaptive(f):
    a3 = read_uchars(f, 1)[0]
    if (a3 >> 7) == 0:
        return a3
    a2 = read_uchars(f, 1)[0]
    if (a3 >> 6) == 0x02:
        return ((a3 & 0x3F) << 8) + a2
    a1 = read_uchars(f, 1)[0]
    a0 = read_uchars(f, 1)[0]
    return ((a3 & 0x3F) << 24) + (a2 << 16) + (a1 << 8) + a0


class NalType(enum.IntEnum):
    NAL_SPS = 0
    NAL_I = 1
    NAL_P = 2


class SPSHelper:
    """Sequence-parameter-set registry, <= 16 live ids."""

    def __init__(self):
        self.spss = []

    def get_sps_id(self, target):
        min_id = -1
        for sps in self.spss:
            if (sps["height"] == target["height"]
                    and sps["width"] == target["width"]
                    and sps["use_ada_i"] == target["use_ada_i"]
                    and sps["ec_part"] == target["ec_part"]):
                return sps["sps_id"], False
            min_id = max(min_id, sps["sps_id"])
        _check(min_id < 15, "no SPS id left (16 live)")
        sps = dict(target)
        sps["sps_id"] = min_id + 1
        self.spss.append(sps)
        return sps["sps_id"], True

    def add_sps_by_id(self, sps):
        for i, s in enumerate(self.spss):
            if s["sps_id"] == sps["sps_id"]:
                self.spss[i] = dict(sps)
                return
        self.spss.append(dict(sps))

    def get_sps_by_id(self, sps_id):
        for sps in self.spss:
            if sps["sps_id"] == sps_id:
                return sps
        return None


def write_sps(f, sps):
    _check(0 <= sps["sps_id"] < 16, "sps_id outside [0, 16)")
    _check(sps["use_ada_i"] in (0, 1) and sps["ec_part"] in (0, 1),
           "use_ada_i and ec_part are one bit each")
    written = 0
    flag = (int(NalType.NAL_SPS) << 4) + sps["sps_id"]
    written += write_uchars(f, (flag,))
    written += write_uint_adaptive(f, sps["height"])
    written += write_uint_adaptive(f, sps["width"])
    flag = (sps["ec_part"] << 2) + sps["use_ada_i"]
    written += write_uchars(f, (flag,))
    return written


def read_header(f):
    header = {}
    flag = read_uchars(f, 1)[0]
    nal_type = flag >> 4
    header["nal_type"] = NalType(nal_type)
    header["sps_id"] = flag & 0x0F
    return header


def read_sps_remaining(f, sps_id):
    sps = {"sps_id": sps_id}
    sps["height"] = read_uint_adaptive(f)
    sps["width"] = read_uint_adaptive(f)
    flag = read_uchars(f, 1)[0]
    sps["ec_part"] = (flag >> 2) & 0x01
    sps["use_ada_i"] = flag & 0x01
    return sps


def write_ip(f, is_i_frame, sps_id, qp, bit_stream):
    written = 0
    flag = (int(NalType.NAL_I if is_i_frame else NalType.NAL_P) << 4) + sps_id
    written += write_uchars(f, (flag,))
    _check(0 <= qp < 256, f"qp {qp} outside [0, 256)")
    written += write_uchars(f, (qp,))
    written += write_uint_adaptive(f, len(bit_stream))
    written += write_bytes(f, bit_stream)
    return written


def read_ip_remaining(f):
    qp = read_uchars(f, 1)[0]
    stream_length = read_uint_adaptive(f)
    bit_stream = read_bytes(f, stream_length)
    return qp, bit_stream


# ---------------------------------------------------------------------------
# flat intra-only container + continuous-rate helpers (EVC / HEM era,
# reference: DCVC-family/EVC/src/utils/stream_helper.py:40-144)
# ---------------------------------------------------------------------------

def write_uints(fd, values):
    fd.write(struct.pack(f">{len(values)}I", *values))
    return len(values) * 4


def read_uints(fd, n):
    return struct.unpack(f">{n}I", fd.read(n * 4))


def write_ushorts(fd, values):
    fd.write(struct.pack(f">{len(values)}H", *values))
    return len(values) * 2


def read_ushorts(fd, n):
    return struct.unpack(f">{n}H", fd.read(n * 2))


def get_rounded_q(q_scale):
    """Quantize a continuous rate scalar to 1/100 steps for the header."""
    q_scale = min(max(float(q_scale), 0.01), 655.0)
    q_index = int(round(q_scale * 100))
    return q_index / 100, q_index


def encode_i(height, width, q_index, bit_stream, output):
    with Path(output).open("wb") as f:
        write_uints(f, (height, width))
        write_ushorts(f, (q_index,))
        write_uints(f, (len(bit_stream),))
        write_bytes(f, bit_stream)


def decode_i(inputpath):
    with Path(inputpath).open("rb") as f:
        height, width = read_uints(f, 2)
        q_index = read_ushorts(f, 1)[0]
        stream_length = read_uints(f, 1)[0]
        bit_stream = read_bytes(f, stream_length)
    return height, width, q_index, bit_stream


def interpolate_log(min_val, max_val, num, decending=True):
    """Log-spaced rate ladder between anchor q_scales (HEM-era harness
    convention)."""
    if num <= 1 or not min_val < max_val:
        raise ValueError("interpolate_log needs num > 1 and min_val < "
                         "max_val")
    if decending:
        values = np.linspace(np.log(max_val), np.log(min_val), num)
    else:
        values = np.linspace(np.log(min_val), np.log(max_val), num)
    return np.exp(values).tolist()
