"""DCVC-FM bitstream syntax.

Counterpart of the JAX package's `utils/stream_helper_fm.py`, byte for
byte (reference: DCVC-FM's stream_helper.py): the SPS carries qp (6 bits)
and fa_idx (2 bits) in place of ec_part / use_ada_i, an I/P record has no
qp byte, and NAL_Ps packs several P-frames' shared stream into one record
(their sps ids nibble-packed after the header).  Out-of-range fields
raise ValueError.
"""

import enum

from .stream_helper import (_check, read_bytes, read_uchars,
                            read_uint_adaptive, write_bytes, write_uchars,
                            write_uint_adaptive)


class NalType(enum.IntEnum):
    NAL_SPS = 0
    NAL_I = 1
    NAL_P = 2
    NAL_Ps = 3


class SPSHelper:
    """SPS registry keyed on (height, width, qp, fa_idx), <= 16 live
    ids."""

    def __init__(self):
        self.spss = []

    def get_sps_id(self, target):
        min_id = -1
        for sps in self.spss:
            if (sps["height"] == target["height"]
                    and sps["width"] == target["width"]
                    and sps["qp"] == target["qp"]
                    and sps["fa_idx"] == target["fa_idx"]):
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
    _check(0 <= sps["qp"] < 64, f"qp {sps['qp']} outside [0, 64)")
    _check(0 <= sps["fa_idx"] < 4, f"fa_idx {sps['fa_idx']} outside [0, 4)")
    written = write_uchars(f, ((int(NalType.NAL_SPS) << 4) + sps["sps_id"],))
    written += write_uint_adaptive(f, sps["height"])
    written += write_uint_adaptive(f, sps["width"])
    written += write_uchars(f, ((sps["qp"] << 2) + sps["fa_idx"],))
    return written


def read_header(f):
    """{"nal_type", "sps_id"} of an SPS / I / P record; {"nal_type",
    "frame_num", "sps_ids"} of a NAL_Ps record."""
    header = {}
    flag = read_uchars(f, 1)[0]
    nal_type = flag >> 4
    header["nal_type"] = NalType(nal_type)
    if nal_type < NalType.NAL_Ps:
        header["sps_id"] = flag & 0x0F
        return header
    frame_num = (flag & 0x0F) + 1
    header["frame_num"] = frame_num
    sps_ids = []
    for _ in range(0, frame_num, 2):
        b = read_uchars(f, 1)[0]
        sps_ids += [b >> 4, b & 0x0F]
    header["sps_ids"] = sps_ids[:frame_num]
    return header


def read_sps_remaining(f, sps_id):
    sps = {"sps_id": sps_id}
    sps["height"] = read_uint_adaptive(f)
    sps["width"] = read_uint_adaptive(f)
    flag = read_uchars(f, 1)[0]
    sps["qp"] = flag >> 2
    sps["fa_idx"] = flag & 0x03
    return sps


def write_ip(f, is_i_frame, sps_id, bit_stream):
    _check(0 <= sps_id < 16, "sps_id outside [0, 16)")
    nal = NalType.NAL_I if is_i_frame else NalType.NAL_P
    written = write_uchars(f, ((int(nal) << 4) + sps_id,))
    written += write_uint_adaptive(f, len(bit_stream))
    written += write_bytes(f, bit_stream)
    return written


def read_ip_remaining(f):
    """The record's stream; one shorter than its length raises
    ValueError."""
    stream_length = read_uint_adaptive(f)
    stream = read_bytes(f, stream_length)
    _check(len(stream) == stream_length,
           f"record of {stream_length} bytes ends after {len(stream)}")
    return stream


def write_p_frames(f, sps_ids, bit_stream):
    """Pack several P-frames (one shared rANS stream) into one NAL_Ps."""
    _check(1 <= len(sps_ids) <= 16, f"{len(sps_ids)} frames in one NAL_Ps")
    _check(all(0 <= i < 16 for i in sps_ids), "sps_id outside [0, 16)")
    written = write_uchars(f, ((int(NalType.NAL_Ps) << 4)
                               + len(sps_ids) - 1,))
    ids = list(sps_ids) + [0] * (len(sps_ids) % 2)
    for i in range(0, len(ids), 2):
        written += write_uchars(f, ((ids[i] << 4) + ids[i + 1],))
    written += write_uint_adaptive(f, len(bit_stream))
    written += write_bytes(f, bit_stream)
    return written
