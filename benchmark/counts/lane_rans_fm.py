"""K2 launches of a DCVC-FM device-EC period for `k2_roofline_pct`, read
from each frame's v6 ("tpu-lane") container with `lane_rans.py`'s header
reader and counted with its `k2_bytes`.

A frame's planes, in decode order, each one K2 launch over the
container's L lanes (K = ceil(symbols / L) steps), reading its table
slice:
  * DMCIFM: z (128 channels at 1/64; the qp's 128 z rows), then four y
    quarters (256 channels at 1/16, a quarter's 64 folded channels each;
    the 256 Gaussian rows);
  * DMCFM: the motion z (64 channels at 1/64; 1 pad row + 64), four
    motion quarters (64 channels at 1/16, 16 folded each), z (64
    channels; 1 + 64 rows), four y quarters (128 channels, 32 each), the
    quarters on the 256 Laplace rows.
The payload words are counted once a frame, with its first launch."""

from . import lane_rans

Y_ROWS = 256
I_Z_CH, I_Y_CH = 128, 256
P_MVZ_CH, P_MV_CH, P_Z_CH, P_Y_CH = 64, 64, 64, 128


def frame_launches(stream, intra, height, width):
    """[(K, L, rows, words)] of one frame's K2 launches at a padded frame
    size; raises where the container's steps do not split that way."""
    h = lane_rans.parse_header(stream)
    if h["kyc"]:
        raise ValueError("skip-compacted containers are not counted")
    lanes = h["L"]
    zh, zw = -(-height // 64), -(-width // 64)
    yh, yw = height // 16, width // 16

    def steps(n):
        return -(-n // lanes)

    if intra:
        planes = [(I_Z_CH * zh * zw, I_Z_CH)] + \
            [(I_Y_CH // 4 * yh * yw, Y_ROWS)] * 4
    else:
        planes = [(P_MVZ_CH * zh * zw, 1 + P_MVZ_CH)] + \
            [(P_MV_CH // 4 * yh * yw, Y_ROWS)] * 4 + \
            [(P_Z_CH * zh * zw, 1 + P_Z_CH)] + \
            [(P_Y_CH // 4 * yh * yw, Y_ROWS)] * 4
    out = [(steps(n), lanes, rows, 0) for n, rows in planes]
    if sum(k for k, _, _, _ in out) != h["K"]:
        raise ValueError(f"container steps {h['K']} do not split as "
                         f"{[k for k, _, _, _ in out]}")
    out[0] = out[0][:3] + (h["total"],)
    return out


def period_launches(streams, height, width):
    """K2 launches of an FM period: its I-frame, then P-frames."""
    return [frame_launches(s, t == 0, height, width)
            for t, s in enumerate(streams)]
