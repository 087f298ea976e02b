"""Published RD and speed numbers of the reference models, as data.

Counterpart of the JAX package's `eval/published_results.py` (the
reference's results-as-code and README headline tables), for checking
trained models and plotting against the papers' curves.  These are the
papers' own numbers: EVC's on Kodak, DCVC-RT's on an NVIDIA A100 in
fp16.  None of them was measured on this port or its card; the port's
own times are in PERF.md.  `bd_rate` is the Bjontegaard delta rate.
"""

import numpy as np

# EVC on Kodak (encoder/decoder width variants), bpp <-> PSNR(dB)
EVC_KODAK = {
    "EncL_DecL": {"bpp": [0.328, 0.501, 0.732, 0.981],
                  "psnr": [32.48, 34.48, 36.42, 37.86]},
    "EncS_DecS": {"bpp": [0.339, 0.514, 0.750, 1.001],
                  "psnr": [32.32, 34.24, 36.09, 37.40]},
}

# DCVC-RT headline numbers (A100, fp16, dual entropy coders)
DCVC_RT = {
    "1080p_encode_fps": 125.2,
    "1080p_decode_fps": 112.8,
    "bitrate_vs_vtm_pct": -21.0,      # UVG YUV420, intra period -1
    "intra_1080p_encode_fps": 40.7,
    "intra_1080p_decode_fps": 44.2,
    "intra_bitrate_vs_vtm_kodak_pct": -11.1,
}

# evaluation protocol constants (reference test_conditions.md:16-75)
PROTOCOL = {
    "frames": 96,
    "intra_periods": [32, 96, -1],
    "yuv_psnr_weights": (6, 1, 1),    # PSNR_avg = (6Y + U + V) / 8
    "pad_dont_crop": True,
}


def bd_rate(r1, p1, r2, p2):
    """Bjontegaard delta-rate between two RD curves (log-rate cubic
    fit), in percent.  r*: bpp lists; p*: PSNR lists."""
    lr1, lr2 = np.log(np.asarray(r1)), np.log(np.asarray(r2))
    p1, p2 = np.asarray(p1), np.asarray(p2)
    f1 = np.polyfit(p1, lr1, 3)
    f2 = np.polyfit(p2, lr2, 3)
    lo = max(p1.min(), p2.min())
    hi = min(p1.max(), p2.max())
    i1 = np.polyint(f1)
    i2 = np.polyint(f2)
    avg1 = (np.polyval(i1, hi) - np.polyval(i1, lo)) / (hi - lo)
    avg2 = (np.polyval(i2, hi) - np.polyval(i2, lo)) / (hi - lo)
    return (np.exp(avg2 - avg1) - 1) * 100
