"""Misc host utilities: flags, folders, JSON logs (reference:
src/utils/common.py).  The port's copy of the JAX package's
`utils/common.py`, numpy only."""

import json
import os

import numpy as np


def str2bool(v):
    return str(v).lower() in ("yes", "y", "true", "t", "1")


def env_flag(name, default=False):
    """Uniform boolean env-flag parsing for every OPENDCVC_TPU_* switch:
    unset -> default; set -> false only for the explicit off spellings
    ('', '0', 'false', 'no', any case)."""
    v = os.environ.get(name)
    if v is None:
        return bool(default)
    return v.strip().lower() not in ("", "0", "false", "no")


def create_folder(path, print_if_create=False):
    if not os.path.exists(path):
        os.makedirs(path, exist_ok=True)
        if print_if_create:
            print(f"created folder: {path}")


def dump_json(obj, fid, float_digits=-1, **kwargs):
    """JSON dump with fixed float precision."""
    if float_digits >= 0:
        def roundf(o):
            if isinstance(o, float):
                return round(o, float_digits)
            if isinstance(o, dict):
                return {k: roundf(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return [roundf(v) for v in o]
            return o
        obj = roundf(obj)
    json.dump(obj, fid, **kwargs)


def generate_log_json(frame_num, frame_pixel_num, test_time, frame_types,
                      bits, psnrs, ssims, verbose=False,
                      avg_encoding_time=None, avg_decoding_time=None):
    """Per-sequence RD summary with the reference's field layout
    (reference: src/utils/common.py:63-177)."""
    include_yuv = len(psnrs[0]) > 1
    assert not include_yuv or (len(psnrs[0]) == 4 and len(ssims[0]) == 4)

    acc = {"i": {"bits": 0.0, "psnr": np.zeros(4), "ssim": np.zeros(4),
                 "num": 0},
           "p": {"bits": 0.0, "psnr": np.zeros(4), "ssim": np.zeros(4),
                 "num": 0}}
    for idx in range(frame_num):
        key = "i" if frame_types[idx] == 0 else "p"
        acc[key]["bits"] += bits[idx]
        pv = np.zeros(4)
        sv = np.zeros(4)
        pv[:len(psnrs[idx])] = psnrs[idx]
        sv[:len(ssims[idx])] = ssims[idx]
        acc[key]["psnr"] += pv
        acc[key]["ssim"] += sv
        acc[key]["num"] += 1

    log = {}
    log["frame_pixel_num"] = frame_pixel_num
    log["i_frame_num"] = acc["i"]["num"]
    log["p_frame_num"] = acc["p"]["num"]
    i_num = max(acc["i"]["num"], 1)
    log["ave_i_frame_bpp"] = acc["i"]["bits"] / i_num / frame_pixel_num
    log["ave_i_frame_psnr"] = acc["i"]["psnr"][0] / i_num
    log["ave_i_frame_msssim"] = acc["i"]["ssim"][0] / i_num
    if include_yuv:
        for j, comp in enumerate("yuv", start=1):
            log[f"ave_i_frame_psnr_{comp}"] = acc["i"]["psnr"][j] / i_num
            log[f"ave_i_frame_msssim_{comp}"] = acc["i"]["ssim"][j] / i_num
    if verbose:
        log["frame_bpp"] = list(np.array(bits) / frame_pixel_num)
        log["frame_psnr"] = [v[0] for v in psnrs]
        log["frame_msssim"] = [v[0] for v in ssims]
        log["frame_type"] = frame_types
    log["test_time"] = test_time
    p_num = acc["p"]["num"]
    if p_num > 0:
        log["ave_p_frame_bpp"] = acc["p"]["bits"] / p_num / frame_pixel_num
        log["ave_p_frame_psnr"] = acc["p"]["psnr"][0] / p_num
        log["ave_p_frame_msssim"] = acc["p"]["ssim"][0] / p_num
        if include_yuv:
            for j, comp in enumerate("yuv", start=1):
                log[f"ave_p_frame_psnr_{comp}"] = acc["p"]["psnr"][j] / p_num
                log[f"ave_p_frame_msssim_{comp}"] = acc["p"]["ssim"][j] / p_num
    else:
        log["ave_p_frame_bpp"] = 0
        log["ave_p_frame_psnr"] = 0
        log["ave_p_frame_msssim"] = 0
    total_bits = acc["i"]["bits"] + acc["p"]["bits"]
    log["ave_all_frame_bpp"] = total_bits / (frame_num * frame_pixel_num)
    log["ave_all_frame_psnr"] = \
        (acc["i"]["psnr"][0] + acc["p"]["psnr"][0]) / frame_num
    log["ave_all_frame_msssim"] = \
        (acc["i"]["ssim"][0] + acc["p"]["ssim"][0]) / frame_num
    if avg_encoding_time is not None and avg_decoding_time is not None:
        log["avg_frame_encoding_time"] = avg_encoding_time
        log["avg_frame_decoding_time"] = avg_decoding_time
    if include_yuv:
        for j, comp in enumerate("yuv", start=1):
            log[f"ave_all_frame_psnr_{comp}"] = \
                (acc["i"]["psnr"][j] + acc["p"]["psnr"][j]) / frame_num
            log[f"ave_all_frame_msssim_{comp}"] = \
                (acc["i"]["ssim"][j] + acc["p"]["ssim"][j]) / frame_num
    return log
