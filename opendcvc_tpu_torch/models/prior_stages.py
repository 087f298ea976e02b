"""Checkerboard-prior pass stages shared by the family codecs (NCHW).

Counterpart of the JAX package's `models/prior_stages.py`, as plain torch
functions: prior separation, masked quantization, CDF-index building,
int16 symbol packing and the running y_hat sum of each pass.  The
decoder's index computation repeats the encoder's elementwise math on the
same inputs, so both sides get the same indexes; the stages with
convolutions stay in the codecs.

    stages = make_pass_stages(cfg, nparts)

cfg is the (scale_min, scale_max, log_scale_min, log_step_recip) tuple of
the codec's GaussianEncoder; nparts is 2 (checkerboard halves) or 4
(quadtree quarters).  The "video" stages split a chunk-3 prior (q_dec,
scales, means); the "qstep" ones take an explicit q_step map.  A packed
plane is (folded symbol << 8) + CDF index as int16, the host coder's y
format.
"""

import torch

from ..ops import fused as F
from . import common as C


def make_pass_stages(cfg, nparts):
    if nparts not in (2, 4):
        raise ValueError(f"nparts {nparts} is neither 2 nor 4")
    smin, smax, lsm, recip = cfg

    def indexes_of(scales_r):
        idx, _ = F.build_index_dec(scales_r, smin, smax, lsm, recip, None)
        return idx

    def masks_of(t):
        _, c, h, w = t.shape
        masks = F.checkerboard_masks_2x if nparts == 2 \
            else F.checkerboard_masks_4x
        return masks(h, w, c, t.dtype, t.device)

    fold = F.fold_halves if nparts == 2 else F.fold_quarters
    restore = F.restore_y_2x if nparts == 2 else F.restore_y_4x

    def pass_core(y_div, scales, means, so_far, k):
        mask = masks_of(y_div)[k]
        _, y_q, y_hat_k, _ = F.process_with_mask(y_div, scales, means, mask,
                                                 None)
        idx = indexes_of(fold(scales * mask))
        packed = (fold(y_q).to(torch.int32) * 256
                  + idx.to(torch.int32)).to(torch.int16)
        so_far = y_hat_k if so_far is None else so_far + y_hat_k
        return packed, so_far

    # --- video-style (chunk-3 prior) ---------------------------------------

    def enc_pass0_video(y, params_prior):
        y_div, _, scales, means = C.separate_prior_video_encoding(
            params_prior, y)
        packed, so_far = pass_core(y_div, scales, means, None, 0)
        return y_div, packed, so_far

    def enc_pass_k(y_div, scales, means, so_far, k):
        return pass_core(y_div, scales, means, so_far, k)

    def dec_index0_video(params_prior):
        _, scales, _ = C.separate_prior_video_decoding(params_prior)
        return indexes_of(fold(scales * masks_of(scales)[0]))

    def dec_index_k(scales, k):
        return indexes_of(fold(scales * masks_of(scales)[k]))

    def dec_restore0_video(y_q_r, params_prior):
        _, _, means = C.separate_prior_video_decoding(params_prior)
        return restore(y_q_r, means, masks_of(means)[0])

    def dec_restore_acc(y_q_r, means, so_far, k):
        y_hat_k = restore(y_q_r, means, masks_of(means)[k])
        return y_hat_k if so_far is None else so_far + y_hat_k

    def finalize_video(so_far, params_prior):
        c3 = params_prior.shape[1] // 3
        return so_far * torch.clamp_min(params_prior[:, :c3], 0.5)

    # --- HEM/EVC-style (explicit q_step map, optional outer q) -------------

    def enc_pass0_qstep(y, q_step, scales, means):
        y_div = y / q_step
        packed, so_far = pass_core(y_div, scales, means, None, 0)
        return y_div, packed, so_far

    def finalize_qstep(y_hat_0, y_hat_1, q_step, outer_q):
        return (y_hat_0 + y_hat_1) * q_step * outer_q

    return {
        "enc_pass0_video": enc_pass0_video,
        "enc_pass_k": enc_pass_k,
        "dec_index0_video": dec_index0_video,
        "dec_index_k": dec_index_k,
        "dec_restore0_video": dec_restore0_video,
        "dec_restore_acc": dec_restore_acc,
        "finalize_video": finalize_video,
        "enc_pass0_qstep": enc_pass0_qstep,
        "finalize_qstep": finalize_qstep,
    }
