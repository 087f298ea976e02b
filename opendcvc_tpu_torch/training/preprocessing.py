"""Reference-frame precomputation for cascaded training.

Counterpart of the JAX package's `training/preprocessing.py` (the
reference's preprocessing step): a frozen intra codec codes the first
frame of every training clip, and its reconstruction is stored as
`<out_name>.png` beside `im1.png`, so the P-frame trainer loads fixed
references (`training/data.py`'s use_precomputed_refs) instead of running
the intra codec every step.  PIL is imported on first use.
"""

import os

import numpy as np

from ..models import common as CM


def precompute_references(dataset_root, list_file, i_codec, qp, out_name,
                          limit=None, pad_to=64, verbose=False):
    """i_codec: any image codec with .compress(x (1, H, W, 3) numpy, qp) ->
    {"x_hat"} (the port's DMCI, on host EC or device EC).  Each im1.png
    is edge-replicate-padded to a multiple of pad_to, coded, cropped
    back, rounded to uint8 and written as <seq_dir>/<out_name>.png.
    Returns the number of sequences."""
    from PIL import Image

    seq_root = os.path.join(dataset_root, "sequences")
    with open(list_file) as f:
        seqs = [ln.strip() for ln in f if ln.strip()]
    if limit:
        seqs = seqs[:limit]

    for i, seq in enumerate(seqs):
        src = os.path.join(seq_root, seq, "im1.png")
        dst = os.path.join(seq_root, seq, f"{out_name}.png")
        img = np.asarray(Image.open(src).convert("RGB"),
                         dtype=np.float32) / 255.0
        h, w, _ = img.shape
        pr, pb = CM.get_padding_size(h, w, pad_to)
        # edge replication on the host: the values replicate_pad copies
        x = np.pad(img[None], ((0, 0), (0, pb), (0, pr), (0, 0)),
                   mode="edge")
        out = i_codec.compress(x, qp)
        x_hat = out["x_hat"][0, :h, :w].float().cpu().numpy()
        rec = np.clip(np.round(x_hat * 255), 0, 255).astype(np.uint8)
        Image.fromarray(rec).save(dst)
        if verbose and (i + 1) % 100 == 0:
            print(f"precomputed {i + 1}/{len(seqs)}")
    return len(seqs)
