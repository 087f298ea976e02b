"""Synthetic evaluation content (numpy).

The port's copy of `synthetic_images` and `TINY_KW` from the JAX
package's `eval/rd_evidence.py`: `python -m opendcvc_tpu_torch.bench`
codes the images under BENCH_CKPT_I, and `chip_smoke.py` codes one with
the committed trained checkpoint (`docs/dmci_tiny_rd.msgpack`, a DMCI at
TINY_KW).  The rest of that module (the RD sweep of a trained checkpoint)
is not ported yet.
"""

import numpy as np

#: the reduced DMCI widths of the trained RD-evidence checkpoint
TINY_KW = {"N": 96, "z_channel": 64, "enc_dec_ch": 64}


def synthetic_images(n, size, seed=0, width=None):
    """Deterministic mixed-content eval set: multi-scale block
    textures + smooth gradients + hard edges + mild noise — content a
    codec can actually model, with enough structure that rate responds
    to quantization (pure noise is incompressible; single-scale
    textures saturate).  `width` defaults to `size` (square).  Returns n
    (1, size, width, 3) float32 frames in [0, 1]."""
    rng = np.random.default_rng(seed)
    w = size if width is None else width
    imgs = []
    for _ in range(n):
        img = np.zeros((size, w, 3), np.float32)
        for block in (16, 8, 4):
            lo = rng.random((-(-size // block), -(-w // block), 3))
            img += np.kron(lo, np.ones((block, block, 1)))[
                :size, :w] / (16 / block) ** 0.5
        yy, xx = np.mgrid[0:size, 0:w].astype(np.float32)
        yy, xx = yy / size, xx / w
        img += (rng.random(3) * np.stack([yy, xx, yy * xx], -1)).sum(
            -1, keepdims=True) * 0.5
        # a few hard-edged rectangles
        for _ in range(4):
            y0 = rng.integers(0, size - 8)
            x0 = rng.integers(0, w - 8)
            h_ = rng.integers(4, size // 3)
            w_ = rng.integers(4, w // 3)
            img[y0:y0 + h_, x0:x0 + w_] += rng.random(3) - 0.5
        img = (img - img.min()) / max(img.max() - img.min(), 1e-6)
        img = np.clip(img + rng.normal(0, 0.01, img.shape), 0, 1)
        imgs.append(img[None].astype(np.float32))
    return imgs
