"""Training data pipelines: the Vimeo-90k septuplet reader and a
synthetic moving-texture generator.

Counterpart of the JAX package's `training/data.py`, host-side numpy with
the same RNG calls in the same order, so one seed gives the same batches
in both packages: (B, T, H, W, 3) float32 in [0, 1], NHWC.  PIL is
imported on first use.
"""

import os

import numpy as np


class Vimeo90kSeptupletDataset:
    """Reads vimeo_septuplet-style trees: root/sequences/<a>/<b>/im{1..7}.png
    with a list file of '<a>/<b>' entries; random start frame, crop and
    flips."""

    def __init__(self, root, list_file, frames_per_sample=2, crop=256,
                 rng=None, use_precomputed_refs=False):
        self.root = root
        self.seq_dir = os.path.join(root, "sequences")
        with open(list_file) as f:
            self.samples = [ln.strip() for ln in f if ln.strip()]
        self.frames_per_sample = frames_per_sample
        self.crop = crop
        self.rng = rng or np.random.default_rng(0)
        # ref.png (the frozen intra codec's reconstruction of im1) stands
        # in for the first frame when asked
        self.use_precomputed_refs = use_precomputed_refs

    def __len__(self):
        return len(self.samples)

    @staticmethod
    def _read_png(path):
        from PIL import Image
        img = Image.open(path).convert("RGB")
        return np.asarray(img, dtype=np.float32) / 255.0

    def _load_frame(self, seq, idx):
        return self._read_png(os.path.join(self.seq_dir, seq, f"im{idx}.png"))

    def get_item(self, index):
        seq = self.samples[index % len(self.samples)]
        t = self.frames_per_sample
        start = int(self.rng.integers(1, 8 - t + 1))
        frames = [self._load_frame(seq, start + i) for i in range(t)]
        if self.use_precomputed_refs and start == 1:
            ref_path = os.path.join(self.seq_dir, seq, "ref.png")
            if os.path.exists(ref_path):
                frames[0] = self._read_png(ref_path)
        h, w, _ = frames[0].shape
        c = self.crop
        y0 = int(self.rng.integers(0, max(h - c, 0) + 1))
        x0 = int(self.rng.integers(0, max(w - c, 0) + 1))
        frames = [f[y0:y0 + c, x0:x0 + c] for f in frames]
        if self.rng.random() < 0.5:
            frames = [f[:, ::-1] for f in frames]
        if self.rng.random() < 0.5:
            frames = [f[::-1, :] for f in frames]
        return np.stack(frames)  # (T, c, c, 3)

    def batches(self, batch_size, steps):
        """Yields (B, T, H, W, 3) float32 batches."""
        order = self.rng.permutation(len(self.samples))
        pos = 0
        for _ in range(steps):
            items = []
            for _ in range(batch_size):
                items.append(self.get_item(int(order[pos % len(order)])))
                pos += 1
            yield np.ascontiguousarray(np.stack(items))


class SyntheticVideoDataset:
    """Deterministic moving-texture clips: random low-resolution fields
    upsampled 8x, mild noise, rolled 2 px a frame."""

    def __init__(self, frames_per_sample=2, size=64, seed=0):
        self.t = frames_per_sample
        self.size = size
        self.rng = np.random.default_rng(seed)

    def batches(self, batch_size, steps):
        s = self.size
        for _ in range(steps):
            lo = self.rng.random(
                (batch_size, s // 8, s // 8, 3)).astype(np.float32)
            base = np.kron(lo, np.ones((1, 8, 8, 1), np.float32))
            base = np.clip(base + self.rng.normal(
                0, 0.02, base.shape).astype(np.float32), 0, 1)
            frames = [np.roll(base, 2 * t, axis=2) for t in range(self.t)]
            yield np.stack(frames, axis=1)  # (B, T, H, W, 3)
