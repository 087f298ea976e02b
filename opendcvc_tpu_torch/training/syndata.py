"""Synthetic training content with natural image statistics, content
banks and a background prefetcher (numpy).

Counterpart of the JAX package's `training/syndata.py`: the same numpy
calls in the same order, so one seed gives bit-equal arrays in both
packages.  The repo ships no photographic corpus, so the training
campaign (`training/campaign.py`) trains on this content: 1/f^alpha power
spectra, piecewise-smooth regions with sharp boundaries, oriented
textures and sensor noise.  `ImageBank`, `PairBank` and `SeqBank`
generate a bank once and serve random crop/flip batches by slicing, so
the host keeps ahead of the device; `Prefetcher` keeps a few batches
ready on a thread.
"""

import queue
import threading

import numpy as np


def _fractal_fields(rng, n, h, w, alpha_lo=1.0, alpha_hi=2.4):
    """Batch of (n, h, w) 1/f^alpha random fields, unit-normalized."""
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    f = np.sqrt(fy * fy + fx * fx)
    f[0, 0] = 1.0
    alpha = rng.uniform(alpha_lo, alpha_hi, n)[:, None, None]
    amp = f[None] ** (-alpha)
    amp[:, 0, 0] = 0.0
    phase = rng.uniform(0, 2 * np.pi, (n, h, fx.shape[1]))
    spec = amp * np.exp(1j * phase)
    x = np.fft.irfft2(spec, s=(h, w)).astype(np.float32)
    sd = x.std(axis=(1, 2), keepdims=True)
    return x / np.maximum(sd, 1e-8)


def natural_images(n, size, seed=0, width=None):
    """n images (1, size, w, 3) float32 in [0,1] with natural statistics.

    Construction per image:
      - luminance = 1/f^alpha field (global structure)
      - region map = smooth thresholded second field -> piecewise-smooth
        segments with sharp, antialiased boundaries (object silhouettes)
      - per-region color offsets + a correlated chroma pair at lower
        bandwidth (chroma subsampling statistics)
      - oriented sinusoid texture masked into one region (fabric/grass)
      - mild highlight bloom + sensor noise
    """
    rng = np.random.default_rng(seed)
    w = size if width is None else width
    h = size
    lum = _fractal_fields(rng, n, h, w)
    seg_f = _fractal_fields(rng, n, h, w, 1.6, 2.6)
    chroma = _fractal_fields(rng, 2 * n, h, w, 1.8, 2.8).reshape(
        2, n, h, w)
    tex_f = _fractal_fields(rng, n, h, w, 0.6, 1.2)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        L = lum[i] * rng.uniform(0.15, 0.3)
        # piecewise-smooth regions: 2-4 soft-thresholded level sets
        n_reg = int(rng.integers(2, 5))
        levels = np.sort(rng.normal(0, 0.8, n_reg - 1))
        sharp = rng.uniform(30, 120)
        region = np.zeros((h, w), np.float32)
        for lv in levels:
            arg = np.clip(sharp * (seg_f[i] - lv), -60.0, 60.0)
            region += 1.0 / (1.0 + np.exp(-arg))
        base = rng.uniform(0.25, 0.75)
        reg_gain = rng.uniform(0.05, 0.2)
        L = base + L + (region - region.mean()) * reg_gain

        # oriented texture in the most-positive region
        th = rng.uniform(0, np.pi)
        freq = rng.uniform(0.05, 0.25)
        carrier = np.sin(2 * np.pi * freq *
                         (np.cos(th) * xx + np.sin(th) * yy)
                         + 3.0 * tex_f[i])
        tex_mask = region >= region.max() - 0.5
        L = L + carrier * tex_mask * rng.uniform(0.0, 0.05)

        ca = chroma[0, i] * rng.uniform(0.02, 0.08) \
            + (region - region.mean()) * rng.uniform(-0.1, 0.1)
        cb = chroma[1, i] * rng.uniform(0.02, 0.08) \
            + (region - region.mean()) * rng.uniform(-0.1, 0.1)
        # BT.709-ish inverse: R/B follow the chroma axes around luma
        img = np.stack([L + 1.28 * ca, L - 0.38 * ca - 0.21 * cb,
                        L + 2.12 * cb], axis=-1)
        img += rng.normal(0, rng.uniform(0.002, 0.008),
                          img.shape).astype(np.float32)
        out[i] = np.clip(img, 0.0, 1.0)
    return [out[i:i + 1] for i in range(n)]


def natural_pairs(n, size, seed=0, max_shift=4):
    """(ref, cur) frame pairs: global translation + local elastic warp +
    brightness drift + noise — the innovation statistics a P-codec
    trains on (the reference uses consecutive Vimeo septuplet frames)."""
    imgs = natural_images(n, size + 2 * max_shift, seed)
    rng = np.random.default_rng(seed + 999)
    pairs = []
    for im in imgs:
        im = im[0]
        dy, dx = (int(v) for v in rng.integers(-max_shift,
                                               max_shift + 1, 2))
        s = max_shift
        ref = im[s:s + size, s:s + size]
        cur = im[s + dy:s + dy + size, s + dx:s + dx + size].copy()
        # local warp: displace rows/cols by a smooth +-1px field
        wob = _fractal_fields(rng, 1, size, size, 2.0, 2.6)[0]
        shift_rows = np.clip(np.round(wob * 0.8), -1, 1).astype(int)
        idx = (np.arange(size)[:, None] + shift_rows) % size
        cur = cur[idx, np.arange(size)[None, :], :]
        cur = np.clip(cur * rng.uniform(0.98, 1.02)
                      + rng.normal(0, 0.004, cur.shape), 0, 1)
        pairs.append((ref[None].astype(np.float32),
                      cur[None].astype(np.float32)))
    return pairs


def natural_seqs(n, size, t=3, seed=0, max_shift=4):
    """n motion sequences, each (t, size, size, 3) float32 in [0,1].

    Frame 0 is the reference; later frames accumulate global translation
    (random walk over a larger canvas), per-frame local elastic warp,
    brightness drift, and fresh sensor noise — the temporal-innovation
    statistics a cascaded P-codec trains on (the reference trains on
    Vimeo septuplets, train_dcvc_sq_2to7_data_ddp.py:31-96)."""
    margin = max_shift * max(t - 1, 1)
    imgs = natural_images(n, size + 2 * margin, seed)
    rng = np.random.default_rng(seed + 999)
    seqs = []
    for im in imgs:
        im = im[0]
        oy = ox = margin
        frames = [im[oy:oy + size, ox:ox + size].copy()]
        for _ in range(t - 1):
            dy, dx = (int(v) for v in rng.integers(-max_shift,
                                                   max_shift + 1, 2))
            oy = int(np.clip(oy + dy, 0, 2 * margin))
            ox = int(np.clip(ox + dx, 0, 2 * margin))
            cur = im[oy:oy + size, ox:ox + size].copy()
            wob = _fractal_fields(rng, 1, size, size, 2.0, 2.6)[0]
            shift_rows = np.clip(np.round(wob * 0.8), -1, 1).astype(int)
            idx = (np.arange(size)[:, None] + shift_rows) % size
            cur = cur[idx, np.arange(size)[None, :], :]
            cur = np.clip(cur * rng.uniform(0.98, 1.02)
                          + rng.normal(0, 0.004, cur.shape),
                          0, 1).astype(np.float32)
            frames.append(cur)
        seqs.append(np.stack(frames))
    return seqs


class ImageBank:
    """Pre-generated content bank serving random crop/flip batches.

    Bank images are stored uint8 (quantized like any camera output);
    crops decode to float32 on the fly.  Batch sampling is pure
    slicing — microseconds, so the accelerator step dominates."""

    def __init__(self, n_images=512, size=320, seed=0, gen=natural_images):
        imgs = gen(n_images, size, seed=seed)
        self.bank = np.stack([
            np.round(im[0] * 255).astype(np.uint8) for im in imgs])
        self.size = size

    def sample(self, rng, batch, crop):
        n, s = self.bank.shape[0], self.size
        idx = rng.integers(0, n, batch)
        ys = rng.integers(0, s - crop + 1, batch)
        xs = rng.integers(0, s - crop + 1, batch)
        flips = rng.integers(0, 4, batch)
        out = np.empty((batch, crop, crop, 3), np.float32)
        for j in range(batch):
            c = self.bank[idx[j], ys[j]:ys[j] + crop,
                          xs[j]:xs[j] + crop]
            if flips[j] & 1:
                c = c[:, ::-1]
            if flips[j] & 2:
                c = c[::-1]
            out[j] = c.astype(np.float32) / 255.0
        return out


class PairBank:
    """Crop/flip batches of (ref, cur) motion pairs for P-frame training.

    Returns (batch, 2, crop, crop, 3): frame 0 = reference."""

    def __init__(self, n_pairs=384, size=256, seed=0):
        pairs = natural_pairs(n_pairs, size, seed=seed)
        self.bank = np.stack([
            np.stack([np.round(r[0] * 255).astype(np.uint8),
                      np.round(c[0] * 255).astype(np.uint8)])
            for r, c in pairs])
        self.size = size

    def sample(self, rng, batch, crop):
        n, s = self.bank.shape[0], self.size
        idx = rng.integers(0, n, batch)
        ys = rng.integers(0, s - crop + 1, batch)
        xs = rng.integers(0, s - crop + 1, batch)
        flips = rng.integers(0, 4, batch)
        out = np.empty((batch, 2, crop, crop, 3), np.float32)
        for j in range(batch):
            c = self.bank[idx[j], :, ys[j]:ys[j] + crop,
                          xs[j]:xs[j] + crop]
            if flips[j] & 1:
                c = c[:, :, ::-1]
            if flips[j] & 2:
                c = c[:, ::-1]
            out[j] = c.astype(np.float32) / 255.0
        return out


class SeqBank:
    """Crop/flip batches of t-frame motion sequences for cascaded
    P-frame training.  Returns (batch, t, crop, crop, 3); frame 0 is
    the reference.

    `replace_refs(fn)` rewrites every sequence's frame 0 through a
    callable (e.g. a frozen trained I-codec recon) — the reference
    precomputes exactly this with its frozen I-model
    (DCVC-family/DCVC/preprocessing.py)."""

    def __init__(self, n_seqs=384, size=256, t=3, seed=0):
        seqs = natural_seqs(n_seqs, size, t=t, seed=seed)
        self.bank = np.stack([
            np.round(s * 255).astype(np.uint8) for s in seqs])
        self.size = size
        self.t = t

    def replace_refs(self, fn, batch=8):
        """fn: (b, size, size, 3) float32 -> recon float32 in [0,1];
        applied over all frame-0 refs in batches."""
        n = self.bank.shape[0]
        for lo in range(0, n, batch):
            refs = self.bank[lo:lo + batch, 0].astype(np.float32) / 255.0
            recon = np.asarray(fn(refs))
            self.bank[lo:lo + batch, 0] = np.round(
                np.clip(recon, 0, 1) * 255).astype(np.uint8)

    def sample(self, rng, batch, crop, t=None):
        n, s = self.bank.shape[0], self.size
        t = self.t if t is None else min(t, self.t)
        idx = rng.integers(0, n, batch)
        ys = rng.integers(0, s - crop + 1, batch)
        xs = rng.integers(0, s - crop + 1, batch)
        flips = rng.integers(0, 4, batch)
        out = np.empty((batch, t, crop, crop, 3), np.float32)
        for j in range(batch):
            c = self.bank[idx[j], :t, ys[j]:ys[j] + crop,
                          xs[j]:xs[j] + crop]
            if flips[j] & 1:
                c = c[:, :, ::-1]
            if flips[j] & 2:
                c = c[:, ::-1]
            out[j] = c.astype(np.float32) / 255.0
        return out


class Prefetcher:
    """One background thread keeps `depth` batches ready (the
    DataLoader-worker equivalent).  Batches come out in the order
    `make_batch` made them; an exception in `make_batch` is raised by the
    next() that would have returned its batch.  close() stops the worker:
    it puts with a timeout and checks the stop flag between tries, so it
    never stays blocked on a full queue, and close() joins it."""

    def __init__(self, make_batch, depth=4):
        self.q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def work():
            while not self._stop.is_set():
                try:
                    item = (make_batch(), None)
                except Exception as e:  # handed to the consumer
                    item = (None, e)
                while not self._stop.is_set():
                    try:
                        self.q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        pass
                if item[1] is not None:
                    return

        self.t = threading.Thread(target=work, daemon=True)
        self.t.start()

    def next(self):
        batch, err = self.q.get()
        if err is not None:
            raise err
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.t.join()
