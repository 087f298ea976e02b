"""Plain reading of DCVC-RT's device-EC streams: the CDF tables, the v6
("tpu-lane") frame container and the lane rANS decode, in numpy.

A frozen copy of the measured package's table construction
(`entropy/cdf.py`, `entropy/models.py`, `entropy/device_rans.py::
full_range_cdf_rows`), its container layout and its decode scan's
arithmetic (`ops/lane_rans.py::decode_scan_plain`), used only to read
the package's encoder output and compare the symbols with the
reference's own.  Each lane carries a 32-bit state over 16-bit words and
16-bit frequencies; symbol i of a plane is coded by lane i % L at step
i // L, the plane flattened channel-major; a frame's planes follow one
another in decode order (z, then the y passes) on the same lanes.
"""

import math

import numpy as np
from scipy import special

PRECISION = 16
FRAME_MAGIC = 0xD6
SKIP = 511


# ---------------------------------------------------------------------------
# CDF tables
# ---------------------------------------------------------------------------

def pmf_to_quantized_cdf(pmf):
    pmf = np.asarray(pmf, dtype=np.float64)
    n = pmf.shape[0]
    cdf = np.zeros(n + 1, dtype=np.int64)
    cdf[1:] = np.floor(pmf * (1 << PRECISION) + 0.5).astype(np.int64)
    total = int(cdf.sum())
    if total <= 0:
        cdf[1:] = 1
        total = n
    cdf = ((1 << PRECISION) * cdf) // total
    cdf = np.cumsum(cdf)
    cdf[-1] = 1 << PRECISION
    for i in range(n):
        if cdf[i] == cdf[i + 1]:
            freqs = cdf[1:] - cdf[:-1]
            candidates = np.where(freqs > 1)[0]
            best = candidates[np.argmin(freqs[candidates])]
            if best < i:
                cdf[best + 1:i + 1] -= 1
            else:
                cdf[i + 1:best + 1] += 1
    return cdf


def _escape_rows(pmf, tail_mass, pmf_length):
    rows = []
    for i in range(pmf_length.shape[0]):
        ln = int(pmf_length[i])
        rows.append(pmf_to_quantized_cdf(
            np.concatenate([pmf[i, :ln], [tail_mass[i]]])))
    return rows


def full_range_rows(rows, offsets):
    """Escape-format rows -> (n, 257) cumulative rows over symbols
    -128..127, every frequency at least 1, the excess taken from each
    row's largest bin."""
    out = np.zeros((len(rows), 257), np.int64)
    for r, (cdf, off) in enumerate(zip(rows, offsets)):
        in_f = np.maximum(cdf[1:-1] - cdf[:-2], 1)   # in-range symbols
        freqs = np.ones(256, np.int64)
        for j, f in enumerate(in_f):
            d = int(off) + 128 + j
            if 0 <= d < 256:
                freqs[d] += f - 1
        freqs[np.argmax(freqs)] -= freqs.sum() - (1 << PRECISION)
        out[r, 1:] = np.cumsum(freqs)
    return out


def gaussian_rows(scale_min=0.11, scale_max=16.0, levels=128, support=8):
    """The 128 zero-mean Gaussian rows of DCVC-RT's y planes."""
    scales = np.exp(np.linspace(math.log(scale_min), math.log(scale_max),
                                levels))

    def cdf(x):
        return 0.5 * (1.0 + special.erf(x / math.sqrt(2.0)))

    center = np.full(levels, support, dtype=np.int64)
    for i in range(support, 1, -1):
        center = np.where(cdf(i / scales) > 0.9999, i, center)
    length = 2 * center + 1
    samples = np.arange(int(length.max()), dtype=np.float64)[None, :] \
        - center[:, None]
    upper = cdf((samples + 0.5) / scales[:, None])
    lower = cdf((samples - 0.5) / scales[:, None])
    rows = _escape_rows(upper - lower, 2 * lower[:, 0], length)
    return full_range_rows(rows, -center)


def factorized_rows(params, qp, support=8):
    """The z rows of one qp (one per channel) of the factorized prior
    `params` ({f1..f4: {h, b[, a]}} of (Q, C) arrays), in float64."""
    p = {k: {n: np.asarray(v, np.float64)[qp] for n, v in layer.items()}
         for k, layer in params.items()}

    def cdf(x):
        for name in ("f1", "f2", "f3", "f4"):
            q = p[name]
            x = x * np.log1p(np.exp(q["h"]))[:, None] + q["b"][:, None]
            if "a" in q:
                x = x + np.tanh(x) * np.tanh(q["a"])[:, None]
        return 1.0 / (1.0 + np.exp(-x))

    c = p["f1"]["h"].shape[0]

    def at(v):
        return cdf(np.full((c, 1), float(v)))[:, 0]

    minima = np.full(c, support, dtype=np.int64)
    maxima = np.full(c, support, dtype=np.int64)
    for i in range(support, 1, -1):
        minima = np.where(at(-i) < 1e-4, i, minima)
        maxima = np.where(at(i) > 0.9999, i, maxima)
    length = maxima + minima + 1
    samples = np.arange(int(length.max()), dtype=np.float64)[None, :] \
        - minima[:, None].astype(np.float64)
    lower, upper = cdf(samples - 0.5), cdf(samples + 0.5)
    tail = lower[:, 0] + (1.0 - cdf(maxima.astype(np.float64)[:, None])[:, 0])
    rows = _escape_rows(upper - lower, tail, length)
    return full_range_rows(rows, -minima)


# ---------------------------------------------------------------------------
# the container and the decode
# ---------------------------------------------------------------------------

def parse(stream):
    """(L, K, lane words (L, max len) int64, states (L,) int64)."""
    b = memoryview(stream)
    if b[0] != FRAME_MAGIC:
        raise ValueError(f"container magic 0x{b[0]:02x}")
    lanes, k = (int(v) for v in np.frombuffer(b, np.uint16, 2, 5))
    dlen = int(np.frombuffer(b, np.uint32, 1, 17)[0])
    off = 21
    lens = np.frombuffer(b, np.uint16, lanes, off).astype(np.int64)
    off += 2 * lanes
    states = np.frombuffer(b, np.uint32, lanes, off).astype(np.int64)
    off += 4 * lanes
    dense = np.frombuffer(b, np.uint16, dlen // 2, off).astype(np.int64)
    if int(lens.sum()) != dense.shape[0]:
        raise ValueError("lane lengths do not add up to the payload")
    words = np.zeros((lanes, int(lens.max(initial=0)) + 1), np.int64)
    ends = np.cumsum(lens)
    for lane in range(lanes):
        words[lane, :lens[lane]] = dense[ends[lane] - lens[lane]:ends[lane]]
    return lanes, k, words, states, lens


class LaneDecoder:
    """Decodes a frame's planes in order, carrying each lane's state, on
    `device` (torch; every lane at once, one step at a time)."""

    def __init__(self, stream, device):
        import torch
        lanes, self.k, words, state, lens = parse(stream)
        self.lanes, self.dev = lanes, torch.device(device)
        self.words = torch.from_numpy(words).to(self.dev)
        self.state = torch.from_numpy(state).to(self.dev)
        self.lens = torch.from_numpy(lens).to(self.dev)
        self.ptr = torch.zeros(lanes, dtype=torch.int64, device=self.dev)
        self.steps = 0

    def plane(self, rows, table):
        """Symbols (int64) of a plane of n = rows.numel() symbols; rows
        (n,) local row ids into `table` ((nr, 257) int64 cumulative), SKIP
        decodes 0."""
        import torch
        n, lanes = rows.numel(), self.lanes
        k = -(-n // lanes)
        r = torch.zeros(k * lanes, dtype=torch.int64, device=self.dev)
        r[:n] = rows.reshape(-1)
        r = r.reshape(k, lanes)
        out = torch.empty((k, lanes), dtype=torch.int64, device=self.dev)
        lane = torch.arange(lanes, device=self.dev)
        last = self.words.shape[1] - 1
        for step in range(k):
            skip = r[step] == SKIP
            cum = table[r[step].clamp(max=table.shape[0] - 1)]
            f = self.state & 0xFFFF
            sym = (cum[:, 1:] <= f[:, None]).sum(dim=1)
            start = cum[lane, sym]
            freq = cum[lane, sym + 1] - start
            s1 = torch.where(skip, self.state,
                             freq * (self.state >> 16) + f - start)
            need = s1 < (1 << 16)
            at = torch.where(self.ptr < self.lens, self.ptr, last)
            self.state = torch.where(need, (s1 << 16) | self.words[lane, at],
                                     s1)
            self.ptr = self.ptr + need.to(torch.int64)
            out[step] = torch.where(skip, 0, sym - 128)
        self.steps += k
        return out.reshape(-1)[:n]

    def done(self):
        """Every step of the container read, every lane's words used."""
        return self.steps == self.k and bool((self.ptr == self.lens).all())
