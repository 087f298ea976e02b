"""CDF quantization for range coding (host-side, numpy).

Semantics match the reference coder's table construction exactly
(reference: src/cpp/py_rans/py_rans.cpp:307-364 pmf_to_quantized_cdf with
frequency stealing; src/models/entropy_models.py:26-34 pmf_to_cdf), so
that streams produced by this framework decode with identical tables on
any host.  Everything here is float64/integer numpy — deterministic across
machines.
"""

import numpy as np

PRECISION = 16


def pmf_to_quantized_cdf(pmf, precision=PRECISION):
    """Quantize a PMF (last entry = tail mass) to an integer CDF summing to
    2**precision, with every symbol given frequency >= 1 via frequency
    stealing from the lowest-frequency stealable symbol."""
    pmf = np.asarray(pmf, dtype=np.float64)
    n = pmf.shape[0]
    cdf = np.zeros(n + 1, dtype=np.int64)
    # round half away from zero (std::round); pmf >= 0 so half-up works
    cdf[1:] = np.floor(pmf * (1 << precision) + 0.5).astype(np.int64)
    total = int(cdf.sum())
    if total <= 0:
        # degenerate all-zero pmf: uniform fallback
        cdf[1:] = 1
        total = n
    cdf = ((1 << precision) * cdf) // total
    cdf = np.cumsum(cdf)
    cdf[-1] = 1 << precision

    # frequency stealing: ensure strictly increasing cdf
    for i in range(n):
        if cdf[i] == cdf[i + 1]:
            freqs = cdf[1:] - cdf[:-1]
            candidates = np.where(freqs > 1)[0]
            assert candidates.size > 0, "no frequency to steal"
            best_steal = candidates[np.argmin(freqs[candidates])]
            if best_steal < i:
                cdf[best_steal + 1:i + 1] -= 1
            else:
                assert best_steal > i
                cdf[i + 1:best_steal + 1] += 1

    assert cdf[0] == 0 and cdf[-1] == (1 << precision)
    assert np.all(cdf[1:] > cdf[:-1])
    return cdf.astype(np.int32)


def pmf_to_cdf(pmf, tail_mass, pmf_length, max_length):
    """Build a (num_cdfs, max_length + 2) int32 CDF table.

    pmf: (num_cdfs, max_length); tail_mass: (num_cdfs, 1);
    pmf_length: (num_cdfs,) valid prefix per row.
    """
    pmf = np.asarray(pmf, dtype=np.float64)
    tail_mass = np.asarray(tail_mass, dtype=np.float64).reshape(-1)
    pmf_length = np.asarray(pmf_length, dtype=np.int64).reshape(-1)
    num = pmf_length.shape[0]
    cdf = np.zeros((num, max_length + 2), dtype=np.int32)
    for i in range(num):
        ln = int(pmf_length[i])
        prob = np.concatenate([pmf[i, :ln], [tail_mass[i]]])
        row = pmf_to_quantized_cdf(prob, PRECISION)
        cdf[i, :row.shape[0]] = row
    return cdf
