"""The comparisons that decide `correct`, between what a cell's timed path
produced (sampled from every pass) and the plain reference of the same
weights and frames, computed after the window one frame at a time."""

import torch

from reference import lane_rans as LR


def frame_gaps(got, want):
    """(widest gap, the worst frame's mean gap) between outputs {pos:
    [frames]} and the reference's {pos: frame}."""
    widest = mean = 0.0
    for pos, outs in got.items():
        for x in outs:
            d = (x.float() - want[pos].float()).abs()
            widest = max(widest, float(d.max()))
            mean = max(mean, float(d.mean()))
    return widest, mean


def decoded_frames(cell, ref, weights, frames, samples, features=None):
    """Checks of a decoding cell: its decoded frames against the
    reference's reconstructions, and where `features` ({pos: the
    decoder's propagated feature}) is given, those against the
    reference's features at the same positions.  Each gap is a check
    where the workload lists its limit."""
    kw = {} if features is None else {"features": dict.fromkeys(features)}
    with torch.no_grad():
        want = ref.reference_sequence(weights, frames, cell.config,
                                      cell.workload, keep=set(samples), **kw)
    lim = cell.workload["check"]["limits"]
    n = sum(len(v) for v in samples.values())
    gaps = dict(zip(("x_hat_max_gap", "x_hat_mean_gap"),
                    frame_gaps(samples, want)))
    if features is not None:
        gaps.update(zip(("feature_max_gap", "feature_mean_gap"),
                        frame_gaps({p: [f] for p, f in features.items()},
                                   kw["features"])))
    return [{"name": k, "value": v, "limit": lim[k],
             "compared": len(features) if k.startswith("feature") else n}
            for k, v in gaps.items() if k in lim]


def _fold(x, parts):
    c = x.shape[1] // parts
    out = x[:, :c]
    for k in range(1, parts):
        out = out + x[:, k * c:(k + 1) * c]
    return out


def rt_cdf_rows(scales_hat, parts, fz, smin=0.11, smax=16.0, levels=128):
    """A y pass's K2 row ids: each kept symbol's CDF index (its folded
    masked scale's log, quantized to one of the 128 levels, truncated),
    SKIP where the scale is at most force_zero_thres; channel-major."""
    import math
    s = torch.clamp(_fold(scales_hat, parts).float(), smin, smax)
    recip = (levels - 1) / (math.log(smax) - math.log(smin))
    idx = ((torch.log(s) - float(math.log(smin))) * float(recip)) \
        .to(torch.uint8).to(torch.int64)
    if fz is not None:
        idx = torch.where(s > fz, idx, LR.SKIP)
    return idx.reshape(-1)


def symbol_planes(syms):
    """A frame's symbols in its stream's order, as int64 planes: z, then
    each y pass's parts folded into one (`syms`: (z, [(y_q, masked
    scales)]), as the reference gives them)."""
    z, passes = syms[0], syms[1:]
    return [z.reshape(-1).to(torch.int64)] + \
        [_fold(y_q, len(passes)).reshape(-1).to(torch.int64)
         for y_q, _ in passes]


def stream_planes(stream, want, tables, fz, device):
    """The planes a DCVC-RT device-EC stream holds, read by the plain
    decoder with the reference's own tables and CDF indexes (taken from
    the reference's symbols `want`), and whether the container was read to
    its end."""
    z, passes = want[0], want[1:]
    dec = LR.LaneDecoder(stream, device)
    c = z.shape[1]
    z_rows = torch.arange(z.numel(), device=z.device) // (z.numel() // c)
    planes = [dec.plane(z_rows, tables["z"])]
    for _, scales_hat in passes:
        planes.append(dec.plane(rt_cdf_rows(scales_hat, len(passes), fz),
                                tables["y"]))
    return planes, dec.done()


def rt_tables(weights, cfg, device):
    """The reference's CDF tables of DCVC-RT at the configuration's qp:
    the 128 Gaussian y rows and each codec's z rows."""
    def z_rows(p):
        params = {k: {n: v.detach().cpu().numpy() for n, v in layer.items()}
                  for k, layer in p["bit_estimator_z"].items()}
        return torch.from_numpy(LR.factorized_rows(params, cfg["qp"])) \
            .to(device)

    y = torch.from_numpy(LR.gaussian_rows()).to(device)
    return {"I": {"y": y, "z": z_rows(weights["intra"])},
            "P": {"y": y, "z": z_rows(weights["inter"])}}


def encoded_symbols(cell, ref, weights, frames, samples, read=None):
    """Checks of an encoding cell: the symbols of its sampled outputs
    against the reference's.  `read(pos, out, want)` turns an output into
    its planes and whether its container was read to its end (one more
    mismatch where not); by default an output is already its planes."""
    with torch.no_grad():
        want = ref.reference_symbols(weights, frames, cell.config,
                                     cell.workload, keep=set(samples))
    bad = 0
    for pos, outs in samples.items():
        ref_planes = symbol_planes(want[pos])
        for out in outs:
            planes, whole = read(pos, out, want[pos]) if read else (out, True)
            bad += sum(int((g != w).sum())
                       for g, w in zip(planes, ref_planes, strict=True))
            bad += 0 if whole else 1
    n = sum(len(v) for v in samples.values())
    return [{"name": "symbol_mismatches", "value": bad,
             "limit": cell.workload["check"]["limits"]["symbol_mismatches"],
             "compared": n}]


def encoded_streams(cell, ref, weights, frames, samples, device):
    """Checks of an encoding cell whose outputs are device-EC streams,
    read back with the reference's tables."""
    tables = rt_tables(weights, cell.config, device)
    fz = cell.config.get("force_zero_thres")

    def read(pos, stream, want):
        return stream_planes(stream, want, tables["I" if pos == 0 else "P"],
                             fz, device)

    return encoded_symbols(cell, ref, weights, frames, samples, read)
