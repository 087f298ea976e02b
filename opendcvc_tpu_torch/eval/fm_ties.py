"""Rounding ties between two encoders that coded a frame apart.

Two encoders that agree to float precision (the port on two devices, or
the port and the JAX package) can still round a value that lies at a
rounding boundary to different integers; the streams then differ.  This
module tells such a tie from a real mismatch:

  * `PreRoundingFloats` records, while on, the values the port's encoder
    rounds, in the order it computes them: each z plane
    (`round_and_to_int8`'s input), each y pass's residual
    (`process_with_mask`'s, or a dense latent's `quantize_dense`
    residual) and its CDF index before truncation (`build_index_dec`'s);
  * `record_coded(net, log)` logs each plane a codec hands its coder, in
    coding order;
  * `first_differing_plane` finds the first plane, in compute order,
    whose coded symbols differ, and gives each differing element's
    distance from its value to the rounding boundary beside the
    tolerance it is held to (REL_TOL x the plane's max |value|).

PLANES holds, by frame kind, the order in which the codecs compute their
planes and the order in which they code them, and FOLD how a pass's
residual folds to its coded plane: the FM codecs ("i", "p"; DCVC-DC's
DMCDC computes and codes DMCFM's planes in DMCFM's orders) fold four
quarters, IntraNoAR ("noar") and DMCHEM ("hem") two checkerboard halves,
DMCTCM ("tcm") codes each latent whole.  The codecs and this module must
change together if either order changes.
"""

import numpy as np
import torch

from ..ops import fused as F

#: the codecs' float agreement, relative to a plane's max |value|
REL_TOL = 1e-4
#: each frame's planes: (compute order, coding order), by frame kind
PLANES = {"i": (["z", "y0", "y1", "y2", "y3"],
                ["z", "y0", "y1", "y2", "y3"]),
          "p": (["mv_z", "mv0", "mv1", "mv2", "mv3", "z", "y0", "y1", "y2",
                 "y3"],
                ["mv_z", "z", "mv0", "mv1", "mv2", "mv3", "y0", "y1", "y2",
                 "y3"]),
          "noar": (["z", "y0", "y1"], ["z", "y0", "y1"]),
          "hem": (["mv_z", "mv0", "mv1", "z", "y0", "y1"],
                  ["mv_z", "mv0", "mv1", "z", "y0", "y1"]),
          "tcm": (["mv_z", "mv", "z", "y"], ["mv_z", "mv", "z", "y"])}
#: how a y pass's residual folds to its coded plane, by frame kind
FOLD = {"i": F.fold_quarters, "p": F.fold_quarters, "noar": F.fold_halves,
        "hem": F.fold_halves, "tcm": lambda t: t}


def _flat(t):
    """A (1, C, H, W) tensor flattened NHWC, as a float32 copy on the
    host."""
    return t.permute(0, 2, 3, 1).reshape(-1).to("cpu", torch.float32,
                                                copy=True)


def _host(t):
    """A float32 copy of t on the host."""
    return t.to("cpu", torch.float32, copy=True)


class PreRoundingFloats:
    """Context manager: inside it, `ops.fused`'s rounding entry points
    are wrapped, and while `on` is true each call's pre-rounding values
    are recorded; `take(kind)` hands out and clears the last frame's."""

    def __init__(self):
        self.on = False
        self.z, self.res, self.idx = [], [], []
        self._saved = None

    def __enter__(self):
        rnd, pwm, qd, bid = self._saved = (F.round_and_to_int8,
                                           F.process_with_mask,
                                           F.quantize_dense,
                                           F.build_index_dec)

        def round_and_to_int8(z):
            if self.on:
                self.z.append(_flat(z))
            return rnd(z)

        def process_with_mask(y, scales, means, mask, fz=None):
            out = pwm(y, scales, means, mask, fz)
            if self.on:
                self.res.append(_host(out[0]))
            return out

        def quantize_dense(y, means):
            if self.on:
                self.res.append(_host(y - means))
            return qd(y, means)

        def build_index_dec(scales, smin, smax, lsm, recip, thres=None):
            if self.on:
                s = torch.clamp(scales.float(), smin, smax)
                self.idx.append(_flat((torch.log(s) - lsm) * recip))
            return bid(scales, smin, smax, lsm, recip, thres)

        F.round_and_to_int8 = round_and_to_int8
        F.process_with_mask = process_with_mask
        F.quantize_dense = quantize_dense
        F.build_index_dec = build_index_dec
        return self

    def __exit__(self, *exc):
        (F.round_and_to_int8, F.process_with_mask, F.quantize_dense,
         F.build_index_dec) = self._saved
        return False

    def take(self, kind):
        """{plane name: values} of the last frame of `kind` (a key of
        PLANES): a z plane its floats, a y plane (residual folded to the
        coded plane, index float)."""
        compute = PLANES[kind][0]
        zs = [n for n in compute if n.endswith("z")]
        ys = [n for n in compute if not n.endswith("z")]
        out = dict(zip(zs, self.z))
        fold = FOLD[kind]
        out.update({n: (_flat(fold(r)), i)
                    for n, r, i in zip(ys, self.res, self.idx)})
        self.z, self.res, self.idx = [], [], []
        return out


def record_coded(net, log):
    """Append to `log` each plane the codec `net` (an FM codec, DMCDC,
    IntraNoAR, DMCHEM or DMCTCM) hands its coder, in coding order."""
    ge = net.gaussian_encoder
    enc_y = ge.encode_y_packed

    def encode_y_packed(packed, *args):
        log.append(np.asarray(packed, np.int16).reshape(-1).copy())
        return enc_y(packed, *args)

    ge.encode_y_packed = encode_y_packed
    for be in (getattr(net, "bit_estimator_z_mv", None),
               net.bit_estimator_z):
        if be is None:
            continue

        def encode_z(z, qp, _f=be.encode_z):
            log.append(np.asarray(z, np.int8).reshape(-1).copy())
            return _f(z, qp)

        be.encode_z = encode_z


def boundary_distance(value):
    """Distance of |value| to the nearest k + 1/2 (round-half-even's
    boundary)."""
    a = np.abs(np.asarray(value, np.float64))
    return np.abs(a - np.floor(a) - 0.5)


def first_differing_plane(planes, other, floats, kind, rel_tol=REL_TOL):
    """The first plane, in compute order, whose symbols differ between
    two encoders' coded planes (`planes`, whose floats `floats` are, and
    `other`, both in coding order).  Returns (plane, rows), a row
    (what, element, value, distance to its rounding boundary, tolerance)
    for each differing element, what being "z", "index" (the CDF row
    differs) or "symbol"; (None, []) when every plane is equal."""
    compute, coding = PLANES[kind]
    for name in compute:
        a, b = planes[coding.index(name)], other[coding.index(name)]
        diff = np.flatnonzero(a != b)
        if not diff.size:
            continue
        if name.endswith("z"):
            v = floats[name].numpy().astype(np.float64)
            tol = rel_tol * float(np.abs(v).max())
            return name, [("z", int(i), float(v[i]),
                           float(boundary_distance(v[i])), tol)
                          for i in diff]
        res, idx = (t.numpy().astype(np.float64) for t in floats[name])
        tol_idx = rel_tol * float(np.abs(idx).max())
        tol_res = rel_tol * float(np.abs(res).max())
        rows = []
        for i in diff:
            if (int(a[i]) & 255) != (int(b[i]) & 255):
                rows.append(("index", int(i), float(idx[i]),
                             float(abs(idx[i] - np.round(idx[i]))),
                             tol_idx))
            else:
                rows.append(("symbol", int(i), float(res[i]),
                             float(boundary_distance(res[i])), tol_res))
        return name, rows
    return None, []
