"""GOP decode on device EC (DCVC-RT): the measured package's bench traffic.

Set-up encodes one intra period with the measured package (the streams
this traffic replays): an I-frame (`DMCI.compress`), one P-frame on the
single-frame path (its feature adaptor starts from the decoded I-frame),
then `gop_chunks` chunks of `gop_n` P-frames (`DMC.compress_gop`).  A
pass decodes the period from its I-frame: `DMCI.decompress`, the first
P-frame by `DMC.decompress`, then the chunks, each chunk's upload
(`upload_gop`) queued before the previous chunk's decode
(`decompress_gop_uploaded`), with no wait for the device until the window
ends.

The codecs, their weights and the frames are in the configuration's
precision: in bfloat16 the codecs are built with `dtype=` and their float32
leaves cast to it (`cast_floating`), as the measured package's bench does.
Where the workload's check has a `dec_enc_max_gap` limit, each pass also
holds the decoder to the set-up encoder on the device, without a wait: the
I-frame against `DMCI.compress`'s x_hat, and the propagated feature after
the first P-frame and after the last chunk against the encoder's DPB
feature at the same points (the encoder keeps no P-frame pixels; the
decoder's x_hat is a function of that feature)."""

import torch

from core.mode import Mode
from counts import lane_rans
from reference.nn import dtype_of

WORST = float(torch.finfo(torch.float32).max)


class Run(Mode):
    def __init__(self, cell, weights, seed, device, rec):
        from core import content
        from opendcvc_tpu_torch.models.dmc import DMC
        from opendcvc_tpu_torch.models.dmci import DMCI
        from opendcvc_tpu_torch.utils.params import cast_floating
        super().__init__(cell, device, rec)
        cfg, wl = cell.config, cell.workload
        self.qp, self.fz = cfg["qp"], cfg.get("force_zero_thres")
        self.gop_n, self.n_chunks = wl["gop_n"], wl["gop_chunks"]
        self.period = 2 + self.gop_n * self.n_chunks
        ec = wl["ec"]
        dtype = dtype_of(cfg)
        self.enc_out = {} if "dec_enc_max_gap" in wl["check"]["limits"] \
            else None
        self.dec_enc, self.n_matched = None, 0
        # the last pass's propagated features after the first P-frame and
        # after the last chunk, held against the reference's
        self.features = {} if "feature_mean_gap" in wl["check"]["limits"] \
            else None

        def codec(cls, role, **kw):
            net = cls(device=device, device_ec=True, lanes=ec["lanes"],
                      bytes_per_symbol=ec["bytes_per_symbol"], dtype=dtype,
                      **kw)
            net.load_params(cast_floating(weights[role], dtype))
            net.update(force_zero_thres=self.fz)
            return net

        self.i_enc = codec(DMCI, "intra")
        self.p_enc = codec(DMC, "inter", cap_frac=ec["cap_frac"])
        self.i_dec = codec(DMCI, "intra")
        self.p_dec = codec(DMC, "inter", cap_frac=ec["cap_frac"])
        self.frames = content.make_frames(cfg, seed, self.period, device,
                                          dtype)
        h, w = self.frames[0].shape[1], self.frames[0].shape[2]
        self.size = (h, w)
        self.sps = {"sps_id": 0, "height": h, "width": w,
                    "ec_part": 1 if cfg["height"] * cfg["width"] > 1280 * 720
                    else 0, "use_ada_i": 0}
        self.work = {"I": [("intra", "dec")], "P1": [("inter_first", "dec")],
                     "P": [("inter", "dec")]}

    def setup(self):
        qp, f = self.qp, self.frames
        enc0 = self.i_enc.compress(f[0], qp)
        self.p_enc.clear_dpb()
        self.p_enc.set_curr_poc(0)
        self.p_enc.add_ref_frame(None, enc0["x_hat"])
        s1 = self.p_enc.compress(f[1], qp)["bit_stream"]
        if self.enc_out is not None:
            self.enc_out[0] = enc0["x_hat"]
            self.enc_out[1] = self.p_enc.dpb[0].feature
        chunks = []
        for c in range(self.n_chunks):
            lo = 2 + c * self.gop_n
            chunks.append(self.p_enc.compress_gop(
                f[lo:lo + self.gop_n], [qp] * self.gop_n)["bit_streams"])
        if self.enc_out is not None:
            self.enc_out[self.period - 1] = self.p_enc.dpb[0].feature
        self.streams = (enc0["bit_stream"], s1, chunks)
        self.k2_launches = lane_rans.rt_period_launches(
            [enc0["bit_stream"], s1] + [s for c in chunks for s in c],
            *self.size)
        del self.i_enc, self.p_enc, enc0

    def run_pass(self):
        s0, s1, chunks = self.streams
        qps = [self.qp] * self.gop_n
        rec, dec = self.rec, self.p_dec
        with rec.span("call.dec"):
            x = self.i_dec.decompress(s0, self.sps, self.qp)["x_hat"]
        rec.frame("I")
        self.keep(0, x)
        self.match(0, x)
        dec.clear_dpb()
        dec.set_curr_poc(0)
        dec.add_ref_frame(None, x)
        with rec.span("call.dec"):
            x = dec.decompress(s1, self.sps, self.qp)["x_hat"]
        rec.frame("P1")
        self.keep(1, x)
        self.match(1, dec.dpb[0].feature)
        if self.features is not None:
            self.features[1] = dec.dpb[0].feature
        with rec.span("call.dec"):
            up = dec.upload_gop(chunks[0], self.sps)
        for i in range(self.n_chunks):
            with rec.span("call.dec"):
                nxt = dec.upload_gop(chunks[i + 1], self.sps) \
                    if i + 1 < self.n_chunks else None
                if up is not None:
                    out = dec.decompress_gop_uploaded(up, self.sps, qps)
                else:       # a chunk of mixed ladder rungs
                    out = dec.decompress_gop(chunks[i], self.sps, qps)
            rec.frame("P", self.gop_n)
            for j in range(self.gop_n):
                self.keep(2 + i * self.gop_n + j, out["x_hat"][j])
            up = nxt
        self.match(self.period - 1, dec.dpb[0].feature)
        if self.features is not None:
            self.features[self.period - 1] = dec.dpb[0].feature

    def match(self, pos, got):
        """Fold the widest gap between the decoder's `got` and the set-up
        encoder's output at `pos` into a running maximum on the device (a
        NaN or an infinity reads as float32's largest number)."""
        if self.enc_out is None:
            return
        gap = torch.nan_to_num(
            (got.float() - self.enc_out[pos].float()).abs().amax(),
            nan=WORST)
        self.dec_enc = gap if self.dec_enc is None \
            else torch.maximum(self.dec_enc, gap)
        self.n_matched += 1

    def release(self):
        """Free the measured codecs and frames; returns the samples."""
        del self.i_dec, self.p_dec, self.frames, self.streams
        if self.dec_enc is not None:
            self.dec_enc = float(self.dec_enc)
        self.enc_out = None if self.enc_out is None else {}
        return self.samples

    def compare(self, ref, weights, frames, samples):
        from core import checks
        out = checks.decoded_frames(self.cell, ref, weights, frames,
                                    samples, self.features)
        lim = self.cell.workload["check"]["limits"]
        if "dec_enc_max_gap" in lim:
            # a run that matched nothing fails
            out.append({"name": "dec_enc_max_gap",
                        "value": WORST if self.dec_enc is None
                        else self.dec_enc,
                        "limit": lim["dec_enc_max_gap"],
                        "compared": self.n_matched})
        return out
