"""Frame-by-frame decode on the host coder (DCVC-FM).

Set-up encodes one intra period with the measured package's FM codecs
on the host coder, under the FM harness's frame schedule (hierarchical
P-frame QPs, a refresh at t % reset_interval == 1).  A pass decodes the
period from its I-frame (`DMCIFM.decompress`, then `DMCFM.decompress`
frame after frame), carrying the DPB as the FM harness carries it; the
host waits for the device only where the coder needs a plane's indexes,
and the window ends with a synchronize."""

from core.mode import Mode


class Run(Mode):
    def __init__(self, cell, weights, seed, device, rec):
        from core import content
        from core.record import clock_coder
        from opendcvc_tpu_torch.models.dmc_fm import DMCFM
        from opendcvc_tpu_torch.models.dmci_fm import DMCIFM
        from reference.fm import schedule
        super().__init__(cell, device, rec)
        cfg, wl = cell.config, cell.workload
        self.period = wl["intra_period"]
        self.plan = [schedule(t, cfg["qp_i"], cfg["qp_p"],
                              cfg["reset_interval"])
                     for t in range(self.period)]

        def codec(cls, role, clocked):
            net = cls(device=device, device_ec=False)
            net.load_params(weights[role])
            net.update()
            if clocked:
                clock_coder(net.entropy_coder, rec)
            return net

        self.i_enc, self.p_enc = codec(DMCIFM, "intra", False), \
            codec(DMCFM, "inter", False)
        self.i_dec, self.p_dec = codec(DMCIFM, "intra", True), \
            codec(DMCFM, "inter", True)
        self.frames = content.make_frames(cfg, seed, self.period, device)
        h, w = self.frames[0].shape[1], self.frames[0].shape[2]
        self.size = (h, w)
        self.work = {"I": [("intra", "dec")], "P1": [("inter_reset", "dec")],
                     "P": [("inter", "dec")]}

    @staticmethod
    def _reset(dpb):
        return dict(dpb, ref_feature=None, ref_mv_feature=None, ref_y=None,
                    ref_mv_y=None)

    def setup(self):
        h, w = self.size
        self.streams, dpb = [], None
        for t, (qp, fa_idx) in enumerate(self.plan):
            sps = {"height": h, "width": w, "qp": qp, "fa_idx": fa_idx}
            if t == 0:
                enc = self.i_enc.compress(self.frames[0], qp)
                dpb = self._reset({"ref_frame": enc["x_hat"]})
            else:
                if fa_idx == 3:
                    dpb = self._reset(dpb)
                enc = self.p_enc.compress(self.frames[t], dpb, qp,
                                          min(fa_idx, 2))
                dpb = enc["dpb"]
            self.streams.append((enc["bit_stream"], sps))
        del self.i_enc, self.p_enc, enc, dpb

    def run_pass(self):
        rec, dpb = self.rec, None
        for t, (stream, sps) in enumerate(self.streams):
            with rec.span("call.dec"):
                if t == 0:
                    dpb = self._reset({"ref_frame": self.i_dec.decompress(
                        stream, sps)["x_hat"]})
                else:
                    if sps["fa_idx"] == 3:
                        dpb = self._reset(dpb)
                    dpb = self.p_dec.decompress(
                        stream, dpb, dict(sps, fa_idx=min(sps["fa_idx"], 2))
                    )["dpb"]
            rec.frame("I" if t == 0 else "P1" if sps["fa_idx"] == 3 else "P")
            self.keep(t, dpb["ref_frame"])

    def release(self):
        del self.i_dec, self.p_dec, self.frames, self.streams
        return self.samples
