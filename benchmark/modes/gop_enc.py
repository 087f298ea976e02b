"""GOP encode on device EC (DCVC-RT): the measured package's bench traffic.

The period's frames are made on the card in set-up.  A pass encodes the
period: the I-frame (`DMCI.compress`), the first P-frame on the
single-frame path (its feature adaptor starts from the I-frame's
reconstruction), then `gop_chunks` chunks of `gop_n` P-frames
(`DMC.compress_gop_async`), each chunk's streams settled on one of two
pool threads while the next chunk is queued, as the package's bench does;
the pass ends when every chunk's streams are back on the host."""

from concurrent.futures import ThreadPoolExecutor

from core.mode import Mode


class Run(Mode):
    def __init__(self, cell, weights, seed, device, rec):
        from core import content
        from opendcvc_tpu_torch.models.dmc import DMC
        from opendcvc_tpu_torch.models.dmci import DMCI
        super().__init__(cell, device, rec)
        cfg, wl = cell.config, cell.workload
        self.qp, self.fz = cfg["qp"], cfg.get("force_zero_thres")
        self.gop_n, self.n_chunks = wl["gop_n"], wl["gop_chunks"]
        self.period = 2 + self.gop_n * self.n_chunks
        ec = wl["ec"]
        self.i_enc = DMCI(device=device, device_ec=True, lanes=ec["lanes"],
                          bytes_per_symbol=ec["bytes_per_symbol"])
        self.i_enc.load_params(weights["intra"])
        self.i_enc.update(force_zero_thres=self.fz)
        self.p_enc = DMC(device=device, device_ec=True, lanes=ec["lanes"],
                         bytes_per_symbol=ec["bytes_per_symbol"],
                         cap_frac=ec["cap_frac"])
        self.p_enc.load_params(weights["inter"])
        self.p_enc.update(force_zero_thres=self.fz)
        self.frames = content.make_frames(cfg, seed, self.period, device)
        self.size = tuple(self.frames[0].shape[1:3])
        self.work = {"I": [("intra", "enc")], "P1": [("inter_first", "enc")],
                     "P": [("inter", "enc")]}
        self.pool = ThreadPoolExecutor(max_workers=2)
        self.streams = None

    def compare(self, ref, weights, frames, samples):
        from core import checks
        return checks.encoded_streams(self.cell, ref, weights, frames,
                                      samples, self.dev)

    def run_pass(self):
        rec, qp, f, enc = self.rec, self.qp, self.frames, self.p_enc
        qps = [qp] * self.gop_n
        with rec.span("call.enc"):
            out = self.i_enc.compress(f[0], qp)
        rec.frame("I")
        enc.clear_dpb()
        enc.set_curr_poc(0)
        enc.add_ref_frame(None, out["x_hat"])
        with rec.span("call.enc"):
            s1 = enc.compress(f[1], qp)["bit_stream"]
        rec.frame("P1")
        handles = []
        for c in range(self.n_chunks):
            lo = 2 + c * self.gop_n
            with rec.span("call.enc"):
                handles.append(self.pool.submit(enc.compress_gop_async(
                    f[lo:lo + self.gop_n], qps)))
        streams = [out["bit_stream"], s1]
        for h in handles:
            streams += h.result()
            rec.frame("P", self.gop_n)
        for pos, s in enumerate(streams):
            self.keep(pos, s)
        self.streams = streams

    @property
    def k1_launches(self):
        """[(K, L, mw, entries)] of the last pass's frames, read off their
        containers."""
        from counts import lane_rans
        return [lane_rans.k1_launch(s) for s in self.streams or ()]

    def release(self):
        self.pool.shutdown(wait=True)
        del self.i_enc, self.p_enc, self.frames
        return self.samples
