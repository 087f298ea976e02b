#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (opendcvc_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR]

Phases (any failure exits nonzero and prints no result):
  1. build the CUDA kernels from opendcvc_tpu_torch/csrc (nvcc, sm_90a);
  2. hold K1 (lane rANS encode) and K2 (decode) against their plain
     PyTorch versions, bit for bit: K1 at 4096 lanes, 272 steps, a
     256-row combined random table, ~30 % skip slots, then at the main
     path's own frames, one launch each over the port's combined y + z
     table (symbols drawn from each row, ~30 % skips): a DMC frame (16 z
     + 2 x 128 y steps), a DMCI frame (16 + 4 x 128) and a DMC frame
     under skip compaction at phase 10 (a)'s first rung (16 + 2 x 64),
     a DMCIFM frame (16 + 4 x 128 over its 384-row [y | qp's z] table)
     and a DMCFM frame (8 + 4 x 32 + 8 + 4 x 64 over its 384-row table),
     each at the staging ladder's first and top rung, and at the
     contract's edges (a
     partial warp, row ids past the table, odd staging widths that some
     lanes overflow); K2 on one 272-step launch over
     a 128-row table, then at the main path's own launch shapes, decoding
     those frames: a DMC frame's z (16 steps, the port's 128-row z
     table), y0 and y1 (128 steps, its 128-row y table), a DMCI
     frame's z and four y quarters, the compacted DMC frame's z, y0
     and y1 (64 steps), a DMCIFM frame's z (16 steps, 128 rows) and four
     y quarters (128 steps on the 256-row y table) and a DMCFM frame's
     motion z, four motion-y quarters (32 steps, 256 rows), z and four y
     quarters (64 steps, 256 rows), the z planes on 65-row tables (the y
     table's row 0 for the lanes' pad slots, then the plane's 64 rows);
     row 255 of a 256-row table is coded and the sentinel DEC_SKIP (511)
     skips; with the (state, ptr) carry handed
     from launch to launch, and on arbitrary words at the contract's
     edges (a partial warp, clamped rows, pointers past either end).
     Every launch is timed as the median of 20 launches with CUDA events
     around the wrapper call (`ms`, the host's call time included) and
     again queued behind a sleep so the events time the device alone
     (`device_ms`); K2's per-frame totals are the sums of the timed
     launches of each frame;
  3. DMCI at 1080p full width (N = 256, z 128), f32, force_zero_thres
     0.12, flat q banks, device EC: one I-frame compress + decompress, the
     decoded frame equal to the encoder's;
  4. DMC at 1080p full width, device EC, seeded from phase 3's frame:
     four P-frames compress, then decompress, the decoder's feature equal
     to the encoder's after every frame; then decompress again from the
     reference under torch.profiler, every frame a replay of the CUDA
     graph the first decode captured (opendcvc_tpu_torch/utils/graph.py):
     the x_hats the first decode's, and the K2 (`lr_decode_kernel`) and
     D1-D4 (`dcb_elementwise_*`) kernels the trace lists equal to the
     launches the replays counted (`k2.launch`, `dcb.launch.*`), which
     no host call made;
  5. a 64x64 I-frame coded on the GPU and on the CPU with the same
     weights, through device EC and through host EC: the CPU decodes the
     GPU's stream and the two agree (the CPU path is the one the test
     suite holds against the JAX package); then a host-EC chain, a 64x64
     I-frame and 3 P-frames coded on the GPU and decoded by the CPU port,
     logging per frame the max |x_hat diff|, the feature diff and whether
     the GPU's and the CPU's streams are identical (fails on a decode
     error or a diff over 1e-3); then a bfloat16 row, reported and never
     failed: the 64x64 I-frame's encoder on the GPU and the CPU (the share
     of equal symbols per plane, the max |x_hat diff|) and whether the CPU
     decodes the GPU's bfloat16 host-EC stream;
  6. the host-EC sequence at 1080p: phases 3-4's weights, frames, qp and
     force_zero_thres, the C++ rANS coder on the host with two coders (as
     the harness above 1280x720); the I-frame and 4 P-frames encoded and
     written as one NAL stream (SPS, then I/P records) into memory, parsed
     back and decoded from those bytes.  The encoder's x_hat and features
     must equal phases 3-4's bit for bit, the decoded I-frame the
     encoder's, the decoder's feature the encoder's after every P-frame
     and each decoded P-frame phase 4's; K1 and K2 must not launch.
     Prints per frame the enc/dec ms, the host coder's ms within them,
     the device->host waits and uploads, and the bpp beside phase 3-4's.
  7. the RD harness, `opendcvc_tpu_torch.eval.harness.main`, in process,
     as a user runs it: a 1920x1080 8-bit YUV420 sequence of 16 textured
     frames and its dataset config (src_type yuv420, intra_period 32)
     written to a temporary directory, coded at qp 21, force_zero_thres
     0.12, reset_interval 8 (a periodic refresh at frames 1 and 9) with
     random full-width weights (--seed 0) into a NAL .bin, decoded from
     the file, the recon .yuv and the RD JSON written; run (a) with host
     EC (the default), run (b) with OPENDCVC_TPU_DEVICE_EC=1.  Fails
     unless, in both runs, every decoded frame equals the encoder's bit
     for bit (the codecs that build_nets returns are wrapped to record
     them), the JSON's bits are 8 x the .bin's size, the recon file has
     16 frames and its PSNR lies within 0.5 dB of the JSON's; K1 and K2
     launch in (b) and not in (a); per-frame PSNR is equal in (a) and
     (b).  Prints per run the harness's average frame times (frames
     10-15), bpp, PSNR, test_time, the time outside the codec calls and
     the decoder graphs' counters (`graph.call`, `graph.replay`,
     `graph.capture`) over its qp cycle (21, 29, 25: one graph for each
     container rung the streams hold, not for each qp).
  8. the port's benchmark, `opendcvc_tpu_torch.bench`, in process at
     bench.py's defaults: 1080p, 32 P-frames in GOP chunks of 8 (encode
     pipelined over two pool threads, chunk k + 1 uploaded before chunk
     k's decode), a batch of 8 intra frames, force_zero_thres 0.12, qp 21,
     device EC (4096 lanes, 0.4 bytes a symbol, P cap fraction 0.375).
     Fails unless K1 launched once a coded frame plus once a rerun and K2
     3 times a decoded P-frame and 5 an I-frame; the first chunk's GOP
     streams equal the same frames coded one by one through
     compress_async; decompress_gop and the last uploaded chunk equal the
     per-frame decode, whose final feature is the GOP decoder's and the
     encoder's; the batch's streams, x_hats and batched decode equal
     DMCI.compress and decompress frame by frame.  Prints the bench's
     JSON line, its ms a chunk and a batch, and a chunk's staging bytes
     with the time of one pinned copy of them each way.
  9. DCVC-RT in bfloat16 (`dtype=torch.bfloat16`), phases 3-8's
     configuration: (a) phases 3-4 (device EC), then phase 6 (host EC,
     two coders, one NAL stream) in bfloat16: each decoded I-frame equal
     to the encoder's, the decoder's feature the encoder's after every
     P-frame, host EC equal to device EC in encoder x_hat, features and
     decoded frames; K1 and K2 launch in the device-EC run only; the frame
     times and bpp printed beside phases 3-4's float32 ones; (b) the
     bench with BENCH_DTYPE=bfloat16 under phase 8's checks; (c) the
     harness with --dtype bfloat16 and device EC on the first 8 frames of
     phase 7's sequence under phase 7's checks.
 10. the training slice: (a) phases 3-4 with skip compaction
     (OPENDCVC_TPU_EC_SKIP_COMPACT=1, first rung at the default survivor
     share), then a P-frame and a GOP chunk of 8 P-frames: decoder exact
     on every frame, the chunk's streams equal to the frames coded one by
     one, K1 and K2 launched once a coded frame or rerun and 5 / 3 times a
     decoded I / P-frame, every K1 launch at k_z + 2 kyc (DMC) or k_z + 4
     kyc (DMCI) steps and each stream's K that of its kyc; prints each
     frame's kyc, the reruns, frame times and bpp beside phases 3-4's and
     a chunk's staging bytes; (b) `python -m opendcvc_tpu_torch.train_video`
     in process at its defaults (synthetic data, batch 8, crop 256, 7
     steps) with --model dmci and --model dmc --frames 3: finite losses,
     float32 parameters and Adam state; the loss on one fixed batch falls
     over 5 steps at lr 1e-4 without warmup; the saved checkpoints load in
     DMCI and DMC, which code a 1080p I-frame and P-frame with the decoder
     exact; prints the median ms a step after 2 warm-up steps, samples/s
     and the peak of torch.cuda.max_memory_allocated; (c) the same runs
     with --amp 1; (d) the harness with --write_stream 0 on the first 8
     frames of phase 7's sequence: the JSON written, every bpp and PSNR
     finite, no stream; prints them beside phase 7's and the seconds a
     frame.
 11. DCVC-FM (DMCIFM N 256, z 128; DMCFM at its module widths), host EC,
     the port's random weights (DMCIFM seed 0, DMCFM seed 1): (a)
     `opendcvc_tpu_torch.eval.fm_harness.main` in process on the first 10
     frames of phase 7's sequence at qp 21 with reset_interval 5, so the
     stream holds fa_idx 0, 1 and 2 and two refreshes (fa_idx 3, frames 1
     and 6): fails unless every decoded frame's DPB (all five entries)
     equals the encoder's, the JSON's bits are 8 x the .bin's size and
     every PSNR is finite; prints per frame the enc / dec ms (host clock,
     synchronized), the host coder's ms within them, the record's bytes,
     bpp and PSNR, and test_time; (b) DMCIFM and DMCFM(stream_part=2) on
     (a)'s first 5 frames with (a)'s schedule: decoder exact every frame,
     every P stream a 2-part stream; ms and bytes beside (a)'s; (c) a
     64x64 I-frame and 2 P-frames coded on the GPU, each also coded on
     the CPU from the GPU's reference and decoded by the CPU port from
     it: fails on a decode error or a DPB diff over 1e-3 (phase 5's
     limit), unless the two devices' symbols differ only where the GPU's
     value lies within the codecs' float agreement of its rounding
     boundary (printed with that distance; the row is then reported).
 12. DCVC-FM on device EC: phase 11's frames, weights and schedule: (a)
     the FM harness with OPENDCVC_TPU_DEVICE_EC=1 under phase 11 (a)'s
     checks, and every frame's encoder and decoder DPB (all five entries;
     x_hat on the I-frame) and per-frame PSNR equal to phase 11 (a)'s
     host-EC ones; K1 launched once a frame plus once a ladder rerun, K2
     5 times a decoded I-frame and 10 a P-frame, held exactly; prints per
     frame the enc / dec ms beside host EC's, the bytes, bpp, reruns and
     the count of y and motion-y CDF indexes of 255 (the JAX package's
     device EC skips that row, the port codes it); (b) DMCIFM and DMCFM
     on device EC called directly on the I-frame and four P-frames with
     (a)'s schedule: per-frame launches exact, decoder exact, encoder
     DPB (a)'s, enc / dec ms printed; (c) phase 11 (c) on device EC (the
     planes compared are the host-EC coder's on each device, the same
     planes).
 13. one 64x64 frame coded on the card with the committed trained
     checkpoint docs/dmci_tiny_rd.msgpack through DMCI host EC and device
     EC, both decoders exact; the frame, streams, the card's x_hats and
     the card and versions written to OUT/h100_streams (`--out OUT`,
     default chip_smoke_out), whose committed copy (tests/data/h100) the
     CPU tests decode with the JAX package and the port.
 14. DCVC-FM in bfloat16: phase 12 (b)'s I-frame and four P-frames through
     DMCIFM / DMCFM(dtype=torch.bfloat16), seeds 0 / 1, qp 21, (a) on host
     EC and on device EC, (b) on host EC with stream_part 2: fails unless
     every decoder's DPB (all five entries, bfloat16) equals its
     encoder's, device EC's and the 2-part run's DPBs equal host EC's on
     every frame, and K1 launched once a frame plus once a rerun and K2 5
     / 10 times a decoded I / P-frame on device EC, never on host EC;
     prints per frame each run's enc / dec ms beside phase 12 (b)'s
     float32, the host coder's ms, bytes, bpp, reruns and the count of y
     and motion-y CDF indexes of 255; (c) a 64x64 bfloat16 chain coded on
     the GPU and the CPU: equal symbols per plane and whether the CPU
     decodes the GPU's stream, reported and never failed (phase 5's
     bfloat16 row).
 15. DCVC-DC (DMCDC) at tools/family_bench.py's operating point: 704x1280,
     3 P-frames after a raw reference (family_bench's frames, seed 3),
     q_index 30 on the fine ladder, frame_idx t, host EC: (a) float32 and
     bfloat16, stream_part 1 and 2: fails unless every decoded DPB entry
     equals the encoder's (in the codec's dtype) and the 2-part DPBs the
     1-part ones; prints per frame the enc / dec ms, the host coder's ms
     within them and bpp; (b) `opendcvc_tpu_torch.family_bench.main` in
     process at its defaults with FAM_CODECS=dc, its dc row printed; (c)
     a 64x64 float32 chain coded on the GPU, decoded by the CPU within
     phase 5's 1e-3 (phase 11 (c)'s rule for a rounding tie), identical
     streams reported.  Neither kernel may launch.
 16. DCVC-HEM at family_bench's operating point (704x1280, its frames,
     seed 2; the port's init, seed 0, HEM's anchors spread to [2.0, 1.2,
     0.8, 0.5], the rung get_interpolated_q_scales(4)[1]), host EC: (a)
     an IntraNoAR I-frame (q_scale 1.0), then 3 DMCHEM P-frames from its
     x_hat, in float32 and bfloat16: fails unless the decoded I-frame
     equals the encoder's x_hat and every decoded DPB entry (all four)
     the encoder's, of the codec's dtype; prints per frame the enc / dec
     ms, the host coder's ms within them and bpp; (b) family_bench's hem
     row (FAM_CODECS=hem); (c) a 64x64 float32 I-frame and 2 P-frames
     coded on the GPU, decoded by the CPU, under phase 15 (c)'s rule.
 17. DCVC-TCM at family_bench's operating point (704x1280, 3 P-frames
     after its raw reference, seed 1; seed-0 weights), host EC: (a)
     float32 and bfloat16, fails unless the decoder's x_hat and feature
     equal the encoder's; times and bpp as 16 (a); (b) the tcm row; (c)
     a 64x64 float32 chain GPU -> CPU as 16 (c); (d) `python -m
     opendcvc_tpu_torch.train_video --model tcm` in process at its
     defaults (batch 8, crop 256, --frames 3, 7 steps, synthetic data):
     finite losses, float32 state, ms a step and peak memory printed, then
     5 steps on one fixed batch, whose loss must fall.  Neither kernel
     may launch in phases 16-17.
 18. EVC, host EC: (a) EVC_LL at family_bench's point (704x1280, its
     frames, seed 4, 3 images, q_scale 1.0; seed-0 weights) in float32
     and bfloat16, then bfloat16 with q_basic from U(0.6, 3.0) at q_scale
     0.37, then the seven other width classes and ScalableEVC at rates
     0-3 in float32: every decoded x_hat equals the encoder's bit for
     bit; per image enc / dec ms, the host coder's ms and bpp printed;
     the evc row; (b) the image harness (EVC_LL, --rate_num 4,
     --calc_ssim 1) on four 768x512 images, through `main` on PNGs when
     PIL imports, else `run_one_image`: each .bin's bits 8 x its size,
     each decoded frame the encoder's x_hat, PSNR finite; (c) a 64x64
     image coded on the GPU, decoded by the CPU within 1e-3.
 19. DCVC, host EC, the AR loop on the host: (a) family_bench's point
     (256x256, its frames, seed 5, 3 P-frames each against the raw frame
     0) on the seed-0 weights and on the "live" tree (the last conv of
     mv_enc, ctx_enc, prior_enc and mv_prior_enc scaled by 20, so every
     plane carries non-zero symbols, counted and required), float32 and
     bfloat16: decompress equals recon_image bit for bit; per frame enc /
     dec ms, the coder's and the AR loop's ms, the four strings' bytes
     and bpp; the dcvc row; (b) a 64x64 live P-frame GPU -> CPU within
     1e-3; (c) `train_video --model dcvc` at its defaults (batch 8, crop
     256, --frames 2), 7 steps of --stage 4 (masks unchanged bit for
     bit), a fixed batch's loss falling over 5 steps, 3 steps of --stage
     2 (the motion branch unchanged too), then the checkpoint codes a
     256x256 pair in DCVCNet, the decoder exact.
 20. The CompressAI zoo (five models, default widths, seed-0 weights) on
     one 768x512 image, float32 and bfloat16: the decoded latent equals
     the encoder's (recomputed through the stage functions), x_hat in [0,
     1], a second decode identical; then a 64x64 image a model coded on
     the GPU and decoded by the CPU within 1e-3.  Neither kernel may
     launch in phases 18-20; each phase prints its seconds.
 21. The rest of training and the evaluation extras: (a) the DMCI
     campaign (`training/campaign.py`) at full width (N 256, z 128), 12
     steps of DEFAULT_STAGES (crops 128 / 192 / 256, batches 8 / 4 / 2), a
     16-image bank of 320 px, saves every 3 steps, float32, under
     torch.use_deterministic_algorithms (warn_only; the ops it warns
     about are printed): uninterrupted, killed at step 6 and resumed,
     the two train states equal byte for byte (with a warned op, within
     RESUME_ATOL) and in the JAX package's layout; then once with --amp
     (a float32 state); (b) the DMC campaign on (a)'s checkpoint (6 steps
     of DMC_STAGES, 16 sequences of 256 px), every reference rewritten,
     uninterrupted and killed at 3 and resumed, equal; losses finite,
     ms a step by stage (the campaign's log) and peak memory printed;
     (c) make_fm_loss through the train step at full width, batch 2,
     crop 256, 3 frames, float32 and AMP, 5 steps on one batch: the loss
     falls, the state stays float32; (d) make_train_step(plateau=True)
     on DMCI, 8 steps, factor 0.5, patience 2, rtol 0.5: each step's
     scale equals optax's rule replayed on the printed losses, and it
     fell; (e) precompute_references on four 448x256 im1.png (a Vimeo
     septuplet's frame) with (a)'s DMCI on device EC (K1) and host EC:
     equal PNGs, equal to compress's rounded x_hat; (f) rd_evidence's
     measure on docs/dmci_tiny_rd.msgpack (qps 20 / 40, 128 px; then
     1080x1920 at qp 20) on host EC, held to the JAX package's gate
     (0.97 < stream / estimate < 1.03, qp 20's bpp > 1.2 x qp 40's), and
     on device EC (K1), whose estimate and PSNR must equal host EC's (its
     stream carries the container's lane headers); measure_dmc on a
     random full-width DMC at 128 px on device EC (K1 + K2), decoder
     exact; train_tiny for 20 steps; (g) profile_dmc's stage table at
     1080p and report_dmci at 768x512.
 22. Multi-GPU training (`opendcvc_tpu_torch/parallel/`), by the cards
     visible (the branches run are printed): (a) always: `train_video
     --data_axis -1` (DMC at its defaults, 3 steps) under
     OPENDCVC_TPU_DIST on one NCCL rank against the same run without a
     process group, under deterministic algorithms: parameters, Adam's
     state, metrics and the checkpoint's bytes equal bit for bit; (b)
     with 2 cards: one step of DMC on clips (8, 2, 256, 256, 3) at data 2
     against one process on the whole batch within the JAX dryrun's
     bounds (|dloss| < 5e-4 max(1, |loss|), max|dparam| < 5e-5), the
     parameters bit-identical on both ranks; then train_video on one card
     at batch 8 and 2 and with --data_axis 2 at batch 8 and 16 (7
     steps, spawned NCCL ranks): ms a step, samples/s against one card,
     one all-reduce of the step's buffer (ms, bytes), peak memory; (c)
     with 4 cards: dryrun_multichip(4) over NCCL under the same bounds,
     --data_axis 4 at batch 8 and 32, and the full-width {data 2,
     spatial 2} DMC step at 1152x1920 (1080p padded so each shard is a
     multiple of 64 rows): step ms, the halo exchanges' calls, bytes and
     ms in one counted step, parameters bit-identical on every rank.  A
     branch that runs and fails fails the script.
 23. The last slice (run before phase 22): (a) transfer slimming at
     1088x1920 (1080p padded), device EC, float32, with
     OPENDCVC_TPU_EC_SLIM unset (on, the default) and at 0: DMCI (phase
     3's), a DMC P-frame alone and a GOP chunk of 8 (phase 8's chunk),
     compacted DMC (OPENDCVC_TPU_EC_SKIP_COMPACT, a P-frame and a chunk
     of 3), DMCIFM + 3 DMCFM P-frames; streams and K1 / K2 launches equal
     on and off, every decoder exact; a P-frame with the encode copy's
     window forced to 8 words: one miss, the window grown, the same
     bytes; each part's bytes each way, and the DMC chunk's copies timed
     at the window / bucket and at the full staging; (b) the eight
     mappers of utils/port_torch.py give back the port's init trees bit
     for bit from the reference state dicts tests/torch_port_reference_sd.py
     writes, and DMCI + DMC loaded through port_dmci / port_dmc code (a)'s
     I-frame and first 2 P-frames to (a)'s bytes; (c)
     tools/make_synth_dataset_torch.py at 1088x1920 (1 sequence, 3
     frames), coded by the port's harness on device EC, decoder exact;
     tools/bd_r5_torch.py on docs/dmci_tiny_rd.msgpack at 512x768 (4 QPs,
     2 images), its BD-rate reported only; (d) phase 8's bench again with
     OPENDCVC_TPU_EC_SLIM=0, its line beside phase 8's (the same bpp).
 24. The DepthConvBlock's epilogue kernels (csrc/dcb_epilogue.cu, run
     after phase 23): (a) bias + WSiLU with a -0.0 bias against x *
     torch.sigmoid(4.0 * x) on every float32 bit pattern (chunks of
     2^28) and every bfloat16 one, 0 differing elements (a NaN matches a
     NaN); (c) DMCI's I-frame, a DMC P-frame and a GOP chunk of 4 at
     1080p, device EC, encoded and decoded on the kernels, on the unfused
     chain (`ops/dcb_epilogue.py::epilogues` held to the plain twins)
     and on the kernels again, the decoder's body eager (no CUDA graph;
     phase 26 holds the graphs to it): streams and decoded frames equal byte for
     byte, `dcb.fused` equal to `dcb.block` on the kernels and 0 on the
     chain, the launches by kernel; (b) every distinct block call of (c)
     (adaptor, shortcut, quant step, widths, planes) on the kernels
     against the chain in float32 and bfloat16, 0 differing elements,
     and under autograd (training) its output and every gradient (x,
     each weight and bias, the quant step) 0 differing bits; (d) each
     kernel at the main path's shapes (C 256 / 320 at 136x240, 368 at
     68x120, both dtypes): median ms (the host's call inside the events,
     and the device's time alone), its bound (bytes at 3.35 TB/s) and
     the chain's ms, printed as one {"dcb_kernels": [...]} line; (e) the
     host's ms of each distinct block call of (c) with a sleep kernel
     holding the card (so the host never waits for it), on the kernels
     and on the chain, summed over (c)'s calls into host ms a frame.
 25. The bilinear warp W1 (csrc/flow_warp.cu, run after phase 24): at
     DCVC-FM's five 1080p calls of `flow_warp` (the reference frame, 3
     channels; c1_init, 48; offset diversity, 32 units of 3 with the
     mask; c2, 64 at half size; c3, 96 at quarter size) and DCVC-HEM's
     three 64-channel contexts, in float32 and bfloat16, flows uniform
     in +-8 px (the offset diversity's also in +-40, and as a smooth
     field of reach 40, like a motion field): W1 equal to the
     plain twin bit for bit, then the median of 20 calls of W1 (the
     host's call inside the events, and the device's time alone), its
     bound (bytes at 3.35 TB/s: image, flow and mask read once, output
     written once), the twin's ms and `F.grid_sample`'s (border padding,
     corners aligned, times the mask; the library yardstick, which the
     port never calls), printed as one {"warp_kernels": [...]} line.
 26. DMC's device-EC decoder body replayed from CUDA graphs
     (opendcvc_tpu_torch/utils/graph.py, run after phase 25): a 1080p
     period (a pixel reference, the first P-frame alone, 8 GOP chunks of
     8) encoded in float32 and in bfloat16 (phase 4's weights and
     force_zero_thres), then decoded as the benchmark decodes it (each
     chunk's upload queued before the previous chunk's decode) by the
     eager twin and twice on the graph path (the first decode captures,
     the second replays every frame): all 65 x_hats and the features
     after the first P-frame and after each chunk equal the twin's bit
     for bit, and the features the encoder's; `graph.call`,
     `graph.replay` and `graph.capture` as counted, K2's and D1-D4's
     launches equal on both paths.  The first P-frame and chunk 0 (9
     frames) decoded again eagerly and replayed, each under
     torch.profiler: the K2 and D1-D4 kernels the trace lists in each
     equal the launches the eager frames' host calls counted.  Then eager
     against replay: host ms a P-frame in the decode calls, wall ms a
     P-frame (synchronized), device ms and device operations a P-frame
     from those two traces, the capture's ms
     (a new key's first frame, its eager warm-up included, less an eager
     frame's) and the bytes the graphs' memory pools hold, printed as one
     {"graph_decode": [...]} line; the timed periods count no launches.
The host coder's ms, the device->host waits' and the uploads' come from
the port's trace (opendcvc_tpu_torch/utils/trace.py): a session around
each timed call, summing its `coder.*`, `wait.fetch` and `upload` spans.
The kernel launch counts (the trace's `k1.launch` and `k2.launch`
counters) are zeroed before phase 3 and read after
phase 4, so the counts are the main path's (the device-EC path); they are
zeroed again before phase 6 and must read 0 after it, again before each
run of phases 7, 9 and 10, and before phase 8; they are
zeroed before phase 11 and must read 0 after it, zeroed before phase
12, whose runs hold them exact, before phase 14, whose device-EC run
holds them exact and whose host-EC runs launch none, and before each of
phases 15-20, after which they must read 0, and before each device-EC
run of phase 21, before each of phase 23's parts, before phase 24 (c),
and before phase 22, after which they must read 0;
`launches` adds the device-EC runs of phases 7 (b), 8,
9, 10 (a, and the checkpoints' coding in b), 12, 14, 21 (e, f), 23, 24 and
26 to phases 3-4's, and `launches_by_run` splits it.  K2's launches in a
frame that a CUDA graph replayed are its capture's counts, added by the
replay (`graph.replay.k2.launch`): K2's record gives them by phase as
`replayed_by_run`, and as `replayed_traced` the K2 kernels that
torch.profiler listed in the replayed periods of phases 4 and 26, which
those phases hold equal to the counts.
W1's launches (`ops/warp.py::launches`) are held exact a frame wherever
DCVC-FM or DCVC-HEM codes one in phases 11 (a), 12 (a, b), 14, 16 (a)
and 23: FM_W1 / HEM_W1's (encoder, decoder) counts, 8 / 5 a P-frame,
8 / 4 in HEM, none an I-frame.  W1's record in the `kernels` line adds
its launches in phases 11, 12, 14, 15, 16, 17, 19, 21, 23 and 25, and
`launches_by_run` splits them; each FM and HEM phase must have some.
Then it
prints the card's name and power limit, one JSON line describing each
kernel, and, last, {"ok": true, "device": {...}}.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H, W = 1080, 1920
QP = 21
FZ = 0.12
L_MAIN, K_MAIN = 4096, 272
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
SCALAR_OPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
REPS = 20
SLEEP_CYCLES = 1_000_000    # ~0.5 ms: covers one wrapper call's host time


def _fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _log(msg):
    print(msg, flush=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


_LAUNCH_BASE = [0, 0]


def _counter(name):
    """The process total of the port's trace counter `name`
    (opendcvc_tpu_torch/utils/trace.py)."""
    from opendcvc_tpu_torch.utils import trace
    return trace.counters().get(name, 0)


def _launch_totals():
    return [_counter("k1.launch"), _counter("k2.launch")]


def _reset_launches():
    """Count K1 / K2 launches (the port's trace counters `k1.launch` /
    `k2.launch`, opendcvc_tpu_torch/utils/trace.py) from here on."""
    _LAUNCH_BASE[:] = _launch_totals()


def _launches():
    """[K1, K2] launches since the last _reset_launches()."""
    return [a - b for a, b in zip(_launch_totals(), _LAUNCH_BASE)]


def _replayed_k2():
    """K2 launches in this process that CUDA graphs' replays added from
    their captures' counts (the counter `graph.replay.k2.launch`, a part
    of `k2.launch`; utils/graph.py)."""
    return _counter("graph.replay.k2.launch")


def _replay_counted(store, name, fn, *args):
    """fn(*args), the K2 launches its graph replays added stored as
    store[name]; its result."""
    n0 = _replayed_k2()
    out = fn(*args)
    store[name] = _replayed_k2() - n0
    return out


#: the kernels phases 4 and 26 count by name in a torch.profiler trace:
#: K2 and the DepthConvBlock epilogues D1-D4 (csrc/lane_rans.cu,
#: csrc/dcb_epilogue.cu)
TRACED_KERNELS = {"k2": "lr_decode_kernel", "dcb": "dcb_elementwise"}


def _dcb_launched():
    """Every D1-D4 launch the port's trace counted (`dcb.launch.*`), and
    the share of them that graph replays added (`graph.replay.dcb.*`)."""
    c = _counter
    return (sum(c("dcb.launch." + k) for k in DCB_KERNELS),
            sum(c("graph.replay.dcb.launch." + k) for k in DCB_KERNELS))


def _profiled(fn):
    """fn() under torch.profiler (the host's and the device's activity),
    synchronized:
    (its result, {"k2": K2 kernels, "dcb": D1-D4 kernels, "ops": every
    device operation, "ms": their summed device ms}), each kernel counted
    by its name in the trace, whichever launched it, a host call or a
    graph's replay."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # late in this script a trace lost the first device operations
        # after its start (14 D1-D4 kernels and no K2 of a 9- and of a
        # 65-frame window: the first P-frame's first blocks, it seems, in
        # phase 26's eager window, none when the phase ran alone): warm-up
        # work, a marker kernel (`torch.cuda._sleep`'s `spin_kernel`) and
        # a pause come first, and only what starts after the marker counts
        warm = torch.zeros(1024, device="cuda")
        for _ in range(256):
            warm.add_(1)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.1)
        out = fn()
        torch.cuda.synchronize()
    events = [ev for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == torch.autograd.DeviceType.CUDA
              and not ev.is_user_annotation()]
    marks = [_ev_ns(ev, "start") for ev in events
             if "spin_kernel" in ev.name()]
    if not marks:
        _fail("the profiler's trace lost its marker kernel")
    got = dict.fromkeys(TRACED_KERNELS, 0)
    ns = ops = 0
    for ev in events:
        if _ev_ns(ev, "start") <= marks[-1]:
            continue
        ns += _ev_ns(ev, "duration")
        ops += 1
        for k, name in TRACED_KERNELS.items():
            got[k] += name in ev.name()
    got.update(ops=ops, ms=ns * 1e-6)
    return out, got


def _ev_ns(ev, what):
    """A kineto event's start or duration in ns."""
    fn = getattr(ev, what + "_ns", None)
    return fn() if fn is not None else getattr(ev, what + "_us")() * 1000


def _traced_launches(label, got, k2, dcb):
    """Fail unless the profiler's K2 and D1-D4 kernels (`got`, from
    _profiled) are the (k2, dcb) launches the port's trace counted over
    the same frames."""
    if (got["k2"], got["dcb"]) != (k2, dcb):
        _fail(f"{label}: the profiler lists {got['k2']} K2 and "
              f"{got['dcb']} D1-D4 kernels, the counters {k2} and {dcb}; "
              f"{got['ops']} device operations in the trace")


def _w1_launches():
    """W1's launches in this process (the counter `warp.launch`)."""
    return _counter("warp.launch")


def _w1_counted(runs, name, fn, *args):
    """fn(*args), its W1 launches stored as runs[name]; its result."""
    n0 = _w1_launches()
    out = fn(*args)
    runs[name] = _w1_launches() - n0
    return out


def _traced(fn, dev=None):
    """fn() in a session of the port's trace (opendcvc_tpu_torch/utils/
    trace.py), synchronized and timed on the host when `dev` is given:
    (its result, its ms or None, the session's totals)."""
    from opendcvc_tpu_torch.utils import trace
    trace.enable()
    try:
        out, ms = (fn(), None) if dev is None else _timed(fn, dev)
    finally:
        trace.disable()
    return out, ms, trace.last_session()


def _span_ms(session, prefix):
    """Host ms of a trace session's spans named `prefix`*."""
    return sum(v["ms"] for k, v in session["spans"].items()
               if k.startswith(prefix))


def _coder_ms(session):
    """Host ms of a trace session in the host coder's calls."""
    return _span_ms(session, "coder.")


def median_ms(fn, dev, reps=REPS, queued=False):
    """Median over `reps` calls; CUDA events around each call, so they
    take the host time of the call as well.  queued: a sleep kernel ahead
    of the first event keeps the card busy while the host runs the call,
    so the events time the device's work alone."""
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            if queued:
                torch.cuda._sleep(SLEEP_CYCLES)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _max_abs_err(got, ref):
    return max(int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
               for g, r in zip(got, ref))


def _bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def random_tables(rng, nr):
    """(nr, 257) int32 valid cumulative rows (every freq >= 1, sum 2^16)."""
    rows = []
    for _ in range(nr):
        freqs = rng.integers(1, 600, 256).astype(np.int64)
        freqs = freqs * (65536 - 256) // freqs.sum() + 1
        freqs[0] += 65536 - freqs.sum()
        rows.append(np.concatenate([[0], np.cumsum(freqs)]))
    return np.stack(rows).astype(np.int32)


def phase_kernels(dev, L, K):
    """K1/K2 kernel vs plain, bit for bit; returns the kernel records."""
    from opendcvc_tpu_torch.entropy.device_rans import staging_width
    from opendcvc_tpu_torch.ops import lane_rans as LR

    rng = np.random.default_rng(0)
    n_y_rows = 128
    k_z = max(1, K // 17)                 # 16 of 272 steps are z
    table = torch.from_numpy(random_tables(rng, 2 * n_y_rows)).to(dev)
    sym = rng.integers(-128, 128, (K, L))
    rows = rng.integers(0, n_y_rows, (K, L))
    rows[K - k_z:] += n_y_rows            # z steps: combined rows 128..255
    skip = rng.random((K, L)) < 0.3
    skip[K - k_z:] = False                # z is never skipped
    rows = np.where(skip, LR.ENC_SKIP, rows)
    sym = np.where(skip, 0, sym)
    packed = LR.pack_operand(torch.from_numpy(sym),
                             torch.from_numpy(rows)).to(dev)

    # K1 at PR 1's shape (random symbols overflow some lanes at the first
    # rung: dropped words and over-counting cursors are part of the
    # contract), then at the main path's frames inside phase_k2
    k1_shapes = []
    _k1_case(dev, LR, packed, LR.prepare_encode_table(table),
             staging_width(K, 0.5), "random", k1_shapes)
    k2 = phase_k2(dev, LR, rng, table, n_y_rows, sym, skip, L, K, k1_shapes)
    k1_edges = _k1_edges(dev, LR, rng)
    for s in k1_shapes:
        _log(f"phase 2: K1 {s['launch']} K={s['steps']} mw={s['mw']}: "
             f"{s['ms']:.4f} ms, device {s['device_ms']:.4f} ms (plain "
             f"{s['plain_ms']:.3f} ms, bound {s['bound_ms']:.5f} ms by "
             f"{s['bound_by']}), {s['coded']} coded slots; bit-exact")
    head = k1_shapes[0]
    return [
        {"name": "lane_rans_encode (K1)", "route": "cuda",
         "source": "opendcvc_tpu_torch/csrc/lane_rans.cu",
         "replaces": "opendcvc_tpu/ops/pallas_rans.py:98",
         "max_abs_err": max([s["max_abs_err"] for s in k1_shapes]
                            + k1_edges),
         "ms": head["ms"], "device_ms": head["device_ms"],
         "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
         "bound_by": head["bound_by"], "library_ms": None,
         "shapes": k1_shapes},
        k2,
    ]


def _k1_bound(packed, mw, LR):
    """Bytes: the operand, 4 B (start and freq, each 16 bits) of every
    (row, symbol) it codes, once, the staging, lens and states;
    operations: ~10 a coded step."""
    coded = (packed & LR.ENC_ROW_MASK) != LR.ENC_SKIP
    n_entries = int(torch.unique(packed[coded]).numel())
    L = packed.shape[1]
    n_bytes = (packed.numel() * 4 + n_entries * 4 + L * mw * 4 + L * 12)
    n_coded = int(coded.sum())
    return _bound_ms(n_bytes, 10 * n_coded) + (n_coded,)


def _k1_case(dev, LR, packed, enc_table, mw, what, shapes):
    """K1 vs its plain version, bit for bit, then timed; appends the
    shape's record and returns K1's output."""
    K = packed.shape[0]
    got = LR.encode_scan(packed, enc_table, mw)
    err = _max_abs_err(got, LR.encode_scan_plain(packed, enc_table, mw))
    if err:
        _fail(f"K1 differs from its plain version at {what} K={K} mw={mw} "
              f"(max |err| {err})")
    ms = median_ms(lambda: LR.encode_scan(packed, enc_table, mw), dev)
    dev_ms = median_ms(lambda: LR.encode_scan(packed, enc_table, mw), dev,
                       queued=True)
    plain = median_ms(lambda: LR.encode_scan_plain(packed, enc_table, mw),
                      dev)
    bound, by, coded = _k1_bound(packed, mw, LR)
    shapes.append({"steps": K, "mw": mw, "launch": what, "ms": ms,
                   "device_ms": dev_ms, "plain_ms": plain,
                   "bound_ms": bound, "bound_by": by, "coded": coded,
                   "max_abs_err": err})
    return got


def _k1_edges(dev, LR, rng):
    """K1 vs its plain version, bit for bit, at the contract's edges: 99
    lanes (a partial warp, and a last block whose staging ends off a
    16-byte boundary), a 24-row table, row ids past it, ~20 % skips, odd
    staging widths that some lanes overflow, K below the entry lead (20)
    and past the operand ring (100).  Returns the max |err| of each."""
    lanes, nr = 99, 24
    table = LR.prepare_encode_table(
        torch.from_numpy(random_tables(rng, nr)).to(dev))
    errs = []
    for k, mw in ((20, 7), (100, 41)):
        rows = rng.integers(0, nr + 8, (k, lanes))
        rows[rng.random(rows.shape) < 0.2] = LR.ENC_SKIP
        packed = LR.pack_operand(
            torch.from_numpy(rng.integers(-128, 128, (k, lanes))),
            torch.from_numpy(rows)).to(dev)
        got = LR.encode_scan(packed, table, mw)
        errs.append(_max_abs_err(got, LR.encode_scan_plain(packed, table,
                                                           mw)))
        over = int((got[1] > mw).sum())
        if errs[-1] or not 0 < over < lanes:
            _fail(f"K1 at the contract's edges, K={k} mw={mw}: max |err| "
                  f"{errs[-1]}, {over} of {lanes} lanes overflowed")
        _log(f"phase 2: K1 at the contract's edges K={k} mw={mw}: "
             f"{over} of {lanes} lanes overflowed; bit-exact")
    return errs


def _enc_operand(dev, LR, rows, sym, skip):
    """K1's operand for decode-order (K, L) row ids and symbols, skip
    slots at zero rate: encode order reverses the steps."""
    rows_enc = np.where(skip, LR.ENC_SKIP, rows)
    sym = np.where(skip, 0, sym)
    return LR.pack_operand(torch.from_numpy(sym[::-1].copy()),
                           torch.from_numpy(rows_enc[::-1].copy())).to(dev)


def _decode_order(got, K):
    """K1's output with room for every word -> the (L, K) words in decode
    order and the final states."""
    buf, lens, states = got
    if int(lens.max()) > buf.shape[1]:
        _fail("K1 staging with room for every word overflowed")
    col = torch.arange(K, device=buf.device)[None, :]
    idx = (lens.to(torch.int64)[:, None] - 1 - col).clamp(min=0)
    data = torch.where(col < lens[:, None], torch.gather(buf, 1, idx), 0) \
        .to(torch.int32).contiguous()
    return data, states


def _k2_bound(rows, dec_table, ptr_in, ptr_out, LR):
    """Bytes: rows and symbols, the compact table once, the words this
    run consumed, the carry in and out; operations: ~14 a coded step."""
    n_words = int((ptr_out.to(torch.int64) - ptr_in.to(torch.int64)).sum())
    n_coded = int((rows != LR.DEC_SKIP).sum())
    L = rows.shape[1]
    n_bytes = (2 * rows.numel() * 4 + dec_table.numel() * 4 + n_words * 4
               + 2 * L * 12)
    return _bound_ms(n_bytes, 14 * n_coded)


def _frame_specs(dev, LR):
    """The main path's frames as phase 2 codes them: (name, K1's prepared
    combined table, decode-order segments (plane, steps, K2's table, its
    (nr, 257) rows as numpy, the map from K2's row ids to K1's, whether
    the plane has skip slots)).  RT: the port's own y rows
    (GaussianEncoder) and one qp's z rows (BitEstimator, seeded init).
    FM: the tables DMCIFM (seed 0, qp 21's z rows) and DMCFM (seed 1)
    build for device EC, 256 y rows each; a DMCFM z table is the y
    table's row 0 (the lanes' pad slots) and the plane's 64 rows."""
    from opendcvc_tpu_torch.entropy import models as M
    from opendcvc_tpu_torch.entropy.device_rans import full_range_cdf_rows
    from opendcvc_tpu_torch.models.dmc_fm import DMCFM
    from opendcvc_tpu_torch.models.dmci_fm import DMCIFM

    def rows(dec_table):
        return LR.expand_decode_table(dec_table.cpu()).numpy()

    def same(ids):
        return ids

    be = M.bit_estimator_init(torch.Generator().manual_seed(1), 1, 128)
    cum_y = full_range_cdf_rows(*M.GaussianEncoder().update())
    cum_z = full_range_cdf_rows(*M.BitEstimator(1, 128).update(be))
    t_rt = torch.from_numpy(np.concatenate([cum_y, cum_z])).to(dev)
    d_y, d_z = (LR.prepare_decode_table(t_rt[a:a + len(cum_y)])
                for a in (0, len(cum_y)))
    z_rt = ("z", 16, d_z, cum_z, lambda i: i + len(cum_y), False)
    specs = [(codec, LR.prepare_encode_table(t_rt), [z_rt] + [
        (f"y{i}", k_y, d_y, cum_y, same, True) for i in range(n_y)])
        for codec, n_y, k_y in (("DMC", 2, 128), ("DMCI", 4, 128),
                                ("DMC kyc 64", 2, 64))]

    inet = DMCIFM(device=dev, device_ec=True)
    inet.init_params(seed=0)
    inet.update()
    n_y, z_base = inet.n_y_rows, inet.n_y_rows + QP * 128
    fy, fz = inet.dec_table[:n_y], inet.dec_table[z_base:z_base + 128]
    specs.append(("DMCIFM", torch.cat([inet.enc_table[:n_y],
                                       inet.enc_table[z_base:z_base + 128]]),
                  [("z", 16, fz, rows(fz), lambda i: i + n_y, False)]
                  + [(f"y{i}", 128, fy, rows(fy), same, True)
                     for i in range(4)]))
    pnet = DMCFM(device=dev, device_ec=True)
    pnet.init_params(seed=1)
    pnet.update()
    tabs = pnet.dec_tables
    y_seg = (tabs["y"], rows(tabs["y"]), same, True)

    def z_seg(name, base):
        return (tabs[name], rows(tabs[name]),
                lambda i: np.where(i == 0, 0, base - 1 + i), False)

    specs.append(("DMCFM", pnet.enc_table,
                  [("motion z", 8) + z_seg("mv_z", n_y + 64)]
                  + [(f"mv{i}", 32) + y_seg for i in range(4)]
                  + [("z", 8) + z_seg("z", n_y)]
                  + [(f"y{i}", 64) + y_seg for i in range(4)]))
    return specs


def _draw(rng, cum, ids):
    """A symbol for every slot, drawn from the distribution of its row."""
    u = rng.integers(0, 65536, ids.shape)
    sym = np.empty(ids.shape, np.int64)
    for r in np.unique(ids):
        at = ids == r
        sym[at] = np.searchsorted(cum[r], u[at], side="right") - 129
    return sym


def phase_k2(dev, LR, rng, table, n_y_rows, sym, skip, L, K, k1_shapes):
    """K2 vs its plain version, bit for bit: one K-step launch over a
    128-row random table (uniform symbols), then the carried launches of
    each of _frame_specs' frames at the main path's shapes (DCVC-FM's y
    planes on 256-row tables, whose row 255 is coded; DEC_SKIP on ~30 %
    of every y plane's slots), symbols drawn from each row; times every
    launch.  Each frame is coded by one K1 launch, checked and timed at
    the first and the top staging rung (into k1_shapes).  Returns K2's
    kernel record."""
    from opendcvc_tpu_torch.entropy.device_rans import staging_width
    t_y = table[:n_y_rows].contiguous()
    d_y = LR.prepare_decode_table(t_y)
    errs, shapes = [], []

    def check(args, want, what):
        got = LR.decode_scan(*args)
        ref = LR.decode_scan_plain(*args)
        errs.append(_max_abs_err(got, ref))
        if errs[-1]:
            _fail(f"K2 differs from its plain version at {what} "
                  f"(max |err| {errs[-1]})")
        if not torch.equal(got[0].to(torch.int64), want):
            _fail(f"K2 did not decode what K1 encoded at {what}")
        return got

    def timed(args, got, what):
        ms = median_ms(lambda: LR.decode_scan(*args), dev)
        dev_ms = median_ms(lambda: LR.decode_scan(*args), dev, queued=True)
        plain = median_ms(lambda: LR.decode_scan_plain(*args), dev)
        bound, by = _k2_bound(args[1], args[2], args[4], got[2], LR)
        shapes.append({"steps": args[1].shape[0], "launch": what, "ms": ms,
                       "device_ms": dev_ms, "plain_ms": plain,
                       "bound_ms": bound, "bound_by": by})
        return shapes[-1]

    def dec_rows(ids, skip_mask):
        return torch.from_numpy(np.where(skip_mask, LR.DEC_SKIP, ids)) \
            .to(torch.int32).to(dev)

    # one K-step launch over the y rows (random rows, uniform symbols)
    ids = rng.integers(0, n_y_rows, (K, L))
    data, states = _decode_order(LR.encode_scan(
        _enc_operand(dev, LR, ids, sym, skip), LR.prepare_encode_table(t_y),
        K), K)
    args = (data, dec_rows(ids, skip), d_y, states,
            torch.zeros((L,), dtype=torch.int32, device=dev))
    got = check(args, torch.from_numpy(sym).to(dev), f"K={K}")
    head = timed(args, got, "one launch")

    # the main path's frames, each coded by one K1 launch against its
    # combined table and decoded launch by launch with the carry
    # (_frame_specs): DMC (z 16 steps, two y halves of 128), DMCI (z, four
    # y quarters of 128), DMC under skip compaction (halves of 64),
    # DMCIFM (z 16, four y quarters of 128 on the 256-row y table) and
    # DMCFM (motion z 8, four motion quarters of 32, z 8, four y quarters
    # of 64)
    frame = {}
    for codec, e_frame, segs in _frame_specs(dev, LR):
        ids = [rng.integers(0, len(cum), (k, L))
               for _, k, _, cum, _, _ in segs]
        skips = [(rng.random(i.shape) < 0.3) if can else
                 np.zeros(i.shape, bool)
                 for i, (*_, can) in zip(ids, segs)]
        syms = [np.where(sk, 0, _draw(rng, cum, i))
                for i, sk, (_, _, _, cum, _, _) in zip(ids, skips, segs)]
        comb = np.concatenate([to_comb(i) for i, (*_, to_comb, _)
                               in zip(ids, segs)])
        sym_f, skip_f = np.concatenate(syms), np.concatenate(skips)
        packed = _enc_operand(dev, LR, comb, sym_f, skip_f)
        k_f = len(comb)
        _k1_case(dev, LR, packed, e_frame, staging_width(k_f, 0.5),
                 f"{codec} frame, first rung", k1_shapes)
        data, states = _decode_order(_k1_case(
            dev, LR, packed, e_frame, staging_width(k_f, 3.0),
            f"{codec} frame, top rung", k1_shapes), k_f)
        carry = (states, torch.zeros((L,), dtype=torch.int32, device=dev))
        frame[codec] = {"ms": 0.0, "device_ms": 0.0}
        for (what, k, dt, _, _, _), i, sk, sy in zip(segs, ids, skips, syms):
            args = (data, dec_rows(i, sk), dt) + carry
            got = check(args, torch.from_numpy(sy).to(dev),
                        f"{codec} {what} (K={k}, {len(dt)} rows)")
            rec = timed(args, got, f"{codec} {what} ({len(dt)} rows)")
            for key in frame[codec]:
                frame[codec][key] += rec[key]
            carry = got[1:]
    # the contract's edges on arbitrary words: 100 lanes (a partial warp),
    # a 24-row table, row ids past it, skips, pointers past either end
    lanes, k_e, nr_e, mw_e = 100, 40, 24, 20
    rows_e = rng.integers(0, nr_e + 8, (k_e, lanes))
    rows_e[rng.random(rows_e.shape) < 0.2] = LR.DEC_SKIP
    arrays = (rng.integers(0, 1 << 16, (lanes, mw_e)).astype(np.int32),
              rows_e.astype(np.int32),
              rng.integers(1 << 16, 1 << 32, lanes),
              rng.integers(-3, mw_e + 3, lanes).astype(np.int32))
    data_e, rows_e, state_e, ptr_e = (torch.from_numpy(a).to(dev)
                                      for a in arrays)
    d_e = LR.prepare_decode_table(
        torch.from_numpy(random_tables(rng, nr_e)).to(dev))
    args = (data_e, rows_e, d_e, state_e, ptr_e)
    errs.append(_max_abs_err(LR.decode_scan(*args),
                             LR.decode_scan_plain(*args)))
    if errs[-1]:
        _fail(f"K2 differs from its plain version at the contract's edges "
              f"(max |err| {errs[-1]})")

    # K = 0 launches at RT's 128 rows and FM's 256: the launch, the
    # table's bulk copy into shared memory (128 blocks x 784 B a row) and
    # the prologue, queued so the events time the device alone
    fixed = {}
    for nr in (128, LR.DEC_MAX_ROWS):
        d_t = LR.prepare_decode_table(
            torch.from_numpy(random_tables(rng, nr)).to(dev))
        args = (torch.zeros((L, 8), dtype=torch.int32, device=dev),
                torch.zeros((0, L), dtype=torch.int32, device=dev), d_t,
                torch.full((L,), 1 << 16, dtype=torch.int64, device=dev),
                torch.zeros((L,), dtype=torch.int32, device=dev))
        fixed[str(nr)] = median_ms(lambda: LR.decode_scan(*args), dev,
                                   queued=True)
    _log(f"phase 2: K2 K=0 (launch, table copy, prologue), device: "
         f"{fixed['128']:.4f} ms at 128 rows, "
         f"{fixed[str(LR.DEC_MAX_ROWS)]:.4f} ms at {LR.DEC_MAX_ROWS}")

    for s in shapes:
        _log(f"phase 2: K2 {s['launch']} K={s['steps']}: {s['ms']:.4f} ms, "
             f"device {s['device_ms']:.4f} ms (plain {s['plain_ms']:.3f} ms, "
             f"bound {s['bound_ms']:.5f} ms by {s['bound_by']})")
    for codec, t in frame.items():
        _log(f"phase 2: K2 per {codec} frame (sum of its timed launches): "
             f"{t['ms']:.4f} ms, device {t['device_ms']:.4f} ms")
    _log(f"phase 2: K2 tables of up to {LR.DEC_MAX_ROWS} rows, "
         f"{LR.DEC_MAX_ROWS * LR.DEC_ROW_WORDS * 4} B of shared memory a "
         f"block; bit-exact, carry exact across each frame's launches, and "
         f"at the contract's edges")
    return {"name": "lane_rans_decode (K2)", "route": "cuda",
            "source": "opendcvc_tpu_torch/csrc/lane_rans.cu",
            "replaces": "opendcvc_tpu/ops/pallas_rans.py:267",
            "max_abs_err": max(errs), "ms": head["ms"],
            "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "shapes": shapes, "frame_ms": frame,
            "fixed_device_ms": fixed}


def synthetic_frames(height, width, n):
    """Noise frames rolled 4 px per frame, replicate-padded to 16."""
    from opendcvc_tpu_torch.models import common as C
    pr, pb = C.get_padding_size(height, width, 16)
    base = np.random.default_rng(0).random((1, height, width, 3),
                                           dtype=np.float32)
    return [np.pad(np.roll(base, 4 * t, axis=2),
                   ((0, 0), (0, pb), (0, pr), (0, 0)), mode="edge")
            for t in range(n)]


def _timed(fn, dev):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def phase_intra(dev, frame, qp, fz, dtype=torch.float32, label="phase 3"):
    from opendcvc_tpu_torch.models.dmci import DMCI
    net = DMCI(device=dev, device_ec=True, dtype=dtype)
    net.init_params(seed=0)     # cast to dtype; the banks set after it
    # flat banks (bench.py's surrogate for trained rate statistics)
    net.params["q_scale_enc"] = torch.ones_like(
        net.params["q_scale_enc"]) * 0.2
    net.params["q_scale_dec"] = torch.ones_like(net.params["q_scale_dec"])
    net.update(force_zero_thres=fz)
    sps = {"height": frame.shape[1], "width": frame.shape[2]}
    results = []
    r0 = _counter("ec.rerun")
    for _ in range(2):   # the first pass warms cuDNN; the second is timed
        enc, enc_ms = _timed(lambda: net.compress(frame, qp), dev)
        dec, dec_ms = _timed(
            lambda: net.decompress(enc["bit_stream"], sps, qp), dev)
        if not torch.equal(enc["x_hat"], dec["x_hat"]):
            _fail("DMCI decoded frame differs from the encoder's")
        results.append((enc, enc_ms, dec_ms))
    enc, enc_ms, dec_ms = results[-1]
    x_hat = enc["x_hat"]
    if tuple(x_hat.shape) != tuple(frame.shape) or \
            not bool(torch.isfinite(x_hat).all()):
        _fail("DMCI x_hat has the wrong shape or is not finite")
    bpp = len(enc["bit_stream"]) * 8 / (frame.shape[1] * frame.shape[2])
    reruns = _counter("ec.rerun") - r0
    _log(f"{label}: DMCI {frame.shape[1]}x{frame.shape[2]} enc "
         f"{enc_ms:.1f} ms dec {dec_ms:.1f} ms (second pass), bpp "
         f"{bpp:.4f}, reruns {reruns}; decoded frame exact")
    return {"params": net.params, "x_hat": x_hat, "bpp": bpp,
            "enc_ms": enc_ms, "dec_ms": dec_ms,
            "streams": [r[0]["bit_stream"] for r in results],
            "reruns": reruns}


def phase_p(dev, x_ref, frames, qp, fz, dtype=torch.float32,
            label="phase 4"):
    from opendcvc_tpu_torch.models.dmc import DMC
    enc_net = DMC(device=dev, device_ec=True, dtype=dtype)
    enc_net.init_params(seed=1)
    enc_net.params["q_encoder"] = torch.ones_like(
        enc_net.params["q_encoder"]) * 0.25
    enc_net.params["q_decoder"] = torch.ones_like(
        enc_net.params["q_decoder"])
    enc_net.update(force_zero_thres=fz)
    dec_net = DMC(device=dev, device_ec=True, dtype=dtype)
    dec_net.load_params(enc_net.params)
    dec_net.update(force_zero_thres=fz)
    for net in (enc_net, dec_net):
        net.add_ref_frame(None, x_ref)
    sps = {"height": frames[0].shape[1], "width": frames[0].shape[2]}
    streams, feats, enc_ms = [], [], []
    r0 = _counter("ec.rerun")
    for x in frames:
        s, ms = _timed(lambda: enc_net.compress(x, qp)["bit_stream"], dev)
        streams.append(s)
        enc_ms.append(ms)
        feats.append(enc_net.dpb[0].feature.clone())
    dec_ms, dec_x = [], []
    for i, s in enumerate(streams):
        out, ms = _timed(lambda: dec_net.decompress(s, sps, qp), dev)
        dec_ms.append(ms)
        dec_x.append(out["x_hat"])
        if not torch.equal(dec_net.dpb[0].feature, feats[i]):
            _fail(f"DMC enc/dec feature chain diverged at P-frame {i}")
        if not bool(torch.isfinite(out["x_hat"]).all()):
            _fail("DMC x_hat is not finite")
    bpp = [len(s) * 8 / (sps["height"] * sps["width"]) for s in streams]
    reruns = _counter("ec.rerun") - r0
    traced = _replays_traced(dec_net, x_ref, streams, sps, qp, dec_x, label)
    _log(f"{label}: DMC P-frames enc ms " + " ".join(f"{t:.1f}" for t in
                                                     enc_ms)
         + " | dec ms " + " ".join(f"{t:.1f}" for t in dec_ms)
         + " | bpp " + " ".join(f"{b:.4f}" for b in bpp)
         + f" | reruns {reruns}; feature chain exact")
    return {"params": enc_net.params, "feats": feats, "dec_x": dec_x,
            "bpp": bpp, "enc_ms": enc_ms, "dec_ms": dec_ms,
            "streams": streams, "reruns": reruns, "traced_k2": traced}


def _replays_traced(dec_net, x_ref, streams, sps, qp, dec_x, label):
    """Phase 4's P-frames decoded again from the reference, every frame a
    replay of the graph the first decode captured, under torch.profiler:
    the x_hats the first decode's, and the K2 and D1-D4 kernels the
    trace lists the launches the counters' replays added.  Returns the
    K2 kernels the profiler counted."""
    dec_net.clear_dpb()
    dec_net.add_ref_frame(None, x_ref)
    c0, d0, r0 = _counter("k2.launch"), _dcb_launched(), _replayed_k2()
    again, got = _profiled(lambda: [dec_net.decompress(s, sps, qp)["x_hat"]
                                    for s in streams])
    k2, replayed = _counter("k2.launch") - c0, _replayed_k2() - r0
    if k2 != replayed:
        _fail(f"{label}: a second decode of the P-frames did not replay "
              f"every frame (K2 {k2}, {replayed} replayed)")
    # D1-D4 also launch from the host outside the body (the I-frame
    # reference's feature adaptor): the trace holds both
    _traced_launches(f"{label} (replays)", got, k2,
                     _dcb_launched()[0] - d0[0])
    if not all(torch.equal(a, b) for a, b in zip(again, dec_x)):
        _fail(f"{label}: the replayed P-frames differ from the first decode")
    _log(f"{label}: {len(streams)} P-frames replayed: the profiler lists "
         f"{got['k2']} K2 and {got['dcb']} D1-D4 kernels, the launches the "
         f"replays counted; x_hats the first decode's")
    return got["k2"]


def phase_reference(dev, qp, fz):
    """The same 64x64 I-frame through the GPU and the CPU port, device EC
    and host EC."""
    from opendcvc_tpu_torch.models.dmci import DMCI
    x = np.random.default_rng(3).random((1, 64, 64, 3), dtype=np.float32)
    sps = {"height": 64, "width": 64, "ec_part": 0}
    params = None
    for device_ec, mode in ((True, "device EC"), (False, "host EC")):
        nets = {d.type: DMCI(device=d, device_ec=device_ec)
                for d in (dev, torch.device("cpu"))}
        if params is None:
            params = nets["cpu"].init_params(seed=3)
        for net in nets.values():
            net.load_params(params)
            net.update(force_zero_thres=fz)
        enc = {k: n.compress(x, qp) for k, n in nets.items()}
        x_dev = enc[dev.type]["x_hat"].cpu()
        x_cpu = enc["cpu"]["x_hat"]
        cross = nets["cpu"].decompress(enc[dev.type]["bit_stream"], sps,
                                       qp)["x_hat"]
        err = max(float((x_dev - x_cpu).abs().max()),
                  float((cross - x_dev).abs().max()))
        same = enc[dev.type]["bit_stream"] == enc["cpu"]["bit_stream"]
        if err > 1e-3:
            _fail(f"GPU and CPU ports disagree on a 64x64 I-frame, {mode} "
                  f"({err:g})")
        _log(f"phase 5: 64x64 I-frame GPU vs CPU port, {mode}: max |x_hat "
             f"diff| {err:.3g}, CPU decodes the GPU stream, streams "
             f"identical: {same}")
    _reference_chain(dev, qp, fz)
    _reference_bf16(dev, qp, fz)


def _reference_bf16(dev, qp, fz):
    """Phase 5's bfloat16 row, reported and never failed (except on a
    crash): the 64x64 I-frame's encoder on the GPU and on the CPU, the
    share of equal symbols per plane and the max |x_hat diff|, and
    whether the CPU decodes the GPU's host-EC stream to the GPU's x_hat.
    cuDNN's and oneDNN's bfloat16 sums differ, so a symbol near a
    rounding boundary may round apart: a property of bfloat16, not a
    fault."""
    from opendcvc_tpu_torch.models import common as C
    from opendcvc_tpu_torch.models import dmci as I
    from opendcvc_tpu_torch.utils.params import to_device
    cpu, bf16 = torch.device("cpu"), torch.bfloat16
    x = np.random.default_rng(3).random((1, 64, 64, 3), dtype=np.float32)
    params = I.DMCI(device=cpu, dtype=bf16).init_params(seed=3)
    enc = {}
    for d in (dev, cpu):
        x_hat, z, planes = I._encode_stages_i(
            to_device(params, d), C.frame_to_nchw(x, d, bf16), qp, fz)
        enc[d.type] = [x_hat.cpu(), z.cpu()] + [pl[0].cpu() for pl in planes]
    shares = [float((a == b).float().mean())
              for a, b in zip(enc[dev.type][1:], enc["cpu"][1:])]
    x_err = float((enc[dev.type][0] - enc["cpu"][0]).abs().max())
    nets = {}
    for d in (dev, cpu):
        nets[d.type] = I.DMCI(device=d, dtype=bf16)
        nets[d.type].load_params(params)
        nets[d.type].update(force_zero_thres=fz)
    gpu = nets[dev.type].compress(x, qp)
    try:
        cross = nets["cpu"].decompress(gpu["bit_stream"], {
            "height": 64, "width": 64, "ec_part": 0}, qp)["x_hat"]
        decoded = (f"CPU decodes the GPU's stream, max |x_hat diff| "
                   f"{float((cross - gpu['x_hat'].cpu()).abs().max()):.3g}")
    except ValueError as e:
        decoded = f"the CPU cannot decode the GPU's stream ({e})"
    _log(f"phase 5: 64x64 I-frame GPU vs CPU port, bfloat16 (reported): "
         f"equal symbols z / y0..y3 "
         + " / ".join(f"{100 * v:.2f} %" for v in shares)
         + f", max |x_hat diff| {x_err:.3g}; host EC: {decoded}")


def textured_frames(h, w, n, seed, shift=3):
    """n (h, w, 3) uint8 frames: a smooth gradient, a blocky texture that
    moves `shift` px a frame, and mild noise (so motion and residuals are
    not pure noise)."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    grad = 48 + 96 * xx * np.float32([1.0, 0.3, 0.6]) \
        + 80 * yy * np.float32([0.2, 1.0, 0.5])
    wide = w + shift * n
    tex = rng.integers(0, 40, (-(-h // 4), -(-wide // 4), 3))
    tex = tex.repeat(4, 0).repeat(4, 1)[:h, :wide].astype(np.float32)
    return [np.clip(grad + tex[:, shift * t:shift * t + w]
                    + rng.normal(0, 1.5, (h, w, 3)).astype(np.float32),
                    0, 255).astype(np.uint8) for t in range(n)]


def _reference_chain(dev, qp, fz):
    """Phase 5's chain: a 64x64 I-frame and 3 P-frames coded on the GPU
    through host EC and decoded by the CPU port; the same frames are also
    coded on the CPU, to say whether the two devices write the same
    streams.  Fails on a decode error or a diff over 1e-3."""
    from opendcvc_tpu_torch.models.dmc import DMC
    from opendcvc_tpu_torch.models.dmci import DMCI
    cpu = torch.device("cpu")
    frames = [f[None].astype(np.float32) / 255.0
              for f in textured_frames(64, 64, 4, seed=5)]
    sps = {"height": 64, "width": 64, "ec_part": 0}
    params = {"I": DMCI(device=cpu).init_params(seed=3),
              "P": DMC(device=cpu).init_params(seed=4)}

    def codec(cls, d):
        net = cls(device=d)
        net.load_params(params["I" if cls is DMCI else "P"])
        net.update(force_zero_thres=fz)
        return net

    enc = {d.type: (codec(DMCI, d), codec(DMC, d)) for d in (dev, cpu)}
    dec_cpu = (codec(DMCI, cpu), codec(DMC, cpu))
    dec_gpu = codec(DMC, dev)
    streams = {}
    for t, x in enumerate(frames):
        if t == 0:
            out = {k: n[0].compress(x, qp) for k, n in enc.items()}
            streams = {k: o["bit_stream"] for k, o in out.items()}
            try:
                x_cpu = dec_cpu[0].decompress(streams[dev.type], sps,
                                              qp)["x_hat"]
            except ValueError as e:
                _fail(f"phase 5 chain: the CPU cannot decode the GPU's "
                      f"I-frame: {e}")
            x_gpu = out[dev.type]["x_hat"]
            for k, n in enc.items():
                n[1].add_ref_frame(None, out[k]["x_hat"])
            dec_cpu[1].add_ref_frame(None, x_cpu)
            dec_gpu.add_ref_frame(None, x_gpu)
            feat_err = 0.0
        else:
            streams = {k: n[1].compress(x, qp)["bit_stream"]
                       for k, n in enc.items()}
            try:
                x_cpu = dec_cpu[1].decompress(streams[dev.type], sps,
                                              qp)["x_hat"]
            except ValueError as e:
                _fail(f"phase 5 chain: the CPU cannot decode the GPU's "
                      f"P-frame {t}: {e}")
            x_gpu = dec_gpu.decompress(streams[dev.type], sps, qp)["x_hat"]
            f_gpu = enc[dev.type][1].dpb[0].feature.cpu()
            feat_err = float((dec_cpu[1].dpb[0].feature - f_gpu).abs()
                             .max()) / max(1.0, float(f_gpu.abs().max()))
        x_err = float((x_cpu - x_gpu.cpu()).abs().max())
        same = streams[dev.type] == streams["cpu"]
        _log(f"phase 5: host-EC chain, {'I' if t == 0 else 'P'}-frame {t} "
             f"coded on the GPU, decoded by the CPU: max |x_hat diff| "
             f"{x_err:.3g}, max |feature diff| / max(1, max|feature|) "
             f"{feat_err:.3g}; GPU and CPU streams identical: {same}")
        if max(x_err, feat_err) > 1e-3:
            _fail(f"phase 5 chain: GPU and CPU disagree at frame {t} "
                  f"(x_hat {x_err:g}, feature {feat_err:g})")


def _frame_record(fn, dev):
    """Run one frame's call, synchronized, in a session of the port's
    trace; returns (its result, {ms, the host coder's ms (`coder.*`
    spans), device->host waits and their ms (`wait.fetch`), uploads and
    their ms (`upload`)})."""
    out, ms, session = _traced(fn, dev)
    rec = {"ms": ms, "coder_ms": _coder_ms(session),
           "wait_ms": _span_ms(session, "wait.fetch"),
           "upload_ms": _span_ms(session, "upload")}
    for key, span in (("d2h", "wait.fetch"), ("h2d", "upload")):
        rec[key] = session["spans"].get(span, {"n": 0})["n"]
    return out, rec


def phase_host(dev, frames, qp, fz, intra, p_run, dtype=torch.float32,
               label="phase 6"):
    """Phase 6 (and 9 (a) in bfloat16): the host-EC sequence at 1080p,
    written to and decoded from one NAL stream; held bit for bit against
    the device-EC run (phases 3-4)."""
    from opendcvc_tpu_torch.models.dmc import DMC
    from opendcvc_tpu_torch.models.dmci import DMCI
    from opendcvc_tpu_torch.utils import stream_helper as S
    i_net = DMCI(device=dev, dtype=dtype)
    i_net.load_params(intra["params"])
    p_net = DMC(device=dev, dtype=dtype)
    p_net.load_params(p_run["params"])
    use_two = H * W > 1280 * 720      # the harness's rule, source size
    for net in (i_net, p_net):
        net.update(force_zero_thres=fz)
        net.set_use_two_entropy_coders(use_two)
    sps = {"sps_id": -1, "height": H, "width": W,
           "ec_part": int(use_two), "use_ada_i": 0}

    # the first pass warms the host path; the sequence is the second
    warm = i_net.compress(frames[0], qp)
    i_net.decompress(warm["bit_stream"], dict(sps), qp)
    return _host_sequence(dev, frames, qp, intra, p_run, i_net, p_net, sps,
                          S, label)


def _host_sequence(dev, frames, qp, intra, p_run, i_net, p_net, sps, S,
                   label):
    """Encode the sequence into one NAL stream, then decode it from the
    bytes; fails on any difference from the device-EC run."""
    use_two = bool(sps["ec_part"])
    n_px = frames[0].shape[1] * frames[0].shape[2]
    buf, helper = io.BytesIO(), S.SPSHelper()
    enc_recs, streams, feats, sps_bytes = [], [], [], 0
    for t, x in enumerate(frames):
        if t == 0:
            enc, rec = _frame_record(lambda: i_net.compress(x, qp), dev)
            if not torch.equal(enc["x_hat"], intra["x_hat"]):
                _fail(f"{label}: host-EC I-frame x_hat differs from the "
                      f"device-EC run's")
            p_net.clear_dpb()
            p_net.add_ref_frame(None, enc["x_hat"])
            x_i, stream = enc["x_hat"], enc["bit_stream"]
        else:
            stream, rec = _frame_record(
                lambda: p_net.compress(x, qp)["bit_stream"], dev)
            feats.append(p_net.dpb[0].feature.clone())
            if not torch.equal(feats[-1], p_run["feats"][t - 1]):
                _fail(f"{label}: host-EC P-frame {t - 1} feature differs "
                      f"from the device-EC run's")
        sps_id, new = helper.get_sps_id(dict(sps))
        if new:
            sps_bytes += S.write_sps(buf, dict(sps, sps_id=sps_id))
        S.write_ip(buf, t == 0, sps_id, qp, stream)
        rec["bpp"] = len(stream) * 8 / n_px
        enc_recs.append(rec)
        streams.append(stream)
    data = buf.getvalue()

    # decode from the bytes, as the harness does
    rd, helper, dec_recs = io.BytesIO(data), S.SPSHelper(), []
    for t in range(len(frames)):
        header = S.read_header(rd)
        while header["nal_type"] == S.NalType.NAL_SPS:
            helper.add_sps_by_id(S.read_sps_remaining(rd, header["sps_id"]))
            header = S.read_header(rd)
        f_sps = helper.get_sps_by_id(header["sps_id"])
        f_qp, stream = S.read_ip_remaining(rd)
        if stream != streams[t] or f_qp != qp or f_sps["ec_part"] != \
                int(use_two):
            _fail(f"{label}: frame {t} does not read back from the NAL "
                  f"stream")
        if header["nal_type"] == S.NalType.NAL_I:
            dec, rec = _frame_record(
                lambda: i_net.decompress(stream, f_sps, f_qp), dev)
            if not torch.equal(dec["x_hat"], x_i):
                _fail(f"{label}: host-EC decoded I-frame differs from the "
                      f"encoder's")
            p_net.clear_dpb()
            p_net.add_ref_frame(None, dec["x_hat"])
        else:
            dec, rec = _frame_record(
                lambda: p_net.decompress(stream, f_sps, f_qp), dev)
            if not torch.equal(p_net.dpb[0].feature, feats[t - 1]):
                _fail(f"{label}: host-EC enc/dec feature chain diverged "
                      f"at P-frame {t - 1}")
            if not torch.equal(dec["x_hat"], p_run["dec_x"][t - 1]):
                _fail(f"{label}: host-EC decoded P-frame {t - 1} differs "
                      f"from the device-EC run's")
        dec_recs.append(rec)
    if rd.read() != b"":
        _fail(f"{label}: bytes left after the last frame of the NAL "
              f"stream")

    dev_bpp = [intra["bpp"]] + p_run["bpp"]

    def side(r):
        return (f"{r['ms']:.1f} ms (host coder {r['coder_ms']:.1f} ms; "
                f"{r['d2h']} device->host waits, {r['wait_ms']:.1f} ms; "
                f"{r['h2d']} uploads, {r['upload_ms']:.2f} ms)")

    for t, (e, d) in enumerate(zip(enc_recs, dec_recs)):
        _log(f"{label}: {'I' if t == 0 else 'P'}-frame {t}: enc {side(e)} "
             f"| dec {side(d)} | bpp {e['bpp']:.4f} (device EC "
             f"{dev_bpp[t]:.4f})")
    _log(f"{label}: NAL stream {len(data)} bytes for {len(frames)} frames "
         f"({sps_bytes} bytes of SPS, two coders: {use_two}); encoder "
         f"outputs equal the device-EC run's, decoded from the bytes: "
         f"I-frame exact, feature chain exact, P-frames equal the "
         f"device-EC run's")
    return {"enc": enc_recs, "dec": dec_recs, "stream_bytes": len(data)}


N_HARNESS = 16          # phase 7's frames (configs' UVG shape, cut)
#: the port's trace counters of DMC's decoder graphs (utils/graph.py)
GRAPH_COUNTERS = ("graph.call", "graph.replay", "graph.capture")
QP_SHIFT_CYCLE = "0 / 8 / 4"    # the harness's qp shifts (its index_map)


def _write_sequence(root, h, w, n):
    """Phase 7's input in `root`: a raw 8-bit YUV420 sequence of n
    textured frames (the chroma subsampled by taking every other sample);
    returns its path."""
    os.makedirs(os.path.join(root, "data"))
    seq = os.path.join(root, "data", "seq1080.yuv")
    with open(seq, "wb") as f:
        for img in textured_frames(h, w, n, seed=7):
            f.write(img[:, :, 0].tobytes())
            f.write(np.ascontiguousarray(
                img[::2, ::2, 1:].transpose(2, 0, 1)).tobytes())
    return seq


def _write_config(root, h, w, n):
    """A dataset config that codes the first n frames of the sequence;
    returns its path."""
    cfg = os.path.join(root, f"config_{n}.json")
    with open(cfg, "w") as f:
        json.dump({"root_path": root, "test_classes": {"synthetic": {
            "test": 1, "base_path": "data", "src_type": "yuv420",
            "sequences": {"seq1080": {"width": w, "height": h, "frames": n,
                                      "intra_period": 32}}}}}, f)
    return cfg


def _record_codecs(harness, log):
    """Wrap the codecs that the harness's build_nets returns: each
    compress / decompress call logs its result and adds its host time,
    synchronized, to log["codec_s"].  Returns the undo."""
    build = harness.build_nets

    def recording(args):
        i_net, p_net = build(args)
        log["p_params"] = p_net.params
        for kind, net in (("I", i_net), ("P", p_net)):
            _wrap_codec(net, kind, log)
        return i_net, p_net

    harness.build_nets = recording
    return lambda: setattr(harness, "build_nets", build)


def _wrap_codec(net, kind, log):
    compress, decompress = net.compress, net.decompress

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(net.device)
        spent = time.perf_counter() - t0
        log["codec_s"] += spent
        log["calls"].append((kind, fn is compress, spent * 1e3))
        return out

    def enc(x, qp):
        out = timed(compress, x, qp)
        log["enc"].append((kind, out["x_hat"] if kind == "I"
                           else net.dpb[0].feature, qp))
        return out

    def dec(bit_stream, sps, qp):
        out = timed(decompress, bit_stream, sps, qp)
        log["dec"].append((kind, out["x_hat"],
                           net.dpb[0].feature if kind == "P" else None))
        return out

    net.compress, net.decompress = enc, dec


def _check_decoder_exact(log, mode, n):
    """Every decoded frame equals the encoder's, bit for bit: the I-frame's
    x_hat, and for a P-frame the feature and the frame the encoder's
    feature reconstructs."""
    from opendcvc_tpu_torch.models import common as C
    from opendcvc_tpu_torch.models.dmc import _stage_recon_x
    if not len(log["enc"]) == len(log["dec"]) == n:
        _fail(f"{mode}: {len(log['enc'])} frames encoded, "
              f"{len(log['dec'])} decoded")
    for t, ((kind, e, qp), (_, x_dec, f_dec)) in enumerate(
            zip(log["enc"], log["dec"])):
        if kind == "I":
            same = torch.equal(e, x_dec)
        else:
            x_enc = C.frame_to_nhwc(_stage_recon_x(log["p_params"], e, qp))
            same = torch.equal(e, f_dec) and torch.equal(x_enc, x_dec)
        if not same:
            _fail(f"{mode}: decoded frame {t} ({kind}) differs from the "
                  f"encoder's")


def _refresh_frames(bin_path):
    """The frames whose SPS in a NAL .bin sets use_ada_i (the refresh)."""
    from opendcvc_tpu_torch.utils import stream_helper as S
    with open(bin_path, "rb") as f:
        rd = io.BytesIO(f.read())
    helper, out, t = S.SPSHelper(), [], 0
    while rd.tell() < len(rd.getbuffer()):
        header = S.read_header(rd)
        while header["nal_type"] == S.NalType.NAL_SPS:
            helper.add_sps_by_id(S.read_sps_remaining(rd, header["sps_id"]))
            header = S.read_header(rd)
        if helper.get_sps_by_id(header["sps_id"])["use_ada_i"]:
            out.append(t)
        S.read_ip_remaining(rd)
        t += 1
    return out


def _recon_psnr(src_path, rec_path, h, w, n):
    """Mean over the first n frames of (6 PSNR_Y + PSNR_U + PSNR_V) / 8,
    from the files."""
    fsz, ysz = h * w * 3 // 2, h * w
    src, rec = (np.fromfile(p, np.uint8, count=n * fsz).reshape(n, fsz)
                .astype(np.float64) for p in (src_path, rec_path))
    out = []
    for s, r in zip(src, rec):
        planes = (slice(0, ysz), slice(ysz, ysz + ysz // 4),
                  slice(ysz + ysz // 4, fsz))
        p = [min(99.9, 10 * np.log10(255.0 ** 2 / max(
            np.mean((s[sl] - r[sl]) ** 2), 1e-10))) for sl in planes]
        out.append((6 * p[0] + p[1] + p[2]) / 8)
    return float(np.mean(out))


HARNESS_STEPS = {"_read_src_frame": "file reads",
                 "ycbcr420_to_444_np": "chroma upsampling",
                 "get_src_frame": "codec input (read, upsample, upload, pad)",
                 "_postprocess": "recon crop/convert/clip + fetch",
                 "_distortion": "metrics",
                 "_write_recon": "recon writes"}


def _clock_harness(harness):
    """Wrap the harness's host steps (module functions, which call each
    other through the module, so get_src_frame's time includes its read
    and upsampling); each adds its host time (s) to the returned dict.
    Returns (dict, undo)."""
    spent = dict.fromkeys(HARNESS_STEPS, 0.0)
    saved = {name: getattr(harness, name) for name in HARNESS_STEPS}
    for name, fn in saved.items():
        def timed(*args, _fn=fn, _name=name):
            t0 = time.perf_counter()
            try:
                return _fn(*args)
            finally:
                spent[_name] += time.perf_counter() - t0
        setattr(harness, name, timed)

    def undo():
        for name, fn in saved.items():
            setattr(harness, name, fn)
    return spent, undo


def _harness_run(harness, root, seq, device_ec, n=N_HARNESS,
                 dtype="float32", phase="phase 7"):
    """One harness run on the first n frames of the sequence, in process,
    through the port's CLI entry point; returns its per-job log, .bin
    size, kernel launches and codec time."""
    tag = ("device_ec" if device_ec else "host_ec") + \
        ("" if dtype == "float32" else f"_{dtype}")
    mode = f"{phase} {'device EC' if device_ec else 'host EC'}" + \
        ("" if dtype == "float32" else f" {dtype}")
    cfg = _write_config(root, H, W, n)
    log = {"enc": [], "dec": [], "codec_s": 0.0, "calls": []}
    saved = os.environ.pop("OPENDCVC_TPU_DEVICE_EC", None)
    if device_ec:
        os.environ["OPENDCVC_TPU_DEVICE_EC"] = "1"
    undo = _record_codecs(harness, log)
    steps, undo_steps = _clock_harness(harness)
    _reset_launches()
    g0 = {k: _counter(k) for k in GRAPH_COUNTERS}
    try:
        harness.main([
            "--test_config", cfg,
            "--output_path", os.path.join(root, f"{tag}.json"),
            "--stream_path", os.path.join(root, tag), "--rate_num", "1",
            "--qp_i", str(QP), "--qp_p", str(QP),
            "--force_zero_thres", str(FZ), "--reset_interval", "8",
            "--verbose", "1", "--verbose_json", "1",
            "--save_decoded_frame", "1", "--seed", "0", "--device", "cuda",
            "--dtype", dtype])
    finally:
        undo_steps()
        undo()
        os.environ.pop("OPENDCVC_TPU_DEVICE_EC", None)
        if saved is not None:
            os.environ["OPENDCVC_TPU_DEVICE_EC"] = saved
    launches = _launches()
    graphs = {k: _counter(k) - g0[k] for k in GRAPH_COUNTERS}
    out_dir = os.path.join(root, tag, "synthetic")
    with open(os.path.join(out_dir, f"seq1080_q{QP}.json")) as f:
        job = json.load(f)
    _check_decoder_exact(log, mode, n)
    n_bytes = os.path.getsize(os.path.join(out_dir, f"seq1080_q{QP}.bin"))
    if round(sum(job["frame_bpp"]) * job["frame_pixel_num"]) != 8 * n_bytes:
        _fail(f"{mode}: the log's bits differ from 8 x the .bin's "
              f"{n_bytes} bytes")
    if (job["i_frame_num"], job["p_frame_num"]) != (1, n - 1):
        _fail(f"{mode}: frame counts {job['i_frame_num']} I, "
              f"{job['p_frame_num']} P")
    refresh = _refresh_frames(os.path.join(out_dir, f"seq1080_q{QP}.bin"))
    if refresh != list(range(1, n, 8)):
        _fail(f"{mode}: periodic refresh at frames {refresh}, not every "
              f"8 from frame 1")
    (rec,) = [p for p in os.listdir(out_dir) if p.endswith("kbps.yuv")]
    rec = os.path.join(out_dir, rec)
    if os.path.getsize(rec) != n * H * W * 3 // 2:
        _fail(f"{mode}: recon file of {os.path.getsize(rec)} bytes")
    psnr_files = _recon_psnr(seq, rec, H, W, n)
    if not abs(psnr_files - job["ave_all_frame_psnr"]) <= 0.5:
        _fail(f"{mode}: PSNR from the files {psnr_files:.4f} dB, the "
              f"log's {job['ave_all_frame_psnr']:.4f} dB")
    outside = job["test_time"] - log["codec_s"]
    p_ms = [float(np.median([ms for kind, enc, ms in log["calls"][2:]
                             if kind == "P" and enc == side]))
            for side in (True, False)]
    avg = " ".join(f"{k} {job[k] * 1e3:.2f} ms" for k in
                   ("avg_frame_encoding_time", "avg_frame_decoding_time")
                   if job.get(k) is not None)
    _log(f"{mode}: harness {avg or 'avg frame times n/a'} (frames 10 on), "
         f"P-frame codec calls enc {p_ms[0]:.2f} / dec {p_ms[1]:.2f} ms "
         f"(median, synchronized), bpp {job['ave_all_frame_bpp']:.4f}, PSNR "
         f"{job['ave_all_frame_psnr']:.4f} dB (from the files "
         f"{psnr_files:.4f}), test_time {job['test_time']:.2f} s, codec "
         f"calls {log['codec_s']:.2f} s, outside the codecs {outside:.2f} s; "
         f".bin {n_bytes} B; K1 {launches[0]}, K2 {launches[1]} launches; "
         f"decoder exact on all {n} frames; DMC's decoder graphs (qps "
         f"{QP} + {QP_SHIFT_CYCLE}): {graphs}")
    _log(f"{mode}: harness host steps (s, {n} frames): "
         + ", ".join(f"{HARNESS_STEPS[k]} {v:.3f}" for k, v in steps.items()))
    return {"job": job, "launches": launches}


def phase_harness(root, seq):
    """Phase 7: the RD harness (`eval.harness.main`) on a 1080p YUV420
    sequence from a dataset config, host EC then device EC; returns the
    device-EC run's K1 and K2 launches."""
    from opendcvc_tpu_torch.eval import harness
    pil_before = "PIL" in sys.modules
    host = _harness_run(harness, root, seq, device_ec=False)
    dev = _harness_run(harness, root, seq, device_ec=True)
    if max(host["launches"]):
        _fail("phase 7: the host-EC harness run launched a lane rANS kernel")
    if min(dev["launches"]) == 0:
        _fail("phase 7: the device-EC harness run did not launch K1 and K2")
    if host["job"]["frame_psnr"] != dev["job"]["frame_psnr"]:
        _fail("phase 7: per-frame PSNR differs between host and device EC")
    if not pil_before and "PIL" in sys.modules:
        _fail("phase 7 imported PIL")
    _log("phase 7: per-frame PSNR equal in host and device EC; bits equal "
         "8 x each .bin; periodic refresh at frames 1 and 9 in both")
    return dev


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if card.returncode != 0:
        _fail(f"nvidia-smi failed: {card.stderr.strip()}")
    return card.stdout.strip().splitlines()[0]


def _copy_ms(shape, dev):
    """Median ms of one int16 copy of `shape` device->host (into pinned
    memory) and host->device (from it), with CUDA events around each."""
    src = torch.zeros(shape, dtype=torch.int16, device=dev)
    host = torch.empty(shape, dtype=torch.int16, pin_memory=True)
    d2h = median_ms(lambda: host.copy_(src, non_blocking=True), dev)
    h2d = median_ms(lambda: src.copy_(host, non_blocking=True), dev)
    return d2h, h2d


def _bench_checks(st, dev, label):
    """Phase 8's holds: the first GOP chunk's streams against the same
    frames coded one by one, the GOP decode against the per-frame decode
    (x_hats and features), the batched intra streams, x_hats and decode
    against the single-frame calls."""
    from opendcvc_tpu_torch.models.dmc import DMC
    p_net, d_net, qp, qps = st["p_net"], st["d_net"], st["qp"], st["qps"]

    def p_codec():
        net = DMC(device=dev, device_ec=True, lanes=p_net.lanes,
                  bytes_per_symbol=p_net.bytes_per_symbol,
                  cap_frac=p_net.cap_frac, dtype=p_net.dtype)
        net.load_params(p_net.params)
        net.update(force_zero_thres=st["fz"])
        net.add_ref_frame(None, st["enc0"]["x_hat"])
        return net

    one = p_codec()
    for x in st["seed_frames"]:
        one.compress_async(x, qp)()
    for t, x in enumerate(st["chunks"][0]):
        if one.compress_async(x, qps[t])() != st["chunk_streams"][0][t]:
            _fail(f"{label}: GOP stream of chunk 0 frame {t} differs from "
                  f"the frame coded alone through compress_async")

    per, gop = p_codec(), p_codec()
    for net in (per, gop):
        for s in st["seed_streams"]:
            net.decompress(s, st["sps"], qp)
    per_x = [per.decompress(s, st["sps"], q)["x_hat"]
             for streams in st["chunk_streams"] for s, q in zip(streams, qps)]
    x_gop = gop.decompress_gop(st["chunk_streams"][0], st["sps"],
                               qps)["x_hat"]
    n = st["gop_n"]
    if not all(torch.equal(x_gop[t], per_x[t]) for t in range(n)):
        _fail(f"{label}: decompress_gop differs from the per-frame decode")
    if not all(torch.equal(st["dec_out"]["x_hat"][t], per_x[t - n])
               for t in range(n)):
        _fail(f"{label}: the last uploaded chunk's decode differs from the "
              "per-frame decode")
    for what, f in (("GOP decoder", d_net.dpb[0].feature),
                    ("encoder", p_net.dpb[0].feature)):
        if not torch.equal(per.dpb[0].feature, f):
            _fail(f"{label}: the per-frame decoder's final feature differs "
                  f"from the {what}'s")
    if not all(bool(torch.isfinite(x).all()) for x in per_x):
        _fail(f"{label}: a decoded P-frame is not finite")

    i_net, i_dec = st["i_net"], st["i_dec"]
    for t, x in enumerate(st["i_frames"]):
        enc = i_net.compress(x, qp)
        if enc["bit_stream"] != st["i_streams"][t] or \
                not torch.equal(enc["x_hat"], st["i_x_hats"][t]):
            _fail(f"{label}: compress_batch frame {t} differs from "
                  f"DMCI.compress")
        dec = i_dec.decompress(enc["bit_stream"], st["i_sps"], qp)["x_hat"]
        if not torch.equal(dec, st["i_dec_out"][t]) or \
                not torch.equal(dec, enc["x_hat"]):
            _fail(f"{label}: decompress_batch frame {t} differs from "
                  f"decompress or from the encoder's x_hat")
    return len(per_x) + n


BENCH_LINES = {}        # each phase_bench run's line, by label


def phase_bench(dev, label="phase 8", env=None):
    """Phase 8 (and 9 (b) with env BENCH_DTYPE=bfloat16):
    `opendcvc_tpu_torch.bench` in process at bench.py's defaults (BENCH_*
    and OPENDCVC_TPU_EC_* unset but for `env`), then its holds; returns
    its K1 and K2 launches, which must match the frames it coded and
    decoded."""
    from opendcvc_tpu_torch import bench
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith(("BENCH_", "OPENDCVC_TPU_EC_"))}
    os.environ.update(env or {})
    _reset_launches()
    t0 = time.perf_counter()
    try:
        st = bench.run()
    finally:
        for k in env or {}:
            os.environ.pop(k)
        os.environ.update(saved)
    launches = _launches()
    bench_s = time.perf_counter() - t0
    coded, decoded, n, gop_n = (st["coded"], st["decoded"], st["n_frames"],
                                st["gop_n"])
    want_p = 2 * len(st["seed_frames"]) + gop_n + n
    if coded["P"] != want_p or decoded["P"] != want_p or \
            decoded["I"] != 3 * len(st["i_frames"]):
        _fail(f"{label}: frames coded {coded}, decoded {decoded}")
    want = [coded["I"] + coded["P"] + st["reruns"],
            5 * decoded["I"] + 3 * decoded["P"]]
    if launches != want:
        _fail(f"{label}: K1/K2 launched {launches} times, the frames coded "
              f"and decoded need {want}")
    line = st["result"]
    BENCH_LINES[label] = line
    _log(f"{label}: {_card()}")
    _log(f"{label}: bench line " + json.dumps(line))
    _log(f"{label}: " + st["verbose"])
    _log(f"{label}: {n} P-frames in chunks of {gop_n}; encode ms a chunk "
         + " ".join(f"{t:.1f}" for t in st["enc_chunk_ms"])
         + " | decode ms a chunk " + " ".join(f"{t:.1f}" for t in
                                                st["dec_chunk_ms"])
         + f" | intra batch of {len(st['i_frames'])}: encode ms "
         + " ".join(f"{t:.1f}" for t in st["intra_enc_ms"]) + ", decode ms "
         + " ".join(f"{t:.1f}" for t in st["intra_dec_ms"])
         + f" | reruns {st['reruns']}; bench {bench_s:.1f} s")

    p_net, (h, w) = st["p_net"], st["size"]
    plan = p_net._plan_device_ec(-(-h // 16) * 16, -(-w // 16) * 16)
    lanes = plan.lanes
    mw, cap = p_net._rung(lanes, plan.steps(), max(
        p_net.bytes_per_symbol, max(p_net._ec_learned.values(), default=0)))
    shape = (gop_n, cap + 3 * lanes)
    d2h, h2d = _copy_ms(shape, dev)
    payload = sum(len(s) for s in st["chunk_streams"][0])
    _log(f"{label}: a chunk's stagings {shape[0]} x {shape[1]} u16 = "
         f"{2 * shape[0] * shape[1]} B (streams {payload} B; lanes {lanes}, "
         f"mw {mw}, cap {cap}); one copy of them: device->host "
         f"{d2h:.4f} ms, host->device {h2d:.4f} ms (pinned, median of "
         f"{REPS})")

    checked = _bench_checks(st, dev, label)
    _log(f"{label}: K1 {launches[0]} launches ({coded['I']} I + "
         f"{coded['P']} P coded + {st['reruns']} reruns), K2 {launches[1]} "
         f"({decoded['I']} I x 5 + {decoded['P']} P x 3); GOP chunk 0 == "
         f"compress_async frame by frame; decompress_gop and the uploaded "
         f"chunks == {checked} per-frame decodes, final features equal, "
         f"enc/dec chain exact; compress_batch / decompress_batch == "
         f"compress / decompress on {len(st['i_frames'])} frames")
    return launches


N_BF16_HARNESS = 8      # phase 9 (c)'s frames, the first of phase 7's


def _times(intra, p_run):
    """The frame times (ms) and bpp of a device-EC I-frame and P-frame
    run (phase_intra, phase_p)."""
    return {"i_enc": intra["enc_ms"], "i_dec": intra["dec_ms"],
            "i_bpp": intra["bpp"], "enc_ms": p_run["enc_ms"],
            "dec_ms": p_run["dec_ms"], "bpp": p_run["bpp"]}


def phase_bf16(dev, frames, f32, root, seq):
    """Phase 9: DCVC-RT in bfloat16 at 1080p full width, phases 3-8's
    configuration.  (a) DMCI + 4 DMC P-frames through device EC, then
    through host EC (two coders, one NAL stream), each exact within
    itself and the two equal; (b) the bench with BENCH_DTYPE=bfloat16;
    (c) the harness with --dtype bfloat16 and device EC on the first
    N_BF16_HARNESS frames of phase 7's sequence.  f32: phases 3-4's
    results, printed beside (a)'s.  Returns the K1 and K2 launches of
    each device-EC run."""
    from opendcvc_tpu_torch.eval import harness
    bf16 = torch.bfloat16
    runs = {}

    _reset_launches()
    intra = phase_intra(dev, frames[0], QP, FZ, bf16, "phase 9 (a)")
    p_run = phase_p(dev, intra["x_hat"], frames[1:], QP, FZ, bf16,
                    "phase 9 (a)")
    runs["phase 9 (a) device EC"] = _launches()
    if min(runs["phase 9 (a) device EC"]) == 0:
        _fail("phase 9 (a): the device-EC run did not launch K1 and K2")
    if intra["x_hat"].dtype != bf16 or p_run["feats"][0].dtype != bf16:
        _fail("phase 9 (a): the codecs did not run in bfloat16")
    _reset_launches()
    phase_host(dev, frames, QP, FZ, intra, p_run, bf16,
               "phase 9 (a) host EC")
    if max(_launches()):
        _fail("phase 9 (a): the host-EC run launched a lane rANS kernel")
    for name, r in (("float32 (phases 3-4)", f32),
                    ("bfloat16 (phase 9 a)", _times(intra, p_run))):
        _log(f"phase 9 (a): device EC, {name}: I-frame enc "
             f"{r['i_enc']:.1f} / dec {r['i_dec']:.1f} ms, bpp "
             f"{r['i_bpp']:.4f}; P-frames enc ms "
             + " ".join(f"{t:.1f}" for t in r["enc_ms"]) + " | dec ms "
             + " ".join(f"{t:.1f}" for t in r["dec_ms"]) + " | bpp "
             + " ".join(f"{b:.4f}" for b in r["bpp"]))

    runs["phase 9 (b)"] = phase_bench(dev, "phase 9 (b)",
                                      {"BENCH_DTYPE": "bfloat16"})
    run_c = _harness_run(harness, root, seq, device_ec=True,
                         n=N_BF16_HARNESS, dtype="bfloat16",
                         phase="phase 9 (c)")
    runs["phase 9 (c)"] = run_c["launches"]
    if min(run_c["launches"]) == 0:
        _fail("phase 9 (c): the device-EC harness run did not launch K1 "
              "and K2")
    return runs


# ---------------------------------------------------------------------------
# phase 10: skip compaction, training, estimate mode
# ---------------------------------------------------------------------------

N_SKIP_GOP = 8          # phase 10 (a)'s GOP chunk
N_TRAIN = 7             # steps a training run: 2 warm-up, 5 timed
N_DESCENT = 5           # steps on one fixed batch
N_ESTIMATE = 8          # phase 10 (d)'s frames, the first of phase 7's
STAGING_PHASE8_B = 1_622_016    # a phase 8 chunk's stagings (PR 7 run)


def _record_k1_steps():
    """Wrap the K1 wrapper that the codecs call (models/dmc.py's
    encode_scan, which DMCI's launches go through too): each launch's
    step count K is appended to the returned list.  Returns (list,
    undo)."""
    from opendcvc_tpu_torch.models import dmc as M
    steps, encode = [], M.encode_scan

    def recording(packed, table, mw):
        steps.append(int(packed.shape[0]))
        return encode(packed, table, mw)

    M.encode_scan = recording
    return steps, lambda: setattr(M, "encode_scan", encode)


def _skip_gop(dev, params, x_ref, xs, qp, fz):
    """A P-frame alone, then a GOP chunk of len(xs) - 1, under skip
    compaction: the chunk's streams must equal the same frames coded one
    by one, and decompress_gop must give each frame the encoder's feature
    reconstructs and end at the encoder's feature.  Returns the streams,
    the reruns, the chunk's encode and decode ms and its staging shape."""
    from opendcvc_tpu_torch.models import common as C
    from opendcvc_tpu_torch.models.dmc import DMC, _stage_recon_x
    nets = []
    for _ in range(3):
        net = DMC(device=dev, device_ec=True)
        net.load_params(params)
        net.update(force_zero_thres=fz)
        net.add_ref_frame(None, x_ref)
        nets.append(net)
    one, gop, dec = nets
    per, feats = [], []
    r0 = _counter("ec.rerun")
    for x in xs:
        per.append(one.compress(x, qp)["bit_stream"])
        feats.append(one.dpb[0].feature.clone())
    first = gop.compress(xs[0], qp)["bit_stream"]
    n = len(xs) - 1
    out, enc_ms = _timed(lambda: gop.compress_gop(xs[1:], [qp] * n), dev)
    streams = [first] + out["bit_streams"]
    if streams != per:
        _fail("phase 10 (a): GOP streams differ from the per-frame streams")
    if not torch.equal(gop.dpb[0].feature, one.dpb[0].feature):
        _fail("phase 10 (a): the GOP encoder's final feature differs")
    sps = {"height": xs[0].shape[1], "width": xs[0].shape[2]}
    dec.decompress(first, sps, qp)
    if not torch.equal(dec.dpb[0].feature, feats[0]):
        _fail("phase 10 (a): decoded P-frame 0 differs from the encoder's")
    x_gop, dec_ms = _timed(
        lambda: dec.decompress_gop(streams[1:], sps, [qp] * n)["x_hat"], dev)
    for t in range(n):
        want = C.frame_to_nhwc(_stage_recon_x(params, feats[t + 1], qp))
        if not torch.equal(x_gop[t], want):
            _fail(f"phase 10 (a): GOP-decoded frame {t + 1} differs from "
                  f"the encoder's")
    if not torch.equal(dec.dpb[0].feature, feats[-1]):
        _fail("phase 10 (a): the GOP decoder's final feature differs from "
              "the encoder's")
    plan = gop._plan_device_ec(xs[0].shape[1], xs[0].shape[2])
    mw, cap = gop._rung(plan.lanes, plan.steps(), gop.bytes_per_symbol)
    mw0, cap0 = gop._rung(plan.lanes, plan.steps(0), gop.bytes_per_symbol)
    return {"streams": streams, "reruns": _counter("ec.rerun") - r0,
            "enc_ms": enc_ms, "dec_ms": dec_ms,
            "plan": plan, "staging": (n, cap + 3 * plan.lanes + 2),
            "staging_kyc0": (n, cap0 + 3 * plan.lanes)}


def phase_skip(dev, f32):
    """Phase 10 (a): phases 3-4 with OPENDCVC_TPU_EC_SKIP_COMPACT=1 (first
    rung at the default survivor share 0.5), then a GOP chunk of
    N_SKIP_GOP P-frames; returns the K1 and K2 launches."""
    from opendcvc_tpu_torch.entropy import device_rans as D
    from opendcvc_tpu_torch.models.dmci import DMCI
    label = "phase 10 (a)"
    frames = synthetic_frames(H, W, N_SKIP_GOP + 6)
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("OPENDCVC_TPU_EC_")}
    os.environ["OPENDCVC_TPU_EC_SKIP_COMPACT"] = "1"
    steps, undo = _record_k1_steps()
    _reset_launches()
    try:
        intra = phase_intra(dev, frames[0], QP, FZ, label=label)
        p_run = phase_p(dev, intra["x_hat"], frames[1:5], QP, FZ,
                        label=label)
        g = _skip_gop(dev, p_run["params"], intra["x_hat"],
                      frames[5:], QP, FZ)
        probe = DMCI(device=dev, device_ec=True)
        probe.force_zero_thres = FZ
        i_plan = probe._plan(frames[0].shape[1], frames[0].shape[2])
    finally:
        undo()
        os.environ.pop("OPENDCVC_TPU_EC_SKIP_COMPACT")
        os.environ.update(saved)
    launches = _launches()
    p_plan = g["plan"]
    coded = [("I", s) for s in intra["streams"]] + \
        [("P", s) for s in p_run["streams"] + g["streams"] + g["streams"]]
    reruns = intra["reruns"] + p_run["reruns"] + g["reruns"]
    # phase_p decodes its P-frames twice (the second time replayed under
    # the profiler)
    want = [len(coded) + reruns,
            5 * len(intra["streams"]) + 3 * (2 * len(p_run["streams"])
                                             + len(g["streams"]))]
    if launches != want:
        _fail(f"{label}: K1/K2 launched {launches} times, the frames coded "
              f"and decoded need {want}")
    if not 0 < i_plan.kyc < i_plan.k_y or not 0 < p_plan.kyc < p_plan.k_y:
        _fail(f"{label}: first compaction rungs {i_plan.kyc} / "
              f"{p_plan.kyc} of {i_plan.k_y} / {p_plan.k_y} steps")
    kycs = {"I": [], "P": []}
    for kind, s in coded:
        meta = D.parse_frame(s)[0]
        plan = i_plan if kind == "I" else p_plan
        if meta["K"] != plan.steps(meta["kyc"]) or not \
                0 < meta["kyc"] <= plan.k_y or meta["K"] not in steps:
            _fail(f"{label}: a {kind}-frame stream records K {meta['K']} "
                  f"at kyc {meta['kyc']}, launches ran {sorted(set(steps))}")
        kycs[kind].append(meta["kyc"])
    allowed = {pl.steps(k) for pl in (i_plan, p_plan)
               for k in range(pl.kyc, pl.k_y + 8, 8) if k <= pl.k_y} \
        | {i_plan.steps(i_plan.k_y), p_plan.steps(p_plan.k_y)}
    if not set(steps) <= allowed:
        _fail(f"{label}: K1 ran {sorted(set(steps))} steps, not k_z + "
              f"n x kyc {sorted(allowed)}")
    n_b = 2 * g["staging"][0] * g["staging"][1]
    n_b0 = 2 * g["staging_kyc0"][0] * g["staging_kyc0"][1]
    _log(f"{label}: first rungs kyc {i_plan.kyc} (DMCI, k_y {i_plan.k_y}, "
         f"k_z {i_plan.k_z}) / {p_plan.kyc} (DMC, k_y {p_plan.k_y}); "
         f"streams' kyc I {kycs['I']} P {kycs['P'][:4]} GOP "
         f"{kycs['P'][4:4 + N_SKIP_GOP + 1]}; reruns {reruns}; K1 steps a "
         f"launch {sorted(set(steps))}")
    for name, r in (("phases 3-4, no compaction", f32),
                    ("skip compaction", _times(intra, p_run))):
        _log(f"{label}: {name}: I-frame enc {r['i_enc']:.1f} / dec "
             f"{r['i_dec']:.1f} ms, bpp {r['i_bpp']:.4f}; P-frames enc ms "
             + " ".join(f"{t:.1f}" for t in r["enc_ms"]) + " | dec ms "
             + " ".join(f"{t:.1f}" for t in r["dec_ms"]) + " | bpp "
             + " ".join(f"{b:.4f}" for b in r["bpp"]))
    _log(f"{label}: GOP chunk of {N_SKIP_GOP}: encode {g['enc_ms']:.1f} ms, "
         f"decode {g['dec_ms']:.1f} ms (host clock, synchronized); stagings "
         f"{g['staging'][0]} x {g['staging'][1]} u16 = {n_b} B at the first "
         f"rung (without compaction at these settings {n_b0} B; phase 8's "
         f"chunk at bench.py's {STAGING_PHASE8_B} B); GOP streams == per "
         f"frame, decoder exact on every frame; K1 {launches[0]}, K2 "
         f"{launches[1]} launches")
    return launches


def _float32_tree(leaves, what, label):
    for t in leaves:
        if t.dtype != torch.float32:
            _fail(f"{label}: {what} holds a {t.dtype} tensor")


def _train_run(dev, model, amp, save_dir, label=None, extra=(),
               steps=N_TRAIN):
    """train_video's main in process at its defaults (synthetic data,
    batch 8, crop 256; dmc and tcm with --frames 3, dcvc with its default
    2) for `steps` steps, with the `extra` options.  Returns {ms a step,
    peak memory, the run's result}."""
    from opendcvc_tpu_torch import train_video
    from opendcvc_tpu_torch.training.train import tree_leaves
    label = label or f"phase 10 ({'c' if amp else 'b'}) {model}"
    argv = ["--model", model, "--steps", str(steps), "--save_dir",
            save_dir, "--log_every", str(steps), "--amp",
            "1" if amp else "0"] + (["--frames", "3"] if model in
                                    ("dmc", "tcm") else []) + list(extra)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = train_video.main(argv)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [m["loss"] for m in out["metrics"]]
    if len(losses) != steps or not all(np.isfinite(losses)):
        _fail(f"{label}: losses {losses}")
    _float32_tree(tree_leaves(out["params"]), "the parameters", label)
    _float32_tree(out["opt_state"]["mu"] + out["opt_state"]["nu"],
                  "Adam's state", label)
    ms = float(np.median(out["step_ms"][2:]))
    _log(f"{label}: {'bfloat16 AMP' if amp else 'float32'}, batch 8, crop "
         f"256: {ms:.1f} ms a step (CUDA events, steps queued; median of "
         f"steps 3-{steps}; all "
         + " ".join(f"{t:.1f}" for t in out["step_ms"]) + f"), "
         f"{8e3 / ms:.1f} samples/s, peak memory "
         f"{peak / 2 ** 30:.2f} GiB ({peak} B); losses "
         + " ".join(f"{v:.3f}" for v in losses) + f"; run {run_s:.1f} s")
    return {"ms": ms, "peak": peak, "out": out}


def _descent(dev, model, label="phase 10 (b)"):
    """The loss on one fixed batch (the defaults' shape) over N_DESCENT
    steps at lr 1e-4, no warmup, must fall, as the JAX package's
    tests/test_training.py holds its train step."""
    from opendcvc_tpu_torch.models.dcvc import dcvc_init
    from opendcvc_tpu_torch.models.dmc import dmc_init
    from opendcvc_tpu_torch.models.dmc_tcm import dmc_tcm_init
    from opendcvc_tpu_torch.models.dmci import dmci_init
    from opendcvc_tpu_torch.training import train as T
    from opendcvc_tpu_torch.training.data import SyntheticVideoDataset
    from opendcvc_tpu_torch.utils.params import to_device
    from opendcvc_tpu_torch.utils.transfer import upload
    gen = torch.Generator().manual_seed(0)
    if model == "dmci":
        params = dmci_init(gen)
        loss_img = T.make_dmci_loss(256.0)

        def loss_fn(p, frames, qp, rng):
            return loss_img(p, frames[:, 0], qp, rng)
    elif model == "tcm":
        params, loss_fn = dmc_tcm_init(gen), T.make_tcm_loss(256.0)
    elif model == "dcvc":
        params = dcvc_init(gen)
        loss_fn = T.make_dcvc_loss(256.0, quant_mode="ste")
    else:
        params, loss_fn = dmc_init(gen), T.make_dmc_loss(256.0)
    params = to_device(params, dev)
    tx = T.make_optimizer(1e-4)
    step = T.make_train_step(loss_fn, tx)
    state = tx.init(T.trainable_leaves(params))
    frames = 2 if model in ("dmci", "dcvc") else 3
    batch = upload(next(SyntheticVideoDataset(frames, 256, seed=0)
                        .batches(8, 1)), dev)
    losses = []
    for _ in range(N_DESCENT):
        params, state, metrics = step(params, state, batch, 32, None)
        losses.append(float(metrics["loss"]))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        _fail(f"{label} {model}: the loss on one batch did not fall "
              f"over {N_DESCENT} steps: {losses}")
    _log(f"{label} {model}: one fixed batch, {N_DESCENT} steps at lr "
         f"1e-4: loss " + " ".join(f"{v:.3f}" for v in losses))


def _code_checkpoints(dev, save_dir):
    """The saved dmci_latest / dmc_latest checkpoints load in the port's
    DMCI and DMC, which code a 1080p I-frame and a P-frame with device EC,
    the decoder exact.  Returns the K1 and K2 launches."""
    from opendcvc_tpu_torch.models.dmc import DMC
    from opendcvc_tpu_torch.models.dmci import DMCI
    from opendcvc_tpu_torch.utils import checkpoint as ckpt
    from opendcvc_tpu_torch.utils.params import from_jax
    x0, x1 = synthetic_frames(H, W, 2)
    sps = {"height": x0.shape[1], "width": x0.shape[2]}
    _reset_launches()
    nets = {}
    for name, make in (("dmci", DMCI), ("dmc", DMC)):
        for role in ("enc", "dec"):
            net = make(device=dev, device_ec=True)
            net.load_params(from_jax(ckpt.load_params(
                os.path.join(save_dir, f"{name}_latest.msgpack"))))
            net.update(force_zero_thres=FZ)
            nets[name, role] = net
    enc = nets["dmci", "enc"].compress(x0, QP)
    dec = nets["dmci", "dec"].decompress(enc["bit_stream"], sps, QP)
    if not torch.equal(enc["x_hat"], dec["x_hat"]):
        _fail("phase 10 (b): the trained DMCI's decoded frame differs")
    for role in ("enc", "dec"):
        nets["dmc", role].add_ref_frame(None, enc["x_hat"])
    s = nets["dmc", "enc"].compress(x1, QP)["bit_stream"]
    out = nets["dmc", "dec"].decompress(s, sps, QP)
    if not torch.equal(nets["dmc", "dec"].dpb[0].feature,
                       nets["dmc", "enc"].dpb[0].feature) or \
            not bool(torch.isfinite(out["x_hat"]).all()):
        _fail("phase 10 (b): the trained DMC's decoder feature differs")
    bpp = [len(b) * 8 / (H * W) for b in (enc["bit_stream"], s)]
    launches = _launches()
    _log(f"phase 10 (b): the saved checkpoints load in DMCI and DMC and "
         f"code a {W}x{H} I-frame and P-frame (bpp {bpp[0]:.4f} / "
         f"{bpp[1]:.4f}), decoder exact; K1 {launches[0]}, K2 "
         f"{launches[1]} launches")
    return launches


def phase_estimate(root, stream_job):
    """Phase 10 (d): the harness with --write_stream 0 on the first
    N_ESTIMATE frames of phase 7's sequence at phase 7's settings."""
    from opendcvc_tpu_torch.eval import harness
    label = "phase 10 (d)"
    cfg = _write_config(root, H, W, N_ESTIMATE)
    harness.main(["--test_config", cfg, "--output_path",
                  os.path.join(root, "estimate.json"), "--stream_path",
                  os.path.join(root, "estimate"), "--rate_num", "1",
                  "--qp_i", str(QP), "--qp_p", str(QP), "--force_zero_thres",
                  str(FZ), "--reset_interval", "8", "--verbose_json", "1",
                  "--seed", "0", "--device", "cuda", "--write_stream", "0"])
    out_dir = os.path.join(root, "estimate", "synthetic")
    with open(os.path.join(out_dir, f"seq1080_q{QP}.json")) as f:
        job = json.load(f)
    bpp, psnr = job["frame_bpp"], job["frame_psnr"]
    if len(bpp) != N_ESTIMATE or not all(np.isfinite(bpp + psnr)):
        _fail(f"{label}: estimate JSON bpp {bpp}, PSNR {psnr}")
    if any(p.endswith(".bin") for p in os.listdir(out_dir)):
        _fail(f"{label}: estimate mode wrote a stream")
    n = N_ESTIMATE
    _log(f"{label}: estimate mode, {n} frames: bpp " + " ".join(
        f"{b:.4f}" for b in bpp) + " | PSNR " + " ".join(
        f"{p:.3f}" for p in psnr) + f"; {job['test_time'] / n:.3f} s a "
         f"frame (test_time {job['test_time']:.2f} s)")
    _log(f"{label}: stream mode (phase 7, device EC), same frames: bpp "
         + " ".join(f"{b:.4f}" for b in stream_job["frame_bpp"][:n])
         + " | PSNR " + " ".join(f"{p:.3f}" for p in
                                 stream_job["frame_psnr"][:n])
         + " (estimate mode runs every P-frame at qp_p with no refresh; "
         "stream mode shifts qp by the frame's index and refreshes)")


def phase_training_slice(dev, f32, root, stream_job):
    """Phase 10: (a) skip compaction; (b) training in float32 and (c) with
    --amp, each of dmci and dmc --frames 3; (d) estimate mode.  Returns
    the K1 and K2 launches of its device-EC runs."""
    runs = {"phase 10 (a)": phase_skip(dev, f32)}
    save_dir = os.path.join(root, "ckpt")
    for amp in (False, True):
        for model in ("dmci", "dmc"):
            _train_run(dev, model, amp, save_dir)
            if not amp:
                _descent(dev, model)
        if not amp:
            runs["phase 10 (b) codecs"] = _code_checkpoints(dev, save_dir)
    phase_estimate(root, stream_job)
    return runs


# ---------------------------------------------------------------------------
# phase 11: DCVC-FM (DMCIFM + DMCFM, host EC)
# ---------------------------------------------------------------------------

N_FM = 10        # (a)'s frames of phase 7's sequence
FM_RESET = 5     # refreshes at frames 1 and 6; frame 9 takes fa_idx 1
N_FM_PARTS = 5   # (b)'s frames
FM_DPB = ("ref_frame", "ref_feature", "ref_mv_feature", "ref_y",
          "ref_mv_y")
#: W1 launches (encoder, decoder) a frame on the card: a P-frame's motion
#: compensation warps 5 times in DMCFM (the reference frame, c1_init, the
#: offset diversity, c2, c3) and 4 in DMCHEM, and the encoder's SpyNet 3
#: (FM) or 4 (HEM) times more; an I-frame never
FM_W1 = {"I": (0, 0), "P": (8, 5)}
HEM_W1 = {"I": (0, 0), "P": (8, 4)}


def _w1_check(got, want, what):
    if tuple(got) != want:
        _fail(f"{what}: W1 launched {tuple(got)} times (encoder, decoder), "
              f"not {want}")
def _fm_wrap(net, kind, log):
    """Wrap an FM codec's compress / decompress: each call synchronized,
    timed, and logged with the host coder's ms within it (the port's
    trace), the device-EC ladder's reruns, the DPB (an I-frame's x_hat) it
    produced and W1's launches within it."""
    compress, decompress = net.compress, net.decompress

    def timed(side, fn, *args):
        r0, w0 = _counter("ec.rerun"), _w1_launches()
        out, ms, session = _traced(lambda: fn(*args), net.device)
        dpb = out["dpb"] if kind == "P" else {"ref_frame": out["x_hat"]}
        log[side].append({"kind": kind, "ms": ms,
                          "coder_ms": _coder_ms(session),
                          "reruns": _counter("ec.rerun") - r0, "dpb": dpb,
                          "w1": _w1_launches() - w0})
        return out

    net.compress = lambda *a: timed("enc", compress, *a)
    net.decompress = lambda *a: timed("dec", decompress, *a)


def _fm_records(data):
    """(nal type, qp, fa_idx, bytes with its SPS) of each frame record of
    an FM NAL stream."""
    from opendcvc_tpu_torch.utils import stream_helper_fm as SF
    rd, helper, out = io.BytesIO(data), SF.SPSHelper(), []
    while rd.tell() < len(data):
        start = rd.tell()
        header = SF.read_header(rd)
        while header["nal_type"] == SF.NalType.NAL_SPS:
            helper.add_sps_by_id(SF.read_sps_remaining(rd,
                                                       header["sps_id"]))
            header = SF.read_header(rd)
        sps = helper.get_sps_by_id(header["sps_id"])
        SF.read_ip_remaining(rd)
        out.append((header["nal_type"].name, sps["qp"], sps["fa_idx"],
                    rd.tell() - start))
    return out


def _fm_exact(enc, dec, what):
    for k in FM_DPB:
        if k in enc and not torch.equal(enc[k], dec[k]):
            _fail(f"{what}: the decoder's {k} differs from the encoder's")


def _fm_harness_run(dev, root, h, w, n, device_ec=False):
    """Phase 11 (a) and 12 (a): `opendcvc_tpu_torch.eval.fm_harness.main`
    in process on the first n frames of phase 7's sequence, with
    OPENDCVC_TPU_DEVICE_EC=1 when device_ec (else unset); returns the
    per-frame log, the JSON and the .bin."""
    from opendcvc_tpu_torch.eval import fm_harness
    log = {"enc": [], "dec": [], "psnr": []}
    build, distortion = fm_harness.build_nets, fm_harness.get_distortion

    def recording(args):
        i_net, p_net = build(args)
        for kind, net in (("I", i_net), ("P", p_net)):
            if net.device_ec != device_ec:
                _fail(f"the FM harness built {kind} on the wrong coder")
            _fm_wrap(net, kind, log)
        return i_net, p_net

    def measured(*args):
        out = distortion(*args)
        log["psnr"].append(out[0][0])
        return out

    fm_harness.build_nets, fm_harness.get_distortion = recording, measured
    cfg = _write_config(root, h, w, n)
    tag = "fm_device_ec" if device_ec else "fm"
    saved = os.environ.pop("OPENDCVC_TPU_DEVICE_EC", None)
    if device_ec:
        os.environ["OPENDCVC_TPU_DEVICE_EC"] = "1"
    try:
        fm_harness.main([
            "--test_config", cfg,
            "--output_path", os.path.join(root, f"{tag}.json"),
            "--stream_path", os.path.join(root, tag), "--rate_num", "1",
            "--qp_i", str(QP), "--qp_p", str(QP),
            "--reset_interval", str(FM_RESET), "--seed", "0",
            "--device", dev.type])
    finally:
        fm_harness.build_nets, fm_harness.get_distortion = build, distortion
        os.environ.pop("OPENDCVC_TPU_DEVICE_EC", None)
        if saved is not None:
            os.environ["OPENDCVC_TPU_DEVICE_EC"] = saved
    out_dir = os.path.join(root, tag, "synthetic")
    with open(os.path.join(out_dir, f"seq1080_q{QP}.json")) as f:
        job = json.load(f)
    with open(os.path.join(out_dir, f"seq1080_q{QP}.bin"), "rb") as f:
        data = f.read()
    return log, job, data


def phase_fm_harness(dev, root, h, w, n=N_FM, device_ec=False,
                     mode="phase 11 (a) FM harness"):
    """Phase 11 (a) (host EC) and 12 (a) (device EC): the FM harness as a
    user runs it; fails unless every decoded frame's DPB equals the
    encoder's, W1 launched FM_W1's times a frame, the JSON's bits are 8 x
    the .bin and every PSNR is finite.
    Returns (the frame records, the per-frame log)."""
    log, job, data = _fm_harness_run(dev, root, h, w, n, device_ec)
    if not len(log["enc"]) == len(log["dec"]) == len(log["psnr"]) == n:
        _fail(f"{mode}: {len(log['enc'])} frames encoded, "
              f"{len(log['dec'])} decoded, {len(log['psnr'])} measured")
    for t, (e, d) in enumerate(zip(log["enc"], log["dec"])):
        _fm_exact(e["dpb"], d["dpb"], f"{mode} frame {t} ({e['kind']})")
        _w1_check((e["w1"], d["w1"]), FM_W1[e["kind"]], f"{mode} frame {t}")
    bits = job["ave_all_frame_bpp"] * n * job["frame_pixel_num"]
    if round(bits) != 8 * len(data):
        _fail(f"{mode}: the JSON's {bits} bits are not 8 x the .bin's "
              f"{len(data)} bytes")
    if not all(np.isfinite(p) for p in log["psnr"]):
        _fail(f"{mode}: a PSNR is not finite: {log['psnr']}")
    recs = _fm_records(data)
    fa = [r[2] for r in recs]
    if len(recs) != n or not {0, 1, 2, 3} <= set(fa):
        _fail(f"{mode}: records {recs}: not every fa_idx 0-3")
    for t, (e, d, r, p) in enumerate(zip(log["enc"], log["dec"], recs,
                                         log["psnr"])):
        coder = "" if device_ec else f" (coder {e['coder_ms']:.2f})"
        dcoder = "" if device_ec else f" (coder {d['coder_ms']:.2f})"
        reruns = f", {e['reruns']} reruns" if device_ec else ""
        _log(f"{mode}: frame {t} {e['kind']} fa_idx {r[2]} qp {r[1]}: "
             f"enc {e['ms']:.2f} ms{coder}, dec {d['ms']:.2f} ms{dcoder}, "
             f"{r[3]} B, bpp {8 * r[3] / (h * w):.4f}, PSNR {p:.4f} dB"
             f"{reruns}")
    _log(f"{mode}: test_time {job['test_time']:.2f} s, bpp "
         f"{job['ave_all_frame_bpp']:.4f}, PSNR "
         f"{job['ave_all_frame_psnr']:.4f} dB, .bin {len(data)} B = JSON "
         f"bits / 8; decoder exact (all five DPB entries) on all {n} "
         f"frames")
    return recs, log


def _fm_src_frames(root, h, w, n, dev):
    """The first n frames of phase 7's sequence as the FM harness feeds
    them to its codecs (on `dev`, padded to 16)."""
    from opendcvc_tpu_torch.eval.harness import get_src_frame, get_src_reader
    from opendcvc_tpu_torch.models import common as C
    pr, pb = C.get_padding_size(h, w, 16)
    args = {"src_type": "yuv420", "src_path": os.path.join(root, "data",
                                                           "seq1080"),
            "src_width": w, "src_height": h, "frame_num": n,
            "device": dev.type}
    reader = get_src_reader(args)
    frames = [get_src_frame(args, reader, (pb, pr))[0] for _ in range(n)]
    reader.close()
    return frames


def _fm_schedule(n, qp=QP, reset=FM_RESET):
    """The FM harness's (fa_idx as coded, fa_idx passed, refresh, qp) of
    P-frames 1..n-1."""
    from opendcvc_tpu_torch.eval.fm_harness import INDEX_MAP, QP_SHIFT
    out = []
    for t in range(1, n):
        fa = 3 if reset > 0 and t % reset == 1 else INDEX_MAP[t % 8]
        out.append((fa, min(fa, 2), fa == 3, min(qp + QP_SHIFT[fa], 63)))
    return out


def phase_fm_parts(dev, root, h, w, recs, n=N_FM_PARTS):
    """Phase 11 (b): DMCIFM and DMCFM(stream_part=2) on (a)'s first n
    frames with (a)'s schedule: decoder exact every frame, every P stream
    a 2-part stream."""
    from opendcvc_tpu_torch.models.dmc_fm import DMCFM
    from opendcvc_tpu_torch.models.dmci_fm import DMCIFM
    mode = "phase 11 (b) stream_part 2"
    i_net = DMCIFM(device=dev, device_ec=False)
    i_net.init_params(seed=0)
    i_net.update()
    enc_net, dec_net = (DMCFM(device=dev, device_ec=False, stream_part=2)
                        for _ in range(2))
    enc_net.init_params(seed=1)
    dec_net.load_params(enc_net.params)
    for net in (enc_net, dec_net):
        net.update()
    xs = _fm_src_frames(root, h, w, n, dev)
    sps = {"height": h, "width": w, "qp": QP}
    e, ms_e = _timed(lambda: i_net.compress(xs[0], QP), dev)
    d, ms_d = _timed(lambda: i_net.decompress(e["bit_stream"], sps), dev)
    _fm_exact({"ref_frame": e["x_hat"]}, {"ref_frame": d["x_hat"]},
              f"{mode} I-frame")
    rows = [f"I {ms_e:.2f} / {ms_d:.2f} ms, {len(e['bit_stream'])} B"]
    none = dict.fromkeys(FM_DPB[1:])
    enc_dpb = dict(none, ref_frame=e["x_hat"])
    dec_dpb = dict(none, ref_frame=d["x_hat"])
    for t, (fa, fa_in, refresh, qp) in enumerate(_fm_schedule(n), start=1):
        if refresh:
            enc_dpb = dict(none, ref_frame=enc_dpb["ref_frame"])
            dec_dpb = dict(none, ref_frame=dec_dpb["ref_frame"])
        out, ms_e = _timed(lambda: enc_net.compress(xs[t], enc_dpb, qp,
                                                    fa_in), dev)
        stream = out["bit_stream"]
        if (stream[0] >> 4) + 1 != 2:
            _fail(f"{mode}: P-frame {t}'s stream flag {stream[0]:#x} is "
                  f"not a 2-part stream's")
        dec, ms_d = _timed(lambda: dec_net.decompress(
            stream, dec_dpb, dict(sps, qp=qp, fa_idx=fa_in)), dev)
        enc_dpb, dec_dpb = out["dpb"], dec["dpb"]
        _fm_exact(enc_dpb, dec_dpb, f"{mode} P-frame {t}")
        rows.append(f"P{t} fa_idx {fa} {ms_e:.2f} / {ms_d:.2f} ms, "
                    f"{len(stream)} B (one part: {recs[t][3]} B with its "
                    f"record)")
    _log(f"{mode}: enc / dec, bytes: " + "; ".join(rows)
         + f"; decoder exact on all {n} frames, every P stream 2 parts")


def _to_cpu(dpb):
    """A DPB's tensors copied to the CPU (None and a raw frame kept)."""
    return {k: v.cpu() if torch.is_tensor(v) else v for k, v in dpb.items()}


def _report_frame(label, what, same, coded, dev, kind, decode, g_dpb):
    """One frame of a 64x64 bfloat16 chain coded on the GPU and on the CPU
    (phase 14 (c)), reported and never failed: the share of equal symbols
    per plane of the two devices' `coded` planes, and whether the CPU
    decoder (`decode()`) takes the GPU's stream, with the max |DPB diff|
    against the GPU encoder's `g_dpb` when it does (cuDNN's and oneDNN's
    bfloat16 sums differ; phase 5's bfloat16 row)."""
    from opendcvc_tpu_torch.eval import fm_ties as TIES
    syms = {k: [p.astype(np.int32) >> 8 if p.dtype == np.int16 else p
                for p in v] for k, v in coded.items()}
    shares = {n: round(float((a == b).mean()), 4) for n, a, b in zip(
        TIES.PLANES[kind][1], syms[dev.type], syms["cpu"])}
    try:
        d = decode()
        diff = max(float((d[k].float() - g_dpb[k].cpu().float())
                         .abs().max()) for k in g_dpb)
        decoded = f"decoded, max |DPB diff| {diff:.4g}"
    except ValueError as e:
        decoded = f"not decoded ({e})"
    _log(f"{label}: 64x64 bfloat16 {what} coded on the GPU and on the "
         f"CPU: equal symbols {shares}; streams identical: {same}; the CPU "
         f"on the GPU's stream: {decoded} (reported)")


def _gpu_cpu_frame(label, what, same, coded, dev, floats, kind, decode,
                   g_dpb):
    """One frame of a 64x64 chain coded on the GPU and on the CPU (phases
    11 (c), 12 (c), 15 (c)).  Where the two streams differ (`same`
    false), the first differing plane of the two devices' `coded` planes
    must differ only where the GPU's value before rounding (`floats`)
    lies within the codecs' float agreement of its rounding boundary (a
    tie: printed, the frame then reported).  `decode()` is the CPU
    decoder on the GPU's stream; fails on its error or a DPB diff over
    1e-3 of max(1, max|ref|) against the GPU encoder's `g_dpb`, unless
    the frame is a tie."""
    from opendcvc_tpu_torch.eval import fm_ties as TIES
    plane, rows = (None, []) if same else \
        TIES.first_differing_plane(coded[dev.type], coded["cpu"],
                                   floats.take(kind), kind)
    if same:
        floats.take(kind)
    tie = bool(rows) and all(r[3] <= r[4] for r in rows)
    for r in rows:
        _log(f"{label}: {what} {plane} {r[0]} {r[1]}: the GPU's value "
             f"{r[2]:.9g} lies {r[3]:.3g} from its rounding boundary "
             f"(float agreement {r[4]:.3g})")
    if not same and not tie:
        _fail(f"{label}: {what}: the GPU's and the CPU's symbols differ "
              f"away from a rounding boundary ({plane}: {rows[:4]})")
    try:
        d = decode()
    except ValueError as e:
        if not tie:
            _fail(f"{label}: the CPU cannot decode the GPU's {what}: {e}")
        d = None
    err = None if d is None else max(
        float((d[k] - g_dpb[k].cpu()).abs().max())
        / max(1.0, float(g_dpb[k].abs().max())) for k in g_dpb)
    if not tie and err > 1e-3:
        _fail(f"{label}: GPU and CPU disagree at {what} ({err:g})")
    diff = "not decoded" if err is None else f"{err:.3g}"
    _log(f"{label}: 64x64 {what} coded on the GPU, decoded by the CPU: max "
         f"|DPB diff| / max(1, max|ref|) {diff}; GPU and CPU streams "
         f"identical: {same}" + (f"; a rounding tie in {plane} (reported)"
                                 if tie else ""))


def phase_fm_reference(dev, device_ec=False, label="phase 11 (c)",
                       dtype=torch.float32):
    """Phase 11 (c) (host EC) and 12 (c) (device EC): a 64x64 I-frame and
    2 P-frames coded on the GPU, each also coded on the CPU from the GPU's
    reference, and decoded by the CPU port from it.  Fails on a decode
    error or a DPB diff over 1e-3 of max(1, max|ref|), unless the GPU's
    and the CPU's symbols differ only at rounding boundaries (a tie:
    printed with the value and its distance to the boundary, the row
    reported).  The symbols compared are the planes each device's host
    coder is handed: on device EC each frame is also coded through host
    EC on both devices, whose planes device EC codes (phase 12 (a) holds
    the two equal).  In bfloat16 (phase 14 (c), host EC) each frame is
    reported and never failed (`_report_frame`)."""
    from opendcvc_tpu_torch.eval import fm_ties as TIES
    from opendcvc_tpu_torch.models.dmc_fm import DMCFM
    from opendcvc_tpu_torch.models.dmci_fm import DMCIFM
    cpu = torch.device("cpu")
    xs = [f[None].astype(np.float32) / 255.0
          for f in textured_frames(64, 64, 3, seed=5)]
    params = {"i": DMCIFM(device=cpu, device_ec=False).init_params(seed=0),
              "p": DMCFM(device=cpu, device_ec=False).init_params(seed=1)}

    def codec(cls, d, ec=device_ec):
        net = cls(device=d, device_ec=ec, dtype=dtype)
        net.load_params(params["i" if cls is DMCIFM else "p"])
        net.update()
        return net

    enc = {d.type: (codec(DMCIFM, d), codec(DMCFM, d)) for d in (dev, cpu)}
    planes = {d.type: (codec(DMCIFM, d, False), codec(DMCFM, d, False))
              for d in (dev, cpu)} if device_ec else enc
    dec = (codec(DMCIFM, cpu), codec(DMCFM, cpu))
    coded = {k: [] for k in enc}
    for k, nets in planes.items():
        for net in nets:
            TIES.record_coded(net, coded[k])

    sps = {"height": 64, "width": 64, "qp": QP}
    ref = None
    with TIES.PreRoundingFloats() as floats:
        for t, (x, fa) in enumerate(zip(xs, (0, 0, 1))):
            kind = "i" if t == 0 else "p"
            for k in coded:
                coded[k].clear()
            floats.on = True
            if t == 0:
                g = enc[dev.type][0].compress(x, QP)
                floats.on = False
                c = enc["cpu"][0].compress(x, QP)
                if device_ec:
                    for k in planes:
                        planes[k][0].compress(x, QP)
                g_dpb = {"ref_frame": g["x_hat"]}
            else:
                p_sps = dict(sps, fa_idx=fa)
                g = enc[dev.type][1].compress(x, ref, QP, fa)
                floats.on = False
                c = enc["cpu"][1].compress(x, _to_cpu(ref), QP, fa)
                if device_ec:
                    planes[dev.type][1].compress(x, ref, QP, fa)
                    planes["cpu"][1].compress(x, _to_cpu(ref), QP, fa)
                g_dpb = g["dpb"]
            stream = g["bit_stream"]

            def decode():
                if t == 0:
                    return {"ref_frame": dec[0].decompress(stream,
                                                           sps)["x_hat"]}
                return dec[1].decompress(stream, _to_cpu(ref), p_sps)["dpb"]

            what = f"{'I' if t == 0 else 'P'}-frame {t}"
            same = stream == c["bit_stream"]
            if dtype == torch.float32:
                _gpu_cpu_frame(label, what, same, coded, dev, floats, kind,
                               decode, g_dpb)
            else:
                floats.take(kind)
                _report_frame(label, what, same, coded, dev, kind, decode,
                              g_dpb)
            ref = g["dpb"] if t else dict.fromkeys(FM_DPB[1:]) | g_dpb


def phase_fm(dev, root, h=H, w=W):
    """Phase 11: DCVC-FM at h x w, (a) the FM harness, (b) the N-part
    split, (c) GPU -> CPU; K1 and K2 must not launch.  Returns (a)'s
    per-frame log."""
    _reset_launches()
    t0 = time.perf_counter()
    recs, log = phase_fm_harness(dev, root, h, w)
    phase_fm_parts(dev, root, h, w, recs)
    phase_fm_reference(dev)
    launches = _launches()
    if max(launches):
        _fail(f"phase 11: FM (host EC) launched K1 / K2 {launches}")
    _log(f"phase 11: DCVC-FM done in {time.perf_counter() - t0:.1f} s; K1 "
         f"{launches[0]}, K2 {launches[1]} launches")
    return log


# ---------------------------------------------------------------------------
# phase 12: DCVC-FM on device EC
# ---------------------------------------------------------------------------

N_FM_ALONE = 5   # (b)'s frames: the I-frame and four P-frames
FM_K2 = {"I": 5, "P": 10}    # K2 launches a decoded frame


def _count_top_index():
    """Wrap both FM modules' y_operand so every y and motion-y plane the
    device-EC encoders code appends its count of CDF index 255 (a device
    tensor, read after the run: no wait for the device) to the returned
    list; returns (list, undo)."""
    from opendcvc_tpu_torch.models import dmc_fm, dmci_fm
    counts, orig = [], dmci_fm.y_operand

    def counting(packed, lanes):
        counts.append(((packed.to(torch.int32) & 255) == 255).sum())
        return orig(packed, lanes)

    dmci_fm.y_operand = dmc_fm.y_operand = counting

    def undo():
        dmci_fm.y_operand = dmc_fm.y_operand = orig
    return counts, undo


def _fm_top_by_frame(counts, kinds):
    """Per frame, its planes' counts of index 255 (4 y planes an I-frame,
    4 motion-y and 4 y planes a P-frame)."""
    out, at = [], 0
    for kind in kinds:
        n = 4 if kind == "I" else 8
        out.append(int(sum(int(c) for c in counts[at:at + n])))
        at += n
    if at != len(counts):
        _fail(f"phase 12: {len(counts)} y planes coded for frames {kinds}")
    return out


def _fm_same(got, want, what, ref="host EC's"):
    for k in FM_DPB:
        if k in want and not torch.equal(got[k], want[k]):
            _fail(f"{what}: {k} differs from {ref}")


def phase_fm_device_harness(dev, root, host, h, w, n=N_FM):
    """Phase 12 (a): the FM harness with OPENDCVC_TPU_DEVICE_EC=1 under
    phase 11 (a)'s checks, then: every frame's encoder and decoder DPB
    (x_hat on an I-frame) equal to phase 11 (a)'s host-EC ones and the
    same per-frame PSNR; K1 launched once a frame plus once a rerun, K2
    5 times a decoded I-frame and 10 a P-frame.  Returns the log."""
    mode = "phase 12 (a) FM harness, device EC"
    counts, undo = _count_top_index()
    _reset_launches()
    try:
        recs, log = phase_fm_harness(dev, root, h, w, n, True, mode)
    finally:
        undo()
    launches = _launches()
    kinds = [e["kind"] for e in log["enc"]]
    reruns = sum(e["reruns"] for e in log["enc"])
    want = [n + reruns, sum(FM_K2[k] for k in kinds)]
    if launches != want:
        _fail(f"{mode}: K1 / K2 launched {launches} times, not {want}")
    for side in ("enc", "dec"):
        for t, (a, b) in enumerate(zip(log[side], host[side])):
            _fm_same(a["dpb"], b["dpb"], f"{mode} frame {t} {side}")
    if log["psnr"] != host["psnr"]:
        _fail(f"{mode}: per-frame PSNR {log['psnr']} differs from host "
              f"EC's {host['psnr']}")
    tops = _fm_top_by_frame(counts, kinds)
    for t, (e, d, he, hd, r, top) in enumerate(zip(
            log["enc"], log["dec"], host["enc"], host["dec"], recs, tops)):
        _log(f"{mode}: frame {t} {e['kind']}: enc {e['ms']:.2f} ms (host "
             f"EC {he['ms']:.2f}), dec {d['ms']:.2f} ms (host EC "
             f"{hd['ms']:.2f}), {r[3]} B, bpp {8 * r[3] / (h * w):.4f}, "
             f"{e['reruns']} reruns, {top} y and motion-y CDF indexes of "
             f"255")
    _log(f"{mode}: K1 {launches[0]} launches ({n} frames, {reruns} "
         f"reruns), K2 {launches[1]} (5 an I-frame, 10 a P-frame); encoder "
         f"and decoder DPBs and PSNR equal to host EC's on all {n} frames")
    return log, launches


def _fm_chain(dev, xs, h, w, device_ec, dtype=torch.float32,
              stream_part=1, label="phase 12 (b)"):
    """DMCIFM (seed 0) and DMCFM (seed 1), built and called directly on
    xs (the I-frame, then P-frames with phase 11 (a)'s schedule), each
    frame decoded by a second pair: fails unless every decoded frame's
    DPB (all five entries) equals the encoder's and, per frame, K1
    launched once plus once a rerun and K2 5 / 10 times on device EC, not
    at all on host EC, and W1 FM_W1's times.  Returns per frame {kind, enc / dec ms, the host
    coder's ms within them (host EC), reruns, bytes, launches, enc / dec
    DPB}."""
    from opendcvc_tpu_torch.models.dmc_fm import DMCFM
    from opendcvc_tpu_torch.models.dmci_fm import DMCIFM
    kw = {"device": dev, "device_ec": device_ec, "dtype": dtype}
    i_enc, i_dec = (DMCIFM(**kw) for _ in range(2))
    p_enc, p_dec = (DMCFM(stream_part=stream_part, **kw) for _ in range(2))
    i_enc.init_params(seed=0)
    p_enc.init_params(seed=1)
    i_dec.load_params(i_enc.params)
    p_dec.load_params(p_enc.params)
    for net in (i_enc, i_dec, p_enc, p_dec):
        net.update()
    sps = {"height": h, "width": w, "qp": QP}
    rows = []

    def coded(kind, enc_fn, dec_fn):
        k0 = _launches()
        r0, w0 = _counter("ec.rerun"), _w1_launches()
        out, ms_e, se = _traced(enc_fn, dev)
        w1 = _w1_launches()
        dec, ms_d, sd = _traced(lambda: dec_fn(out["bit_stream"]), dev)
        _w1_check((w1 - w0, _w1_launches() - w1), FM_W1[kind],
                  f"{label} frame {len(rows)}")
        reruns = _counter("ec.rerun") - r0
        launches = tuple(a - b for a, b in zip(_launches(), k0))
        want = (1 + reruns, FM_K2[kind]) if device_ec else (0, 0)
        if launches != want:
            _fail(f"{label}: frame {len(rows)} launched K1 / K2 "
                  f"{launches} times, not {want}")
        enc_dpb = out.get("dpb", {"ref_frame": out.get("x_hat")})
        dec_dpb = dec.get("dpb", {"ref_frame": dec.get("x_hat")})
        _fm_exact(enc_dpb, dec_dpb, f"{label} frame {len(rows)} ({kind})")
        rows.append({"kind": kind, "enc_ms": ms_e, "dec_ms": ms_d,
                     "enc_coder_ms": _coder_ms(se),
                     "dec_coder_ms": _coder_ms(sd), "reruns": reruns,
                     "bytes": len(out["bit_stream"]),
                     "stream": out["bit_stream"], "launches": launches,
                     "enc": enc_dpb, "dec": dec_dpb})

    coded("I", lambda: i_enc.compress(xs[0], QP),
          lambda s: i_dec.decompress(s, sps))
    none = dict.fromkeys(FM_DPB[1:])
    enc_dpb = dict(none, ref_frame=rows[0]["enc"]["ref_frame"])
    dec_dpb = dict(none, ref_frame=rows[0]["dec"]["ref_frame"])
    for t, (fa, fa_in, refresh, qp) in enumerate(_fm_schedule(len(xs)),
                                                 start=1):
        if refresh:
            enc_dpb = dict(none, ref_frame=enc_dpb["ref_frame"])
            dec_dpb = dict(none, ref_frame=dec_dpb["ref_frame"])
        coded("P", lambda: p_enc.compress(xs[t], enc_dpb, qp, fa_in),
              lambda s: p_dec.decompress(s, dec_dpb,
                                         dict(sps, qp=qp, fa_idx=fa_in)))
        enc_dpb, dec_dpb = rows[-1]["enc"], rows[-1]["dec"]
    return rows


def _launch_total(rows):
    return [sum(r["launches"][i] for r in rows) for i in (0, 1)]


def phase_fm_device_alone(dev, root, ref, h, w, n=N_FM_ALONE):
    """Phase 12 (b): DMCIFM and DMCFM on device EC, built and called
    directly, on (a)'s first n frames with (a)'s schedule (`_fm_chain`'s
    checks), the encoder's DPB (a)'s.  Prints each frame's enc / dec ms,
    reruns and bytes.  Returns the rows."""
    mode = "phase 12 (b) device EC alone"
    rows = _fm_chain(dev, _fm_src_frames(root, h, w, n, dev), h, w,
                     True, label=mode)
    for t, r in enumerate(rows):
        _fm_same(r["enc"], ref["enc"][t]["dpb"], f"{mode} frame {t}")
    total = _launch_total(rows)
    _log(f"{mode}: " + "; ".join(
        f"{r['kind']}{t} enc {r['enc_ms']:.2f} / dec {r['dec_ms']:.2f} ms, "
        f"{r['reruns']} reruns, {r['bytes']} B" for t, r in enumerate(rows))
        + f"; decoder exact and encoder equal to (a) on all {n} frames; "
        f"K1 {total[0]}, K2 {total[1]} launches")
    return rows


def phase_fm_device(dev, root, host, h=H, w=W):
    """Phase 12: DCVC-FM on device EC at h x w, phase 11's frames, weights
    and schedule: (a) the FM harness, (b) the codecs alone, (c) GPU ->
    CPU.  Returns the K1 / K2 launches of the phase and (b)'s rows."""
    t0 = time.perf_counter()
    log, launches = phase_fm_device_harness(dev, root, host, h, w)
    alone = phase_fm_device_alone(dev, root, log, h, w)
    phase_fm_reference(dev, True, "phase 12 (c)")
    total = [a + b for a, b in zip(launches, _launch_total(alone))]
    _log(f"phase 12: DCVC-FM device EC done in "
         f"{time.perf_counter() - t0:.1f} s")
    return total, alone


# ---------------------------------------------------------------------------
# phase 13: an H100 stream for the CPU tests
# ---------------------------------------------------------------------------

H100_QP = 30


def phase_h100_streams(dev, out_dir):
    """Phase 13: one 64x64 frame (the port's synthetic_images(1, 64,
    seed=0)) coded on the card with the committed trained checkpoint
    docs/dmci_tiny_rd.msgpack (DMCI at TINY_KW), qp 30, through host EC
    and device EC, each decoded on the card (exact, or the phase fails).
    Writes the frame, both streams, the GPU decoder's x_hat of each and
    the card and versions to out_dir/h100_streams; tests/data/h100 holds
    a copy that tests/test_torch_port_h100_streams.py decodes on the CPU
    with the JAX package and the port."""
    from opendcvc_tpu_torch.eval.rd_evidence import TINY_KW, \
        synthetic_images
    from opendcvc_tpu_torch.models.dmci import DMCI
    from opendcvc_tpu_torch.utils import checkpoint as ckpt
    from opendcvc_tpu_torch.utils.params import from_jax
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs",
                        "dmci_tiny_rd.msgpack")
    params = from_jax(ckpt.load_params(path))
    x = synthetic_images(1, 64, seed=0)[0]
    out_dir = os.path.join(out_dir, "h100_streams")
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "x.npy"), x)
    sps = {"height": 64, "width": 64, "ec_part": 0}
    sizes = {}
    for mode, device_ec in (("host", False), ("device", True)):
        enc, dec = (DMCI(device=dev, device_ec=device_ec, **TINY_KW)
                    for _ in range(2))
        for net in (enc, dec):
            net.load_params(params)
            net.update()
        out = enc.compress(x, H100_QP)
        x_hat = dec.decompress(out["bit_stream"], sps, H100_QP)["x_hat"]
        if not torch.equal(x_hat, out["x_hat"]):
            _fail(f"phase 13: the {mode}-EC decoder differs from its "
                  f"encoder")
        with open(os.path.join(out_dir, f"{mode}.bin"), "wb") as f:
            f.write(out["bit_stream"])
        np.save(os.path.join(out_dir, f"{mode}_x_hat.npy"),
                x_hat.cpu().numpy())
        sizes[mode] = len(out["bit_stream"])
    meta = {"card": _card(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "qp": H100_QP, "size": 64,
            "checkpoint": "docs/dmci_tiny_rd.msgpack", "dmci": TINY_KW,
            "frame": "opendcvc_tpu_torch.eval.rd_evidence."
                     "synthetic_images(1, 64, seed=0)", "bytes": sizes}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    _log(f"phase 13: a 64x64 trained-DMCI frame coded on the card (host EC "
         f"{sizes['host']} B, device EC {sizes['device']} B), both decoders "
         f"exact; written to {out_dir}")


# ---------------------------------------------------------------------------
# phase 14: DCVC-FM in bfloat16
# ---------------------------------------------------------------------------

def phase_fm_bf16(dev, root, f32_rows, h=H, w=W, n=N_FM_ALONE):
    """Phase 14: phase 12 (b)'s I-frame and four P-frames through DMCIFM /
    DMCFM(dtype=torch.bfloat16), seeds 0 / 1, qp 21, on host EC and on
    device EC (`_fm_chain`'s checks: decoder exact, launches), and on host
    EC with stream_part 2; fails unless every DPB entry is bfloat16, host
    EC equals device EC (every frame's encoder and decoder DPB) and the
    2-part run decodes to host EC's DPB.  Prints per frame the enc / dec
    ms of each run beside phase 12 (b)'s float32, the host coder's ms,
    bytes, bpp, reruns and the count of y and motion-y CDF indexes of
    255; (c) `phase_fm_reference` in bfloat16.  Returns device EC's K1 / K2
    launches."""
    bf16, label = torch.bfloat16, "phase 14 FM bfloat16"
    t0 = time.perf_counter()
    xs = _fm_src_frames(root, h, w, n, dev)
    _reset_launches()
    host = _fm_chain(dev, xs, h, w, False, bf16,
                     label=f"{label} (a) host EC")
    counts, undo = _count_top_index()
    try:
        device = _fm_chain(dev, xs, h, w, True, bf16,
                           label=f"{label} (a) device EC")
    finally:
        undo()
    parts = _fm_chain(dev, xs, h, w, False, bf16, stream_part=2,
                      label=f"{label} (b) stream_part 2")
    kinds = [r["kind"] for r in host]
    tops = _fm_top_by_frame(counts, kinds)
    for t, (a, b, c) in enumerate(zip(host, device, parts)):
        for side in ("enc", "dec"):
            if any(v.dtype != bf16 for v in a[side].values()
                   if v is not None):
                _fail(f"{label}: frame {t}'s {side} DPB is not bfloat16")
            _fm_same(b[side], a[side], f"{label} device EC frame {t} {side}")
            _fm_same(c[side], a[side], f"{label} 2 parts frame {t} {side}")
    for t, (a, b, c, f, top) in enumerate(zip(host, device, parts,
                                              f32_rows, tops)):
        _log(f"{label}: frame {t} {a['kind']}: host EC enc {a['enc_ms']:.2f}"
             f" ms (coder {a['enc_coder_ms']:.2f}) / dec {a['dec_ms']:.2f} "
             f"ms (coder {a['dec_coder_ms']:.2f}), {a['bytes']} B, bpp "
             f"{8 * a['bytes'] / (h * w):.4f}; device EC enc "
             f"{b['enc_ms']:.2f} / dec {b['dec_ms']:.2f} ms, {b['bytes']} B,"
             f" bpp {8 * b['bytes'] / (h * w):.4f}, {b['reruns']} reruns, "
             f"{top} y and motion-y CDF indexes of 255; 2 parts enc "
             f"{c['enc_ms']:.2f} / dec {c['dec_ms']:.2f} ms, {c['bytes']} B;"
             f" float32 device EC (phase 12 (b)) enc {f['enc_ms']:.2f} / dec"
             f" {f['dec_ms']:.2f} ms")
    launches = _launch_total(device)
    _log(f"{label}: decoder exact (all five DPB entries, bfloat16) on all "
         f"{n} frames in every run; device EC == host EC == 2 parts; K1 "
         f"{launches[0]}, K2 {launches[1]} launches (device EC)")
    phase_fm_reference(dev, label="phase 14 (c)", dtype=torch.bfloat16)
    _log(f"phase 14: done in {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 15: DCVC-DC at tools/family_bench.py's operating point
# ---------------------------------------------------------------------------

DC_H, DC_W, DC_FRAMES, DC_Q = 704, 1280, 3, 30


def _dc_chain(dev, xs, h, w, dtype, stream_part, label, params=None):
    """DMCDC (seed 0, or `params`) on xs (the raw reference, then
    P-frames with frame_idx t), host EC, each frame decoded by a second
    DMCDC: fails unless every decoded DPB entry equals the encoder's and
    has `dtype`.  Returns per frame {enc / dec ms, coder ms, bytes,
    stream, enc DPB}."""
    from opendcvc_tpu_torch.models.dmc_dc import DMCDC
    enc, dec = (DMCDC(device=dev, dtype=dtype, stream_part=stream_part)
                for _ in range(2))
    if params is None:
        enc.init_params(seed=0)
    else:
        enc.load_params(params)
    dec.load_params(enc.params)
    for net in (enc, dec):
        net.update()
    enc_dpb = dec_dpb = dict.fromkeys(FM_DPB[1:]) | {"ref_frame": xs[0]}
    rows = []
    for t in range(1, len(xs)):
        out, ms_e, se = _traced(lambda: enc.compress(
            xs[t], enc_dpb, q_in_ckpt=False, q_index=DC_Q, frame_idx=t), dev)
        d, ms_d, sd = _traced(lambda: dec.decompress(
            out["bit_stream"], dec_dpb, h, w, q_in_ckpt=False, q_index=DC_Q,
            frame_idx=t), dev)
        enc_dpb, dec_dpb = out["dpb"], d["dpb"]
        _fm_exact(enc_dpb, dec_dpb, f"{label} frame {t}")
        if any(v.dtype != dtype for v in enc_dpb.values()):
            _fail(f"{label}: frame {t}'s DPB is not {dtype}")
        rows.append({"enc_ms": ms_e, "dec_ms": ms_d,
                     "enc_coder_ms": _coder_ms(se),
                     "dec_coder_ms": _coder_ms(sd),
                     "bytes": len(out["bit_stream"]),
                     "stream": out["bit_stream"], "enc": enc_dpb})
    return rows, enc.params


def _dc_reference(dev, label="phase 15 (c)"):
    """Phase 15 (c): a 64x64 float32 DCVC-DC chain (3 P-frames after a
    raw reference) coded on the GPU, each frame also coded on the CPU
    from the GPU's reference and decoded by the CPU port from it: fails
    on a decode error or a DPB diff over 1e-3 of max(1, max|ref|) (phase
    5's bound), unless the two devices' symbols differ only where the
    GPU's value lies within the codecs' float agreement of its rounding
    boundary (printed, the row reported); identical streams reported."""
    from opendcvc_tpu_torch.eval import fm_ties as TIES
    from opendcvc_tpu_torch.models.dmc_dc import DMCDC
    cpu = torch.device("cpu")
    xs = [f[None].astype(np.float32) / 255.0
          for f in textured_frames(64, 64, 4, seed=6)]
    params = DMCDC(device=cpu).init_params(seed=0)

    def codec(d):
        net = DMCDC(device=d)
        net.load_params(params)
        net.update()
        return net

    enc = {dev.type: codec(dev), "cpu": codec(cpu)}
    dec = codec(cpu)
    coded = {k: [] for k in enc}
    for k, net in enc.items():
        TIES.record_coded(net, coded[k])

    ref = dict.fromkeys(FM_DPB[1:]) | {"ref_frame": xs[0]}
    with TIES.PreRoundingFloats() as floats:
        for t in range(1, len(xs)):
            for k in coded:
                coded[k].clear()
            floats.on = True
            g = enc[dev.type].compress(xs[t], ref, False, DC_Q, frame_idx=t)
            floats.on = False
            c = enc["cpu"].compress(xs[t], _to_cpu(ref), False, DC_Q,
                                    frame_idx=t)
            _gpu_cpu_frame(
                label, f"P-frame {t}", g["bit_stream"] == c["bit_stream"],
                coded, dev, floats, "p",
                lambda: dec.decompress(g["bit_stream"], _to_cpu(ref), 64, 64,
                                       False, DC_Q, frame_idx=t)["dpb"],
                g["dpb"])
            ref = g["dpb"]


def _family_row(dev, name, label, hw=(DC_H, DC_W)):
    """`opendcvc_tpu_torch.family_bench.main` in process at its defaults
    (704x1280, 256x256 for dcvc, 3 frames; FAM_* cleared) but for
    FAM_CODECS=name: fails unless its row has the shape hw, a positive bpp
    and the platform is the device's; the row printed."""
    from opendcvc_tpu_torch import family_bench
    env = {k: os.environ.pop(k, None) for k in ("FAM_H", "FAM_W",
                                                "FAM_FRAMES", "FAM_CODECS",
                                                "FAM_PLATFORM",
                                                "FAM_DCVC_HW")}
    os.environ["FAM_CODECS"] = name
    with tempfile.TemporaryDirectory(prefix="family_bench_") as d:
        try:
            result = family_bench.main([os.path.join(d, "fam.json")])
        finally:
            del os.environ["FAM_CODECS"]
            for k, v in env.items():
                if v is not None:
                    os.environ[k] = v
    row = result["codecs"][name]
    if not (row["h"], row["w"], row["frames"]) == (*hw, DC_FRAMES) \
            or not row["bpp"] > 0 \
            or result["platform"] != ("gpu" if dev.type == "cuda" else "cpu"):
        _fail(f"{label}: family_bench's {name} row {row} on "
              f"{result['platform']}")
    _log(f"{label} family_bench: {name} {json.dumps(row)}")


def phase_dc(dev):
    """Phase 15: DCVC-DC at tools/family_bench.py's operating point
    (704x1280, 3 P-frames after a raw reference, q_index 30 on the fine
    ladder, frame_idx t; family_bench's frames, seed 3), host EC: (a)
    float32 and bfloat16, stream_part 1 and 2, decoder exact every frame
    and entry, each part count's DPB equal to one part's; prints per
    frame enc / dec ms, the host coder's ms within them and bpp; (b)
    `opendcvc_tpu_torch.family_bench.main` in process, its dc row
    printed; (c) `_dc_reference`.  Neither kernel may launch."""
    from opendcvc_tpu_torch import family_bench
    t0 = time.perf_counter()
    _reset_launches()
    xs = family_bench._frames(DC_H, DC_W, DC_FRAMES, dev, seed=3)
    params = None
    for dtype in (torch.float32, torch.bfloat16):
        runs = {}
        for parts in (1, 2):
            label = f"phase 15 (a) DCVC-DC {str(dtype)[6:]} {parts} part" \
                + ("s" if parts > 1 else "")
            runs[parts], params = _dc_chain(dev, xs, DC_H, DC_W, dtype,
                                            parts, label, params)
            for t, r in enumerate(runs[parts], 1):
                _log(f"{label}: frame {t} (frame_idx {t}): enc "
                     f"{r['enc_ms']:.2f} ms (coder {r['enc_coder_ms']:.2f})"
                     f" / dec {r['dec_ms']:.2f} ms (coder "
                     f"{r['dec_coder_ms']:.2f}), {r['bytes']} B, bpp "
                     f"{8 * r['bytes'] / (DC_H * DC_W):.4f}; decoder exact")
        for t, (a, b) in enumerate(zip(runs[1], runs[2]), 1):
            _fm_same(b["enc"], a["enc"], f"phase 15 (a) {dtype} 2 parts "
                     f"frame {t}", "one part's")
            if (b["stream"][0] >> 4) + 1 != 2:
                _fail(f"phase 15 (a): frame {t} is not a 2-part stream")
    _family_row(dev, "dc", "phase 15 (b)")
    _dc_reference(dev)
    launches = _launches()
    if max(launches):
        _fail(f"phase 15: DCVC-DC (host EC) launched K1 / K2 {launches}")
    _log(f"phase 15: DCVC-DC done in {time.perf_counter() - t0:.1f} s; K1 "
         f"{launches[0]}, K2 {launches[1]} launches")

# ---------------------------------------------------------------------------
# phases 16-17: DCVC-HEM and DCVC-TCM at tools/family_bench.py's operating
# points
# ---------------------------------------------------------------------------

HEM_SEED, TCM_SEED = 2, 1   # family_bench's frame seeds


def _codec_pair(cls, dev, dtype, tree):
    """An encoder and a decoder of `cls` on `tree`'s weights, update()d."""
    nets = []
    for _ in range(2):
        net = cls(device=dev, dtype=dtype)
        net.load_params(tree)
        net.update()
        nets.append(net)
    return nets


def _pair_coded(kind, enc_fn, dec_fn, dev):
    """enc_fn() then dec_fn(its result), each timed in a trace session:
    (the encoder's and the decoder's results, the frame's row, with W1's
    launches in each)."""
    w0 = _w1_launches()
    out, ms_e, se = _traced(enc_fn, dev)
    w1 = _w1_launches()
    d, ms_d, sd = _traced(lambda: dec_fn(out), dev)
    return out, d, {"kind": kind, "enc_ms": ms_e, "dec_ms": ms_d,
                    "enc_coder_ms": _coder_ms(se),
                    "dec_coder_ms": _coder_ms(sd),
                    "bytes": len(out["bit_stream"]),
                    "w1": (w1 - w0, _w1_launches() - w1)}


def _hem_trees(dev):
    """IntraNoAR's and DMCHEM's weights (the port's init, seed 0), HEM's
    anchors spread as family_bench spreads them."""
    from opendcvc_tpu_torch.family_bench import HEM_ANCHORS
    from opendcvc_tpu_torch.models.dmc_hem import DMCHEM
    from opendcvc_tpu_torch.models.intra_no_ar import IntraNoAR
    intra = IntraNoAR(device=dev).init_params(seed=0)
    hem = DMCHEM(device=dev).init_params(seed=0)
    for name in ("y_q_scale", "mv_y_q_scale"):
        hem[name] = torch.tensor(HEM_ANCHORS, device=dev)
    return intra, hem


def _hem_chain(dev, xs, h, w, dtype, label, trees):
    """An IntraNoAR I-frame (q_scale 1.0) of xs[0] (after an untimed
    warm-up one), then DMCHEM P-frames of xs[1:] from its x_hat at the
    rung get_interpolated_q_scales(4)[1], host EC, each frame decoded by
    a second codec: fails unless the
    decoded I-frame equals the encoder's x_hat and every decoded DPB
    entry the encoder's, all of `dtype`, and W1 launched HEM_W1's times
    a frame.  Returns per frame {kind, enc /
    dec ms, the host coder's ms within them, bytes}."""
    from opendcvc_tpu_torch.models.dmc_hem import DMCHEM
    from opendcvc_tpu_torch.models.intra_no_ar import IntraNoAR
    ie, idec = _codec_pair(IntraNoAR, dev, dtype, trees[0])
    pe, pdec = _codec_pair(DMCHEM, dev, dtype, trees[1])
    y_l, mv_l = pe.get_interpolated_q_scales(4)
    yq, mvq = float(y_l[1]), float(mv_l[1])
    # a warm-up I-frame, untimed: the dtype's first convolutions set up
    # cuDNN (over 1 s on the card)
    idec.decompress(ie.compress(xs[0], 1.0)["bit_stream"], h, w, 1.0)
    out, d, row = _pair_coded(
        "I", lambda: ie.compress(xs[0], 1.0),
        lambda o: idec.decompress(o["bit_stream"], h, w, 1.0), dev)
    if not torch.equal(d["x_hat"], out["x_hat"]) \
            or out["x_hat"].dtype != dtype:
        _fail(f"{label}: the decoded I-frame differs from the encoder's "
              f"x_hat (or is not {dtype})")
    _w1_check(row["w1"], HEM_W1["I"], f"{label} I-frame")
    rows = [row]
    enc_dpb = {"ref_frame": out["x_hat"], "ref_feature": None,
               "ref_y": None, "ref_mv_y": None}
    dec_dpb = dict(enc_dpb, ref_frame=d["x_hat"])
    for t in range(1, len(xs)):
        out, d, row = _pair_coded(
            "P", lambda: pe.compress(xs[t], enc_dpb, mvq, yq),
            lambda o: pdec.decompress(dec_dpb, o["bit_stream"], h, w, mvq,
                                      yq), dev)
        enc_dpb, dec_dpb = out["dpb"], d["dpb"]
        _fm_exact(enc_dpb, dec_dpb, f"{label} P-frame {t}")
        _w1_check(row["w1"], HEM_W1["P"], f"{label} P-frame {t}")
        if any(v.dtype != dtype for v in enc_dpb.values()):
            _fail(f"{label}: P-frame {t}'s DPB is not {dtype}")
        rows.append(row)
    return rows


def _tcm_chain(dev, xs, h, w, dtype, label, tree):
    """DMCTCM P-frames of xs[1:] after the raw reference xs[0], host EC,
    each decoded by a second DMCTCM: fails unless the decoder's x_hat and
    feature equal the encoder's, of `dtype`.  Returns per frame as
    _hem_chain."""
    from opendcvc_tpu_torch.models.dmc_tcm import DMCTCM
    enc, dec = _codec_pair(DMCTCM, dev, dtype, tree)
    refs = {"enc": (xs[0], None), "dec": (xs[0], None)}
    rows = []
    for t in range(1, len(xs)):
        out, d, row = _pair_coded(
            "P", lambda: enc.compress(xs[t], *refs["enc"]),
            lambda o: dec.decompress(*refs["dec"], o["bit_stream"], h, w),
            dev)
        for k in ("x_hat", "feature"):
            if not torch.equal(out[k], d[k]) or out[k].dtype != dtype:
                _fail(f"{label}: P-frame {t}'s decoded {k} differs from "
                      f"the encoder's (or is not {dtype})")
        refs = {"enc": (out["x_hat"], out["feature"]),
                "dec": (d["x_hat"], d["feature"])}
        rows.append(row)
    return rows


def _log_rows(label, rows, h, w):
    """One line a frame; P-frames count from 1."""
    for t, r in enumerate(rows, 0 if rows[0]["kind"] == "I" else 1):
        _log(f"{label}: {r['kind']}-frame {t}: enc {r['enc_ms']:.2f} ms "
             f"(coder {r['enc_coder_ms']:.2f}) / dec {r['dec_ms']:.2f} ms "
             f"(coder {r['dec_coder_ms']:.2f}), {r['bytes']} B, bpp "
             f"{8 * r['bytes'] / (h * w):.4f}; decoder exact")


def _small_frames(seed, n):
    return [f[None].astype(np.float32) / 255.0
            for f in textured_frames(64, 64, n, seed=seed)]


def _hem_reference(dev, label="phase 16 (c)"):
    """Phase 16 (c): a 64x64 float32 IntraNoAR I-frame and 2 DMCHEM
    P-frames coded on the GPU, each frame also coded on the CPU from the
    GPU's reference and decoded by the CPU port from it, under phase 15
    (c)'s rule (`_gpu_cpu_frame`)."""
    from opendcvc_tpu_torch.eval import fm_ties as TIES
    from opendcvc_tpu_torch.models.dmc_hem import DMCHEM
    from opendcvc_tpu_torch.models.intra_no_ar import IntraNoAR
    cpu = torch.device("cpu")
    xs = _small_frames(7, 3)
    trees = _hem_trees(cpu)

    def codecs(d):
        return tuple(_codec_pair(cls, d, torch.float32, tree)[0]
                     for cls, tree in zip((IntraNoAR, DMCHEM), trees))

    enc = {dev.type: codecs(dev), "cpu": codecs(cpu)}
    dec = codecs(cpu)
    coded = {k: [] for k in enc}
    for k, pair in enc.items():
        for net in pair:
            TIES.record_coded(net, coded[k])
    y_l, mv_l = dec[1].get_interpolated_q_scales(4)
    yq, mvq = float(y_l[1]), float(mv_l[1])
    with TIES.PreRoundingFloats() as floats:
        floats.on = True
        g = enc[dev.type][0].compress(xs[0], 1.0)
        floats.on = False
        c = enc["cpu"][0].compress(xs[0], 1.0)
        _gpu_cpu_frame(
            label, "I-frame", g["bit_stream"] == c["bit_stream"], coded,
            dev, floats, "noar",
            lambda: {"ref_frame": dec[0].decompress(g["bit_stream"], 64, 64,
                                                    1.0)["x_hat"]},
            {"ref_frame": g["x_hat"]})
        ref = {"ref_frame": g["x_hat"], "ref_feature": None, "ref_y": None,
               "ref_mv_y": None}
        for t in range(1, len(xs)):
            for k in coded:
                coded[k].clear()
            floats.on = True
            g = enc[dev.type][1].compress(xs[t], ref, mvq, yq)
            floats.on = False
            c = enc["cpu"][1].compress(xs[t], _to_cpu(ref), mvq, yq)
            _gpu_cpu_frame(
                label, f"P-frame {t}", g["bit_stream"] == c["bit_stream"],
                coded, dev, floats, "hem",
                lambda: dec[1].decompress(_to_cpu(ref), g["bit_stream"], 64,
                                          64, mvq, yq)["dpb"], g["dpb"])
            ref = g["dpb"]


def _tcm_reference(dev, label="phase 17 (c)"):
    """Phase 17 (c): 3 64x64 float32 DMCTCM P-frames after a raw
    reference, coded on the GPU, each also coded on the CPU from the
    GPU's references and decoded by the CPU port, under phase 15 (c)'s
    rule."""
    from opendcvc_tpu_torch.eval import fm_ties as TIES
    from opendcvc_tpu_torch.models.dmc_tcm import DMCTCM
    cpu = torch.device("cpu")
    xs = _small_frames(8, 4)
    tree = DMCTCM(device=cpu).init_params(seed=0)
    enc = {d.type: _codec_pair(DMCTCM, d, torch.float32, tree)[0]
           for d in (dev, cpu)}
    dec = _codec_pair(DMCTCM, cpu, torch.float32, tree)[0]
    coded = {k: [] for k in enc}
    for k, net in enc.items():
        TIES.record_coded(net, coded[k])
    ref, feat = xs[0], None
    with TIES.PreRoundingFloats() as floats:
        for t in range(1, len(xs)):
            for k in coded:
                coded[k].clear()
            floats.on = True
            g = enc[dev.type].compress(xs[t], ref, feat)
            floats.on = False
            cref = ref.cpu() if torch.is_tensor(ref) else ref
            cfeat = None if feat is None else feat.cpu()
            c = enc["cpu"].compress(xs[t], cref, cfeat)
            _gpu_cpu_frame(
                label, f"P-frame {t}", g["bit_stream"] == c["bit_stream"],
                coded, dev, floats, "tcm",
                lambda: dec.decompress(cref, cfeat, g["bit_stream"], 64, 64),
                {"x_hat": g["x_hat"], "feature": g["feature"]})
            ref, feat = g["x_hat"], g["feature"]


def _no_launches(label, t0):
    launches = _launches()
    if max(launches):
        _fail(f"{label} (host EC) launched K1 / K2 {launches}")
    _log(f"{label} done in {time.perf_counter() - t0:.1f} s; K1 "
         f"{launches[0]}, K2 {launches[1]} launches")


def phase_hem(dev):
    """Phase 16: DCVC-HEM at tools/family_bench.py's operating point
    (704x1280, family_bench's frames, seed 2; HEM's anchors spread, its
    rung get_interpolated_q_scales(4)[1]), host EC: (a) an IntraNoAR
    I-frame (q_scale 1.0) and 3 DMCHEM P-frames from its x_hat, in
    float32 and bfloat16, the decoders exact (`_hem_chain`), per frame
    enc / dec ms, the host coder's ms and bpp printed; (b) family_bench's
    hem row; (c) `_hem_reference`.  Neither kernel may launch."""
    from opendcvc_tpu_torch import family_bench
    t0 = time.perf_counter()
    _reset_launches()
    xs = family_bench._frames(DC_H, DC_W, DC_FRAMES, dev, seed=HEM_SEED)
    trees = _hem_trees(dev)
    for dtype in (torch.float32, torch.bfloat16):
        label = f"phase 16 (a) DCVC-HEM {str(dtype)[6:]}"
        _log_rows(label, _hem_chain(dev, xs, DC_H, DC_W, dtype, label,
                                    trees), DC_H, DC_W)
    _family_row(dev, "hem", "phase 16 (b)")
    _hem_reference(dev)
    _no_launches("phase 16: DCVC-HEM", t0)


def phase_tcm(dev, root):
    """Phase 17: DCVC-TCM at tools/family_bench.py's operating point
    (704x1280, 3 P-frames after family_bench's raw reference, seed 1),
    host EC: (a) float32 and bfloat16, the decoders exact
    (`_tcm_chain`), per frame enc / dec ms, the host coder's ms and bpp
    printed; (b) family_bench's tcm row; (c) `_tcm_reference`; (d)
    train_video --model tcm at its defaults (batch 8, crop 256, --frames
    3) for N_TRAIN steps, then N_DESCENT steps on one fixed batch, whose
    loss must fall.  Neither kernel may launch."""
    from opendcvc_tpu_torch import family_bench
    from opendcvc_tpu_torch.models.dmc_tcm import DMCTCM
    t0 = time.perf_counter()
    _reset_launches()
    xs = family_bench._frames(DC_H, DC_W, DC_FRAMES, dev, seed=TCM_SEED)
    tree = DMCTCM(device=dev).init_params(seed=0)
    for dtype in (torch.float32, torch.bfloat16):
        label = f"phase 17 (a) DCVC-TCM {str(dtype)[6:]}"
        _log_rows(label, _tcm_chain(dev, xs, DC_H, DC_W, dtype, label,
                                    tree), DC_H, DC_W)
    _family_row(dev, "tcm", "phase 17 (b)")
    _tcm_reference(dev)
    _train_run(dev, "tcm", False, os.path.join(root, "ckpt"),
               label="phase 17 (d) tcm")
    _descent(dev, "tcm", label="phase 17 (d)")
    _no_launches("phase 17: DCVC-TCM", t0)


# ---------------------------------------------------------------------------
# phases 18-20: EVC, DCVC and the CompressAI zoo
# ---------------------------------------------------------------------------

EVC_SEED, DCVC_SEED = 4, 5  # family_bench's frame seeds
DCVC_HW = 256               # family_bench's FAM_DCVC_HW
KODAK_H, KODAK_W = 512, 768  # Kodak's landscape shape
LIVE = 20.0                 # the live trees' scale


def _evc_images(dev, label, enc, dec, xs, h, w, q, warm=True):
    """Each image of xs coded by enc at q and decoded by dec: fails unless
    the decoded x_hat equals the encoder's, bit for bit.  Returns per
    image {kind, enc / dec ms, coder ms, bytes}; one untimed warm-up
    image first when `warm`."""
    if warm:
        dec.decompress(enc.compress(xs[0], q)["bit_stream"], h, w, q)
    rows = []
    for t, x in enumerate(xs):
        out, d, row = _pair_coded(
            "I", lambda: enc.compress(x, q),
            lambda o: dec.decompress(o["bit_stream"], h, w, q), dev)
        if not torch.equal(d["x_hat"], out["x_hat"]):
            _fail(f"{label}: image {t}'s decoded x_hat differs from the "
                  f"encoder's")
        rows.append(row)
    return rows


def phase_evc_codecs(dev):
    """Phase 18 (a): EVC_LL at family_bench's point (704x1280, its
    frames, seed 4, 3 images, q_scale 1.0) in float32 and bfloat16, then
    bfloat16 with q_basic from U(0.6, 3.0) at q_scale 0.37, then the seven
    other width classes and ScalableEVC (enc_num 4) at rates 0-3 once in
    float32; every decoder exact."""
    from opendcvc_tpu_torch import family_bench
    from opendcvc_tpu_torch.models import evc as PE
    from opendcvc_tpu_torch.utils.params import cast_floating
    xs = family_bench._frames(DC_H, DC_W, DC_FRAMES, dev, seed=EVC_SEED)[1:]
    tree = PE.EVC_LL(device=dev).init_params(seed=0)
    for dtype in (torch.float32, torch.bfloat16):
        label = f"phase 18 (a) EVC_LL {str(dtype)[6:]}"
        enc, dec = _codec_pair(PE.EVC_LL, dev, dtype,
                               cast_floating(tree, dtype))
        rows = _evc_images(dev, label, enc, dec, xs, DC_H, DC_W, 1.0)
        _log_rows(label, rows, DC_H, DC_W)
    spread = dict(tree)
    spread["q_basic"] = torch.from_numpy(np.random.default_rng(9).uniform(
        0.6, 3.0, 192).astype(np.float32)).to(dev)
    label = "phase 18 (a) EVC_LL bfloat16, q_basic U(0.6, 3.0), q 0.37"
    enc, dec = _codec_pair(PE.EVC_LL, dev, torch.bfloat16,
                           cast_floating(spread, torch.bfloat16))
    _log_rows(label, _evc_images(dev, label, enc, dec, xs[:1], DC_H,
                                 DC_W, 0.37, warm=False), DC_H, DC_W)
    for name in ("EVC_LM", "EVC_LS", "EVC_ML", "EVC_SL", "EVC_MM", "EVC_MS",
                 "EVC_SS"):
        cls = getattr(PE, name)
        label = f"phase 18 (a) {name} float32"
        enc, dec = _codec_pair(cls, dev, torch.float32,
                               cls(device=dev).init_params(seed=0))
        _log_rows(label, _evc_images(dev, label, enc, dec, xs[:1],
                                     DC_H, DC_W, 1.0), DC_H, DC_W)
    stree = PE.ScalableEVC(device=dev).init_params(seed=0)
    enc, dec = _codec_pair(PE.ScalableEVC, dev, torch.float32, stree)
    for rate in range(4):
        enc.set_rate(rate)
        label = f"phase 18 (a) ScalableEVC float32 rate {rate}"
        _log_rows(label, _evc_images(dev, label, enc, dec, xs[:1],
                                     DC_H, DC_W, 1.0, warm=rate == 0),
                  DC_H, DC_W)


def _write_pngs(root, images):
    """The images as PNGs under root/kodak and a config naming them."""
    from PIL import Image
    os.makedirs(os.path.join(root, "kodak"), exist_ok=True)
    names = []
    for i, img in enumerate(images):
        names.append(f"kodim{i + 1:02d}.png")
        Image.fromarray(img).save(os.path.join(root, "kodak", names[-1]))
    cfg = os.path.join(root, "kodak.json")
    with open(cfg, "w") as f:
        json.dump({"root_path": root, "test_classes": {"kodak": {
            "test": 1, "base_path": "kodak", "images": names}}}, f)
    return cfg, names


def phase_image_harness(dev, root):
    """Phase 18 (b): the image harness (EVC_LL, seed 0, --rate_num 4, the
    anchors; --calc_ssim 1) on four 768x512 images: in process through
    `main` on PNGs when PIL imports, else `run_one_image` on the same
    arrays.  Fails unless each .bin's bits are 8 x its size, each decoded
    frame equals the encoder's x_hat, and PSNR is finite.  Prints per
    coding the harness's enc / dec ms, the host coder's ms within them
    (the codec's coder clocked on its first call), bytes, bpp, PSNR."""
    from opendcvc_tpu_torch.eval import image_harness as IH
    label = "phase 18 (b) image harness"
    images = textured_frames(KODAK_H, KODAK_W, 4, seed=11)
    cls = IH.MODEL_REGISTRY["EVC_LL"]
    seen = []
    enc_fn, dec_fn = cls.compress, cls.decompress

    def clocked(self, side, fn, *args):
        out, _, session = _traced(lambda: fn(self, *args))
        seen.append([side, out["x_hat"], _coder_ms(session)])
        return out

    def compress(self, x, q):
        return clocked(self, "enc", enc_fn, x, q)

    def decompress(self, *args):
        return clocked(self, "dec", dec_fn, *args)

    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    bins = os.path.join(root, "image_bins")
    cls.compress, cls.decompress = compress, decompress
    try:
        if have_pil:
            cfg, names = _write_pngs(root, images)
            t0 = time.perf_counter()
            results = IH.main(["--test_config", cfg, "--output_path",
                               os.path.join(root, "image.json"),
                               "--stream_path", bins, "--calc_ssim", "1",
                               "--rate_num", "4", "--device",
                               str(dev)])["kodak"]
            how = "main on PNGs (PIL present)"
        else:
            net = cls(device=dev)
            net.init_params(seed=0)
            net.update()
            os.makedirs(bins, exist_ok=True)
            names, results = [f"kodim{i + 1:02d}.png" for i in range(4)], {}
            t0 = time.perf_counter()
            for name, img in zip(names, images):
                results[name] = {}
                for ri, q in enumerate(net.get_q_scales()):
                    results[name][f"{ri:03d}"] = IH.run_one_image(
                        net, img.astype(np.float32) / 255, float(q),
                        os.path.join(bins, f"{name}_{ri}.bin"), True)
            how = "run_one_image on the arrays (no PIL)"
        run_s = time.perf_counter() - t0
    finally:
        del cls.compress, cls.decompress
    if len(seen) != 2 * 4 * 4:
        _fail(f"{label}: {len(seen)} codec calls for 16 codings")
    for (ek, e, _), (dk, d, _) in zip(seen[::2], seen[1::2]):
        if (ek, dk) != ("enc", "dec") or not torch.equal(e, d):
            _fail(f"{label}: a decoded frame differs from its encoder's")
    coder_ms = iter(zip(seen[::2], seen[1::2]))
    for name in names:
        for ri, r in results[name].items():
            (_, _, ce), (_, _, cd) = next(coder_ms)
            size = os.path.getsize(os.path.join(bins,
                                                f"{name}_{int(ri)}.bin"))
            if round(r["bpp"] * KODAK_H * KODAK_W) != 8 * size \
                    or not np.isfinite(r["psnr"]):
                _fail(f"{label}: {name} rate {ri}: {r}, {size} B")
            _log(f"{label}: {name} rate {ri} (q {r['q_scale']:.2f}): enc "
                 f"{1e3 * r['encoding_time']:.2f} ms (coder {ce:.2f}) / dec "
                 f"{1e3 * r['decoding_time']:.2f} ms (coder {cd:.2f}), "
                 f"{size} B, bpp "
                 f"{r['bpp']:.4f}, PSNR {r['psnr']:.3f}, MS-SSIM "
                 f"{r['msssim']:.5f}")
    _log(f"{label}: {how}: 16 codings of 4 {KODAK_W}x{KODAK_H} images in "
         f"{run_s:.1f} s, every decoded frame equal to its encoder's")


def phase_evc_reference(dev):
    """Phase 18 (c): a 64x64 EVC_LL image coded on the GPU and on the CPU,
    the GPU's stream decoded by the CPU port: x_hat within 1e-3 (phase
    15 (c)'s rule, `_gpu_cpu_frame`)."""
    from opendcvc_tpu_torch.eval import fm_ties as TIES
    from opendcvc_tpu_torch.models import evc as PE
    cpu = torch.device("cpu")
    x = _small_frames(12, 1)[0]
    tree = PE.EVC_LL(device=cpu).init_params(seed=0)
    nets = {k: _codec_pair(PE.EVC_LL, d, torch.float32, tree)
            for k, d in ((dev.type, dev), ("cpu", cpu))}
    coded = {k: [] for k in nets}
    for k, (enc, _) in nets.items():
        TIES.record_coded(enc, coded[k])
    with TIES.PreRoundingFloats() as floats:
        floats.on = True
        g = nets[dev.type][0].compress(x, 1.0)
        floats.on = False
        c = nets["cpu"][0].compress(x, 1.0)
        _gpu_cpu_frame("phase 18 (c)", "EVC_LL image",
                       g["bit_stream"] == c["bit_stream"], coded, dev,
                       floats, "evc",
                       lambda: nets["cpu"][1].decompress(g["bit_stream"],
                                                         64, 64, 1.0),
                       {"x_hat": g["x_hat"]})


def phase_evc(dev, root):
    """Phase 18: EVC, host EC: (a) `phase_evc_codecs`, (b)
    `phase_image_harness`, (c) `phase_evc_reference`.  Neither kernel may
    launch."""
    t0 = time.perf_counter()
    _reset_launches()
    phase_evc_codecs(dev)
    _family_row(dev, "evc", "phase 18 (a)")
    phase_image_harness(dev, root)
    phase_evc_reference(dev)
    _no_launches("phase 18: EVC", t0)


def live_dcvc_tree(tree, scale=LIVE):
    """The DCVC tree whose motion latent, motion z, y and z carry
    non-zero symbols: the last conv of mv_enc, ctx_enc, prior_enc and
    mv_prior_enc scaled (`tests/test_torch_port_dcvc.py`'s tree)."""
    import copy
    tree = copy.deepcopy(tree)
    for conv in (tree["mv_enc"]["convs"][3], tree["ctx_enc"]["convs"][3],
                 tree["prior_enc"][2], tree["mv_prior_enc"][2]):
        conv["w"] = conv["w"] * scale
        conv["b"] = conv["b"] * scale
    return tree


def _clock_ar(net):
    """Wrap the codec's two AR coders so each call adds its host ms to
    the returned one-element list."""
    spent = [0.0]
    for ar in (net._ar, net._ar_mv):
        for name in ("encode", "decode"):
            def timed(*args, _fn=getattr(ar, name)):
                t0 = time.perf_counter()
                try:
                    return _fn(*args)
                finally:
                    spent[0] += (time.perf_counter() - t0) * 1e3
            setattr(ar, name, timed)
    return spent


DCVC_KEYS = ("mv_z_string", "mv_y_string", "z_string", "y_string")


def _dcvc_args(o):
    return [o[k] for k in ("mv_y_string", "mv_z_string", "y_string",
                           "z_string")]


def _dcvc_frames(dev, label, tree, xs, hw, dtype, count=False):
    """DCVCNet on `tree`: each of xs[1:] coded against the raw xs[0] and
    decoded by a second codec (one untimed warm-up frame first): fails
    unless decompress equals recon_image bit for bit, of `dtype`.  Prints
    per frame enc / dec ms, the host coder's and the AR loop's ms within
    them, the four strings' bytes and bpp; with `count`, each plane's
    non-zero symbols, which must all be > 0."""
    from opendcvc_tpu_torch.eval import fm_ties as TIES
    from opendcvc_tpu_torch.models.dcvc import DCVCNet
    nets = []
    for _ in range(2):
        net = DCVCNet(device=dev, dtype=dtype)
        net.load_params(tree)
        net.update()
        nets.append(net)
    enc, dec = nets
    dec.decompress(xs[0], *_dcvc_args(enc.compress(xs[0], xs[1])), hw, hw)
    ar = [_clock_ar(n) for n in nets]
    coded = []
    TIES.record_coded(enc, coded)
    for t in range(1, len(xs)):
        coded.clear()
        c0 = ar[0][0], ar[1][0]
        out, ms_e, se = _traced(lambda: enc.compress(xs[0], xs[t]), dev)
        d, ms_d, sd = _traced(lambda: dec.decompress(
            xs[0], *_dcvc_args(out), hw, hw), dev)
        if not torch.equal(d, out["recon_image"]) or d.dtype != dtype:
            _fail(f"{label}: P-frame {t}'s decoded frame differs from "
                  f"recon_image (or is not {dtype})")
        sizes = [len(out[k]) for k in DCVC_KEYS]
        nz = ""
        if count:
            counts = {n: int(((p.astype(np.int32) >> 8)
                              if p.dtype == np.int16 else p).astype(bool)
                             .sum())
                      for n, p in zip(TIES.PLANES["dcvc"][1], coded)}
            if min(counts.values()) == 0:
                _fail(f"{label}: P-frame {t} has a plane without a "
                      f"non-zero symbol: {counts}")
            nz = f"; non-zero symbols {counts}"
        _log(f"{label}: P-frame {t}: enc {ms_e:.2f} ms (coder "
             f"{_coder_ms(se):.2f}, AR loop {ar[0][0] - c0[0]:.2f}) / "
             f"dec {ms_d:.2f} ms (coder {_coder_ms(sd):.2f}, AR loop "
             f"{ar[1][0] - c0[1]:.2f}), mv_z / mv_y / z / y {sizes} B, bpp "
             f"{8 * sum(sizes) / (hw * hw):.4f}; decoder exact{nz}")


def phase_dcvc_reference(dev, tree):
    """Phase 19 (b): a 64x64 P-frame on the live tree coded on the GPU and
    on the CPU, the GPU's strings decoded by the CPU port: within 1e-3
    (`_gpu_cpu_frame`)."""
    from opendcvc_tpu_torch.eval import fm_ties as TIES
    from opendcvc_tpu_torch.models.dcvc import DCVCNet
    from opendcvc_tpu_torch.utils.params import to_device
    cpu = torch.device("cpu")
    ref, x = _small_frames(13, 2)
    nets = {}
    for k, d in ((dev.type, dev), ("cpu", cpu), ("dec", cpu)):
        nets[k] = DCVCNet(device=d)
        nets[k].load_params(to_device(tree, d))
        nets[k].update()
    coded = {dev.type: [], "cpu": []}
    for k in coded:
        TIES.record_coded(nets[k], coded[k])
    with TIES.PreRoundingFloats() as floats:
        floats.on = True
        g = nets[dev.type].compress(ref, x)
        floats.on = False
        c = nets["cpu"].compress(ref, x)
        _gpu_cpu_frame("phase 19 (b)", "DCVC P-frame (live tree)",
                       all(g[k] == c[k] for k in DCVC_KEYS), coded, dev,
                       floats, "dcvc",
                       lambda: {"x_hat": nets["dec"].decompress(
                           ref, *_dcvc_args(g), 64, 64)},
                       {"x_hat": g["recon_image"]})


def phase_dcvc_training(dev, root):
    """Phase 19 (c): train_video --model dcvc at its defaults (batch 8,
    crop 256, --frames 2), float32, N_TRAIN steps of --stage 4: finite
    losses, every mask unchanged bit for bit; one fixed batch's loss falls
    over N_DESCENT steps; then 3 steps of --stage 2: every leaf of
    DCVC_MOTION_SUBTREES unchanged; then the checkpoint loads into
    DCVCNet, which codes a 256x256 pair, the decoder exact."""
    from opendcvc_tpu_torch import family_bench
    from opendcvc_tpu_torch.models.dcvc import DCVCNet, dcvc_init
    from opendcvc_tpu_torch.training.forward import DCVC_MOTION_SUBTREES
    from opendcvc_tpu_torch.training.train import _paths, tree_leaves
    from opendcvc_tpu_torch.utils import checkpoint as ckpt
    from opendcvc_tpu_torch.utils.params import from_jax
    save_dir = os.path.join(root, "ckpt_dcvc")
    init = dcvc_init(torch.Generator().manual_seed(0))
    paths = _paths(init)
    for stage, steps, frozen in ((4, N_TRAIN, ()),
                                 (2, 3, DCVC_MOTION_SUBTREES)):
        label = f"phase 19 (c) dcvc --stage {stage}"
        run = _train_run(dev, "dcvc", False, save_dir, label=label,
                         extra=["--stage", str(stage)], steps=steps)
        after = tree_leaves(run["out"]["params"])
        kept = [p for p in paths if p.endswith("/mask")
                or p.split("/")[0] in frozen]
        for path, a, b in zip(paths, tree_leaves(init), after):
            if path in kept and not torch.equal(a, b.cpu()):
                _fail(f"{label}: {path} moved")
        _log(f"{label}: {len(kept)} fixed leaves (the masks"
             + (", the motion branch" if frozen else "")
             + ") unchanged bit for bit")
        if stage == 4:
            _descent(dev, "dcvc", label="phase 19 (c)")
    net = DCVCNet(device=dev)
    net.load_params(from_jax(ckpt.load_params(
        os.path.join(save_dir, "dcvc_latest.msgpack"))))
    net.update()
    xs = family_bench._frames(DCVC_HW, DCVC_HW, 1, dev, seed=DCVC_SEED)
    out = net.compress(xs[0], xs[1])
    if not torch.equal(net.decompress(xs[0], *_dcvc_args(out), DCVC_HW,
                                      DCVC_HW), out["recon_image"]):
        _fail("phase 19 (c): the trained DCVC's decoded frame differs")
    _log(f"phase 19 (c): the saved checkpoint loads in DCVCNet and codes a "
         f"{DCVC_HW}x{DCVC_HW} pair ({sum(len(out[k]) for k in DCVC_KEYS)}"
         f" B), the decoder exact")


def phase_dcvc(dev, root):
    """Phase 19: DCVC at family_bench's point (256x256, its frames, seed
    5, 3 P-frames against the raw frame 0), host EC: (a) the init (seed 0)
    and the live tree, float32 and bfloat16, every decoder exact, the live
    tree's non-zero symbols printed (`_dcvc_frames`); (b)
    `phase_dcvc_reference`; (c) `phase_dcvc_training`.  Neither kernel may
    launch."""
    from opendcvc_tpu_torch import family_bench
    from opendcvc_tpu_torch.models.dcvc import DCVCNet
    t0 = time.perf_counter()
    _reset_launches()
    xs = family_bench._frames(DCVC_HW, DCVC_HW, DC_FRAMES, dev,
                              seed=DCVC_SEED)
    tree = DCVCNet(device=dev).init_params(seed=0)
    live = live_dcvc_tree(tree)
    for name, t, count in (("init", tree, False), ("live", live, True)):
        for dtype in (torch.float32, torch.bfloat16):
            _dcvc_frames(dev, f"phase 19 (a) DCVC {name} "
                         f"{str(dtype)[6:]}", t, xs, DCVC_HW, dtype, count)
    _family_row(dev, "dcvc", "phase 19 (a)", (DCVC_HW, DCVC_HW))
    phase_dcvc_reference(dev, live)
    phase_dcvc_training(dev, root)
    _no_launches("phase 19: DCVC", t0)


def _zoo_latent(net, x):
    """The latent the encoder of the zoo codec `net` codes for x,
    recomputed through its stage functions, as the decoder's synthesis
    takes it (NCHW, the codec's dtype).  For the autoregressive models,
    the y and prior the stage functions give must be those compress
    handed the host coder (`net._seen`), whose y_hat is the latent."""
    from opendcvc_tpu_torch.models import priors_zoo as PZ
    from opendcvc_tpu_torch.models.common import from_host_nhwc
    from opendcvc_tpu_torch.models.dcvc import from_host_hwc
    from opendcvc_tpu_torch.ops import fused as F
    p, dev, dtype = net.params, net.device, net.dtype
    xc = net._x(x)
    if isinstance(net, PZ.FactorizedPrior):
        return F.round_and_to_int8(PZ._ga_apply(p["g_a"], xc))[1].to(dtype)
    y, z = net._fwd_ga(p, xc)
    z_hat = F.round_and_to_int8(z)[1].to(torch.float32).to(dtype)
    if isinstance(net, PZ.JointAutoregressiveHierarchicalPriors):
        prior = net._fwd_hs(p, z_hat)
        y_in, prior_in, y_hat = net._seen
        host = [t[0].permute(1, 2, 0).float().cpu().numpy()
                for t in (y, prior)]
        if not (np.array_equal(host[0], y_in)
                and np.array_equal(host[1], prior_in)):
            _fail(f"{type(net).__name__}: the stage functions' y or prior "
                  f"differs from the one compress coded")
        return from_host_hwc(y_hat, dev, dtype)
    y_host = PZ._host_f32(y)
    if isinstance(net, PZ.MeanScaleHyperprior):
        _, means = net._scales_means(z_hat)
        y_q = np.clip(np.round(y_host - means), -128, 127) + means
    else:
        y_q = np.clip(np.round(y_host), -128, 127)
    return from_host_nhwc(y_q.astype(np.float32), dev, dtype)


def _zoo_codec(cls, dev, dtype, tree):
    net = cls(device=dev, dtype=dtype)
    net.load_params(tree)
    net.update()
    if getattr(net, "_ar", None) is not None:
        encode = net._ar.encode

        def seen(y, prior, ge):
            y_hat = encode(y, prior, ge)
            net._seen = (y, prior, y_hat)
            return y_hat

        net._ar.encode = seen
    return net


def phase_zoo(dev):
    """Phase 20: each zoo model at its default widths (the port's init,
    seed 0) on one 768x512 image, float32 and bfloat16, host EC: fails
    unless the decoded latent equals the encoder's (recomputed by
    `_zoo_latent`), x_hat lies in [0, 1] and a second decode is
    identical; prints enc / dec ms, the host coder's ms and bytes.  Then
    a 64x64 float32 image a model coded on the GPU, its strings decoded by
    the CPU port: x_hat within 1e-3.  Neither kernel may launch."""
    from opendcvc_tpu_torch.models import priors_zoo as PZ
    from opendcvc_tpu_torch.utils.params import to_device
    t0 = time.perf_counter()
    _reset_launches()
    cpu = torch.device("cpu")
    x = textured_frames(KODAK_H, KODAK_W, 1, seed=14)[0][None] \
        .astype(np.float32) / 255
    small = _small_frames(15, 1)[0]
    for name, cls in PZ.IMAGE_CODEC_ZOO.items():
        tree = cls(device=dev).init_params(seed=0)
        for dtype in (torch.float32, torch.bfloat16):
            label = f"phase 20 {name} {str(dtype)[6:]}"
            enc, dec = (_zoo_codec(cls, dev, dtype, tree) for _ in range(2))
            seen = []
            gs = dec._gs
            dec._gs = lambda y_hat: (seen.append(y_hat), gs(y_hat))[1]
            out, ms_e, se = _traced(lambda: enc.compress(x), dev)
            d1, ms_d, sd = _traced(lambda: dec.decompress(out["strings"],
                                                          out["shape"]), dev)
            coder_ms = _coder_ms(se), _coder_ms(sd)
            d2 = dec.decompress(out["strings"], out["shape"])
            want = _zoo_latent(enc, x)
            if not torch.equal(seen[0], want) or seen[0].dtype != dtype:
                _fail(f"{label}: the decoded latent differs from the "
                      f"encoder's")
            xh = d1["x_hat"]
            if not torch.equal(xh, d2["x_hat"]) or xh.dtype != dtype \
                    or float(xh.min()) < 0 or float(xh.max()) > 1:
                _fail(f"{label}: x_hat out of [0, 1], of another dtype, or "
                      f"a second decode differs")
            sizes = [len(s) for g in out["strings"] for s in g]
            _log(f"{label}: enc {ms_e:.2f} ms (coder {coder_ms[0]:.2f}) / "
                 f"dec {ms_d:.2f} ms (coder {coder_ms[1]:.2f}), strings "
                 f"{sizes} B, bpp {8 * sum(sizes) / (KODAK_H * KODAK_W):.4f}"
                 f"; latent exact, second decode identical")
        g = _zoo_codec(cls, dev, torch.float32, tree).compress(small)
        c = _zoo_codec(cls, cpu, torch.float32,
                       to_device(tree, cpu)).compress(small)
        d = _zoo_codec(cls, cpu, torch.float32, to_device(tree, cpu)) \
            .decompress(g["strings"], g["shape"])["x_hat"]
        ref = _zoo_codec(cls, dev, torch.float32, tree) \
            .decompress(g["strings"], g["shape"])["x_hat"].cpu()
        err = float((d - ref).abs().max())
        if err > 1e-3:
            _fail(f"phase 20 {name}: GPU and CPU disagree on a 64x64 "
                  f"image ({err:g})")
        same = [a == b for a, b in zip(
            [s for grp in g["strings"] for s in grp],
            [s for grp in c["strings"] for s in grp])]
        _log(f"phase 20 {name}: 64x64 image coded on the GPU, decoded by "
             f"the CPU: max |x_hat diff| {err:.3g}; GPU and CPU strings "
             f"identical: {same}")
    _no_launches("phase 20: the CompressAI zoo", t0)


# ---------------------------------------------------------------------------
# phase 21: the rest of training and the evaluation extras
# ---------------------------------------------------------------------------

CAMP_STEPS = 12      # DEFAULT_STAGES at 12 steps: 8 at crop 128, 2 + 2
CAMP_KILL = 6
DMC_CAMP_STEPS = 6   # DMC_STAGES at 6 steps: 3 with 1 P-frame, 1 + 2 with 2
FM_STEPS = 5
PLATEAU_STEPS = 8
PLATEAU = dict(factor=0.5, patience=2, rtol=0.5)
VIMEO_H, VIMEO_W = 256, 448  # a Vimeo-90k septuplet frame
RD_QPS = (20, 40)
RESUME_ATOL = 1e-5   # the resume's bound if an op has no deterministic form


class _Deterministic:
    """torch.use_deterministic_algorithms(True, warn_only=True) inside the
    block; `ops` lists the first line of each warning about an operation
    without a deterministic CUDA implementation."""

    def __enter__(self):
        import warnings
        self._catch = warnings.catch_warnings(record=True)
        self._seen = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        return self

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(False)
        self._catch.__exit__(*exc)
        self.ops = sorted({str(w.message).splitlines()[0] for w in self._seen
                           if "determinis" in str(w.message)})
        return False


def _recorded_steps(CP, losses):
    """Patch the campaign's make_train_step so each step's loss (a device
    tensor) lands in `losses`; returns the original."""
    orig = CP.make_train_step

    def make(loss_fn, tx, **kw):
        step = orig(loss_fn, tx, **kw)

        def run(*args):
            out = step(*args)
            losses.append(out[2]["loss"])
            return out
        return run

    CP.make_train_step = make
    return orig


def _campaign_run(dev, CP, label, fn, *args, **kw):
    """One campaign call: its losses (finite, or the phase fails), seconds
    and peak memory printed."""
    losses = []
    orig = _recorded_steps(CP, losses)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        fn(*args, **kw)
    finally:
        CP.make_train_step = orig
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    vals = [float(v) for v in losses]
    if not vals or not all(np.isfinite(vals)):
        _fail(f"{label}: losses {vals}")
    _log(f"{label}: {len(vals)} steps, {secs:.1f} s in all (the bank, the "
         f"init, the saves and the probes included), peak memory "
         f"{peak / 2 ** 30:.2f} GiB ({peak} B); losses "
         + " ".join(f"{v:.4f}" for v in vals))
    return vals


def _same_state(label, a, b, det):
    """Fail unless the train states in files a and b are equal byte for
    byte; with a determinism warning, hold them to RESUME_ATOL instead and
    print the difference."""
    from opendcvc_tpu_torch.training.train import tree_leaves
    from opendcvc_tpu_torch.utils import checkpoint as ckpt
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if fa.read() == fb.read():
            _log(f"{label}: the resumed run's train state (params, Adam's "
                 f"moments, step) equals the uninterrupted run's bit for "
                 f"bit")
            return
    pa, pb = ckpt.load_checkpoint(a), ckpt.load_checkpoint(b)
    diff = max(float(np.abs(np.asarray(x, np.float64)
                            - np.asarray(y, np.float64)).max())
               for x, y in zip(tree_leaves(pa), tree_leaves(pb)))
    _log(f"{label}: resumed != uninterrupted, max |diff| {diff:.3g}; ops "
         f"without a deterministic CUDA form: {det.ops}")
    if not det.ops or diff > RESUME_ATOL:
        _fail(f"{label}: the resumed run differs from the uninterrupted "
              f"one ({diff:g})")


def _check_layout(label, path):
    """The file holds the JAX package's full train state layout."""
    from opendcvc_tpu_torch.utils import checkpoint as ckpt
    p = ckpt.load_checkpoint(path)
    st = p.get("opt_state", {})
    ok = set(p) == {"params", "opt_state", "step", "extra"} and \
        set(st) == {"0", "1"} and st["0"] == {} and \
        set(st["1"]) == {"0", "1"} and \
        set(st["1"]["0"]) == {"count", "mu", "nu"} and \
        set(st["1"]["1"]) == {"count"} and \
        np.asarray(st["1"]["0"]["count"]).dtype == np.int32 and \
        np.asarray(p["step"]).dtype == np.int64
    if not ok:
        _fail(f"{label}: {path} is not the JAX package's train state layout")
    return p


def _memo(fn):
    """fn with its results kept by argument: the campaigns' init trees,
    drawn once and handed out as copies."""
    from opendcvc_tpu_torch.utils.params import tree_map
    cache = {}

    def draw(*args):
        key = repr(args)
        if key not in cache:
            cache[key] = fn(*args)
        return tree_map(torch.clone, cache[key])
    return draw


def phase_campaign(dev, root):
    """Phase 21 (a) and (b): the DMCI campaign at full width, uninterrupted,
    killed at CAMP_KILL and resumed, and with --amp; then the DMC campaign
    on (a)'s checkpoint, uninterrupted and killed at 3 and resumed.
    Returns (a)'s checkpoint."""
    from opendcvc_tpu_torch.training import campaign as CP
    inits = CP._dmci_params, CP._dmc_params
    CP._dmci_params, CP._dmc_params = map(_memo, inits)
    try:
        return _campaigns(dev, root, CP)
    finally:
        CP._dmci_params, CP._dmc_params = inits


def _campaigns(dev, root, CP):
    from opendcvc_tpu_torch.training.train import tree_leaves
    d = os.path.join(root, "campaign")
    kw = dict(total_steps=CAMP_STEPS, seed=0, bank_images=16, bank_size=320,
              save_every=3, log_every=CAMP_STEPS, eval_every=CAMP_STEPS,
              device=dev)
    a, b, amp = (os.path.join(d, f"dmci_{n}.msgpack")
                 for n in ("a", "b", "amp"))
    with _Deterministic() as det:
        _campaign_run(dev, CP, "phase 21 (a) DMCI uninterrupted",
                      CP.train_dmci_campaign, a, **kw)
        _campaign_run(dev, CP, f"phase 21 (a) DMCI killed at {CAMP_KILL}",
                      CP.train_dmci_campaign, b, stop_after=CAMP_KILL, **kw)
        _campaign_run(dev, CP, "phase 21 (a) DMCI resumed",
                      CP.train_dmci_campaign, b, resume=True, **kw)
    _same_state("phase 21 (a)", a, b, det)
    p = _check_layout("phase 21 (a)", b)
    _log(f"phase 21 (a): the file is the JAX package's train state layout "
         f"(step {int(p['step'])}, Adam count "
         f"{int(p['opt_state']['1']['0']['count'])}); ops without a "
         f"deterministic CUDA form: {det.ops or 'none'}")
    _campaign_run(dev, CP, "phase 21 (a) DMCI --amp", CP.train_dmci_campaign,
                  amp, amp=True, **kw)
    p = _check_layout("phase 21 (a) --amp", amp)
    adam = p["opt_state"]["1"]["0"]
    if any(np.asarray(t).dtype != np.float32 for t in tree_leaves(
            [p["params"], adam["mu"], adam["nu"]])):
        _fail("phase 21 (a) --amp: the train state is not float32")

    refs = []
    orig = CP._recon_refs

    def spy(bank, groups, ckpt_path, device):
        before = bank.bank[:, 0].copy()
        orig(bank, groups, ckpt_path, device)
        refs.append((before, bank.bank.copy()))

    dkw = dict(dmci_ckpt=a, total_steps=DMC_CAMP_STEPS, seed=0, bank_seqs=16,
               bank_size=256, seq_t=3, save_every=3,
               log_every=DMC_CAMP_STEPS, eval_every=DMC_CAMP_STEPS,
               device=dev)
    da, db = (os.path.join(d, f"dmc_{n}.msgpack") for n in ("a", "b"))
    CP._recon_refs = spy
    try:
        with _Deterministic() as det:
            _campaign_run(dev, CP, "phase 21 (b) DMC uninterrupted",
                          CP.train_dmc_campaign, da, **dkw)
            _campaign_run(dev, CP, "phase 21 (b) DMC killed at 3",
                          CP.train_dmc_campaign, db, stop_after=3, **dkw)
            _campaign_run(dev, CP, "phase 21 (b) DMC resumed",
                          CP.train_dmc_campaign, db, resume=True, **dkw)
    finally:
        CP._recon_refs = orig
    for before, after in refs:
        if any(np.array_equal(before[i], after[i, 0])
               for i in range(len(before))):
            _fail("phase 21 (b): a reference was not rewritten by the "
                  "frozen DMCI")
    _log(f"phase 21 (b): every run rewrote all {len(refs[0][0])} "
         f"references through (a)'s DMCI at the qp anchors "
         f"{CP.REF_QP_ANCHORS}")
    _same_state("phase 21 (b)", da, db, det)
    _check_layout("phase 21 (b)", db)
    return a


def phase_fm_training(dev):
    """Phase 21 (c): make_fm_loss through the port's step at full width,
    batch 2, crop 256, 3 frames, q_index 30, float32 then AMP, FM_STEPS
    steps on one fixed batch: the loss falls, the state stays float32."""
    from opendcvc_tpu_torch.models.dmc_fm import dmc_fm_init
    from opendcvc_tpu_torch.training import train as T
    from opendcvc_tpu_torch.training.syndata import natural_seqs
    from opendcvc_tpu_torch.utils.params import to_device
    from opendcvc_tpu_torch.utils.transfer import upload
    batch = upload(np.stack(natural_seqs(2, 256, t=3, seed=5)), dev)
    for amp in (False, True):
        label = f"phase 21 (c) FM {'AMP' if amp else 'float32'}"
        params = to_device(dmc_fm_init(torch.Generator().manual_seed(0)),
                           dev)
        tx = T.make_optimizer(1e-4)
        state = tx.init(T.trainable_leaves(params))
        step = T.make_train_step(T.make_fm_loss(32.0, 4096.0), tx,
                                 compute_dtype=torch.bfloat16 if amp
                                 else None)
        torch.cuda.reset_peak_memory_stats(dev)
        marks, losses = [], []
        for _ in range(FM_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            params, state, m = step(params, state, batch, 30, None)
            ev[1].record()
            marks.append(ev)
            losses.append(m["loss"])
        _sync(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        ms = [a.elapsed_time(b) for a, b in marks]
        vals = [float(v) for v in losses]
        if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
            _fail(f"{label}: the loss on one batch did not fall over "
                  f"{FM_STEPS} steps: {vals}")
        _float32_tree(T.tree_leaves(params) + state["mu"] + state["nu"],
                      "the train state", label)
        _log(f"{label}: batch 2, crop 256, 2 P-frames: "
             f"{float(np.median(ms[1:])):.1f} ms a step (CUDA events, "
             f"steps queued; median of steps 2-{FM_STEPS}; all "
             + " ".join(f"{t:.1f}" for t in ms) + f"), peak memory "
             f"{peak / 2 ** 30:.2f} GiB ({peak} B); loss "
             + " ".join(f"{v:.3f}" for v in vals))


def _plateau_replay(values, factor, patience, rtol=1e-4, atol=0.0,
                    cooldown=0, accumulation_size=1, min_scale=0.0):
    """optax.contrib.reduce_on_plateau's scales after each value, in numpy
    float32 (the plain version of the port's rule)."""
    f32, i32 = np.float32, np.int32
    avg, best, scale = f32(0), f32(np.inf), f32(1)
    count = plateau = cool = i32(0)
    out = []
    for v in values:
        new_count = count + 1
        avg = f32(f32(f32(count) * avg + f32(v)) / f32(new_count))
        count = new_count
        if count == accumulation_size:
            improved = avg < f32(f32(f32(1 - rtol) * best) - f32(atol))
            best = avg if improved else best
            curr = i32(0) if improved else plateau + 1
            if cool > 0:
                plateau, cool = i32(0), cool - 1
            else:
                hit = curr == patience
                plateau = i32(0) if hit else curr
                scale = max(f32(scale * f32(factor)) if hit else scale,
                            f32(min_scale))
                cool = i32(cooldown) if hit else i32(0)
            count, avg = i32(0), f32(0)
        out.append(float(scale))
    return out


def phase_plateau(dev):
    """Phase 21 (d): make_train_step(plateau=True) on the full DMCI for
    PLATEAU_STEPS steps (ImageBank batches, crop 128, batch 8): every
    step's scale equals optax's rule replayed on the printed losses, and
    the scale fell."""
    from opendcvc_tpu_torch.models.dmci import dmci_init
    from opendcvc_tpu_torch.training import train as T
    from opendcvc_tpu_torch.training.syndata import ImageBank
    from opendcvc_tpu_torch.utils.params import to_device
    from opendcvc_tpu_torch.utils.transfer import upload
    params = to_device(dmci_init(torch.Generator().manual_seed(0)), dev)
    tx = T.make_optimizer(1e-4, plateau=PLATEAU)
    state = tx.init(T.trainable_leaves(params))
    step = T.make_train_step(T.make_dmci_loss(32.0, lmbda_max=4096.0), tx,
                             plateau=True)
    bank = ImageBank(n_images=8, size=256, seed=1)
    losses, scales = [], []
    for i in range(PLATEAU_STEPS):
        r = np.random.default_rng(i)
        params, state, m = step(params, state,
                                upload(bank.sample(r, 8, 128), dev),
                                int(r.integers(0, 64)), None)
        losses.append(m["loss"])
        scales.append(state["plateau"]["scale"].clone())
    vals = np.asarray([float(v) for v in losses], np.float32)
    got = [float(s) for s in scales]
    want = _plateau_replay(vals, **PLATEAU)
    _log(f"phase 21 (d) plateau {PLATEAU}: losses "
         + " ".join(f"{v:.6g}" for v in vals) + "; scale after each step "
         + " ".join(f"{s:g}" for s in got) + " (optax's rule on these "
         "losses: " + " ".join(f"{s:g}" for s in want) + ")")
    if got != want or min(got) >= 1.0:
        _fail("phase 21 (d): the plateau's scale does not follow optax's "
              "rule, or never fell")


def _vimeo_tree(root, n=4):
    from PIL import Image
    from opendcvc_tpu_torch.training.syndata import natural_images
    names = [f"00001/{i + 1:04d}" for i in range(n)]
    imgs = natural_images(n, VIMEO_H, seed=21, width=VIMEO_W)
    for name, img in zip(names, imgs):
        d = os.path.join(root, "sequences", name)
        os.makedirs(d)
        Image.fromarray(np.round(img[0] * 255).astype(np.uint8)).save(
            os.path.join(d, "im1.png"))
    lst = os.path.join(root, "sep_trainlist.txt")
    with open(lst, "w") as f:
        f.write("\n".join(names) + "\n")
    return names, lst


def phase_precompute(dev, root, dmci_ckpt):
    """Phase 21 (e): precompute_references on a Vimeo-layout tree of four
    448x256 im1.png with the campaign's DMCI at qp 21, on device EC (K1)
    and host EC: the PNGs equal, and equal to the uint8 rounding of
    DMCI.compress's x_hat.  Returns the K1 / K2 launches."""
    from PIL import Image
    from opendcvc_tpu_torch.models import common as C
    from opendcvc_tpu_torch.models.dmci import DMCI
    from opendcvc_tpu_torch.training.preprocessing import \
        precompute_references
    from opendcvc_tpu_torch.utils import checkpoint as ckpt
    from opendcvc_tpu_torch.utils.params import from_jax
    vroot = os.path.join(root, "vimeo")
    names, lst = _vimeo_tree(vroot)
    params = from_jax(ckpt.load_params(dmci_ckpt))
    nets, launches = {}, {}
    for name, device_ec in (("ref_dev", True), ("ref_host", False)):
        net = DMCI(device=dev, device_ec=device_ec)
        net.load_params(params)
        net.update()
        nets[name] = net
        _reset_launches()
        t0 = time.perf_counter()
        precompute_references(vroot, lst, net, QP, name)
        launches[name] = _launches()
        _log(f"phase 21 (e) {name}: {len(names)} references in "
             f"{time.perf_counter() - t0:.2f} s, K1 / K2 launches "
             f"{launches[name]}")
    if launches["ref_dev"][0] < len(names) or launches["ref_dev"][1] or \
            max(launches["ref_host"]):
        _fail(f"phase 21 (e): launches {launches}")
    pr, pb = C.get_padding_size(VIMEO_H, VIMEO_W, 64)
    for name in names:
        d = os.path.join(vroot, "sequences", name)
        dev_png, host_png = (np.asarray(Image.open(os.path.join(d, f)))
                             for f in ("ref_dev.png", "ref_host.png"))
        img = np.asarray(Image.open(os.path.join(d, "im1.png")),
                         np.float32) / 255.0
        x = np.pad(img[None], ((0, 0), (0, pb), (0, pr), (0, 0)),
                   mode="edge")
        x_hat = nets["ref_host"].compress(x, QP)["x_hat"][0, :VIMEO_H,
                                                          :VIMEO_W]
        want = np.clip(np.round(x_hat.float().cpu().numpy() * 255), 0,
                       255).astype(np.uint8)
        if not (np.array_equal(dev_png, host_png)
                and np.array_equal(host_png, want)):
            _fail(f"phase 21 (e) {name}: the PNGs differ between the "
                  f"coders or from compress's x_hat")
    _log(f"phase 21 (e): {len(names)} {VIMEO_W}x{VIMEO_H} references equal "
         f"on device EC and host EC and to compress's rounded x_hat")
    return launches["ref_dev"]


def phase_rd_evidence(dev, root):
    """Phase 21 (f): measure on docs/dmci_tiny_rd.msgpack (qps 20 / 40,
    128 px, 2 images) on host EC and on device EC, then 1080x1920 at qp
    20; measure_dmc at full width (the port's random DMC, 128 px, 2
    pairs) on device EC; train_tiny for 20 steps.  Returns the K1 / K2
    launches."""
    from opendcvc_tpu_torch.eval import rd_evidence as R
    from opendcvc_tpu_torch.models.dmc import dmc_init
    from opendcvc_tpu_torch.utils import checkpoint as ckpt
    tiny = os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs",
                        "dmci_tiny_rd.msgpack")
    total = [0, 0]
    prev = os.environ.pop("OPENDCVC_TPU_DEVICE_EC", None)
    try:
        points = {}
        for mode in ("host EC", "device EC"):
            if mode == "device EC":
                os.environ["OPENDCVC_TPU_DEVICE_EC"] = "1"
            for size, width, qps, n in ((128, None, RD_QPS, 2),
                                        (1080, 1920, (20,), 1)):
                _reset_launches()
                t0 = time.perf_counter()
                pts = R.measure(tiny, qps=qps, size=size, n_images=n,
                                width=width, device=dev)
                k = _launches()
                total = [total[0] + k[0], total[1] + k[1]]
                points[mode, size] = pts
                _log(f"phase 21 (f) measure, {mode}, {width or size}x{size}"
                     f": {time.perf_counter() - t0:.2f} s, K1 / K2 {k}; "
                     + "; ".join(
                         f"qp {p['qp']}: bpp {p['bpp_stream']:.5f} stream / "
                         f"{p['bpp_estimate']:.5f} estimate = "
                         f"{p['stream_vs_estimate']:.4f}, PSNR "
                         f"{p['psnr']:.3f}" for p in pts))
                if (mode == "device EC") != (k[0] > 0) or k[1]:
                    _fail(f"phase 21 (f) measure {mode}: launches {k}")
        host = points["host EC", 128]
        if not all(0.97 < p["stream_vs_estimate"] < 1.03 for p in
                   host + points["host EC", 1080]) or \
                not host[0]["bpp_stream"] > 1.2 * host[-1]["bpp_stream"]:
            _fail("phase 21 (f): measure on host EC misses the JAX "
                  "package's rate-consistency gate")
        for size in (128, 1080):
            for h, d in zip(points["host EC", size],
                            points["device EC", size]):
                if h["bpp_estimate"] != d["bpp_estimate"] or \
                        h["psnr"] != d["psnr"]:
                    _fail(f"phase 21 (f): device EC's estimate or PSNR "
                          f"differs from host EC's at {size}")
        _log("phase 21 (f): host EC within the JAX gate (0.97 < stream / "
             "estimate < 1.03, qp 20's bpp > 1.2 x qp 40's); device EC's "
             "estimate and PSNR equal host EC's, its stream longer by the "
             "container's lane headers")

        os.environ["OPENDCVC_TPU_DEVICE_EC"] = "1"
        path = os.path.join(root, "dmc_random.msgpack")
        ckpt.save_params(path, dmc_init(torch.Generator().manual_seed(1)))
        _reset_launches()
        t0 = time.perf_counter()
        pts = R.measure_dmc(path, qps=RD_QPS, size=128, n_pairs=2,
                            device=dev)
        k = _launches()
        total = [total[0] + k[0], total[1] + k[1]]
        _log(f"phase 21 (f) measure_dmc, device EC, 128x128: "
             f"{time.perf_counter() - t0:.2f} s, K1 / K2 {k}; " + "; ".join(
                 f"qp {p['qp']}: bpp {p['bpp_stream']:.5f} / "
                 f"{p['bpp_estimate']:.5f}, PSNR {p['psnr']:.3f}, decoder "
                 f"exact {p['decoder_exact']}" for p in pts))
        if min(k) == 0 or not all(
                p["decoder_exact"] and all(np.isfinite(
                    [p["bpp_stream"], p["bpp_estimate"], p["psnr"]]))
                for p in pts):
            _fail("phase 21 (f): measure_dmc's points are not finite, its "
                  "decoder not exact, or a kernel did not launch")
    finally:
        os.environ.pop("OPENDCVC_TPU_DEVICE_EC", None)
        if prev is not None:
            os.environ["OPENDCVC_TPU_DEVICE_EC"] = prev

    t0 = time.perf_counter()
    out = os.path.join(root, "tiny_trained.msgpack")
    R.train_tiny(out, steps=20, log_every=10, device=dev)
    extra = ckpt.load_checkpoint(out)["extra"]
    if int(extra["steps"]) != 20:
        _fail("phase 21 (f): train_tiny did not save step 20")
    _log(f"phase 21 (f) train_tiny: 20 steps (TINY_KW, crop 96, batch 8) "
         f"in {time.perf_counter() - t0:.1f} s")
    return total


def phase_profiler(dev):
    """Phase 21 (g): profile_dmc's stage table at 1080p and report_dmci at
    768x512."""
    from opendcvc_tpu_torch.eval import complexity, profiler
    t0 = time.perf_counter()
    res = profiler.profile_dmc(H, W, iters=10, device=dev)
    profiler.print_table(res, f"phase 21 (g) DMC stages @ {W}x{H}, "
                         f"float32, CUDA events, 10 calls after 2")
    rep = complexity.report_dmci(768, 512, device=dev)
    _log("phase 21 (g) report_dmci: " + ", ".join(
        f"{k} {v}" for k, v in rep.items())
        + f" ({time.perf_counter() - t0:.1f} s)")


def phase_training_extras(dev, root):
    """Phase 21: (a) + (b) the campaigns, (c) the FM loss, (d) plateau, (e)
    precompute_references, (f) rd_evidence, (g) the profiler and
    complexity.  Returns the K1 / K2 launches of its device-EC runs."""
    t0 = time.perf_counter()
    torch.empty(0, device=dev)      # the allocator's stats need the context
    dmci_ckpt = phase_campaign(dev, root)
    phase_fm_training(dev)
    phase_plateau(dev)
    launches = phase_precompute(dev, root, dmci_ckpt)
    rd = phase_rd_evidence(dev, root)
    phase_profiler(dev)
    total = [launches[0] + rd[0], launches[1] + rd[1]]
    _log(f"phase 21 done in {time.perf_counter() - t0:.1f} s; K1 "
         f"{total[0]}, K2 {total[1]} launches")
    return total


# ---------------------------------------------------------------------------
# phase 22: multi-GPU training
# ---------------------------------------------------------------------------

DIST_ENV = ("OPENDCVC_TPU_DIST", "OPENDCVC_TPU_COORDINATOR",
            "OPENDCVC_TPU_NUM_PROCS", "OPENDCVC_TPU_PROC_ID", "MASTER_ADDR",
            "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
            "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID")
N_DIST_STEPS = 3     # (a): train_video on one NCCL rank against one device
N_SCALE_STEPS = 7    # a timing run: median of steps 3-7
PARITY_SHAPE = (8, 2, 256, 256, 3)   # train_video's defaults, --frames 2
# 1080p padded so each of two shards is a multiple of 64 rows (9 x 64);
# 1088 rows would leave two shards of 8.5 x 64
HALO_H, HALO_W = 1152, 1920
N_HALO_STEPS = 3


def _dist_argv(save_dir, batch=8, steps=N_SCALE_STEPS):
    """train_video at its defaults (DMC, crop 256, --frames 2, float32)
    but the batch, the steps and the save directory."""
    return ["--model", "dmc", "--batch_size", str(batch), "--steps",
            str(steps), "--log_every", str(steps), "--save_dir", save_dir]


def _ms_line(ms):
    return (f"{float(np.median(ms[2:])):.1f} ms a step (median of steps "
            f"3-{len(ms)}; all " + " ".join(f"{t:.1f}" for t in ms) + ")")


def _allreduce_ms(dev, n):
    """Median of 20 all-reduces (sum, NCCL) of n float32, CUDA events,
    after 3 warm-up calls; every rank calls it."""
    import torch.distributed as dist
    buf = torch.zeros(n, device=dev)
    times = []
    for i in range(23):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        dist.all_reduce(buf)
        b.record()
        b.synchronize()
        if i >= 3:
            times.append(a.elapsed_time(b))
    return float(np.median(times))


def _scale_rank(dev, argvs, halo_steps=0):
    """A rank of multi-card train_video runs (OPENDCVC_TPU_DIST; the
    group is joined), one for each of `argvs`: each run's step times,
    losses and peak memory, then the time of one all-reduce of the
    step's buffer (the trainable leaves, the loss and the metrics); with
    halo_steps, then _halo_rank's run (4 ranks)."""
    from opendcvc_tpu_torch import train_video
    from opendcvc_tpu_torch.training.train import trainable_leaves
    os.environ["OPENDCVC_TPU_DIST"] = "1"
    runs = []
    for argv in argvs:
        torch.cuda.reset_peak_memory_stats(dev)
        out = train_video.main(argv)
        n = sum(t.numel() for t in trainable_leaves(out["params"])) \
            + 1 + len(out["metrics"][0])
        runs.append({"step_ms": out["step_ms"],
                     "loss": [m["loss"] for m in out["metrics"]],
                     "peak": torch.cuda.max_memory_allocated(dev)})
        del out
    ms = _allreduce_ms(dev, n)
    for r in runs:
        r.update(allreduce_ms=ms, allreduce_bytes=4 * n)
    return {"runs": runs,
            "halo": _halo_rank(dev, halo_steps) if halo_steps else None}


def _halo_rank(dev, steps):
    """A rank of the full-width {data 2, spatial 2} DMC step at HALO_H x
    HALO_W (port init seed 0, Adam at 1e-4, lambda 256, qp 21, one
    P-frame a clip, a clip a data rank): `steps` timed steps (CUDA
    events), then one step whose exchanges are counted and timed on the
    host around a synchronize each; whether the parameters stay
    bit-identical on every rank."""
    from opendcvc_tpu_torch.models.dmc import dmc_init
    from opendcvc_tpu_torch.parallel import spatial as S
    from opendcvc_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                                  replicate_sharding)
    from opendcvc_tpu_torch.training import train as T
    from opendcvc_tpu_torch.utils.params import to_device
    from opendcvc_tpu_torch.utils.transfer import upload
    mesh = make_mesh((2, 2))
    params = to_device(dmc_init(torch.Generator().manual_seed(0)), dev)
    tx = T.make_optimizer(1e-4)
    state = tx.init(T.trainable_leaves(params))
    step = T.make_train_step(T.make_dmc_loss(256.0), tx, mesh=mesh,
                             spatial=True)
    frames = np.random.default_rng(0).random(
        (2, 2, HALO_H, HALO_W, 3)).astype(np.float32)
    batch = upload(np.ascontiguousarray(
        batch_sharding(mesh, frames, spatial_dim=2)), dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ms, losses = [], []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        params, state, m = step(params, state, batch, QP, None)
        b.record()
        losses.append(m["loss"])
        ms.append((a, b))
    torch.cuda.synchronize(dev)
    ms = [a.elapsed_time(b) for a, b in ms]
    swap, seen = S._swap, {"bytes": 0, "calls": 0, "s": 0.0}

    def counted(sends, recvs, group):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        swap(sends, recvs, group)
        torch.cuda.synchronize(dev)
        seen["s"] += time.perf_counter() - t0
        seen["calls"] += 1
        seen["bytes"] += sum(t.numel() * t.element_size()
                             for _, t in sends)
    S._swap = counted
    try:
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch, QP, None)
        torch.cuda.synchronize(dev)
        counted_s = time.perf_counter() - t0
    finally:
        S._swap = swap
    return {"step_ms": ms, "loss": [float(v) for v in losses],
            "peak": torch.cuda.max_memory_allocated(dev),
            "halo_bytes": seen["bytes"], "halo_calls": seen["calls"],
            "halo_ms": seen["s"] * 1e3, "counted_step_ms": counted_s * 1e3,
            "same": replicate_sharding(mesh, params)}


def _one_card(root, batch):
    """train_video on card 0 alone (no process group) at `batch`."""
    from opendcvc_tpu_torch import train_video
    out = train_video.main(_dist_argv(os.path.join(root, f"one_{batch}"),
                                      batch))
    return out["step_ms"]


def _log_ranks(label, ranks, batch, ref_ms):
    """A multi-card run's line: rank 0's step times, samples/s against
    one card's at batch 8 (`ref_ms` a step), every rank's median, the
    all-reduce, peak memory and the losses."""
    r0 = ranks[0]
    ms = float(np.median(r0["step_ms"][2:]))
    rate, ref = batch * 1e3 / ms, 8e3 / ref_ms
    _log(f"{label}: rank 0 {_ms_line(r0['step_ms'])}, {rate:.1f} "
         f"samples/s ({ref:.1f} on one card at batch 8: "
         f"{rate / ref:.2f}x); ranks' medians "
         + " ".join(f"{float(np.median(r['step_ms'][2:])):.1f}"
                    for r in ranks)
         + f"; one all-reduce of {r0['allreduce_bytes']} B (the gradients, "
         f"loss and metrics) {r0['allreduce_ms']:.3f} ms (median of 20, "
         f"CUDA events); peak {max(r['peak'] for r in ranks) / 2 ** 30:.2f}"
         f" GiB a rank; losses " + " ".join(f"{v:.3f}" for v in r0["loss"]))
    if not all(np.isfinite(r["loss"]).all() for r in ranks):
        _fail(f"{label}: a loss is not finite")


def _log_scaling(label, dp, batches, ref_ms, ranks):
    for i, batch in enumerate(batches):
        _log_ranks(f"phase 22 {label} train_video --data_axis {dp}, batch "
                   f"{batch}", [r["runs"][i] for r in ranks], batch, ref_ms)


def phase_dist_one_rank(root):
    """Phase 22 (a): train_video --data_axis -1 under OPENDCVC_TPU_DIST on
    one NCCL rank against the same run without a process group, 3 steps
    under deterministic algorithms: parameters, Adam's state, metrics and
    the checkpoint's bytes equal."""
    import torch.distributed as dist
    from opendcvc_tpu_torch import train_video
    from opendcvc_tpu_torch.parallel.dryrun import free_port
    from opendcvc_tpu_torch.training.train import tree_leaves
    runs = {}
    for name in ("one rank", "one device"):
        saved = {k: os.environ.pop(k, None) for k in DIST_ENV}
        if name == "one rank":
            os.environ.update(
                OPENDCVC_TPU_DIST="1", OPENDCVC_TPU_NUM_PROCS="1",
                OPENDCVC_TPU_PROC_ID="0",
                OPENDCVC_TPU_COORDINATOR=f"localhost:{free_port()}")
        try:
            with _Deterministic():
                out = train_video.main(
                    _dist_argv(os.path.join(root, name), steps=N_DIST_STEPS)
                    + ["--data_axis", "-1"])
            if name == "one rank" and (
                    not dist.is_initialized()
                    or dist.get_backend() != "nccl"):
                _fail("phase 22 (a): train_video joined no NCCL group")
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for k, v in saved.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
        with open(os.path.join(root, name, "dmc_latest.msgpack"),
                  "rb") as f:
            runs[name] = (out, f.read())
    (a, fa), (b, fb) = runs["one rank"], runs["one device"]
    same = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a["params"]) + a["opt_state"]["mu"]
        + a["opt_state"]["nu"],
        tree_leaves(b["params"]) + b["opt_state"]["mu"]
        + b["opt_state"]["nu"]))
    _log(f"phase 22 (a): train_video under OPENDCVC_TPU_DIST on one NCCL "
         f"rank, {N_DIST_STEPS} steps: losses "
         + " ".join(f"{m['loss']:.6f}" for m in a["metrics"])
         + "; without a process group " + " ".join(
             f"{m['loss']:.6f}" for m in b["metrics"])
         + f"; ms a step " + " ".join(f"{t:.1f}" for t in a["step_ms"])
         + " / " + " ".join(f"{t:.1f}" for t in b["step_ms"]))
    if not (same and a["metrics"] == b["metrics"] and fa == fb):
        _fail("phase 22 (a): one NCCL rank does not equal one device bit "
              "for bit")
    _log("phase 22 (a): parameters, Adam's state, metrics and the "
         "checkpoint's bytes equal bit for bit")


def _parity(label, res):
    from opendcvc_tpu_torch.parallel.dryrun import check_parity
    _log(f"{label}: mesh {res['mesh']}, loss {res['loss']:.6f} against one "
         f"process {res['ref_loss']:.6f} (|dloss| {res['dloss']:.3e}), "
         f"max|dparam| {res['max_dparam']:.3e}, parameters bit-identical "
         f"on every rank: {res['same']}; first step {res['ms']:.1f} ms "
         f"sharded, {res['ref_ms']:.1f} in one process")
    try:
        check_parity(res)
    except AssertionError as e:
        _fail(f"{label}: {e}")


def phase_multi_gpu(root):
    """Phase 22: multi-GPU training.  (a) always; (b) with 2 cards: a
    2-rank data-axis step against one process at train_video's defaults
    (the JAX dryrun's bounds), then train_video --data_axis 2 at batch 8
    and 16 timed against one card at batch 8 and 2; (c) with 4 cards:
    dryrun_multichip(4) over NCCL, train_video --data_axis 4 at batch 8
    and 32 timed, and the {data 2, spatial 2} DMC step at 1152x1920 with
    its halo bytes and ms."""
    from opendcvc_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                                    run_ranks, step_parity)
    t0 = time.perf_counter()
    n = torch.cuda.device_count()
    ran = {"a": True, "b": n >= 2, "c": n >= 4}
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    _log(f"phase 22: {n} card(s) visible ({'; '.join(cards)}); branches: "
         f"(a) runs, (b) "
         f"{'runs' if ran['b'] else 'skipped (needs 2 cards)'}, (c) "
         f"{'runs' if ran['c'] else 'skipped (needs 4 cards)'}")
    phase_dist_one_rank(root)
    if ran["b"]:
        _parity("phase 22 (b) data 2, DMC, clips (8, 2, 256, 256, 3)",
                step_parity(2, "cuda", "dmc", (2, 1), shape=PARITY_SHAPE))
        ref = {}
        for batch in (8, 2):
            ms = _one_card(root, batch)
            ref[batch] = float(np.median(ms[2:]))
            _log(f"phase 22 (b) one card, batch {batch}: {_ms_line(ms)}, "
                 f"{batch * 1e3 / ref[batch]:.1f} samples/s")
        _log_scaling("(b)", 2, (8, 16), ref[8], run_ranks(
            2, _scale_rank, ([_dist_argv(os.path.join(root, f"d2_{b}"), b)
                              for b in (8, 16)],), device="cuda"))
    if ran["c"]:
        res = dryrun_multichip(4, "cuda")
        _parity("phase 22 (c) dryrun_multichip(4)", res)
        ranks = run_ranks(4, _scale_rank, (
            [_dist_argv(os.path.join(root, f"d4_{b}"), b) for b in (8, 32)],
            N_HALO_STEPS), device="cuda")
        _log_scaling("(c)", 4, (8, 32), ref[8], ranks)
        ranks = [r["halo"] for r in ranks]
        r0 = ranks[0]
        _log(f"phase 22 (c) DMC {{data 2, spatial 2}} at {HALO_W}x{HALO_H}"
             f", a clip of 2 frames a data rank: rank 0 step ms "
             + " ".join(f"{t:.1f}" for t in r0["step_ms"])
             + f"; the halo exchanges of a step: {r0['halo_calls']} calls, "
             f"{r0['halo_bytes']} B sent a rank, {r0['halo_ms']:.1f} ms of "
             f"a {r0['counted_step_ms']:.1f} ms step (host clock, a "
             f"synchronize around each); peak "
             f"{max(r['peak'] for r in ranks) / 2 ** 30:.2f} GiB a rank; "
             f"losses " + " ".join(f"{v:.3f}" for v in r0["loss"]))
        if not (all(r["same"] for r in ranks)
                and all(np.isfinite(r["loss"]).all() for r in ranks)):
            _fail("phase 22 (c): the 1152x1920 sharded step's parameters "
                  "differ between ranks or a loss is not finite")
    _log(f"phase 22 done in {time.perf_counter() - t0:.1f} s")
    return ran


# ---------------------------------------------------------------------------
# phase 23: transfer slimming, reference state dicts, the RD-artifact tools
# ---------------------------------------------------------------------------

N_SLIM_GOP = 8          # (a)'s GOP chunk, phase 8's (bench.py's BENCH_GOP_N)
N_SLIM_COMPACT = 3      # (a)'s compacted chunk, after a P-frame alone
N_SLIM_FM = 4           # (a)'s DMCIFM I-frame and three DMCFM P-frames
SLIM_MISS_W = 8         # (a)'s forced miss: the encode copy's window
SYN_H = 1088            # (c): make_synth_dataset_torch's frames, 1080p padded
BD_QPS = "16,26,36,46"  # (c): bd_r5_torch's sweep (bd_rate fits a cubic)
ROOT = os.path.dirname(os.path.abspath(__file__))


def _slim_counts():
    """The port's trace counters of transfer slimming."""
    from opendcvc_tpu_torch.utils import trace
    c = trace.counters()
    return {k: c.get(k, 0) for k in ("slim.fetch", "slim.miss", "d2h_bytes",
                                     "h2d_bytes")}


def _slim_bytes():
    c = _slim_counts()
    return c["d2h_bytes"], c["h2d_bytes"]


def _moved(since):
    d2h, h2d = _slim_bytes()
    return d2h - since[0], h2d - since[1]


def _dmc_params(dev):
    """Phase 4's DMC: the port's init (seed 1), flat q banks."""
    from opendcvc_tpu_torch.models.dmc import DMC
    net = DMC(device=dev, device_ec=True)
    net.init_params(seed=1)
    net.params["q_encoder"] = torch.ones_like(net.params["q_encoder"]) * 0.25
    net.params["q_decoder"] = torch.ones_like(net.params["q_decoder"])
    return net.params


def _slim_dmc(dev, params, x_ref, xs, label, moved):
    """A P-frame alone, then a GOP chunk of the rest, encoded and decoded;
    fails unless the decoder ends at the encoder's feature and frame.
    Records each call's bytes in `moved`; returns the streams, the
    encoder and the decoder."""
    from opendcvc_tpu_torch.models import common as C
    from opendcvc_tpu_torch.models.dmc import DMC, _stage_recon_x
    enc, dec = (DMC(device=dev, device_ec=True) for _ in range(2))
    for net in (enc, dec):
        net.load_params(params)
        net.update(force_zero_thres=FZ)
        net.add_ref_frame(None, x_ref)
    n = len(xs) - 1
    sps = {"height": xs[0].shape[1], "width": xs[0].shape[2]}
    t = _slim_bytes()
    first = enc.compress(xs[0], QP)["bit_stream"]
    d2h, t = _moved(t)[0], _slim_bytes()
    chunk = enc.compress_gop(xs[1:], [QP] * n)["bit_streams"]
    d2h_chunk, t = _moved(t)[0], _slim_bytes()
    dec.decompress(first, sps, QP)
    moved["frame"], t = (d2h, _moved(t)[1]), _slim_bytes()
    x_gop = dec.decompress_gop(chunk, sps, [QP] * n)["x_hat"]
    moved["chunk"] = (d2h_chunk, _moved(t)[1])
    want = C.frame_to_nhwc(_stage_recon_x(params, enc.dpb[0].feature, QP))
    if not (torch.equal(dec.dpb[0].feature, enc.dpb[0].feature)
            and torch.equal(x_gop[-1], want)
            and bool(torch.isfinite(x_gop).all())):
        _fail(f"{label}: the decoder's feature or frame differs from the "
              f"encoder's")
    return [first] + chunk, enc, dec


def _slim_pass(dev, xs, p_params, on):
    """Phase 23 (a), one pass with OPENDCVC_TPU_EC_SLIM unset (on, the
    default) or 0 (off): DMCI (phase 3's, its two passes), DMC's P-frame
    alone and a GOP chunk of N_SLIM_GOP, compacted DMC's
    (OPENDCVC_TPU_EC_SKIP_COMPACT) P-frame alone and a chunk of
    N_SLIM_COMPACT, then DMCIFM + DMCFM on N_SLIM_FM frames
    (`_fm_chain`'s checks); every decoder exact.  Returns the streams,
    the bytes each part moved each way, the K1 / K2 launches, and the
    shapes of the DMC chunk's copies."""
    from opendcvc_tpu_torch.entropy import device_rans as D
    label = f"phase 23 (a) slim {'on' if on else 'off'}"
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("OPENDCVC_TPU_EC_")}
    if not on:
        os.environ["OPENDCVC_TPU_EC_SLIM"] = "0"
    slim0 = _slim_counts()
    _reset_launches()
    streams, moved = {}, {}
    t0 = time.perf_counter()
    try:
        t = _slim_bytes()
        intra = phase_intra(dev, xs[0], QP, FZ, label=label)
        moved["DMCI frame"] = [v / 2 for v in _moved(t)]
        streams["DMCI"] = intra["streams"]
        parts = {}
        streams["DMC"], enc, _ = _slim_dmc(
            dev, p_params, intra["x_hat"], xs[1:2 + N_SLIM_GOP], label,
            parts)
        moved["DMC frame"] = parts["frame"]
        moved[f"DMC chunk of {N_SLIM_GOP}"] = parts["chunk"]
        plan = enc._plan_device_ec(xs[0].shape[1], xs[0].shape[2])
        mw, cap = enc._rung(plan.lanes, plan.steps(), enc.bytes_per_symbol)
        shapes = {"lanes": plan.lanes, "cap": cap,
                  "window": enc._fetch_windows.get(cap, cap),
                  "bucket": D.quantize_window(max(
                      D.parse_frame_parts(s)[0]["total"]
                      for s in streams["DMC"][1:]), cap) if on else cap}
        os.environ["OPENDCVC_TPU_EC_SKIP_COMPACT"] = "1"
        try:
            parts = {}
            streams["compacted DMC"], _, _ = _slim_dmc(
                dev, p_params, intra["x_hat"],
                xs[2 + N_SLIM_GOP:3 + N_SLIM_GOP + N_SLIM_COMPACT], label,
                parts)
        finally:
            os.environ.pop("OPENDCVC_TPU_EC_SKIP_COMPACT")
        moved["compacted DMC frame"] = parts["frame"]
        moved[f"compacted DMC chunk of {N_SLIM_COMPACT}"] = parts["chunk"]
        t = _slim_bytes()
        rows = _fm_chain(dev, xs[:N_SLIM_FM], xs[0].shape[1],
                         xs[0].shape[2], True, label=label)
        moved[f"FM {N_SLIM_FM} frames"] = _moved(t)
        streams["FM"] = [r["stream"] for r in rows]
    finally:
        os.environ.pop("OPENDCVC_TPU_EC_SLIM", None)
        os.environ.update(saved)
    launches = _launches()
    slim = {k: v - slim0[k] for k, v in _slim_counts().items()}
    _log(f"{label}: bytes moved device->host / host->device: " + "; ".join(
        f"{k} {int(a)} / {int(b)}" for k, (a, b) in moved.items())
        + f"; windowed fetches {slim['slim.fetch']}, misses "
        f"{slim['slim.miss']}; K1 {launches[0]}, K2 {launches[1]} "
        f"launches; every decoder exact; {time.perf_counter() - t0:.1f} s")
    return {"streams": streams, "moved": moved, "launches": launches,
            "shapes": shapes, "x_ref": intra["x_hat"],
            "i_params": intra["params"]}


def _forced_miss(dev, p_params, x_ref, x, want):
    """(a)'s forced miss: a P-frame with the encode copy's window at
    SLIM_MISS_W words: one miss, the window grown, the same bytes."""
    from opendcvc_tpu_torch.models.dmc import DMC
    net = DMC(device=dev, device_ec=True)
    net.load_params(p_params)
    net.update(force_zero_thres=FZ)
    net.add_ref_frame(None, x_ref)
    plan = net._plan_device_ec(x.shape[1], x.shape[2])
    cap = net._rung(plan.lanes, plan.steps(), net.bytes_per_symbol)[1]
    net._fetch_windows[cap] = SLIM_MISS_W
    misses = _slim_counts()["slim.miss"]
    got = net.compress(x, QP)["bit_stream"]
    grown = net._fetch_windows[cap]
    missed = _slim_counts()["slim.miss"] - misses
    if missed != 1 or grown <= SLIM_MISS_W or got != want:
        _fail(f"phase 23 (a): the forced miss counted "
              f"{missed} misses, left the window "
              f"at {grown} words, streams equal: {got == want}")
    return grown, cap


def phase_slim(dev):
    """Phase 23 (a): transfer slimming at 1088x1920 (1080p padded),
    device EC, float32: `_slim_pass` with slim on and off, the streams
    and launches equal, a forced miss, and the DMC chunk's copies timed
    at the window and at the full staging.  Returns the launches, the
    pass's streams, reference frame and parameters."""
    xs = synthetic_frames(H, W, 3 + N_SLIM_GOP + N_SLIM_COMPACT)
    p_params = _dmc_params(dev)
    runs = {on: _slim_pass(dev, xs, p_params, on) for on in (True,
                                                                  False)}
    on, off = runs[True], runs[False]
    if on["streams"] != off["streams"]:
        bad = [k for k in on["streams"] if on["streams"][k] !=
               off["streams"][k]]
        _fail(f"phase 23 (a): streams differ with slim on and off: {bad}")
    if on["launches"] != off["launches"]:
        _fail(f"phase 23 (a): K1 / K2 launched {on['launches']} times with "
              f"slim on, {off['launches']} off")
    _reset_launches()
    grown, cap = _forced_miss(dev, p_params, on["x_ref"], xs[1],
                              on["streams"]["DMC"][0])
    miss = _launches()
    sh = on["shapes"]
    tail = 3 * sh["lanes"]
    win = _copy_ms((N_SLIM_GOP, sh["window"] + tail), dev)
    bucket = _copy_ms((N_SLIM_GOP, sh["bucket"] + tail), dev)
    full = _copy_ms((N_SLIM_GOP, sh["cap"] + tail), dev)
    _log(f"phase 23 (a): {_card()}")
    _log(f"phase 23 (a): the DMC chunk of {N_SLIM_GOP}: cap {sh['cap']} "
         f"words, lanes {sh['lanes']}; encode copy {N_SLIM_GOP} x "
         f"{sh['window'] + tail} u16 (window {sh['window']}) "
         f"{win[0]:.4f} ms against {N_SLIM_GOP} x {sh['cap'] + tail} "
         f"{full[0]:.4f} ms device->host; decode upload {N_SLIM_GOP} x "
         f"{sh['bucket'] + tail} (bucket {sh['bucket']}) {bucket[1]:.4f} ms "
         f"against {full[1]:.4f} ms host->device (pinned, median of "
         f"{REPS}, CUDA events)")
    _log(f"phase 23 (a): streams byte-equal with slim on and off (DMCI, "
         f"DMC frame + chunk, compacted DMC frame + chunk, FM I + 3 P), K1 "
         f"/ K2 launches equal ({on['launches']}); forced miss (window "
         f"{SLIM_MISS_W}): 1 miss, window grown to {grown} of {cap}, the "
         f"same bytes")
    total = [a + b + c for a, b, c in zip(on["launches"], off["launches"],
                                          miss)]
    return total, on


def _tree_equal(a, b):
    """Two parameter trees: the same keys and list lengths, each leaf the
    same dtype, shape and bits."""
    if isinstance(b, dict):
        return sorted(a) == sorted(b) and all(_tree_equal(a[k], b[k])
                                              for k in b)
    if isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_tree_equal(x, y)
                                        for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.cpu(), b.cpu())


def phase_port_torch(dev, slim):
    """Phase 23 (b): `utils/port_torch.py` on this machine: each of the
    eight mappers gives back, bit for bit, the port's init tree that
    tests/torch_port_reference_sd.py wrote as a reference state dict;
    then DMCI + DMC loaded through port_dmci / port_dmc (from (a)'s
    trees) code (a)'s I-frame and its first 2 P-frames at 1088x1920 on
    device EC, byte-equal to (a)'s codecs, loaded directly."""
    import importlib
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_port_reference_sd import REFERENCE_SD
    from opendcvc_tpu_torch.models.dmc import DMC
    from opendcvc_tpu_torch.models.dmci import DMCI
    from opendcvc_tpu_torch.utils import port_torch as PT
    from opendcvc_tpu_torch.utils.params import to_jax
    t0 = time.perf_counter()
    inits = {"dmci": "dmci_init", "dmc": "dmc_init",
             "dmc_hem": "dmc_hem_init", "dmc_tcm": "dmc_tcm_init",
             "dmc_fm": "dmc_fm_init", "dcvc": "dcvc_init",
             "dmc_dc": "dmc_dc_init", "evc": "evc_init"}
    n_keys = {}
    for model, fn in inits.items():
        mod = importlib.import_module(f"opendcvc_tpu_torch.models.{model}")
        tree = getattr(mod, fn)(torch.Generator().manual_seed(0))
        sd = REFERENCE_SD[model](to_jax(tree))
        if not _tree_equal(getattr(PT, "port_" + model)(sd), tree):
            _fail(f"phase 23 (b): port_{model} does not give back the "
                  f"tree its reference state dict was written from")
        n_keys[model] = len(sd)
    x_ref, xs = slim["x_ref"], synthetic_frames(H, W, 3)
    want = slim["streams"]
    i_net = DMCI(device=dev, device_ec=True)
    i_net.load_params(PT.port_dmci(REFERENCE_SD["dmci"](
        to_jax(slim["i_params"]))))
    i_net.update(force_zero_thres=FZ)
    enc = i_net.compress(xs[0], QP)
    p_net = DMC(device=dev, device_ec=True)
    p_net.load_params(PT.port_dmc(REFERENCE_SD["dmc"](
        to_jax(_dmc_params(dev)))))
    p_net.update(force_zero_thres=FZ)
    p_net.add_ref_frame(None, x_ref)
    got = [p_net.compress(x, QP)["bit_stream"] for x in xs[1:3]]
    if enc["bit_stream"] != want["DMCI"][-1] or \
            not torch.equal(enc["x_hat"], x_ref) or got != want["DMC"][:2]:
        _fail("phase 23 (b): the codecs loaded through port_dmci / port_dmc "
              "code other bytes than the codecs loaded directly")
    _log("phase 23 (b): port_torch's eight mappers give back the port's "
         "init trees bit for bit from reference state dicts of "
         + ", ".join(f"{m} {n}" for m, n in n_keys.items())
         + " keys; DMCI + DMC loaded through port_dmci / port_dmc code the "
         "I-frame and 2 P-frames at 1088x1920 (device EC) to the bytes of "
         f"the codecs loaded directly; {time.perf_counter() - t0:.1f} s")


def _find_key(node, key):
    """The first dict under `node` (a JSON tree) that holds `key`."""
    if isinstance(node, dict):
        if key in node:
            return node
        node = list(node.values())
    if isinstance(node, list):
        for v in node:
            found = _find_key(v, key)
            if found is not None:
                return found
    return None


def phase_tools(dev, root):
    """Phase 23 (c): tools/make_synth_dataset_torch.py at 1088x1920 (1
    sequence, 3 frames) into `root`, then the port's harness codes its
    config.json on device EC, every decoded frame equal to the encoder's;
    tools/bd_r5_torch.py on docs/dmci_tiny_rd.msgpack at 512x768 (4 QPs,
    2 images) on the card, its BD-rate reported only (tiny weights trained
    on synthetic content).  Returns the K1 / K2 launches."""
    import contextlib
    from opendcvc_tpu_torch.eval import harness
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import bd_r5_torch
    import make_synth_dataset_torch
    t0 = time.perf_counter()
    syn = os.path.join(root, "synth_ds")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cfg = make_synth_dataset_torch.main([
            "--root", syn, "--seqs", "1", "--frames", "3", "--height",
            str(SYN_H), "--width", str(W)])
    t_make = time.perf_counter() - t0
    log = {"enc": [], "dec": [], "codec_s": 0.0, "calls": []}
    saved = os.environ.pop("OPENDCVC_TPU_DEVICE_EC", None)
    os.environ["OPENDCVC_TPU_DEVICE_EC"] = "1"
    undo = _record_codecs(harness, log)
    _reset_launches()
    try:
        harness.main([
            "--test_config", cfg,
            "--output_path", os.path.join(syn, "rd.json"),
            "--stream_path", os.path.join(syn, "streams"),
            "--rate_num", "1", "--qp_i", str(QP), "--qp_p", str(QP),
            "--force_zero_thres", str(FZ), "--seed", "0",
            "--device", dev.type])
    finally:
        undo()
        os.environ.pop("OPENDCVC_TPU_DEVICE_EC")
        if saved is not None:
            os.environ["OPENDCVC_TPU_DEVICE_EC"] = saved
    _check_decoder_exact(log, "phase 23 (c) harness", 3)
    with open(os.path.join(syn, "rd.json")) as f:
        job = _find_key(json.load(f), "ave_all_frame_bpp")
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        bd = bd_r5_torch.main([
            "--ckpt", os.path.join(ROOT, "docs", "dmci_tiny_rd.msgpack"),
            "--out", os.path.join(root, "bd_rate_r5.json"), "--qps", BD_QPS,
            "--size", "512", "--width", "768", "--n_images", "2",
            "--device", dev.type])
    launches = _launches()
    if not all(np.isfinite([p["bpp_stream"], p["psnr"]]).all()
               for p in bd["points"]) or len(bd["points"]) != 4:
        _fail("phase 23 (c): bd_r5_torch's points are not finite")
    _log(f"phase 23 (c): make_synth_dataset_torch wrote 3 {W}x{SYN_H} PNGs "
         f"and config.json in {t_make:.1f} s; the harness coded them on "
         f"device EC, decoder exact on all 3 frames, bpp "
         f"{job['ave_all_frame_bpp']:.4f}, PSNR "
         f"{job['ave_all_frame_psnr']:.4f} dB")
    _log("phase 23 (c): bd_r5_torch on docs/dmci_tiny_rd.msgpack, 512x768, "
         f"qps {BD_QPS}, 2 images: points " + json.dumps(
             [{k: p[k] for k in ("qp", "bpp_stream", "psnr")}
              for p in bd["points"]])
         + f"; BD-rate vs the EVC EncL anchor {bd['bd_rate_vs_anchor_pct']}"
         f" % (reported only: tiny weights, synthetic content, PSNRs below "
         f"the anchor's range); {time.perf_counter() - t1:.1f} s; K1 "
         f"{launches[0]}, K2 {launches[1]} launches in (c)")
    for line in printed.getvalue().splitlines():
        _log(f"phase 23 (c) tool: {line}")
    return launches


def phase_slice15(dev, root):
    """Phase 23: (a) transfer slimming, (b) reference state dicts, (c) the
    RD-artifact tools, (d) phase 8's bench again with slim off.  Returns
    the K1 / K2 launches of its device-EC runs."""
    t0 = time.perf_counter()
    launches, slim = phase_slim(dev)
    _reset_launches()
    phase_port_torch(dev, slim)
    launches = [a + b for a, b in zip(launches, _launches())]
    launches = [a + b for a, b in zip(launches, phase_tools(dev, root))]
    launches = [a + b for a, b in zip(launches, phase_bench(
        dev, "phase 23 (d)", env={"OPENDCVC_TPU_EC_SLIM": "0"}))]
    on, off = BENCH_LINES["phase 8"], BENCH_LINES["phase 23 (d)"]
    _log("phase 23 (d): the bench line with slim on (phase 8, the default) "
         "/ off (OPENDCVC_TPU_EC_SLIM=0, this run): " + ", ".join(
             f"{k} {on[k]} / {off[k]}" for k in (
                 "enc_fps", "dec_fps", "intra_enc_fps", "intra_dec_fps",
                 "bpp")))
    if on["bpp"] != off["bpp"]:
        _fail("phase 23 (d): the bench's bpp differs with slim on and off")
    _log(f"phase 23 done in {time.perf_counter() - t0:.1f} s; K1 "
         f"{launches[0]}, K2 {launches[1]} launches")
    return launches


# ---------------------------------------------------------------------------
# phase 24: the DepthConvBlock's epilogue kernels
# ---------------------------------------------------------------------------

N_DCB_GOP = 4           # (c)'s GOP chunk, after the I-frame and a P-frame
WSILU_CHUNK = 1 << 28   # (a): float32 bit patterns a launch
DCB_KERNELS = ("bias", "bias_wsilu", "chunk_add", "residual")
#: (d)'s shapes: (C, (H, W)) of the 1080p main path
DCB_SHAPES = ((256, (136, 240)), (320, (136, 240)), (368, (68, 120)))


def _dcb_counts():
    """The block and launch counters of the port's trace."""
    from opendcvc_tpu_torch.utils import trace
    c = trace.counters()
    return {k: c.get(k, 0) for k in ("dcb.block", "dcb.fused") + tuple(
        "dcb.launch." + k for k in DCB_KERNELS)}


def _dcb_delta(a, b):
    return {k: b[k] - a[k] for k in a}


@contextlib.contextmanager
def _plain_blocks():
    """Every DepthConvBlock on the unfused chain, whatever its inputs."""
    from opendcvc_tpu_torch.ops import dcb_epilogue as E
    epilogues = E.epilogues
    E.epilogues = lambda x: E.PLAIN
    try:
        yield
    finally:
        E.epilogues = epilogues


def _eager_decoders():
    """DMC's device-EC decoder body run eagerly, as on the CPU, where it
    would replay a CUDA graph (opendcvc_tpu_torch/utils/graph.py::eager):
    for a phase that swaps the code a graph captured, or times the eager
    twin."""
    from opendcvc_tpu_torch.utils import graph as G
    return G.eager()


@contextlib.contextmanager
def _recorded_blocks(store):
    """Keep each distinct block call (its parameters' shapes, x's shape,
    the quant step's, the shortcut) in `store`, with a copy of x and the
    number of such calls."""
    from opendcvc_tpu_torch.layers import blocks as L
    apply = L.depth_conv_block_apply

    def rec(p, x, quant_step=None, shortcut=False):
        key = (tuple((k, tuple(v["w"].shape)) for k, v in p.items()),
               tuple(x.shape), None if quant_step is None
               else tuple(quant_step.shape), shortcut)
        if key not in store:
            store[key] = [p, x.clone(), quant_step, shortcut, 0]
        store[key][4] += 1
        return apply(p, x, quant_step=quant_step, shortcut=shortcut)
    L.depth_conv_block_apply = rec
    try:
        yield
    finally:
        L.depth_conv_block_apply = apply


def _diff_count(got, want):
    """(elements that differ: neither the same bits nor both NaN, NaNs
    whose bits differ)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    same = got.view(ints[got.dtype]) == want.view(ints[want.dtype])
    nan = got.isnan() & want.isnan()
    return int((~(same | nan)).sum()), int((nan & ~same).sum())


def _dcb_wsilu_patterns(dev):
    """(a) bias_wsilu with a -0.0 bias (x + -0.0 is x for every x but a
    NaN) against x * sigmoid(4x) on every float32 bit pattern, in chunks,
    and on every bfloat16 one."""
    from opendcvc_tpu_torch.ops import dcb_epilogue as E
    for dtype, ints, lo, hi, step in (
            (torch.float32, torch.int32, -2 ** 31, 2 ** 31, WSILU_CHUNK),
            (torch.bfloat16, torch.int16, -2 ** 15, 2 ** 15, 2 ** 16)):
        t0 = time.perf_counter()
        b = torch.full((1,), -0.0, dtype=dtype, device=dev)
        bad = nan_bits = n = 0
        for s in range(lo, hi, step):
            x = torch.arange(s, s + step, dtype=torch.int64, device=dev).to(
                ints).view(dtype).view(1, 1, 1, -1)
            want = x * torch.sigmoid(4.0 * x)
            got = E.bias_wsilu(x.clone(), b)
            d, nb = _diff_count(got, want)
            bad, nan_bits, n = bad + d, nan_bits + nb, n + x.numel()
            del x, want, got
        _log(f"phase 24 (a): WSiLU on all {n} {str(dtype)[6:]} bit "
             f"patterns: {bad} differing elements ({nan_bits} NaNs whose "
             f"payload bits differ) in {time.perf_counter() - t0:.1f} s")
        if bad:
            _fail(f"phase 24 (a): the {str(dtype)[6:]} WSiLU differs from "
                  f"the chain on {bad} patterns")


def _dcb_nets(dev):
    """Phase 3's DMCI and phase 4's DMC encoder and decoder."""
    from opendcvc_tpu_torch.models.dmc import DMC
    from opendcvc_tpu_torch.models.dmci import DMCI
    i_net = DMCI(device=dev, device_ec=True)
    i_net.init_params(seed=0)
    i_net.params["q_scale_enc"] = torch.ones_like(
        i_net.params["q_scale_enc"]) * 0.2
    i_net.params["q_scale_dec"] = torch.ones_like(i_net.params["q_scale_dec"])
    i_net.update(force_zero_thres=FZ)
    enc = DMC(device=dev, device_ec=True)
    enc.init_params(seed=1)
    enc.params["q_encoder"] = torch.ones_like(enc.params["q_encoder"]) * 0.25
    enc.params["q_decoder"] = torch.ones_like(enc.params["q_decoder"])
    enc.update(force_zero_thres=FZ)
    dec = DMC(device=dev, device_ec=True)
    dec.load_params(enc.params)
    dec.update(force_zero_thres=FZ)
    return i_net, enc, dec


def _dcb_chain(dev, nets, frames):
    """DMCI's I-frame, a DMC P-frame alone and a GOP chunk of N_DCB_GOP,
    each encoded (K1) and decoded (K2): (streams, decoded frames, the
    chunk's encode and decode ms)."""
    i_net, enc, dec = nets
    sps = {"height": frames[0].shape[1], "width": frames[0].shape[2]}
    s_i = i_net.compress(frames[0], QP)["bit_stream"]
    x_i = i_net.decompress(s_i, sps, QP)["x_hat"]
    for net in (enc, dec):
        net.clear_dpb()
        net.add_ref_frame(None, x_i)
    s_p = enc.compress(frames[1], QP)["bit_stream"]
    x_p = dec.decompress(s_p, sps, QP)["x_hat"]
    qps = [QP] * N_DCB_GOP
    out, enc_ms = _timed(lambda: enc.compress_gop(frames[2:], qps), dev)
    x_gop, dec_ms = _timed(
        lambda: dec.decompress_gop(out["bit_streams"], sps, qps)["x_hat"],
        dev)
    return [s_i, s_p] + out["bit_streams"], [x_i, x_p, x_gop], enc_ms, dec_ms


def _dcb_same(label, a, b):
    if a[0] != b[0]:
        _fail(f"phase 24 (c): {label}: the streams differ")
    for i, (x, y) in enumerate(zip(a[1], b[1])):
        if not torch.equal(x, y):
            _fail(f"phase 24 (c): {label}: decoded frame set {i} differs")


def _dcb_codecs(dev, store):
    """(c) the codec chain on the kernels, then on the unfused chain, then
    on the kernels again: streams and frames equal byte for byte; the
    blocks' calls recorded into `store` for (b)."""
    frames = synthetic_frames(H, W, 2 + N_DCB_GOP)
    nets = _dcb_nets(dev)
    c0 = _dcb_counts()
    # a graph would replay the kernels it captured under the chain, and
    # record a block call at its capture only (phase 26 holds the graphs
    # to this eager path)
    with _eager_decoders():
        with _recorded_blocks(store):
            fused = _dcb_chain(dev, nets, frames)
        c1 = _dcb_counts()
        with _plain_blocks():
            plain = _dcb_chain(dev, nets, frames)
        c2 = _dcb_counts()
        again = _dcb_chain(dev, nets, frames)
    on, off = _dcb_delta(c0, c1), _dcb_delta(c1, c2)
    if not on["dcb.block"] or on["dcb.fused"] != on["dcb.block"] \
            or off["dcb.fused"] or off["dcb.block"] != on["dcb.block"] \
            or any(off["dcb.launch." + k] for k in DCB_KERNELS):
        _fail(f"phase 24 (c): the blocks' counters are off: kernels {on}, "
              f"chain {off}")
    _dcb_same("kernels / chain", fused, plain)
    _dcb_same("kernels / kernels again", fused, again)
    n = sum(len(s) for s in fused[0])
    _log(f"phase 24 (c): DMCI I-frame, a DMC P-frame and a GOP chunk of "
         f"{N_DCB_GOP} at {W}x{H}: {len(fused[0])} streams ({n} B) and "
         f"every decoded frame equal byte for byte on the kernels and on "
         f"the chain; {on['dcb.block']} blocks, launches " + ", ".join(
             f"{k} {on['dcb.launch.' + k]}" for k in DCB_KERNELS)
         + f"; the chunk's encode / decode ms {again[2]:.1f} / "
         f"{again[3]:.1f} on the kernels, {plain[2]:.1f} / {plain[3]:.1f} "
         f"on the chain")
    return on


def _dcb_grads(p, x, q, shortcut):
    """The block's output and the gradients of sum(out^2) for x, each
    weight and bias and the quant step, on fresh leaves."""
    from opendcvc_tpu_torch.layers import blocks as L
    pp = {k: {n: t.detach().clone().requires_grad_() for n, t in v.items()}
          for k, v in p.items()}
    xx = x.detach().clone().requires_grad_()
    qq = None if q is None else q.detach().clone().requires_grad_()
    out = L.depth_conv_block_apply(pp, xx, qq, shortcut)
    (out.float() * out.float()).sum().backward()
    return [out.detach(), xx.grad] + [t.grad for v in pp.values()
                                      for t in v.values()] + (
        [] if q is None else [qq.grad])


def _dcb_variants(store):
    """(b) each recorded block call on the kernels against the chain, in
    float32 and in bfloat16, without autograd and under it."""
    from opendcvc_tpu_torch.layers import blocks as L
    rows, grad_rows = [], []
    for (shapes, x_shape, q_shape, shortcut), (p, x, q, _, _) in \
            store.items():
        for dtype in (torch.float32, torch.bfloat16):
            pp = {k: {n: t.to(dtype) for n, t in v.items()}
                  for k, v in p.items()}
            xx = x.to(dtype)
            qq = None if q is None else q.to(dtype)
            with torch.no_grad():
                got = L.depth_conv_block_apply(pp, xx, qq, shortcut)
                with _plain_blocks():
                    want = L.depth_conv_block_apply(pp, xx, qq, shortcut)
            bad, _ = _diff_count(got, want)
            rows.append(bad)
            got = _dcb_grads(pp, xx, qq, shortcut)
            with _plain_blocks():
                want = _dcb_grads(pp, xx, qq, shortcut)
            bad_grad = sum(int((g.view(torch.int16 if g.dtype ==
                                        torch.bfloat16 else torch.int32) !=
                                w.view(torch.int16 if w.dtype ==
                                       torch.bfloat16 else torch.int32))
                               .sum()) for g, w in zip(got, want))
            grad_rows.append(bad_grad)
            del got, want
            if bad or bad_grad:
                _fail(f"phase 24 (b): block {shapes} on {x_shape} "
                      f"(quant {q_shape}, shortcut {shortcut}) in "
                      f"{str(dtype)[6:]}: {bad} elements differ, "
                      f"{bad_grad} under autograd")
    _log(f"phase 24 (b): {len(store)} distinct DCVC-RT block calls at "
         f"1080p (adaptor {sum('adaptor' in dict(k[0]) for k in store)}, "
         f"shortcut {sum(k[3] for k in store)}, quant_step "
         f"{sum(k[2] is not None for k in store)}), float32 and bfloat16: "
         f"{sum(rows)} differing elements; under autograd (output and "
         f"every gradient) {sum(grad_rows)} differing bits")


def _host_ms(fn, calls=8, reps=REPS):
    """Median host ms of one call of fn while a sleep kernel holds the
    card, so the host's time is its own (its launches only queue)."""
    times = []
    for _ in range(reps):
        torch.cuda._sleep(40 * SLEEP_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
        torch.cuda.synchronize()
    return float(np.median(times))


def _dcb_host(store, frames):
    """(e) each recorded block call's host ms on the kernels and on the
    chain, summed over (c)'s calls and divided by its frames."""
    from opendcvc_tpu_torch.layers import blocks as L
    sums = {"kernels": 0.0, "chain": 0.0}
    calls = 0
    for p, x, q, shortcut, n in store.values():
        with torch.no_grad():
            def run():
                L.depth_conv_block_apply(p, x, q, shortcut)
            run()
            k = _host_ms(run)
            with _plain_blocks():
                run()
                c = _host_ms(run)
        sums["kernels"] += n * k
        sums["chain"] += n * c
        calls += n
    _log(f"phase 24 (e): host ms with the card held, {calls} block calls "
         f"over {frames} frames: kernels {sums['kernels']:.2f} "
         f"({sums['kernels'] * 1e3 / calls:.1f} us a call, "
         f"{sums['kernels'] / frames:.2f} ms a frame), chain "
         f"{sums['chain']:.2f} ({sums['chain'] * 1e3 / calls:.1f} us a "
         f"call, {sums['chain'] / frames:.2f} ms a frame)")
    return {"calls": calls, "frames": frames,
            "kernels_ms_a_frame": sums["kernels"] / frames,
            "chain_ms_a_frame": sums["chain"] / frames}


def _dcb_bytes(kind, c, hw, itemsize):
    """Least bytes of one launch: each input read once, each output
    written once (kind: bias, bias_wsilu, chunk_add on 4C -> 2C,
    residual, residual_shortcut_quant)."""
    plane = c * hw[0] * hw[1] * itemsize
    units = {"bias": 2, "bias_wsilu": 2, "chunk_add": 6, "residual": 3,
             "residual_shortcut_quant": 4}[kind]
    rows = {"chunk_add": 4, "residual_shortcut_quant": 2}.get(kind, 1)
    return units * plane + rows * c * itemsize


def _dcb_timings(dev):
    """(d) each kernel's median ms (host call inside the events, and the
    device's time alone) against its bound and the chain's ms."""
    from opendcvc_tpu_torch.ops import dcb_epilogue as E
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for c, hw in DCB_SHAPES:
            g = torch.Generator(device=dev).manual_seed(c)
            conv, r, x = (torch.randn((1, c) + hw, generator=g, device=dev)
                          .to(dtype) for _ in range(3))
            wide = torch.randn((1, 4 * c) + hw, generator=g,
                               device=dev).to(dtype)
            b, b4 = (torch.randn((n,), generator=g, device=dev).to(dtype)
                     for n in (c, 4 * c))
            q = torch.rand((1, c, 1, 1), generator=g, device=dev).to(dtype)
            cases = {
                "bias": (lambda: E.bias(conv, b),
                         lambda: E.bias_plain(conv, b)),
                "bias_wsilu": (lambda: E.bias_wsilu(conv, b),
                               lambda: E.bias_wsilu_plain(conv, b)),
                "chunk_add": (lambda: E.bias_wsilu_chunk_add(wide, b4),
                              lambda: E.bias_wsilu_chunk_add_plain(wide,
                                                                   b4)),
                "residual": (lambda: E.bias_residual(conv, b, r),
                             lambda: E.bias_residual_plain(conv, b, r)),
                "residual_shortcut_quant": (
                    lambda: E.bias_residual(conv, b, r, x, q),
                    lambda: E.bias_residual_plain(conv, b, r, x, q)),
            }
            for kind, (kern, plain) in cases.items():
                with torch.no_grad():
                    for fn in (kern, plain):
                        fn()
                    row = {"kernel": "dcb_elementwise_" + (
                        "bias_residual" if kind.startswith("residual")
                        else "bias_wsilu_chunk_add" if kind == "chunk_add"
                        else kind), "case": kind, "dtype": str(dtype)[6:],
                        "C": c, "hw": list(hw),
                        "ms": median_ms(kern, dev),
                        "device_ms": median_ms(kern, dev, queued=True),
                        "plain_ms": median_ms(plain, dev, queued=True)}
                row["bound_ms"], _ = _bound_ms(
                    _dcb_bytes(kind, c, hw, conv.element_size()), 0)
                out.append(row)
    for row in out:
        _log(f"phase 24 (d): {row['case']} {row['dtype']} C {row['C']} "
             f"{row['hw'][0]}x{row['hw'][1]}: {row['ms']:.4f} ms (device "
             f"{row['device_ms']:.4f}), bound {row['bound_ms']:.4f}, chain "
             f"{row['plain_ms']:.4f}")
    return out


def phase_dcb(dev):
    """Phase 24: the DepthConvBlock's epilogue kernels (a) on every WSiLU
    input pattern, (c) in the codecs' chain against the unfused chain,
    (b) on every block call that chain made, (e) their host's ms, (d)
    timed.  Returns the K1 / K2 launches."""
    t0 = time.perf_counter()
    _dcb_wsilu_patterns(dev)
    torch.cuda.empty_cache()
    store = {}
    _reset_launches()
    on = _dcb_codecs(dev, store)
    launches = _launches()
    _dcb_variants(store)
    torch.cuda.empty_cache()
    # (c) codes each of its 2 + N_DCB_GOP frames once and decodes it once
    host = _dcb_host(store, 2 * (2 + N_DCB_GOP))
    del store
    torch.cuda.empty_cache()
    rows = _dcb_timings(dev)
    for row in rows:
        row["launches_c"] = on["dcb.launch." + (
            "residual" if row["case"].startswith("residual")
            else row["case"])]
    print(json.dumps({"dcb_kernels": rows, "dcb_host": host}), flush=True)
    _log(f"phase 24 done in {time.perf_counter() - t0:.1f} s")
    return launches


#: phase 25's calls at 1080p: (name, units, C, H, W, masked, flow px);
#: a negative flow px: a smooth field of that reach (see `_warp_flow`)
WARP_SHAPES = (("fm_ref_frame", 1, 3, 1088, 1920, False, 8.0),
               ("fm_c1_init", 1, 48, 1088, 1920, False, 8.0),
               ("fm_offset_diversity", 32, 3, 1088, 1920, True, 8.0),
               ("fm_offset_diversity_wide", 32, 3, 1088, 1920, True, 40.0),
               ("fm_offset_diversity_smooth", 32, 3, 1088, 1920, True,
                -40.0),
               ("fm_c2", 1, 64, 544, 960, False, 8.0),
               ("fm_c3", 1, 96, 272, 480, False, 8.0),
               ("hem_c1", 1, 64, 1088, 1920, False, 8.0),
               ("hem_c2", 1, 64, 544, 960, False, 8.0),
               ("hem_c3", 1, 64, 272, 480, False, 8.0))


def _warp_bytes(units, c, h, w, masked, itemsize):
    """Least bytes of one W1 call: image, flow and mask read once, the
    output written once."""
    return units * h * w * itemsize * (2 * c + 2 + (1 if masked else 0))


def _warp_flow(g, units, h, w, mag, dev):
    """Flows uniform in +-mag px, each pixel its own; for a negative mag a
    smooth field of reach |mag| (a random field on a grid 32 px apart,
    upsampled bilinearly), whose neighbouring pixels sample neighbouring
    taps, as a motion field's do."""
    if mag >= 0:
        return (torch.rand((units, 2, h, w), generator=g, device=dev)
                * 2 - 1) * mag
    low = torch.rand((units, 2, -(-h // 32), -(-w // 32)), generator=g,
                     device=dev) * 2 - 1
    return torch.nn.functional.interpolate(
        low, size=(h, w), mode="bilinear", align_corners=False) * -mag


def _grid(flow):
    """flow_warp's sample positions as `F.grid_sample`'s grid (corners
    aligned), in flow's dtype."""
    _, _, h, w = flow.shape
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=flow.device)[None, :]
    gx = (xs + flow[:, 0].float()) * (2.0 / max(w - 1, 1)) - 1.0
    gy = (ys + flow[:, 1].float()) * (2.0 / max(h - 1, 1)) - 1.0
    return torch.stack((gx, gy), -1).to(flow.dtype)


def phase_warp(dev):
    """Phase 25: W1 against the plain twin at the main path's 1080p
    calls, bit for bit, and timed beside its bound, the twin and
    `F.grid_sample`.  Returns the rows."""
    import torch.nn.functional as TF
    from opendcvc_tpu_torch.ops import warp as W
    t0 = time.perf_counter()
    n0 = _w1_launches()
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, units, c, h, w, masked, mag in WARP_SHAPES:
            g = torch.Generator(device=dev).manual_seed(units * c + h)
            im = torch.randn((units, c, h, w), generator=g,
                             device=dev).to(dtype)
            flow = _warp_flow(g, units, h, w, mag, dev).to(dtype)
            mask = torch.rand((units, 1, h, w), generator=g,
                              device=dev).to(dtype) if masked else None
            grid = _grid(flow)
            with torch.no_grad():
                got = W.flow_warp(im, flow, mask)
                want = W.flow_warp_plain(im, flow, mask)
                _sync(dev)
                iv = torch.int32 if dtype == torch.float32 else torch.int16
                n_diff = int((got.view(iv) != want.view(iv)).sum())
                del got, want
                if n_diff:
                    _fail(f"phase 25: W1 differs from the twin at {name} "
                          f"{dtype} in {n_diff} elements")

                def kern():
                    W.flow_warp(im, flow, mask)

                def plain():
                    W.flow_warp_plain(im, flow, mask)

                def library():
                    out = TF.grid_sample(im, grid, mode="bilinear",
                                         padding_mode="border",
                                         align_corners=True)
                    if mask is not None:
                        out.mul_(mask)

                row = {"kernel": "flow_warp_kernel", "case": name,
                       "dtype": str(dtype)[6:], "units": units, "C": c,
                       "hw": [h, w], "masked": masked, "flow_px": mag,
                       "ms": median_ms(kern, dev),
                       "device_ms": median_ms(kern, dev, queued=True),
                       "plain_ms": median_ms(plain, dev, queued=True),
                       "library_ms": median_ms(library, dev, queued=True)}
            row["bound_ms"], _ = _bound_ms(
                _warp_bytes(units, c, h, w, masked, im.element_size()), 0)
            row["x_bound"] = row["device_ms"] / row["bound_ms"]
            rows.append(row)
            del im, flow, mask, grid
            torch.cuda.empty_cache()
            _log(f"phase 25: {name} {row['dtype']} ({units}, {c}, {h}, {w})"
                 f"{' masked' if masked else ''} "
                 f"{'smooth ' if mag < 0 else ''}+-{abs(mag):g} px: "
                 f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}), "
                 f"bound {row['bound_ms']:.4f} ({row['x_bound']:.2f}x), "
                 f"twin {row['plain_ms']:.4f}, grid_sample "
                 f"{row['library_ms']:.4f}")
    print(json.dumps({"warp_kernels": rows,
                      "warp_launches": _w1_launches() - n0}), flush=True)
    _log(f"phase 25 done in {time.perf_counter() - t0:.1f} s")
    return rows


N_GRAPH_CHUNKS, N_GRAPH_GOP = 8, 8     # phase 26's period: 1 + 8 x 8 P


def _graph_encode(dev, dtype, x_ref, frame):
    """Phase 26's period encoded by phase 4's DMC (seed 1, flat q banks,
    FZ): (weights, the first P-frame's stream, the chunks' streams, the
    encoder's features after the first P-frame and after each chunk)."""
    from opendcvc_tpu_torch.models.dmc import DMC
    enc = DMC(device=dev, device_ec=True, dtype=dtype)
    enc.init_params(seed=1)
    enc.params["q_encoder"] = torch.ones_like(enc.params["q_encoder"]) * 0.25
    enc.params["q_decoder"] = torch.ones_like(enc.params["q_decoder"])
    enc.update(force_zero_thres=FZ)
    enc.add_ref_frame(None, x_ref)
    s1 = enc.compress(frame(1), QP)["bit_stream"]
    feats, chunks = [enc.dpb[0].feature], []
    for c in range(N_GRAPH_CHUNKS):
        lo = 2 + c * N_GRAPH_GOP
        chunks.append(enc.compress_gop(
            [frame(t) for t in range(lo, lo + N_GRAPH_GOP)],
            [QP] * N_GRAPH_GOP)["bit_streams"])
        feats.append(enc.dpb[0].feature)
    return enc.params, s1, chunks, feats


def _graph_decode(dec, dev, x_ref, s1, chunks):
    """Decode phase 26's period as the benchmark does: (the 65 x_hats,
    the features after the first P-frame and after each chunk, host ms in
    the calls, wall ms to the decode's end)."""
    sps = {"height": x_ref.shape[1], "width": x_ref.shape[2]}
    qps = [QP] * N_GRAPH_GOP
    _sync(dev)
    t0 = time.perf_counter()
    dec.clear_dpb()
    dec.set_curr_poc(0)
    dec.add_ref_frame(None, x_ref)
    xs = [dec.decompress(s1, sps, QP)["x_hat"]]
    feats = [dec.dpb[0].feature]
    up = dec.upload_gop(chunks[0], sps)
    for i, chunk in enumerate(chunks):
        nxt = dec.upload_gop(chunks[i + 1], sps) \
            if i + 1 < len(chunks) else None
        out = dec.decompress_gop(chunk, sps, qps) if up is None \
            else dec.decompress_gop_uploaded(up, sps, qps)
        xs.extend(out["x_hat"])
        feats.append(dec.dpb[0].feature)
        up = nxt
    host_ms = (time.perf_counter() - t0) * 1e3
    _sync(dev)
    return xs, feats, host_ms, (time.perf_counter() - t0) * 1e3


def _graph_row(dev, dtype):
    """Phase 26 for one dtype; returns its row."""
    from opendcvc_tpu_torch.models.dmc import DMC
    base = torch.from_numpy(synthetic_frames(H, W, 1)[0]).to(dev)

    def frame(t):
        return torch.roll(base, 4 * t, dims=2).to(dtype)

    x_ref = frame(0)
    params, s1, chunks, enc_feats = _graph_encode(dev, dtype, x_ref, frame)
    n = 1 + N_GRAPH_CHUNKS * N_GRAPH_GOP
    n_traced = 1 + N_GRAPH_GOP      # the profiled frames
    label = f"phase 26 {str(dtype)[6:]}"

    def decoder():
        dec = DMC(device=dev, device_ec=True, dtype=dtype)
        dec.load_params(params)
        dec.update(force_zero_thres=FZ)
        return dec

    def decode(dec, n_chunks=N_GRAPH_CHUNKS):
        return _graph_decode(dec, dev, x_ref, s1, chunks[:n_chunks])

    def traced(dec):
        """The first P-frame and chunk 0 under the profiler:
        (its counts, the K2 and D1-D4 launches the counters saw)."""
        k0, d0 = _counter("k2.launch"), _dcb_launched()
        _, got = _profiled(lambda: decode(dec, 1))
        return got, (_counter("k2.launch") - k0,
                     _dcb_launched()[0] - d0[0])

    eager = decoder()
    with _eager_decoders():
        k0, d0 = _counter("k2.launch"), _dcb_launched()
        want_x, want_f, _, _ = decode(eager)
        k2_eager = _counter("k2.launch") - k0
        dcb_eager = _dcb_launched()[0] - d0[0]
        traced_e, counted_e = traced(eager)
    _traced_launches(f"{label} (eager)", traced_e, *counted_e)
    dec = decoder()
    names = ("graph.call", "graph.replay", "graph.capture", "k2.launch",
             "graph.replay.k2.launch")
    for run in ("captures", "replays"):
        c0, d0 = {k: _counter(k) for k in names}, _dcb_launched()
        xs, feats, _, _ = decode(dec)
        got = {k: _counter(k) - c0[k] for k in c0}
        dcb = [a - b for a, b in zip(_dcb_launched(), d0)]
        bad = sum(not torch.equal(a, b) for a, b in zip(xs, want_x))
        bad_f = sum(not torch.equal(a, b) for a, b in zip(feats, want_f))
        bad_e = sum(not torch.equal(a, b) for a, b in zip(feats, enc_feats))
        if len(xs) != n or bad or bad_f or bad_e:
            _fail(f"{label} ({run}): {bad} of {len(xs)} x_hats, {bad_f} "
                  f"and {bad_e} of {len(feats)} features differ from the "
                  f"eager twin's and the encoder's")
        if got["k2.launch"] != k2_eager or dcb[0] != dcb_eager or \
                got["graph.call"] != n or (run == "replays" and (
                    got["graph.replay"] != n
                    or got["graph.replay.k2.launch"] != k2_eager)):
            _fail(f"{label} ({run}): counters {got}, D1-D4 {dcb}; eager K2 "
                  f"{k2_eager}, D1-D4 {dcb_eager}")
        _log(f"{label} ({run}): {n} frames bit for bit the eager twin's, "
             f"features the encoder's; {got}, D1-D4 {dcb[0]} launches "
             f"({dcb[1]} added by replays)")
        del xs, feats
    del want_x, want_f
    # every frame a replay: the replays' kernels as the profiler lists
    # them, against the eager decode's launches (each counted by its host
    # call) over the same frames
    traced_r, counted_r = traced(dec)
    if counted_r != counted_e:
        _fail(f"{label}: {n_traced} replayed frames counted {counted_r} "
              f"K2 / D1-D4 launches, the eager ones {counted_e}")
    _traced_launches(f"{label} (replays)", traced_r, *counted_e)
    _log(f"{label}: the profiler lists {traced_r['k2']} K2 and "
         f"{traced_r['dcb']} D1-D4 kernels in {n_traced} replayed frames, "
         f"{traced_e['k2']} and {traced_e['dcb']} in the eager ones")

    row = {"dtype": str(dtype)[6:], "frames": n, "keys": len(dec._graphs),
           "k2_traced": {"eager": traced_e["k2"], "replay": traced_r["k2"]},
           "dcb_traced": {"eager": traced_e["dcb"],
                          "replay": traced_r["dcb"]}}
    # the timed periods count nothing: their launches are not the
    # profiler's to check
    with trace_counted_into({}):
        with _eager_decoders():
            decode(eager)
            _, _, host, wall = decode(eager)
            # an eager frame, synchronized, for the capture's cost
            _, eager_ms = _timed(lambda: eager.decompress(s1, {
                "height": x_ref.shape[1], "width": x_ref.shape[2]}, QP),
                dev)
        row["eager"] = {"host_ms": host / n, "wall_ms": wall / n,
                        "device_ms": traced_e["ms"] / n_traced,
                        "launches": traced_e["ops"] / n_traced}
        _, _, host, wall = decode(dec)
        row["replay"] = {"host_ms": host / n, "wall_ms": wall / n,
                         "device_ms": traced_r["ms"] / n_traced,
                         "launches": traced_r["ops"] / n_traced}
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved(dev)
        dec._graphs.clear()
        torch.cuda.empty_cache()
        row["pool_bytes"] = held - torch.cuda.memory_reserved(dev)
        # a new key's first frame: the eager warm-up and the capture
        dec.clear_dpb()
        dec.add_ref_frame(None, x_ref)
        _, first_ms = _timed(lambda: dec.decompress(s1, {
            "height": x_ref.shape[1], "width": x_ref.shape[2]}, QP), dev)
    row["capture_ms"] = first_ms - eager_ms
    row["eager_frame_ms"] = eager_ms
    e, r = row["eager"], row["replay"]
    _log(f"{label}: a P-frame eager / replay: host {e['host_ms']:.3f} / "
         f"{r['host_ms']:.3f} ms, wall {e['wall_ms']:.3f} / "
         f"{r['wall_ms']:.3f} ms, device {e['device_ms']:.3f} / "
         f"{r['device_ms']:.3f} ms, launches {e['launches']:.1f} / "
         f"{r['launches']:.1f}; capture {row['capture_ms']:.1f} ms; "
         f"{row['keys']} graphs' pools {row['pool_bytes'] / 2**30:.3f} GiB")
    return row


def trace_counted_into(counts):
    """The port's trace's counted_into (utils/trace.py): this thread's
    counts go to `counts` alone."""
    from opendcvc_tpu_torch.utils import trace
    return trace.counted_into(counts)


def phase_graph(dev):
    """Phase 26: DMC's decoder body replayed from CUDA graphs against its
    eager twin, bit for bit, its replayed K2 and D1-D4 kernels counted
    from a profiler's trace, then timed.  Returns the K1 / K2 launches
    and the K2 kernels the profiler counted in replayed periods."""
    t0 = time.perf_counter()
    _reset_launches()
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(_graph_row(dev, dtype))
        torch.cuda.empty_cache()
    print(json.dumps({"graph_decode": rows}), flush=True)
    _log(f"phase 26 done in {time.perf_counter() - t0:.1f} s")
    return _launches(), sum(r["k2_traced"]["replay"] for r in rows)


def _w1_record(rows, runs):
    """W1's record of the `kernels` line: phase 25's float32 offset
    diversity call (the largest) as its head, every row as its shapes,
    and its launches by run, which must be more than 0 in each FM and
    HEM run."""
    for name in ("phase 11 FM host EC", "phase 12 FM device EC",
                 "phase 14 FM bfloat16", "phase 16 HEM"):
        if not runs[name]:
            _fail(f"{name} never launched W1")
    head = next(r for r in rows if r["case"] == "fm_offset_diversity"
                and r["dtype"] == "float32")
    return {"name": "flow_warp (W1)", "route": "cuda",
            "source": "opendcvc_tpu_torch/csrc/flow_warp.cu",
            "replaces": None, "max_abs_err": 0, "ms": head["ms"],
            "device_ms": head["device_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes",
            "library_ms": head["library_ms"], "shapes": rows,
            "launches": sum(runs.values()), "launches_by_run": runs}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chip_smoke_out",
                    help="directory phase 13 writes its streams into")
    args = ap.parse_args()
    # cuBLAS's deterministic workspace, for phase 21's deterministic runs;
    # read when cuBLAS starts, so before any CUDA work
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        _fail("CUDA is not available")
    try:
        import opendcvc_tpu_torch  # noqa: F401  (pins cuDNN determinism)
        from opendcvc_tpu_torch.ops import _build
    except ImportError as e:
        _fail(f"the port's package is missing: {e}")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    _build.load_kernels()
    _log(f"phase 1: kernels built and loaded in "
         f"{time.perf_counter() - t0:.1f} s")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                _log(f"  {name}: {line.strip()}")

    kernels = phase_kernels(dev, L_MAIN, K_MAIN)

    frames = synthetic_frames(H, W, 5)
    _reset_launches()
    replayed = {}
    r0 = _replayed_k2()
    intra = phase_intra(dev, frames[0], QP, FZ)
    p_run = phase_p(dev, intra["x_hat"], frames[1:], QP, FZ)
    replayed["phases 3-4"] = _replayed_k2() - r0
    traced = {"phases 3-4": p_run["traced_k2"]}
    f32 = _times(intra, p_run)
    launches = _launches()
    _log(f"main path launches: K1 {launches[0]}, K2 {launches[1]}")
    if min(launches) == 0:
        _fail("a kernel of the main path was never launched")
    for k, n in zip(kernels, launches):
        k["launches"] = n

    phase_reference(dev, QP, FZ)

    _reset_launches()
    phase_host(dev, frames, QP, FZ, intra, p_run)
    host_launches = _launches()
    _log(f"host-EC path launches: K1 {host_launches[0]}, K2 "
         f"{host_launches[1]}")
    if max(host_launches):
        _fail("the host-EC path launched a lane rANS kernel")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        t0 = time.perf_counter()
        seq = _write_sequence(root, H, W, N_HARNESS)
        _log(f"phase 7: {N_HARNESS} frames of {W}x{H} YUV420 written in "
             f"{time.perf_counter() - t0:.1f} s")
        stream7 = _replay_counted(replayed, "phase 7 device EC",
                                  phase_harness, root, seq)
        runs = {"phase 7 device EC": stream7["launches"],
                "phase 8": _replay_counted(replayed, "phase 8",
                                           phase_bench, dev)}
        runs.update(_replay_counted(replayed, "phase 9", phase_bf16, dev,
                                    frames, f32, root, seq))
        runs.update(_replay_counted(replayed, "phase 10",
                                    phase_training_slice, dev, f32, root,
                                    stream7["job"]))
        w1_runs = {}
        fm_host = _w1_counted(w1_runs, "phase 11 FM host EC", phase_fm,
                              dev, root)
        runs["phase 12 FM device EC"], fm_f32 = _w1_counted(
            w1_runs, "phase 12 FM device EC", phase_fm_device, dev, root,
            fm_host)
        del fm_host
        phase_h100_streams(dev, args.out)
        runs["phase 14 FM bfloat16"] = _w1_counted(
            w1_runs, "phase 14 FM bfloat16", phase_fm_bf16, dev, root,
            fm_f32)
        del fm_f32
        _w1_counted(w1_runs, "phase 15 DC", phase_dc, dev)
        _w1_counted(w1_runs, "phase 16 HEM", phase_hem, dev)
        _w1_counted(w1_runs, "phase 17 TCM", phase_tcm, dev, root)
        phase_evc(dev, root)
        _w1_counted(w1_runs, "phase 19 DCVC", phase_dcvc, dev, root)
        phase_zoo(dev)
        runs["phase 21"] = _replay_counted(
            replayed, "phase 21", _w1_counted, w1_runs, "phase 21",
            phase_training_extras, dev, root)
        torch.cuda.empty_cache()
        runs["phase 23"] = _replay_counted(
            replayed, "phase 23", _w1_counted, w1_runs, "phase 23",
            phase_slice15, dev, root)
        torch.cuda.empty_cache()
        runs["phase 24"] = _replay_counted(replayed, "phase 24", phase_dcb,
                                           dev)
        torch.cuda.empty_cache()
        warp_rows = _w1_counted(w1_runs, "phase 25", phase_warp, dev)
        torch.cuda.empty_cache()
        runs["phase 26"], traced["phase 26"] = _replay_counted(
            replayed, "phase 26", phase_graph, dev)
        torch.cuda.empty_cache()
        _reset_launches()
        phase_multi_gpu(root)
        if max(_launches()):
            _fail("phase 22 (training) launched a lane rANS kernel")
    for i, k in enumerate(kernels):
        k["launches_by_run"] = {"phases 3-4": k["launches"]}
        for name, n in runs.items():
            k["launches_by_run"][name] = n[i]
            k["launches"] += n[i]
    # K2's launches that graph replays added (their captures' counts), by
    # run; in phases 4 and 26 the profiler lists each replayed kernel
    kernels[1]["replayed_by_run"] = {k: n for k, n in replayed.items() if n}
    kernels[1]["replayed_traced"] = traced
    kernels.append(_w1_record(warp_rows, w1_runs))

    card = _card()
    _log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)   # name, power limit
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
