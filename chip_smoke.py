#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: refuse to run without CUDA; print the card's name and power limit.
2. build: compile the seven CUDA sources of fastspeech2_tpu_torch/csrc with
   nvcc for sm_90a (all sources at once) and print the build seconds and the
   ptxas register/shared-memory report; the 20 bf16 training-attention
   kernels (forward, dQ, dK/dV: the tile bodies at DK 128/192/256 and both
   grid splits, the wide bodies of d_k past 256 at column parts of 192 and
   256), the eight SERVE instantiations of the shared forward (kernels 7
   and 8, and launch B of 1, 5 and 6: the tile body at DK 128/192/256 in
   both grid splits, the wide body at parts of 192 and 256; the new ones
   without a ptxas note of serialized wgmma in either library), the eleven
   q|k|v and out projection kernels of
   1, 5 and 6, the twelve widths of the bf16 residual stack and its wide
   path's two kernels (kernel 13),
   the 21 conv-FFN kernels (2, 9, 10: k-tap conv at two tilings and with
   its x tile in 512-column chunks, whose SASS holds one fence.proxy.async
   more than the whole tile's, and k=1 conv with its epilogue), the three variance-adaptor kernels (3: two ring-tile widths
   and the x tile in chunks) and the ten postnet kernels (4: nine chain
   kernels and the wide path's stage kernel) must show HGMMA and no HMMA in
   their SASS (cuobjdump) and no
   ptxas spills; all but the training kernels also no ptxas note of
   serialized wgmma (C7512/C7514/C7515/C7519); each kernel's generic
   ST.E/LD.E count is printed. The f32 FFT kernel of stft_mel_energy (14) must show
   no ptxas spill (its report lines printed, in phase 3).
3. kernels: each of the fourteen kernels (attention_block, ffn_block,
   variance_adaptor, postnet, resstack, attention_res_ln, attention_res,
   fused_attention_packed, fused_attention, ffn_block_pre, fused_ffn, the
   training attention's two entries attention_train_packed and
   attention_train, forward and backward, and stft_mel_energy in f32 at the
   preprocess path's (8, 229,376) and (8, 16,384) buckets and at 10.4 s rows
   of hop 200 and 512, and at hops outside 32-512 or with a prime factor
   above 5 (7, 28, 220, 257, 275, 441, 600, 1024 in 10 s rows; float64 errors held to the card
   tests' band), n_fft = 4 hop, 1e-4) against its plain PyTorch
   version on the card, on
   the same bf16-tier inputs at the main paths' shapes (the FFT-block and
   decoder kernels with lengths that leave dead tiles, the MelGAN residual
   stack at the four stage shapes of a B=16, 768-frame rung (the per-layer
   cuDNN loop logged beside each), at lengths with one end and both ends in
   a tile, at widths 96, 48 and 24 (zero-padded to 32) and in f32, and past
   256 channels (RESSTACK_WIDTHS: the wide path at C 320, 512 and 1024, bf16
   and f32, three and four dilations, two launches a block, timed; f32 at
   250, zero-padded), the
   training attention at the decoder's and the
   encoder's training shapes with rate 0 and 0.2, timed at both rates beside
   SDPA at the same dropout_p, with the backward's three launches timed apart
   by the profiler, and in f32; the FFN kernels 2, 9 and 10 at both shapes
   with their device times by the profiler, and at the shapes their tiling
   makes risky: T under and off the tiles, D = 512, D = 1024 at H = 4096,
   H = 1056, k = 1 and 3, O = 80 and 200, and past D 1,344 where launch 1
   holds its x tile in 512-column chunks: D 1376, 1536 and 2048 at H 4096,
   1500 at k = 31, 2044 and 2047); max/mean abs error
   against the stated tolerance; kernel and plain times (CUDA events, median
   of 25) beside the least time the card could take for the same work (for
   stft_mel_energy counted by an FFT and the sparse mel projection at the
   shape's n_fft; its device time by the profiler beside that of the cuFFT
   composition, torch.stft -> abs -> mel product -> log, and the float64
   errors of the kernel, the plain version and the composition) and,
   for the training attention and the bare attention (fused_attention_packed,
   fused_attention), one scaled_dot_product_attention call (for the bare
   attention also both device times per call, by the profiler); the dead
   rows of the pre-LN and bare kernels against their exact constants, and of
   the FFN kernels from len + (k - 1) / 2 on against the call's one
   bias-only row c (10: c bit for bit; 9: x + c, 2: LN(x + c), within
   1e-5); kernels 3
   and 4 with their device times by the profiler, and at the widths their
   tilings make risky (the adaptor at D = 200, 256, 384, 512, 1024 and over
   48 batch rows, and at D = 36, 60, 100, 1100, 1504, 2048 and 8,192 and
   65,536 bins; the postnet at C = 512, C = 200 with C0 = 88 and k = 7,
   k = 9, 8 layers of k = 9 in two launches, 100 mels at C = 500, one
   layer, k = 11 and 31, 12 layers, and on its wide path (one launch a
   stage) C = 1024, (768, 513, 11, 10) and (1024, 1024, 5, 2)), dead rows
   exactly 0 (3) and the last stage's BN of zero bit for bit (4); kernel
   7 against kernel 11's forward at rate 0, bit for bit (one body), at both
   shapes and at T = 2048, where 7 and 8 also meet their plain versions;
   kernels 1, 5 and 6 with their device times by the profiler, also at d_k
   256 (B=16, T=768, D=256, one head), where their dead rows are held bit
   for bit to res + bo (6) and to kernel 5's own LN(res + bo) at length 0
   (1 and 5; that within 1e-5 of the plain LayerNorm). Every head dim:
   kernels 7, 8, 11 and 12 (forward and the three gradients, rate 0.2) at
   d_k 40, 64, 136, 160, 320, 384, 512 and 1024 (two heads at 40, 136 and
   160, so that a load or store crossing into the next head's columns
   shows; d_k 40 also reads a 64-column box past a map of 40), lengths
   T, 0, random and short, against their plain versions: dead rows zero,
   8 == 7 == 11's forward at rate 0 and a second training call bit for bit;
   the f32 instantiations at d_k 160 and 384; kernels 1, 5 and 6 at (D, H)
   = (384, 1), (320, 2) and (1024, 1) with their dead rows; at d_k 160, 384
   and 1024 every one of the seven timed at (16, 768) beside its plain
   version, its bound and (7, 8, 11, 12) SDPA, whose backend is named.
   The wide kernel phase (WIDE_FFN_TIMED, WIDE_HEAD_DIMS): kernels 2, 9,
   10 at (16, 768), k 9, H 4096, D 1536 and 2048 against their plain
   versions and timed; the same head-dim checks at d_k 1500, 1536 (two
   heads) and 2048, f32 at 1500 and 2048, kernels 1, 5, 6 at D 1536, 2048
   (one and two heads) and 1500, timed at d_k 1536 and 2048 beside SDPA.
4. mel path: the default-config model (random weights from seed 0, duration
   bias 1.87 for realistic frame counts) served through
   Synthesizer(bf16=True) on cuda at B=1, 8 and 32 with fixed ARPAbet
   sentences; every kernel's launch counter must rise; one B=8 batch served
   with the 2-way split is held row by row against the same port on the CPU
   (plain versions) fed the card's durations; mel-frames/s at B=32; a
   torch.profiler breakdown of one B=32 call (device time by kernel, device
   busy share).
5. wav path: the default MelGAN generator (bf16, seeded weights) attached to
   the same synthesizer; warmup; wav_from_token_batch at B=1, 8 and 32 (int16,
   lengths, the mel path's mel, 8 residual-stack launches per split B=32
   call); rows of the B=8 batch against the CPU port's generator (plain
   versions) fed the card's mel; ms per B=32 call, audio-seconds per second,
   the vocoder's share, the B=32 mel and wav calls with reduced-precision
   reductions of bf16 GEMMs refused (device.py's setting) and allowed, a
   profile. Then (wide_vocoder_phase) a base_channels: 1024 MelGAN on the
   same synthesizer: 9 kernel 13 launches a decode group, one row of each
   group of a B=8 wav call held to the CPU port's generator on its first
   64 frames, the B=32 wav call timed beside the default generator's; f32
   generators at base_channels 1024 and 500 vocode a B=2 mel held to the
   CPU port (1e-4 of the peak).
6. server: infer.server.serve in a thread on 127.0.0.1 with the same
   synthesizer: 16 concurrent /synthesize wav requests (text and phonemes), a
   /stream of a three-sentence paragraph, a mel request, /healthz; RIFF
   headers, sample counts, batching engaged; requests/s and median latency;
   clean shutdown.
7. switch: flags.FUSED_ATT_QKV off: the split attention kernel carries a B=8
   mel batch and its output is held to the fused route's; then
   flags.FUSED_ATT_RES off: the bare attention kernel (plain projections,
   residual and LayerNorm around it) and the post-LN FFN kernel, held the
   same way.
8. one train step, card against CPU: the default-config model (seed 0) takes
   one bf16 step on the same batch and dropout seeds on the card (training
   attention kernels) and on the CPU (plain versions); loss and gradient norm
   within the stated band.
9. train path: train.loop.train at full width and depth (bf16, batch 16 x
   accum_grad 4) on a seeded feature store of 160 utterances at real lengths
   for 10 steps, one periodic save; finite losses, forward and backward
   launch counts of kernel 11 equal to 8 x micro-batches x steps, the final
   checkpoint reloads to the same parameters; two more steps from it with
   flags.FUSED_ATT_TRAIN_PACKED off go through kernel 12; ms per step (CUDA
   events), mel-frames/s, peak device memory, a profile of one step.
10. Griffin-Lim (between 7 and 8): a Synthesizer with no vocoder serves a
   B=1 sentence; vocode (30 iterations) on the card against the CPU port from
   the same mel and initial phase (max < 1e-3 of the peak); ms per call;
   serve() with no vocoder answers a /synthesize wav and a /stream request
   with RIFF audio of (frames - 1) * 256 samples.
11. preprocess: 160 seeded synthetic wavs (16-bit, 1.5-10 s; three of
   cmd_preprocess's 64-file chunks) through cli.main(["preprocess"]) on the card and cli.main(["stats"]); one .npy of
   each kind per wav with the JAX package's shapes and dtypes, kernel 14
   (the FFT kernel, one launch a batch) launched once per bucket batch (39)
   and no other kernel, four files held
   against the CPU port (1e-4), the statistics finite with every key, the
   store read by TTSDataset; wavs/s, audio-seconds/s, shares of the wall
   time (kernel 14, host DIO, file I/O). Then (preprocess_corpora_phase)
   12 wavs each at 22.05 kHz / hop 220, 44.1 kHz / hop 441 and 48 kHz / hop
   600 (n_fft = 4 hop, an audio: override YAML) through the same command:
   kernel 14 once a bucket batch, two files held to the plain version and
   to float64, wavs/s.

12. prenorm (after 10): the default widths and depth with pre-LN blocks in
   both stacks (a minimal override YAML), seed 0, duration bias 1.87, saved
   as a checkpoint; `python -m fastspeech2_tpu_torch serve -p CKPT --warmup`
   as a subprocess (config from the checkpoint's hp_yaml): two rounds of 16
   concurrent mel requests and a Griffin-Lim wav request, requests/s, median
   latency, the server's launch counts from /healthz; in process B=1/8/32 mel
   calls through Synthesizer(bf16=True) (kernels 6 and 9 in every block, not
   1 and 2), ms per B=32 call, mel-frames/s, B=8 against the CPU port fed the
   card's durations; `synth -p CKPT` once on the card (mel.npy, test_tts.wav).
13. prenorm_concat: the same with concat_after in both stacks, a B=8 call:
   kernels 7 and 9, not 6.
14. d_k 256: a post-LN model with adim = ddim = 256 and one head serves a
   B=8 mel call through kernel 1 at d_k 256 (its launch counter), held
   against the CPU port fed the card's durations.
14b. one head: configs/default.yaml with aheads 1 (encoder d_k 256,
   decoder d_k 384) serves B=1, 8 and 32 mel calls through kernel 1 in all
   8 blocks (12 launches a B=32 call), B=8 held against the CPU port fed the
   card's durations; one B=8 call each with FUSED_ATT_QKV off (kernel 5),
   pre-LN blocks (kernel 6) and concat_after (kernel 7); adim 320 at two
   heads (encoder d_k 160) serves a B=8 call through kernel 1, held the
   same way. After the train path (9), train() with aheads 1 at full width
   in bf16 takes 2 steps (kernel 11 at d_k 256 and 384, 32 / 32 a step),
   the single-process step on one window runs twice with the same bits, and
   one step with FUSED_ATT_TRAIN_PACKED off goes through kernel 12.
14c. wide model (after 15): WIDE_MODEL (default.yaml, one head, adim 1536,
   ddim 2048, 4,096-unit FFNs; ~0.7 G parameters) served in bf16: B=1, 8,
   32 mel calls through kernels 1 and 2 in all 8 blocks, B=8 against the
   CPU port fed the card's durations, the B=32 mel call and a B=32 wav
   call (default MelGAN) timed beside default.yaml's in this run, a
   profile; B=8 with pre-LN blocks (6, 9), the int8 tier (1, 3, 4; 5 with
   FUSED_ATT_QKV off), concat_after (7) and two heads (decoder d_k 1024).
   After the train path: train() 2 steps (kernel 11 at d_k 1536 and 2048,
   32 / 32 a step, finite losses), the single-process step twice bit for
   bit, one step through kernel 12.
15. wide postnet: a post-LN model with postnet_chans 512 and adim 384 serves
   a B=8 mel call through kernels 3 (D = 384) and 4 (C = 512), held against
   the CPU port fed the card's durations; their launch counters rise. Then
   the narrow (adim 60, two heads of d_k 30; 100 mels; postnet_chans 500)
   and wide (adim 1280, two heads of d_k 640; 8,192 bins; postnet_chans
   1024, k = 11, 10 layers) models of the default config at full depth:
   a B=8 mel call each held the same way, a timed B=32 call, kernels 3
   and 4 launched in both (CONV_WIDTH_MODELS).
16. CLI train (after 9, on its store): `python -m fastspeech2_tpu_torch
   train` at full width in bf16 (4 steps of 16 x 4; validation sample and
   saves every 2 steps; --profile_dir) in a subprocess: two checkpoints, the
   four validation tags in the TensorBoard events, one Chrome trace, kernel
   11's launches from its log (32 a step); `train -p` one step with
   FS2_FUSED_ATT_TRAIN_PACKED=off (kernel 12, 32 a step); `evaluate` held
   to the CPU port's evaluate_predictors; `average` of the two checkpoints;
   `convert` .npz -> .pth -> .npz bit for bit; `synth` of the .pth and the
   .npz (the same mel.npy); `gta` of 16 utterances held to the CPU port's;
   the bucketed B=32 mel call (3 buckets) against the unbucketed rows of the
   batch (kernels 1-4 counted; the two calls' times).
18. export, golden, demo (after WaveGlow): the CLI `export --bf16` of the
   main path's model with and without a baked MelGAN (seungwonpark format,
   seed 0), of a pre-LN checkpoint, and `--bf16 --int8`; each artifact
   loaded and called at B=8 (128 tokens, 1024 frames): the launches of
   kernels 1-4 (6 and 9 pre-LN, 13 with MelGAN) from the counters, mel and
   wav against Synthesizer's at the same precision (lengths equal, bf16
   band), both calls timed; `golden` on a stand-in reference .pth of that
   model (mel within 1e-4 of the CPU port's f32 run, which writes the
   golden files; with --vocoder kernels 13 in f32 and 14 counted);
   examples/demo_torch.py on the card in its own process. In phase 3 the
   custom op's cost against the direct launch for kernels 1 and 2.
17. parallel (last; parallel/): two gloo ranks share the card (worker
   processes: `chip_smoke.py --parallel-worker ...`) for a dp=2 and a tp=2
   pair of full-width bf16 steps (dropout 0, two seeded 64-row windows),
   each held to the single-process steps on the same windows: every term of
   the report (the mel L1 terms as well as the pitch term that dominates
   the loss), each module group's summed gradient (norm and four seeded
   projections: each stack's attention and the rest of it, the variance
   adaptor, feat_out, the postnet) and the postnet's BatchNorm running
   statistics (equal across ranks); kernel 12 launched 32 / 32 times per
   rank per step and kernel 11 never; TP=2 inference at B=8 (kernel 7, 8
   launches per rank, kernels 1-4 none) held to the unsharded model, and
   Synthesizer(mesh=) serving the TP model; the single process's steps
   run twice, bit for bit; a formed NCCL group of one takes the same steps,
   within 1e-6 of them at both; Synthesizer(mesh=) over two entries of the card: a B=32
   mel call (kernels 1-4 per shard) and a B=8 wav call (13) held to the
   unsharded calls; `serve` under `torch.distributed.run` with two gloo
   ranks: mel and Griffin-Lim wav requests, rank 0's launches.
   `python3 chip_smoke.py --parallel-only` builds the kernels and runs this
   phase alone (no result lines).

The line before the last is a JSON object listing the kernels; the last line
is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
# WaveGlow bf16 against f32 at the waveglow_256channels width, relative to
# the f32 output: (mean gap / rms, max gap / peak). The JAX package's own
# gap there (scripts/waveglow_bf16_gap.py --frames 96 on the CPU, seeds 0
# and 1) is 0.00701 and 0.00722 of rms, 0.01279 and 0.01254 of peak; the
# port's CPU route gives 0.00702 / 0.00720 and 0.01198 / 0.01419 on the same
# inputs: the statistic itself moves by up to 15% between seeds and between
# the packages, so the band is 1.25 x the larger JAX value.
WAVEGLOW_BAND = (0.00903, 0.0160)

# fixed ARPAbet sentences (stress digits are remapped by the frontend)
SENTENCES = [
    "DH AH0 K W IH1 K B R AW1 N F AA1 K S JH AH1 M P S OW1 V ER0 DH AH0 L EY1 Z IY0 D AO1 G",
    "SH IY1 S EH1 L Z S IY1 SH EH2 L Z B AY1 DH AH0 S IY1 SH AO1 R pau AH0 N D DH AH0 "
    "SH EH1 L Z SH IY1 S EH1 L Z AA1 R SH UH1 R L IY0 S IY1 SH EH2 L Z",
    "HH IY1 HH AE1 D N EH1 V ER0 S IY1 N S AH1 CH AH0 B Y UW1 T AH0 F AH0 L "
    "M AO1 R N IH0 NG IH0 N AO1 L HH IH0 Z L AY1 F",
    "AY1 W IH1 L T EY1 K DH AH0 T R EY1 N T AH0 DH AH0 S IH1 T IY0 T AH0 M AA1 R OW2 "
    "pau AH0 N D DH EH1 N W AO1 K DH AH0 R EH1 S T AH0 V DH AH0 W EY1 HH OW1 M",
    "IH0 N DH AH0 B IH0 G IH1 N IH0 NG DH EH1 R W AA1 Z N AH1 TH IH0 NG B AH1 T "
    "DH AH0 D AA1 R K W AO1 T ER0 Z AH0 N D DH AH0 K OW1 L D W IH1 N D pau "
    "AH0 N D DH EH1 N DH AH0 F ER1 S T L AY1 T K EY1 M AH0 P AA1 N DH AH0 W ER1 L D",
    "P L IY1 Z K AO1 L S T EH1 L AH0 pau AE1 S K HH ER0 T AH0 B R IH1 NG DH IY1 Z "
    "TH IH1 NG Z W IH1 DH HH ER0 F R AH1 M DH AH0 S T AO1 R pau S IH1 K S "
    "S P UW1 N Z AH1 V F R EH1 SH S N OW1 P IY1 Z pau F AY1 V TH IH1 K S L AE1 B Z "
    "AH1 V B L UW1 CH IY1 Z",
    "W EH1 N DH AH0 S AH1 N L AY1 T S T R AY1 K S R EY1 N D R AA2 P S IH0 N DH IY0 "
    "EH1 R pau DH EY1 AE1 K T AE1 Z AH0 P R IH1 Z AH0 M AH0 N D F AO1 R M AH0 "
    "R EY1 N B OW2 pau DH AH0 R EY1 N B OW2 IH1 Z AH0 D IH0 V IH1 ZH AH0 N AH1 V "
    "W AY1 T L AY1 T IH1 N T UW1 M EH1 N IY0 B Y UW1 T AH0 F AH0 L K AH1 L ER0 Z",
    "N AW1 IH1 Z DH AH0 T AY1 M F AO1 R AO1 L G UH1 D M EH1 N T UW1 K AH1 M "
    "T UW1 DH AH0 EY1 D AH1 V DH EH1 R K AH1 N T R IY0",
]


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_time_ms(fn, reps: int = 25) -> float:
    """Median of `reps` single-call CUDA-event timings, after 3 warm calls."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


PARAGRAPH = ("The quick brown fox jumps over the lazy dog. She sells sea shells by "
             "the sea shore. Now is the time for all good men.")
TEXTS = ["Hello world, this is a test of the server.",
         "The rainbow is a division of white light into many beautiful colors.",
         "Please call Stella and ask her to bring these things from the store.",
         "He had never seen such a beautiful morning in all his life."]


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name, got, want, mean_tol, max_tol, rtol=0.0):
    """Fails unless the mean abs error is under mean_tol and every element is
    within max_tol + rtol * |want| (with rtol, assert_allclose's rule with
    atol = max_tol). Returns the max abs error."""
    d = (got.float() - want.float()).abs()
    mx, mn = float(d.max()), float(d.mean())
    worst = float((d / (max_tol + rtol * want.float().abs())).max())
    ok = worst < 1 and mn < mean_tol
    rule = f"rtol {rtol:g}, atol {max_tol:.3g}: worst {worst:.3f} of it" if rtol else f"max<{max_tol:g}"
    log(f"  {name}: max_abs={mx:.3e} mean_abs={mn:.3e} "
        f"(tolerance {rule}, mean<{mean_tol:.3g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return mx


def ffn_bias_row(torch, KF, w, k):
    """The bias-only row c = round(relu(round(b1)) W2) + b2 of the FFN
    weights w = (w1, b1, w2, b2) in f32, by kernel 10: row k - 1 of a
    length-0 input, past its halo."""
    dev, D = w[0].device, w[0].shape[1] // k
    x0 = torch.zeros(1, k, D, dtype=torch.bfloat16, device=dev)
    lens0 = torch.zeros(1, dtype=torch.int32, device=dev)
    return KF.fused_ffn(x0, *w, lens0, k, torch.float32)[0, -1]


def ffn_dead_rows(name, got, lens, k, want_from, exact=False):
    """Every row t >= len + (k - 1) / 2 of every batch row of an FFN kernel's
    output against want_from(b, t0) (its rows t0 on): bit for bit, or within
    1e-5 (the f32 rounding of the residual add and of the LayerNorm)."""
    T, rows, worst = got.shape[1], 0, 0.0
    for b, n in enumerate(lens.tolist()):
        t0 = min(T, max(0, n) + (k - 1) // 2)
        if t0 == T:
            continue
        want = want_from(b, t0).expand_as(got[b, t0:])
        if exact:
            assert bool((got[b, t0:] == want).all()), f"{name}: dead rows of row {b}"
        else:
            worst = max(worst, float((got[b, t0:].float() - want.float()).abs().max()))
        rows += T - t0
    assert worst < 1e-5, f"{name}: dead rows {worst}"
    log(f"  {name}: {rows} rows from len + {(k - 1) // 2} on hold the call's one bias-only "
        f"row c ({'bit for bit' if exact else f'max abs {worst:.2e}, tolerance 1e-5'})")


def record_device_ms(torch, results, name, key, fn):
    """The profiler's device time per call of fn (every launch it makes)
    beside the events' time of `record`."""
    by = device_ms_by_kernel(torch, fn)
    d = sum(by.values()) or None
    results[name].setdefault("device_ms", {})[key] = d
    log(f"  {name} {key}: device time per call (profiler) {d} ms "
        f"({', '.join(f'{n} {v:.4f}' for n, v in by.items())})")


def op_dispatch(torch, results, name, key, op_fn, direct_fn, n=200):
    """What the custom op (``ops/kernels/library.py``) adds to a launch: the
    wrapper's call through its ``fs2::`` op against the direct ctypes launch
    on the same inputs, by CUDA events (median of 25) and by the host's time
    to enqueue one call (n calls back to back, then one synchronize)."""
    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    got = {"op_ms": cuda_time_ms(op_fn), "direct_ms": cuda_time_ms(direct_fn),
           "op_host_us": host_us(op_fn), "direct_host_us": host_us(direct_fn)}
    results[name].setdefault("op_dispatch", {})[key] = got
    log(f"  {name} {key} through its custom op: {got['op_ms']:.4f} ms against "
        f"{got['direct_ms']:.4f} ms direct (events); host enqueue {got['op_host_us']:.1f} "
        f"us against {got['direct_host_us']:.1f} us a call")


def kernel_phase(torch, results):
    """Each kernel against its plain version at the serving path's shapes."""
    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.models.postnet import Postnet, PostnetConfig
    from fastspeech2_tpu_torch.models.predictors import Predictor, PredictorConfig
    from fastspeech2_tpu_torch.ops import nn
    from fastspeech2_tpu_torch.ops.kernels import adaptor as KAd
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF
    from fastspeech2_tpu_torch.ops.kernels import postnet as KP
    from fastspeech2_tpu_torch.ops.length_regulator import expansion_indices
    from fastspeech2_tpu_torch.ops.quantize import linear_bins, log_bins

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(0)

    def lengths(B, T, lo):
        ls = torch.randint(lo, T + 1, (B,), generator=gen, dtype=torch.int32)
        ls[0], ls[-1] = T, max(1, T // 5)  # one full row, one short row
        return ls.to(dev)

    def record(name, src, replaces, err, ms, plain_ms, flops, nb, key=None,
               library_ms=None):
        key = key or shape_key
        b_ms, by = bound_ms(flops, nb)
        lib = f", library {library_ms:.4f} ms" if library_ms is not None else ""
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib}, bound "
            f"{b_ms:.4f} ms ({by}), kernel {ms / b_ms:.1f}x its bound")
        results.setdefault(name, {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "max_abs_err": 0.0, "ms": {}, "plain_ms": {},
            "bound_ms": {}, "bound_by": {}})
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"][key] = ms
        r["plain_ms"][key] = plain_ms
        r["bound_ms"][key] = b_ms
        r["bound_by"][key] = by
        if library_ms is not None:
            r.setdefault("library_ms", {})[key] = library_ms

    # kernel 1 and 2: encoder shape and a decoder rung shape
    for B, T, D in ((32, 128, 256), (16, 768, 384)):
        shape_key = f"B={B},T={T},D={D}"
        torch.manual_seed(B + T + D)
        blk = FFTBlock(EncoderConfig(idim=D, attention_dim=D, attention_heads=2,
                                     linear_units=1024,
                                     positionwise_conv_kernel_size=9), device=dev)
        x = torch.randn(B, T, D, generator=gen).to(dev)
        lens = lengths(B, T, T // 4)
        lc = lens.cpu().tolist()
        with torch.inference_mode():
            ap = blk.attn_pack(bf16)
            got = KA.attention_block(x, *ap, lens, 2)
            want = KA.attention_block_plain(x, *ap, lens, 2)
            torch.cuda.synchronize()
            log(f"kernel attention_block {shape_key}")
            err = compare("attention_block", got, want, 2e-3, 0.1)
            ms = cuda_time_ms(lambda: KA.attention_block(x, *ap, lens, 2))
            pms = cuda_time_ms(lambda: KA.attention_block_plain(x, *ap, lens, 2))
            flops = sum(8 * l * D * D + 4 * l * l * D for l in lc)
            record("attention_block", "fastspeech2_tpu_torch/csrc/attention.cu",
                   "fastspeech2_tpu/ops/pallas/attention.py:587", err, ms, pms, flops,
                   nbytes(x, x, *ap))
            record_device_ms(torch, results, "attention_block", shape_key,
                             lambda: KA.attention_block(x, *ap, lens, 2))
            op_dispatch(torch, results, "attention_block", shape_key,
                        lambda: KA.attention_block(x, *ap, lens, 2),
                        lambda: KA.launch_block(x, *ap, lens, 2, 1e-5))
            fp = blk.ffn_pack(bf16)
            got = KF.ffn_block(x, *fp, lens, 9)
            want = KF.ffn_block_plain(x, *fp, lens, 9)
            c = ffn_bias_row(torch, KF, fp[:4], 9)
            torch.cuda.synchronize()
            log(f"kernel ffn_block {shape_key}")
            err = compare("ffn_block", got, want, 2e-3, 0.1)
            ffn_dead_rows("ffn_block", got, lens, 9,
                          lambda b, t0: nn.layer_norm(x[b, t0:] + c, fp[4], fp[5]))
            ms = cuda_time_ms(lambda: KF.ffn_block(x, *fp, lens, 9))
            pms = cuda_time_ms(lambda: KF.ffn_block_plain(x, *fp, lens, 9))
            flops = sum(min(l + 4, T) * 2 * (9 * D * 1024 + 1024 * D) for l in lc)
            record("ffn_block", "fastspeech2_tpu_torch/csrc/ffn.cu",
                   "fastspeech2_tpu/ops/pallas/ffn.py:344", err, ms, pms, flops,
                   nbytes(x, x, *fp))
            record_device_ms(torch, results, "ffn_block", shape_key,
                             lambda: KF.ffn_block(x, *fp, lens, 9))
            op_dispatch(torch, results, "ffn_block", shape_key,
                        lambda: KF.ffn_block(x, *fp, lens, 9),
                        lambda: KF.launch_block(False, x, *fp, lens, 9, 1e-5))

    # kernel 3 and 4: a decoder rung shape
    B, T, L, D, C, NB = 16, 128, 768, 256, 256, 256
    shape_key = f"B={B},T={T},L={L}"
    torch.manual_seed(1)
    pitch, energy = (Predictor(PredictorConfig(idim=D), device=dev) for _ in range(2))
    p_emb, e_emb = (torch.nn.Linear(NB, D, device=dev) for _ in range(2))
    hs = torch.randn(B, T, D, generator=gen).to(dev)
    tok = lengths(B, T, 16)
    ds = torch.randint(1, 11, (B, T), generator=gen, dtype=torch.int32).to(dev)
    tok_mask = torch.arange(T, device=dev)[None] < tok[:, None]
    with torch.inference_mode():
        idx, _, out_lens = expansion_indices(ds, tok_mask, L, T)
        pack = KAd.pack_weights(pitch, energy, p_emb, e_emb,
                                torch.from_numpy(log_bins(71.0, 676.2260946528305)).to(dev),
                                torch.from_numpy(linear_bins(0.01786651276051998,
                                                             130.5338592529297)).to(dev),
                                bf16)
        got, graw = KAd.variance_adaptor(hs, idx, out_lens, *pack)
        want, wraw = KAd.variance_adaptor_plain(hs, idx, out_lens, *pack)
        torch.cuda.synchronize()
        log(f"kernel variance_adaptor {shape_key}")
        # the bucketize is a knife-edge: a frame whose prediction moved one
        # ulp may land one bucket off; at most 1% of live frames may differ,
        # the others must agree within the band
        bins = pack[10]
        bk = lambda r, i: (bins[i][None, None] < r[:, i][..., None]).sum(-1)  # noqa: E731
        same = (bk(graw, 0) == bk(wraw, 0)) & (bk(graw, 1) == bk(wraw, 1))
        live = torch.arange(L, device=dev)[None] < out_lens[:, None]
        flipped = int((~same & live).sum())
        log(f"  variance_adaptor: {flipped}/{int(live.sum())} live frames one bucket off "
            "(tolerance 1%)")
        assert flipped <= 0.01 * int(live.sum()), "too many bucket flips"
        keep = (same & live)[..., None]
        err = max(compare("variance_adaptor.raw", graw, wraw, 1e-2, 0.5),
                  compare("variance_adaptor", torch.where(keep, got, 0),
                          torch.where(keep, want, 0), 2e-3, 0.1))
        ms = cuda_time_ms(lambda: KAd.variance_adaptor(hs, idx, out_lens, *pack))
        pms = cuda_time_ms(lambda: KAd.variance_adaptor_plain(hs, idx, out_lens, *pack))
        n_live = int(out_lens.sum())
        flops = n_live * 2 * (2 * 3 * D * C + 2 * 3 * C * C + 2 * C)
        record("variance_adaptor", "fastspeech2_tpu_torch/csrc/adaptor.cu",
               "fastspeech2_tpu/ops/pallas/adaptor.py:152", err, ms, pms, flops,
               nbytes(hs, idx, out_lens, got, graw, *pack))
        record_device_ms(torch, results, "variance_adaptor", shape_key,
                         lambda: KAd.variance_adaptor(hs, idx, out_lens, *pack))

    net = Postnet(PostnetConfig(), device=dev)
    with torch.no_grad():
        for layer in net.layers:
            c = layer.bn.running_mean.shape[0]
            layer.bn.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
            layer.bn.running_var.copy_(1.0 + torch.rand(c, generator=gen))
    mel = torch.randn(B, L, 80, generator=gen).to(dev)
    with torch.inference_mode():
        w, bn, hidden = KP.pack_weights(net.layers, bf16)
        got = KP.postnet(mel, w, bn, out_lens, 5, hidden, 5)
        want = KP.postnet_plain(mel, w, bn, out_lens, 5, hidden, 5)
        torch.cuda.synchronize()
        log(f"kernel postnet {shape_key}")
        err = compare("postnet", got, want, 2e-3, 0.1)
        ms = cuda_time_ms(lambda: KP.postnet(mel, w, bn, out_lens, 5, hidden, 5))
        pms = cuda_time_ms(lambda: KP.postnet_plain(mel, w, bn, out_lens, 5, hidden, 5))
        # each stage's input is re-masked to the live rows, so stages 1-4 need
        # the l live rows; the last stage needs l+2 (past that its output is
        # the constant BN of zero)
        first, last = 2 * 5 * (80 * 256 + 3 * 256 * 256), 2 * 5 * 256 * 80
        flops = sum(l * first + min(l + 2, L) * last for l in out_lens.cpu().tolist())
        record("postnet", "fastspeech2_tpu_torch/csrc/postnet.cu",
               "fastspeech2_tpu/ops/pallas/postnet.py:112", err, ms, pms, flops,
               nbytes(mel, mel, w, bn, out_lens))
        record_device_ms(torch, results, "postnet", shape_key,
                         lambda: KP.postnet(mel, w, bn, out_lens, 5, hidden, 5))
    resstack_phase(torch, results, record)
    attention_res_ln_phase(torch, results, record)
    prenorm_kernel_phase(torch, results, record)
    attention_halves_dk256(torch, results, record)
    ffn_edges_phase(torch, results)
    adaptor_postnet_edges_phase(torch, results)


def resstack_phase(torch, results, record):
    """Kernel 13 against its plain version: bf16 at the four stage shapes of
    a B=16, 768-frame rung (each beside the per-layer cuDNN loop of
    fused_resstack=False, logged for context), at a length with both ends in
    one tile, at a single tile of the JAX kernel, at widths the kernel takes
    natively beyond 32/64/128/256 (96, 48: a base_channels=192 generator)
    and at one it zero-pads (24 -> 32); f32 at a smaller shape. Weights are
    the generators' (seed 0), the input is unit normal noise in bf16."""
    from fastspeech2_tpu_torch.ops.kernels import resstack as KR
    from fastspeech2_tpu_torch.vocoder.melgan import MelGANConfig, MelGANGenerator

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gens = (MelGANGenerator(seed=0), MelGANGenerator(MelGANConfig(base_channels=192), seed=0))
    g = torch.Generator().manual_seed(13)
    blocks = {b.stacks[0].c1.weight.shape[0]: (gen, b) for gen in gens for b in gen.blocks}

    def check(B, S, C, cd, time_it):
        gen, block = blocks[C]
        ws = KR.pack_weights(block.stacks, cd)
        x = torch.randn(B, S, C, generator=g).to(cd).to(dev)
        got = KR.resstack(x, *ws)
        want = KR.resstack_plain(x, *ws)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        scale = float(want.float().abs().max())
        # both sides round at the same points; what differs is the f32
        # summation order, which flips an occasional bf16 rounding that later
        # blocks carry on. Relative to the plain output's scale: bf16 max
        # < 2^-6 (two ulps of the largest values), mean < 1e-4; f32 max
        # < 1e-5, mean < 1e-6.
        tol = (2.0 ** -6, 1e-4) if cd == bf16 else (1e-5, 1e-6)
        tag = f"resstack {str(cd).split('.')[-1]} B={B},S={S},C={C}"
        log(f"kernel {tag}: output scale {scale:.3f}")
        ends = max(float(d[:, :16].max()), float(d[:, -16:].max()))
        log(f"  first/last 16 rows (reflection): max_abs={ends:.3e} "
            f"(tolerance <{tol[0] * scale:.3e})")
        assert ends < tol[0] * scale, "reflected ends disagree"
        err = compare(tag, got, want, tol[1] * scale, tol[0] * scale)
        if not time_it:
            return err, None, None
        ms = cuda_time_ms(lambda: KR.resstack(x, *ws))
        pms = cuda_time_ms(lambda: KR.resstack_plain(x, *ws), reps=5)
        if cd == bf16:  # context, not a gate: the unfused route of the same stage
            loop_ms = cuda_time_ms(lambda: gen.residual_loop(x, block, bf16), reps=5)
            log(f"  per-layer cuDNN loop (fused_resstack=False): {loop_ms:.4f} ms")
        return err, ms, pms

    with torch.inference_mode():
        check(2, 2048, 64, bf16, False)   # single tile of the JAX kernel
        check(1, 128, 256, bf16, False)   # a tile per end
        check(1, 128, 64, bf16, False)    # one tile holds both ends
        for B, S, C in ((2, 2048, 96), (2, 4096, 48), (2, 2048, 24)):
            check(B, S, C, bf16, False)   # widths beyond 32/64/128/256
        for S, C in ((6144, 256), (49152, 128), (98304, 64), (196608, 32)):
            B = 16
            err, ms, pms = check(B, S, C, bf16, True)
            record("resstack", "fastspeech2_tpu_torch/csrc/resstack.cu",
                   "fastspeech2_tpu/ops/pallas/resstack.py:120", err, ms, pms,
                   2.0 * B * S * 3 * 4 * C * C,
                   2 * B * S * C * 2 + 3 * 4 * C * C * 2 + 2 * 3 * C * 4,
                   f"B={B},S={S},C={C}")
        B, S, C = 4, 16384, 128
        err, ms, pms = check(B, S, C, torch.float32, True)
        flops, nb = 2.0 * B * S * 3 * 4 * C * C, 2 * B * S * C * 4
        log(f"  resstack f32 B={B},S={S},C={C}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
            f"bound {1e3 * max(flops / PEAK_F32_FLOPS, nb / PEAK_BYTES):.4f} ms "
            "(67 TFLOP/s f32 outside the tensor cores)")
        results["resstack"]["f32"] = {"shape": f"B={B},S={S},C={C}", "ms": ms,
                                      "plain_ms": pms, "max_abs_err": err}
    resstack_widths(torch, results)


# kernel 13 past 256 channels (the wide path) and f32 at any width: (dtype,
# B, S, C, dilations, timed). 512 is a base_channels: 1024 generator's first
# stage (S = 6144: a B=16, 768-frame rung)
RESSTACK_WIDTHS = (("bf16", 16, 6144, 512, (1, 3, 9), True),
                   ("bf16", 16, 6144, 320, (1, 3, 9, 27), True),
                   ("bf16", 8, 6144, 1024, (1, 3, 9), True),
                   ("bf16", 2, 2048, 1024, (1, 3, 9, 27), False),
                   ("f32", 2, 2048, 512, (1, 3, 9), True),
                   ("f32", 2, 2048, 320, (1, 3, 9, 27), True),
                   ("f32", 1, 2048, 1024, (1, 3, 9), True),
                   ("f32", 1, 1024, 1024, (1, 3, 9, 27), False),
                   ("f32", 2, 2048, 250, (1, 3, 9), False))


def resstack_widths(torch, results):
    """Kernel 13 at RESSTACK_WIDTHS against its plain version (seeded
    weights of a stage at that width, unit normal input): the bands of
    resstack_phase, the launches (two a dilated block on the wide path),
    CUDA events, device time by the profiler and the bound (bf16 at 989
    TFLOP/s, f32 at 67)."""
    from fastspeech2_tpu_torch.ops.kernels import resstack as KR
    from fastspeech2_tpu_torch.ops.precision import round_to

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1024)
    widths = results["resstack"].setdefault("widths", {})
    for tier, B, S, C, dil, timed in RESSTACK_WIDTHS:
        cd = torch.bfloat16 if tier == "bf16" else torch.float32
        n, bound = len(dil), 1.0 / (3 * C) ** 0.5
        w1 = ((torch.rand(n, C, 3 * C, generator=g) * 2 - 1) * bound).to(cd)
        w2 = ((torch.rand(n, C, C, generator=g) * 2 - 1) / C ** 0.5).to(cd)
        b1, b2 = (round_to((torch.rand(n, C, generator=g) * 2 - 1) * bound, cd)
                  for _ in range(2))
        ws = [t.to(dev).contiguous() for t in (w1, b1, w2, b2)]
        x = torch.randn(B, S, C, generator=g).to(cd).to(dev)
        key = f"{tier} B={B},S={S},C={C},n={n}"
        with torch.inference_mode():
            n0 = KR.launches
            got = KR.resstack(x, *ws, dil)
            torch.cuda.synchronize()
            launched = KR.launches - n0
            want = KR.resstack_plain(x, *ws, dil)
            torch.cuda.synchronize()
        scale = float(want.float().abs().max())
        # bf16: max 2^-6 of the scale as resstack_phase; the mean 2^-11 of
        # it, the band tests/test_torch_port_kernels.py holds the plain
        # version to against the JAX kernel: the share of elements one
        # rounding apart grows with the sums' length (K = 3C) and with the
        # blocks that carry a flip on (1.8% of them one ulp apart at C 1024,
        # four blocks, on the H100; 1% at three), past resstack_phase's
        # 1e-4, which its widths (K <= 768) meet. f32: 1e-5 and 1e-6.
        tol = (2.0 ** -6, 2.0 ** -11) if tier == "bf16" else (1e-5, 1e-6)
        expect = 2 * n if KR.wide(C) else 1
        log(f"kernel resstack {key} (dilations {dil}): {launched} launches (expected "
            f"{expect}), output scale {scale:.3f}")
        assert launched == expect, (launched, expect)
        d = (got.float() - want.float()).abs()
        ends = max(float(d[:, :16].max()), float(d[:, -16:].max()))
        assert ends < tol[0] * scale, "reflected ends disagree"
        err = compare(f"resstack {key}", got, want, tol[1] * scale, tol[0] * scale)
        r = {"max_abs_err": err, "launches_per_call": launched}
        if timed:
            fn = lambda: KR.resstack(x, *ws, dil)  # noqa: E731
            with torch.inference_mode():
                ms = cuda_time_ms(fn, reps=10)
                pms = cuda_time_ms(lambda: KR.resstack_plain(x, *ws, dil), reps=3)
                dms = device_ms_by_kernel(torch, fn)
            flops = 2.0 * B * S * n * 4 * C * C
            nb = 2 * B * S * C * x.element_size() + nbytes(*ws)
            b_ms, by = bound_ms(flops, nb, PEAK_BF16_FLOPS if tier == "bf16" else PEAK_F32_FLOPS)
            dev_ms = sum(dms.values()) or None
            log(f"  resstack {key}: kernel {ms:.4f} ms (device {dev_ms} ms: "
                f"{', '.join(f'{k} {v:.4f}' for k, v in dms.items())}), plain {pms:.4f} ms, "
                f"bound {b_ms:.4f} ms ({by}), kernel {(dev_ms or ms) / b_ms:.1f}x its bound "
                "by device time")
            r.update(ms=ms, device_ms=dev_ms, plain_ms=pms, bound_ms=b_ms, bound_by=by)
        widths[key] = r
        del x, ws, got, want, d
        torch.cuda.empty_cache()


def attention_res_ln_phase(torch, results, record):
    """Kernel 5 (q/k/v given) against its plain version and against kernel
    1 on the same x, at the two shapes kernel 1 is checked at."""
    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.ops import nn
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.precision import compute_dtype

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(5)
    for B, T, D in ((32, 128, 256), (16, 768, 384)):
        key = f"B={B},T={T},D={D}"
        torch.manual_seed(B + T + D)
        blk = FFTBlock(EncoderConfig(idim=D, attention_dim=D, attention_heads=2,
                                     linear_units=1024,
                                     positionwise_conv_kernel_size=9), device=dev)
        x = torch.randn(B, T, D, generator=gen).to(dev)
        lens = torch.randint(T // 4, T + 1, (B,), generator=gen, dtype=torch.int32)
        lens[0], lens[-1] = T, max(1, T // 5)
        lc, lens = lens.tolist(), lens.to(dev)
        with torch.inference_mode(), compute_dtype(bf16):
            ap = blk.attn_pack(bf16)
            q, k, v = (nn.linear(x, p.weight, p.bias, out_dtype=bf16)
                       for p in (blk.attn.q, blk.attn.k, blk.attn.v))
            args = (q, k, v, x, *ap[2:], lens, 2)
            got = KA.attention_res_ln(*args)
            want = KA.attention_res_ln_plain(*args)
            fused = KA.attention_block(x, *ap, lens, 2)
            torch.cuda.synchronize()
            log(f"kernel attention_res_ln {key}")
            err = compare("attention_res_ln", got, want, 2e-3, 0.1)
            # kernel 1 projects on the tensor cores, this route with a cuBLAS
            # f32 product of the same bf16 values: q/k/v may differ by rare
            # one-ulp flips, so the outputs are held in the band
            same = float((got == fused).float().mean())
            log(f"  vs attention_block on the same x: {same:.4f} of outputs bit-equal")
            compare("attention_res_ln vs attention_block", got, fused, 2e-3, 0.1)
            ms = cuda_time_ms(lambda: KA.attention_res_ln(*args))
            pms = cuda_time_ms(lambda: KA.attention_res_ln_plain(*args))
            flops = sum(2 * l * D * D + 4 * l * l * D for l in lc)
            # q/k/v rows past a length are never read; res and out are whole
            record("attention_res_ln", "fastspeech2_tpu_torch/csrc/attention.cu",
                   "fastspeech2_tpu/ops/pallas/attention.py:448", err, ms, pms, flops,
                   3 * sum(lc) * D * 2 + nbytes(x, x, *ap[2:]), key)
            record_device_ms(torch, results, "attention_res_ln", key,
                             lambda: KA.attention_res_ln(*args))


def attention_halves_dk256(torch, results, record):
    """Kernels 1, 5 and 6 at d_k 256 (one head, D = 256) at the decoder rung's
    B and T, against their plain versions, with their device times: q/k/v of
    5 and 6 are column blocks of one q|k|v buffer projected by plain ops
    (from LN(x) for 6), the residual x. Rows at or past each length: res +
    bo exactly (6); for 1 and 5 what 5 gives at length 0 on the same
    residual, bit for bit, itself within 1e-5 of the plain LN(res + bo)."""
    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.ops import nn
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.precision import compute_dtype

    dev, bf16, (B, T, D, H) = torch.device("cuda"), torch.bfloat16, (16, 768, 256, 1)
    key, src = f"B={B},T={T},D={D},H={H}", "fastspeech2_tpu_torch/csrc/attention.cu"
    gen = torch.Generator().manual_seed(256)
    torch.manual_seed(256)
    blk = FFTBlock(EncoderConfig(idim=D, attention_dim=D, attention_heads=H,
                                 linear_units=1024), device=dev)
    with torch.no_grad():  # LayerNorm affines with something to do
        for ln in (blk.norm1, blk.norm2):
            ln.weight.add_(0.2 * torch.randn(D, generator=gen).to(dev))
            ln.bias.add_(0.1 * torch.randn(D, generator=gen).to(dev))
    x = (2.0 * torch.randn(B, T, D, generator=gen) + 0.5).to(dev)
    lens = torch.randint(T // 4, T + 1, (B,), generator=gen, dtype=torch.int32)
    lens[0], lens[1], lens[-1] = T, 0, max(1, T // 5)  # full, wholly dead, short
    lc, lens = lens.tolist(), lens.to(dev)
    with torch.inference_mode(), compute_dtype(bf16):
        ap = blk.attn_pack(bf16)
        wo, bo = ap[2], ap[3]

        def qkv_of(y):
            w = torch.cat([p.weight for p in (blk.attn.q, blk.attn.k, blk.attn.v)])
            b = torch.cat([p.bias for p in (blk.attn.q, blk.attn.k, blk.attn.v)])
            t = nn.linear(y, w, b, out_dtype=bf16)
            return t[..., :D], t[..., D:2 * D], t[..., 2 * D:]

        a1 = (x, *ap, lens, H)
        a5 = (*qkv_of(x), x, *ap[2:], lens, H)
        a6 = (*qkv_of(nn.layer_norm(x, blk.norm1.weight, blk.norm1.bias)), x, wo, bo, lens, H)
        dead = KA.attention_res_ln(*a5[:-2], torch.zeros_like(lens), H)
        torch.cuda.synchronize()
        worst = float((dead - nn.layer_norm(x + bo, ap[4], ap[5])).abs().max())
        assert worst < 1e-5, f"kernel 5 at length 0 vs LN(res + bo): {worst}"
        live_qkv = 3 * sum(lc) * D * 2
        small = sum(4 * l * l * D + 2 * l * D * D for l in lc)
        for name, fn, plain, args, flops, nb, want_dead in (
                ("attention_block", KA.attention_block, KA.attention_block_plain, a1,
                 sum(8 * l * D * D + 4 * l * l * D for l in lc), nbytes(x, x, *ap), dead),
                ("attention_res_ln", KA.attention_res_ln, KA.attention_res_ln_plain, a5,
                 small, live_qkv + nbytes(x, x, *ap[2:]), dead),
                ("attention_res", KA.attention_res, KA.attention_res_plain, a6,
                 small, live_qkv + nbytes(x, x, wo, bo), x + bo)):
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            log(f"kernel {name} {key} (d_k 256)")
            err = compare(name, got, want, 2e-3, 0.1)
            for b, n in enumerate(lc):
                assert torch.equal(got[b, n:], want_dead[b, n:]), f"{name} dead row {b}"
            what = "res + bo" if name == "attention_res" else "kernel 5's LN(res + bo) at length 0"
            log(f"  {name}: rows at or past each length == {what}, bit for bit (that "
                f"within {worst:.2e} of the plain LN(res + bo), tolerance 1e-5)")
            record(name, src, results[name]["replaces"], err,
                   cuda_time_ms(lambda: fn(*args)), cuda_time_ms(lambda: plain(*args)),
                   flops, nb, key)
            record_device_ms(torch, results, name, key, lambda: fn(*args))
            results[name]["main_shape"] = "B=16,T=768,D=384"


def train_attention_fns(KT, packed, lens, seed, H, rate):
    """The kernel entry (11 packed, 12 (B, H, T, dk)) and its plain version."""
    if packed:
        return (lambda q, k, v: KT.fused_attention_train_packed(q, k, v, lens, seed, H, rate),
                lambda q, k, v: KT.attention_train_plain(q, k, v, lens, seed, rate, H))
    return (lambda q, k, v: KT.fused_attention_train(q, k, v, lens, seed, rate),
            lambda q, k, v: KT.attention_train_plain(q, k, v, lens, seed, rate))


def train_attention_times(torch, KT, packed, q, k, v, do, lens, H, rate, seed=12345):
    """Forward and backward ms of one training-attention entry (CUDA events,
    median of 25) and of one scaled_dot_product_attention call on the same
    q, k, v with a boolean key mask and the same dropout_p (a yardstick only:
    SDPA draws its own dropout mask)."""
    import torch.nn.functional as F

    kern = train_attention_fns(KT, packed, lens, seed, H, rate)[0]
    o = kern(q, k, v)
    with torch.no_grad():
        f_ms = cuda_time_ms(lambda: kern(q, k, v))
    b_ms = cuda_time_ms(lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True))
    del o
    B, T = lens.numel(), q.shape[1] if packed else q.shape[2]
    dk = q.shape[-1] // H if packed else q.shape[-1]
    q4, k4, v4, do4 = ((t if not packed else t.reshape(B, T, H, dk).transpose(1, 2))
                       for t in (q, k, v, do))
    pad = torch.arange(T, device=q.device)[None] >= lens[:, None]
    amask = (~pad)[:, None, :, None] & (~pad)[:, None, None, :]
    amask = amask | pad[:, None, :, None]  # padded rows: any key, no NaN
    sd = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, attn_mask=amask, dropout_p=rate)
    so = sd()
    with torch.no_grad():
        lf_ms = cuda_time_ms(sd)
    lb_ms = cuda_time_ms(lambda: torch.autograd.grad(so, (q, k, v), do4, retain_graph=True))
    out = {"fwd": f_ms, "bwd": b_ms, "sdpa_fwd": lf_ms, "sdpa_bwd": lb_ms}
    # device time per call (the profiler's kernel durations summed): at the
    # encoder's shape a single call's events also hold the host's launch time
    o = kern(q, k, v)
    for name, fn in (("fwd", lambda: kern(q, k, v)), ("sdpa_fwd", sd),
                     ("bwd", lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True)),
                     ("sdpa_bwd", lambda: torch.autograd.grad(so, (q, k, v), do4,
                                                              retain_graph=True))):
        with torch.no_grad() if name.endswith("fwd") else contextlib.nullcontext():
            by_kernel = device_ms_by_kernel(torch, fn)
        out["device_" + name] = sum(by_kernel.values()) if by_kernel else None
        if name == "bwd":  # the backward's launches apart: t, dQ, dK/dV
            out["bwd_launches"] = {n: round(ms, 5) for n, ms in by_kernel.items()
                                   if "train_" in n}
    return out


def device_ms_by_kernel(torch, fn, n=10):
    """Device ms per call of each kernel that fn launches, by name
    (torch.profiler over n calls); {} where the profiler records no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+)(<[^(]*>)?\(", e.name)
            name = m.group(1) if m else e.name
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / n
    return out


def train_kernel_phase(torch, results):
    """Kernels 11 and 12, forward and backward, against the plain version on
    the card: the decoder's and the encoder's training shapes, lengths with
    one full row, one short row and dead tiles, rate 0 and 0.2; padded rows
    exactly zero; times (CUDA events, median of 25) of forward and backward
    at rate 0 and 0.2, each beside one scaled_dot_product_attention call at
    the same dropout_p (boolean mask: the library yardstick, used nowhere in
    the port), the plain version's (0.2) and the bound; the backward's
    launches (t, dQ, dK/dV) timed apart by the profiler; kernel 12's backward
    against kernel 11's at each shape."""
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT

    dev, bf16, H = torch.device("cuda"), torch.bfloat16, 2
    gen = torch.Generator().manual_seed(11)
    src = "fastspeech2_tpu_torch/csrc/attention_train.cu"
    entries = {True: ("attention_train_packed",
                      "fastspeech2_tpu/ops/pallas/attention_train.py:337"),
               False: ("attention_train",
                       "fastspeech2_tpu/ops/pallas/attention_train.py:365")}

    def grads(fn, q, k, v, do):
        o = fn(q, k, v)
        return (o, *torch.autograd.grad(o, (q, k, v), do))

    for B, T, D in ((16, 896, 384), (16, 128, 256)):
        dk = D // H
        lens = torch.randint(T // 4, T + 1, (B,), generator=gen, dtype=torch.int32)
        lens[0], lens[1], lens[-1] = T, T // 2 - 3, max(1, T // 5)
        lc, lens = lens.tolist(), lens.to(dev)
        pad = (torch.arange(T, device=dev)[None] >= lens[:, None])  # (B, T)
        for packed in (True, False):
            name, replaces = entries[packed]
            shape = (B, T, D) if packed else (B, H, T, dk)
            key = f"B={B},T={T},D={D}"
            q, k, v, do = (torch.randn(shape, generator=gen).to(bf16).to(dev)
                           for _ in range(4))
            q, k, v = (t.requires_grad_() for t in (q, k, v))
            padrows = pad[:, :, None] if packed else pad[:, None, :, None]
            err = 0.0
            for rate in (0.0, 0.2):
                seed = 0xFFFFFFF0 + int(rate * 10)  # past 2^31: the uint32 path
                kern, plain = train_attention_fns(KT, packed, lens, seed, H, rate)
                got = grads(kern, q, k, v, do)
                want = grads(plain, q, k, v, do)
                torch.cuda.synchronize()
                log(f"kernel {name} {key} rate={rate}")
                for what, g, w in zip(("o", "dq", "dk", "dv"), got, want):
                    assert g.dtype == bf16 and g.shape == w.shape
                    dead = float(torch.where(padrows, g.detach().float().abs(), 0).max())
                    assert dead == 0.0, f"{name} {what}: padded rows not exactly zero"
                    # both sides round at the same points; the f32 summation
                    # order differs and flips single bf16 roundings, which the
                    # later products carry: max < 2^-6 (two bf16 steps at the
                    # peak) and mean < 1e-4 of the plain result's peak
                    peak = float(w.detach().float().abs().max())
                    err = max(err, compare(f"{name}.{what} (peak {peak:.3f}, padded rows 0)",
                                           g.detach(), w.detach(), 1e-4 * peak, 2.0 ** -6 * peak))
            # times at rate 0 and 0.2 (the configured rate), each beside SDPA
            # at the same dropout_p; the plain version at 0.2
            tm = {rate: train_attention_times(torch, KT, packed, q, k, v, do, lens, H, rate)
                  for rate in (0.0, 0.2)}
            f_ms, b_ms, lf_ms, lb_ms = (tm[0.2][x] for x in ("fwd", "bwd", "sdpa_fwd", "sdpa_bwd"))
            o = plain(q, k, v)
            with torch.no_grad():
                pf_ms = cuda_time_ms(lambda: plain(q, k, v), reps=5)
            pb_ms = cuda_time_ms(lambda: torch.autograd.grad(o, (q, k, v), do,
                                                             retain_graph=True), reps=5)
            del o
            split = tm[0.2].get("bwd_launches")
            for rate, t in tm.items():
                log(f"  {name} {key} rate {rate}: forward {t['fwd']:.4f} ms (sdpa "
                    f"{t['sdpa_fwd']:.4f}), backward {t['bwd']:.4f} ms (sdpa "
                    f"{t['sdpa_bwd']:.4f}); device time per call (profiler): forward "
                    f"{t['device_fwd']} (sdpa {t['device_sdpa_fwd']}), backward "
                    f"{t['device_bwd']} (sdpa {t['device_sdpa_bwd']})")
            log(f"  {name} {key}: backward launches at 0.2 (profiler, ms per launch): {split}")
            pairs = sum(l * l for l in lc) * H * dk
            # bytes the function needs: q, k, v (and dO) by live rows, the
            # outputs whole (padded rows are written as zeros); the saved row
            # statistics are the implementation's own and are not counted
            live, whole = sum(lc) * D * 2, B * T * D * 2
            fb, fby = bound_ms(4 * pairs, 3 * live + whole)
            bb, bby = bound_ms(10 * pairs, 4 * live + 3 * whole)
            log(f"  {name} {key}: forward {f_ms:.4f} ms (plain {pf_ms:.3f}, sdpa "
                f"{lf_ms:.4f}, bound {fb:.4f} {fby}); backward {b_ms:.4f} ms (plain "
                f"{pb_ms:.3f}, sdpa {lb_ms:.4f}, bound {bb:.4f} {bby})")
            r = results.setdefault(name, {
                "name": name, "route": "cuda", "source": src, "replaces": replaces,
                "max_abs_err": 0.0, "ms": {}, "plain_ms": {}, "bound_ms": {},
                "bound_by": {}, "library_ms": {}, "bwd": {}})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["ms"][key], r["plain_ms"][key] = f_ms, pf_ms
            r["bound_ms"][key], r["bound_by"][key], r["library_ms"][key] = fb, fby, lf_ms
            r["bwd"][key] = {"ms": b_ms, "plain_ms": pb_ms, "bound_ms": bb,
                             "bound_by": bby, "library_ms": lb_ms}
            r.setdefault("rate0", {})[key] = tm[0.0]
            r.setdefault("bwd_launches_ms", {})[key] = split
        # CUDA events around one call also hold the host's launch time, which
        # at the encoder's shape is several times the device's; the
        # profiler's device time is the kernels' own
        k11, k12 = (results[entries[p][0]] for p in (True, False))
        ev = k12["bwd"][key]["ms"] / k11["bwd"][key]["ms"]
        d11, d12 = (r["rate0"][key]["device_bwd"] for r in (k11, k12))
        dv = f"{d12 / d11:.3f}" if d11 and d12 else "not measured"
        log(f"  {key}: kernel 12 backward / kernel 11 backward: {ev:.3f} by CUDA events "
            f"around one call (rate 0.2), {dv} by device time (rate 0)")

    # the f32 instantiation (plain multiply-adds, no TF32) at a smaller shape
    B, T, D, rate, seed = 4, 320, 384, 0.2, 2 ** 32 - 3
    lens = torch.tensor([T, 200, 65, 7], dtype=torch.int32, device=dev)
    for packed in (True, False):
        name = entries[packed][0]
        shape = (B, T, D) if packed else (B, H, T, D // H)
        q, k, v = (torch.randn(shape, generator=gen).to(dev).requires_grad_()
                   for _ in range(3))
        do = torch.randn(shape, generator=gen).to(dev)
        kern, plain = train_attention_fns(KT, packed, lens, seed, H, rate)
        got, want = grads(kern, q, k, v, do), grads(plain, q, k, v, do)
        torch.cuda.synchronize()
        log(f"kernel {name} f32 B={B},T={T},D={D} rate={rate}")
        err = 0.0
        for what, g, w in zip(("o", "dq", "dk", "dv"), got, want):
            # full f32 on both sides; the summation order and expf differ
            peak = float(w.detach().abs().max())
            err = max(err, compare(f"{name}.{what} f32 (peak {peak:.3f})", g.detach(),
                                   w.detach(), 2e-6 * peak, 2e-5 * peak))
        o, op = kern(q, k, v), plain(q, k, v)
        with torch.no_grad():
            f_ms = cuda_time_ms(lambda: kern(q, k, v))
            pf_ms = cuda_time_ms(lambda: plain(q, k, v), reps=5)
        b_ms = cuda_time_ms(lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True))
        pb_ms = cuda_time_ms(lambda: torch.autograd.grad(op, (q, k, v), do,
                                                         retain_graph=True), reps=5)
        pairs = sum(l * l for l in lens.tolist()) * D
        log(f"  {name} f32: forward {f_ms:.4f} ms (plain {pf_ms:.3f}), backward {b_ms:.4f} ms "
            f"(plain {pb_ms:.3f}); bounds at 67 TFLOP/s f32 "
            f"{1e3 * 4 * pairs / PEAK_F32_FLOPS:.4f} / {1e3 * 10 * pairs / PEAK_F32_FLOPS:.4f} ms")
        results[name]["f32"] = {"shape": f"B={B},T={T},D={D}", "ms": f_ms, "plain_ms": pf_ms,
                                "bwd_ms": b_ms, "bwd_plain_ms": pb_ms, "max_abs_err": err}


def train_step_vs_cpu_phase(torch):
    """One bf16 train step at full width and depth, card (kernels 11) against
    CPU (plain versions): the same weights, batch and seeds. The batch is cut
    to 4 rows of at most 384 frames so the CPU side takes seconds."""
    import numpy as np

    from fastspeech2_tpu_torch.config import Config
    from fastspeech2_tpu_torch.models.fastspeech2 import Batch, FastSpeech2
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT
    from fastspeech2_tpu_torch.train.optimizer import NoamAdam
    from fastspeech2_tpu_torch.train.seeds import SeedSchedule
    from fastspeech2_tpu_torch.train.step import TrainState, make_train_step, trainable

    cfg = Config()
    g = np.random.default_rng(3)
    B, T, L = 4, 64, 384
    ilens = np.asarray([64, 50, 33, 20], np.int32)
    ds = g.integers(3, 7, (B, T)).astype(np.int32) * (np.arange(T)[None] < ilens[:, None])
    olens = ds.sum(1).astype(np.int32)
    m = np.arange(L)[None] < olens[:, None]
    xs = (g.integers(1, 68, (B, T)) * (ds > 0)).astype(np.int32)
    b = Batch(xs=xs, ilens=ilens, olens=olens, ds=ds,
              ys=(g.normal(-5, 2, (B, L, 80)) * m[..., None]).astype(np.float32),
              es=(g.uniform(0.02, 100, (B, L)) * m).astype(np.float32),
              ps=(g.uniform(71, 600, (B, L)) * m).astype(np.float32))
    out = {}
    for dev in ("cpu", "cuda"):
        model = FastSpeech2(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        opt = NoamAdam(trainable(model), cfg)
        seeds = [SeedSchedule(model.dropout_sites(), seed=9).draw()]
        n0 = KT.packed_fwd_launches, KT.packed_bwd_launches
        t0 = time.perf_counter()
        _, rep = make_train_step(model, opt, 1, bf16=True)(
            TrainState(model, opt), Batch(*(torch.from_numpy(a).to(dev) for a in b)), seeds)
        out[dev] = {k: float(v) for k, v in rep.items()}
        out[dev]["launches"] = (KT.packed_fwd_launches - n0[0], KT.packed_bwd_launches - n0[1])
        out[dev]["first_param"] = next(model.parameters()).detach().float().cpu()
        log(f"one step on {dev}: loss {out[dev]['loss']:.4f} l1 {out[dev]['l1_loss']:.5f} "
            f"grad_norm {out[dev]['grad_norm']:.4f} launches {out[dev]['launches']} "
            f"({time.perf_counter() - t0:.1f} s, first call)")
    c, g_ = out["cpu"], out["cuda"]
    assert c["launches"] == (0, 0) and g_["launches"] == (8, 8), (c["launches"], g_["launches"])
    # bf16 band: the two sides round at the same points and sum in another
    # order (cuBLAS/cuDNN/tensor cores against CPU f32 products)
    for k, tol in (("loss", 0.01), ("l1_loss", 0.01), ("duration_loss", 0.02),
                   ("grad_norm", 0.05)):
        rel = abs(g_[k] - c[k]) / abs(c[k])
        log(f"  card vs CPU {k}: relative difference {rel:.2e} (tolerance {tol:g})")
        assert rel < tol, f"one step, card vs CPU: {k} differs by {rel}"
    d = float((c["first_param"] - g_["first_param"]).abs().max())
    log(f"  embedding table after the update: max abs difference {d:.2e}")
    assert d < 1e-6  # lr(1) = 2.5e-7 per unit of Adam's normalised first step


def seeded_store(work):
    """The train paths' feature store in ``work``: 160 seeded utterances at
    real lengths; (root, filelist)."""
    from fastspeech2_tpu_torch.data.dataset import TTSDataset, write_fake_feature_store

    root = f"{work}/store"
    t0 = time.perf_counter()
    fl = write_fake_feature_store(root, n_utts=160, seed=0, min_tokens=80,
                                  max_tokens=170, min_dur=3, max_dur=7)
    ds = TTSDataset(root, fl)
    fr, tk = ds.frame_lengths(), ds.token_lengths()
    log(f"train path: store of {len(ds)} utterances in {time.perf_counter() - t0:.1f} s, "
        f"tokens {tk.min()}-{tk.max()}, frames {fr.min()}-{fr.max()} "
        f"({int((fr > 870).sum())} over 870 are dropped)")
    assert len(ds) >= 64 and tk.min() >= 60 and fr.min() >= 240
    return root, fl


def train_path_phase(torch, results, store):
    """train() at full width and depth, bf16, batch 16 x accum 4, on the
    seeded feature store; then two more steps with FUSED_ATT_TRAIN_PACKED
    off; then timed steps and a profile."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from fastspeech2_tpu_torch.config import Config, DataConfig
    from fastspeech2_tpu_torch.data.batching import BucketBatcher
    from fastspeech2_tpu_torch.data.dataset import TTSDataset
    from fastspeech2_tpu_torch.data.prefetch import batch_to_device
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.ops import flags
    from fastspeech2_tpu_torch.train.checkpoint import load_checkpoint
    from fastspeech2_tpu_torch.train.loop import train
    from fastspeech2_tpu_torch.train.seeds import SeedSchedule
    from fastspeech2_tpu_torch.train.step import make_train_step

    work = tempfile.mkdtemp(prefix="fs2_train_", dir=str(ROOT / "build"))
    try:
        root, fl = store
        ds = TTSDataset(root, fl)
        cfg = Config()
        steps, accum, bsz = 10, cfg.train.accum_grad, cfg.train.batch_size
        assert (accum, bsz) == (4, 16)
        cfg = dataclasses.replace(
            cfg, data=DataConfig(data_dir=root, train_filelist=fl, valid_filelist=fl),
            train=dataclasses.replace(cfg.train, bf16=True, summary_interval=1,
                                      save_interval=6, validation_step=10 ** 6,
                                      keep_ckpts=3))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        ts = train(cfg, "smoke", f"{work}/out", max_steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        recs = [json.loads(ln) for ln in open(f"{work}/out/logs/smoke/train_metrics.jsonl")]
        main = [r for r in recs if "main/loss" in r]
        assert [r["step"] for r in main] == list(range(1, steps + 1)), main
        assert all(np.isfinite(r["main/loss"]) and np.isfinite(r["main/grad_norm"])
                   for r in main), "non-finite loss or gradient norm"
        assert any("evaluation/Dur_Loss" in r for r in recs), "the save interval did not fire"
        log(f"train path: {steps} steps in {wall:.1f} s (set-up, first-step plans and one "
            f"async save + predictor evaluation included); loss {main[0]['main/loss']:.1f} -> "
            f"{main[-1]['main/loss']:.1f}, grad_norm {main[0]['main/grad_norm']:.1f} -> "
            f"{main[-1]['main/grad_norm']:.1f}; peak device memory {peak:.2f} GiB")
        late = [r for r in main if r["step"] > 3]
        log(f"train path: host clock per step after the first three, data wait included: "
            f"{statistics.median(r['main/wall_s'] for r in late) * 1e3:.1f} ms median, "
            f"{statistics.median(r['main/mel_frames_per_s'] for r in late):.0f} mel-frames/s")
        log(f"train path launches: {counts}")
        want = 8 * accum * steps
        got = (counts["attention_train_packed"], counts["attention_train_packed.bwd"])
        assert got == (want, want), f"kernel 11 launches {got}, expected {want} each"
        assert counts["attention_train"] == 0 and counts["attention_block"] == 0
        results["attention_train_packed"]["launches"] = got[0]
        results["attention_train_packed"]["launches_bwd"] = got[1]

        ckpts = sorted(Path(work, "out/checkpoints/smoke").glob("ckpt_*.npz"))
        assert [c.name for c in ckpts] == ["ckpt_00000006.npz", "ckpt_00000010.npz"], ckpts
        fresh = FastSpeech2(cfg)
        assert load_checkpoint(str(ckpts[-1]), fresh)[0] == steps
        for (n, a), (_, b) in zip(ts.model.named_parameters(), fresh.named_parameters()):
            assert torch.equal(a, b), f"checkpoint reload: {n} differs"
        moved = float((next(fresh.parameters()) - next(FastSpeech2(
            cfg, generator=torch.Generator().manual_seed(cfg.train.seed)).parameters()
        )).abs().max())
        log(f"train path: final checkpoint reloads to the same parameters; the embedding "
            f"table moved by up to {moved:.2e} from its initial values")
        assert moved > 0

        # the same two steps through kernel 12
        reset_counts()
        flags.FUSED_ATT_TRAIN_PACKED = False
        try:
            ts2 = train(cfg, "smoke", f"{work}/out", max_steps=2, resume_path=str(ckpts[-1]))
            torch.cuda.synchronize()
        finally:
            flags.FUSED_ATT_TRAIN_PACKED = True
        counts = read_counts()
        log(f"switch FUSED_ATT_TRAIN_PACKED=off, 2 steps from step {steps}: launches {counts}")
        assert ts2.step == steps + 2
        got = (counts["attention_train"], counts["attention_train.bwd"])
        assert got == (8 * accum * 2,) * 2 and counts["attention_train_packed"] == 0, counts
        results["attention_train"]["launches"] = got[0]
        results["attention_train"]["launches_bwd"] = got[1]
        recs = [json.loads(ln) for ln in open(f"{work}/out/logs/smoke/train_metrics.jsonl")]
        tail = [r for r in recs if "main/loss" in r and r["step"] > steps]
        assert len(tail) == 2 and all(np.isfinite(r["main/loss"]) for r in tail)

        # timed steps on one full window (64 utterances), CUDA events
        model, opt = ts.model, ts.optimizer
        step_fn = make_train_step(model, opt, accum, bf16=True)
        batch_np, shape = next(iter(BucketBatcher(
            ds, batch_size=bsz * accum, seed=1).epoch(0)))
        dev_batch = batch_to_device(batch_np, model.device)
        frames = int(batch_np.olens.sum())
        sched = SeedSchedule(model.dropout_sites(), seed=123)
        one = lambda: step_fn(ts, dev_batch, [sched.draw() for _ in range(accum)])  # noqa: E731
        one()
        ms, _ = timed_calls(torch, one, n=7)
        log(f"train step (B=16 x accum 4, pad {shape}, {frames} frames): {ms:.1f} ms median "
            f"of 7 (CUDA events), {frames / ms * 1e3:.0f} mel-frames/s")
        by_name = profile_phase(torch, one, "train step")
        groups = {"training attention kernels": 0.0,
                  "int64 elementwise + arange (hash dropout masks)": 0.0,
                  "GEMM and convolution (cuBLAS, cuDNN)": 0.0, "other plain ops": 0.0}
        for k, v in by_name.items():
            low = k.lower()
            if "train_fwd" in low or "train_bwd" in low:
                groups["training attention kernels"] += v
            elif "long" in low or "arange" in low:
                groups["int64 elementwise + arange (hash dropout masks)"] += v
            elif any(w in low for w in ("gemm", "cutlass", "cudnn", "xmma", "wgrad",
                                        "dgrad", "conv", "sm90_", "sm80_")):
                groups["GEMM and convolution (cuBLAS, cuDNN)"] += v
            else:
                groups["other plain ops"] += v
        total = sum(by_name.values())
        for k, v in groups.items():
            if by_name:
                log(f"profile train step: {v:8.3f} ms  {v / total:.3f} of device time  {k}")
        return ms, frames
    finally:
        shutil.rmtree(work, ignore_errors=True)


def tb_tags(log_dir):
    """{tag: steps} of the summaries (non-scalar) in log_dir's TensorBoard
    event files (TFRecord framing; the tensorboard package's Event proto)."""
    from tensorboard.compat.proto.event_pb2 import Event

    tags = {}
    for f in sorted(Path(log_dir).glob("events.out.tfevents*")):
        data, pos = f.read_bytes(), 0
        while pos < len(data):
            (n,) = struct.unpack("<Q", data[pos: pos + 8])
            ev = Event.FromString(data[pos + 12: pos + 12 + n])
            pos += 16 + n
            for v in ev.summary.value:
                if not v.HasField("simple_value"):
                    tags.setdefault(v.tag, []).append(ev.step)
    return tags


def run_cli(args, what, env=None, timeout=600):
    """``python -m fastspeech2_tpu_torch ARGS`` in its own process; (stderr,
    seconds). Fails with the tail of its output unless it exits 0."""
    import os

    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "fastspeech2_tpu_torch", *args], cwd=str(ROOT),
                       env={**os.environ, "PYTHONPATH": str(ROOT), **(env or {})},
                       capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"{what} exited {r.returncode}:\n{r.stderr[-3000:]}")
    return r.stderr, secs


def cli_main(torch, args):
    """cli.main(ARGS) in this process: (standard output, seconds)."""
    import io

    from fastspeech2_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(args)
    torch.cuda.synchronize()
    return buf.getvalue(), time.perf_counter() - t0


def cli_train_phase(torch, results, store, smi):
    """The training and checkpoint commands on the card, at full width
    (CLI_TRAIN_DEPTH: two encoder and two decoder blocks, the depth cut to
    keep the run inside its time limit) in bf16 on the train path's store:
    ``train`` (subprocess; 4 steps of 16 x 4,
    validation sample and saves every 2 steps, --profile_dir), ``train -p``
    one step with FS2_FUSED_ATT_TRAIN_PACKED=off (subprocess, kernel 12),
    ``evaluate`` (against the CPU port), ``average``, ``convert`` .npz ->
    .pth -> .npz, ``synth`` of the .pth and the .npz, ``gta`` on 16
    utterances (against the CPU port), and the bucketed B=32 mel call
    against the unbucketed one."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from fastspeech2_tpu_torch.config import Config, DataConfig
    from fastspeech2_tpu_torch.data.dataset import TTSDataset
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from fastspeech2_tpu_torch.train.gta import generate_gta
    from fastspeech2_tpu_torch.train.loop import evaluate_predictors

    root, fl = store
    work = Path(tempfile.mkdtemp(prefix="fs2_cli_train_", dir=str(ROOT / "build")))
    try:
        valid = work / "valid16.txt"
        valid.write_text("".join(open(fl).readlines()[:16]))
        cfg = Config()
        blocks = CLI_TRAIN_DEPTH["elayers"] + CLI_TRAIN_DEPTH["dlayers"]
        cfg = dataclasses.replace(
            cfg, data=DataConfig(data_dir=root, train_filelist=fl, valid_filelist=str(valid)),
            model=dataclasses.replace(cfg.model, **CLI_TRAIN_DEPTH),
            train=dataclasses.replace(cfg.train, bf16=True, summary_interval=1,
                                      validation_step=2, save_interval=2, keep_ckpts=5))
        (work / "train.yaml").write_text(cfg.to_yaml())
        out, prof = work / "out", work / "prof"
        err, secs = run_cli(["train", "-c", str(work / "train.yaml"), "-n", "smoke", "-o",
                             str(out), "--max_steps", "4", "--profile_dir", str(prof)],
                            "CLI train")
        counts = json.loads(re.findall(r"kernel launches: (\{.*\})", err)[-1])
        recs = [json.loads(ln) for ln in open(out / "logs/smoke/train_metrics.jsonl")]
        walls = [r["main/wall_s"] * 1e3 for r in recs if "main/loss" in r]
        assert len(walls) == 4 and all(np.isfinite(r["main/loss"]) for r in recs
                                       if "main/loss" in r)
        log(f"CLI train: 4 steps (16 x 4, bf16) in {secs:.1f} s of process (start, build, "
            f"two validations with the sample, two saves with evaluation, the trace); host "
            f"clock between step summaries {', '.join(f'{w:.0f}' for w in walls)} ms (step 2 "
            f"alone; steps 1, 3 and 4 also hold the first step's set-up, step 2's "
            f"validation and save, the profiler) on {smi}")
        want = blocks * 4 * 4
        got = (counts["attention_train_packed"], counts["attention_train_packed.bwd"])
        log(f"CLI train launches: { {k: v for k, v in counts.items() if v} }")
        assert got == (want, want) and counts["attention_train"] == 0, counts
        results["attention_train_packed"]["launches_cli_train_step"] = got[0] // 4
        ckpts = sorted(p.name for p in (out / "checkpoints/smoke").glob("ckpt_*.npz"))
        assert ckpts == ["ckpt_00000002.npz", "ckpt_00000004.npz"], ckpts
        tags = tb_tags(out / "logs/smoke")
        sample = {"validation/mel_target", "validation/mel_predicted",
                  "validation/audio_predicted", "validation/audio_target"}
        assert all(tags.get(t) == [2, 4] for t in sample), tags
        traces = sorted(prof.glob("trace_steps_*.json"))
        assert [t.name for t in traces] == ["trace_steps_4-4.json"], traces
        log(f"CLI train: validation tags {sorted(tags)} at steps 2 and 4; trace "
            f"{traces[0].name} ({traces[0].stat().st_size / 2 ** 20:.1f} MiB)")
        ck2, ck4 = (str(out / "checkpoints/smoke" / c) for c in ckpts)

        err, secs = run_cli(["train", "-c", str(work / "train.yaml"), "-n", "smoke", "-o",
                             str(out), "--max_steps", "1", "-p", ck4], "CLI train -p",
                            env={"FS2_FUSED_ATT_TRAIN_PACKED": "off"})
        counts = json.loads(re.findall(r"kernel launches: (\{.*\})", err)[-1])
        got = (counts["attention_train"], counts["attention_train.bwd"])
        log(f"CLI train -p (FS2_FUSED_ATT_TRAIN_PACKED=off): 1 step from step 4 in "
            f"{secs:.1f} s of process on {smi}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        assert got == (blocks * 4,) * 2 and counts["attention_train_packed"] == 0, counts
        assert (out / "checkpoints/smoke/ckpt_00000005.npz").exists()
        results["attention_train"]["launches_cli_train_step"] = got[0]

        stdout, secs = cli_main(torch, ["evaluate", "-p", ck4])
        card = json.loads(stdout)
        cpu_model = FastSpeech2(cfg, device="cpu")
        load_checkpoint(ck4, cpu_model)
        vds = TTSDataset(root, str(valid))
        cpu = evaluate_predictors(cpu_model, vds)
        log(f"CLI evaluate (16 utterances): {secs:.2f} s on {smi}; card {card}, CPU port "
            f"{cpu}")
        assert sorted(card) == ["Dur_Loss", "Energy_Loss", "Pitch_Loss"]
        for k, v in cpu.items():  # f32 both sides, TF32 off on the card
            assert np.isfinite(card[k]) and abs(card[k] - v) <= 1e-4 * abs(v) + 1e-5, (k, card, cpu)

        avg = str(work / "avg.npz")
        _, secs = cli_main(torch, ["average", ck2, ck4, "-o", avg])
        log(f"CLI average of 2 checkpoints: {secs:.2f} s on {smi}")
        # a deployable model: the duration bias of the smoke's serving models
        model = FastSpeech2(cfg)
        step, _ = load_checkpoint(avg, model)
        assert step == 4
        with torch.no_grad():
            model.duration_predictor.out.bias.fill_(1.87)
        deploy = str(work / "deploy.npz")
        save_checkpoint(deploy, model, None, step, cfg)
        pth, back = str(work / "deploy.pth"), str(work / "back.npz")
        _, s1 = cli_main(torch, ["convert", "-p", deploy, "-o", pth])
        _, s2 = cli_main(torch, ["convert", "-p", pth, "-o", back])
        with np.load(deploy) as a, np.load(back) as b:
            keys = sorted(k for k in a.files if k != "__meta__")
            assert keys == sorted(k for k in b.files if k != "__meta__")
            for k in keys:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        log(f"CLI convert .npz -> .pth {s1:.2f} s, .pth -> .npz {s2:.2f} s on {smi}: "
            f"{len(keys)} arrays bit for bit")
        mels = {}
        for src in (deploy, pth):
            d = work / ("synth_" + Path(src).suffix[1:])
            _, secs = cli_main(torch, ["synth", "-p", src, "--phonemes", "--text", SENTENCES[0],
                                "-o", str(d)])
            mels[src] = np.load(d / "mel.npy")
            log(f"CLI synth -p {Path(src).name}: mel {mels[src].shape} in {secs:.2f} s on {smi}")
        assert mels[deploy].shape[1] > 5 and np.array_equal(mels[deploy], mels[pth])

        _, secs = cli_main(torch, ["gta", "-p", ck4, "-o", str(work / "gta"),
                                   "--filelist", str(valid)])
        n = generate_gta(cpu_model, vds, str(work / "gta_cpu"))
        names = sorted(p.name for p in (work / "gta").glob("*.npy"))
        assert n == len(names) == 16
        worst = 0.0
        for name in names:
            a, b = np.load(work / "gta" / name), np.load(work / "gta_cpu" / name)
            assert a.shape == b.shape and a.shape[0] == 80 and np.isfinite(a).all()
            worst = max(worst, float(np.abs(a - b).max()))
        log(f"CLI gta: 16 utterances in {secs:.2f} s on {smi} ({secs / 16 * 1e3:.1f} ms an "
            f"utterance, process-internal, model load included); max abs against the CPU "
            f"port {worst:.2e} (tolerance 1e-3, f32 both sides)")
        assert worst < 1e-3
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # the bucketed B=32 mel call against the unbucketed rows of the batch
    synth = Synthesizer(seeded_model(torch, Config()), bf16=True)
    b32 = batch(32)
    synth.mel_from_token_batch(b32)
    synth.mel_from_token_batch_bucketed(b32, max_buckets=3)
    torch.cuda.synchronize()
    reset_counts()
    mel_b, lens_b = synth.mel_from_token_batch_bucketed(b32, max_buckets=3)
    torch.cuda.synchronize()
    counts = read_counts()
    plan = synth._bucket_plan([len(x) for x in b32], 3, 1.0)
    log(f"bucketed B=32 (max_buckets 3): buckets of {[len(g) for g in plan]} rows; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    for k in ("attention_block", "ffn_block", "variance_adaptor", "postnet"):
        assert counts[k] > 0, f"kernel {k} was not launched by the bucketed call"
        results[k]["launches_bucketed_b32"] = counts[k]
    mel_u, lens_u = synth.mel_from_token_batch(b32)
    assert np.array_equal(lens_b, lens_u), "bucketed and unbucketed out_lens differ"
    L = min(mel_b.shape[1], mel_u.shape[1])
    live = np.arange(L)[None] < lens_b[:, None]
    for i in range(len(b32)):
        compare(f"bucketed B=32 row {i} ({int(lens_b[i])} frames) vs unbucketed",
                torch.from_numpy(mel_b[i, :L][live[i]]),
                torch.from_numpy(mel_u[i, :L][live[i]]), 0.02, 0.2)
    ms_b, _ = timed_calls(torch, lambda: synth.mel_from_token_batch_bucketed(b32, max_buckets=3))
    ms_u, _ = timed_calls(torch, lambda: synth.mel_from_token_batch(b32))
    log(f"B=32 mel call: bucketed {ms_b:.3f} ms, unbucketed {ms_u:.3f} ms (median of 5, CUDA "
        f"events) on {smi}")


def batch(n: int, offset: int = 0):
    from fastspeech2_tpu_torch.text import phonemes_to_sequence
    import numpy as np

    seqs = []
    for i in range(n):
        toks = SENTENCES[(i + offset) % len(SENTENCES)].split()
        # 20..120 phonemes: cut or repeat to a per-row target length
        want = 20 + (37 * (i + offset)) % 101
        toks = (toks * (want // len(toks) + 1))[:want]
        seqs.append(np.asarray(phonemes_to_sequence(toks), np.int64))
    return seqs


def hold_b8_vs_cpu(torch, synth, cfg, what, cpu_model=None, split=True):
    """One B=8 batch served through the timed path with the 2-way split
    engaged (``split=False``: however the dispatch groups it); every served
    row is held against the same port on the CPU (plain versions;
    ``cpu_model``, default a CPU copy of the served model) fed the card's
    durations (live frames do not depend on the decode rung, so one CPU
    decode at the longer rung covers both)."""
    import numpy as np

    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.ops import make_non_pad_mask
    from fastspeech2_tpu_torch.ops.length_regulator import frame_demand, scale_durations
    from fastspeech2_tpu_torch.ops.precision import compute_dtype

    model = synth.model
    seqs = batch(8, offset=8)
    mel_s, lens_s = synth.mel_from_token_batch(seqs)
    B, t_pad, _, xs_g, il_g, alphas = synth._pad_batch(seqs, 1.0)
    with synth._cd():
        _, d_g = model.encode(xs_g, il_g)
        demand = frame_demand(scale_durations(d_g, alphas), make_non_pad_mask(il_g, t_pad))
    groups = synth._decode_groups(demand.cpu().numpy())
    log(f"{what}: B=8 decode groups (rows, rung): {[(g.tolist(), r) for g, r in groups]}")
    assert len(groups) == 2 or not split, "the 2-way split did not engage on the B=8 batch"
    rung = max(r for _, r in groups)
    assert mel_s.shape[1] == rung, (mel_s.shape, rung)
    if cpu_model is None:
        cpu_model = FastSpeech2(cfg, device="cpu")
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    xs_c, il_c, d_g = xs_g.cpu(), il_g.cpu(), d_g.cpu()
    with compute_dtype(torch.bfloat16), torch.inference_mode():
        hs_c, d_c = cpu_model.encode(xs_c, il_c)
        mel_c, lens_c = cpu_model.decode_frames(hs_c, d_g, il_c, out_maxlen=rung)
    dur_match = float((d_c == d_g).float().mean())
    log(f"{what} on the card vs CPU plain versions: durations agree on "
        f"{dur_match:.4f} of tokens")
    assert np.array_equal(lens_s, lens_c[:B].numpy()), "out_lens differ"
    live = torch.from_numpy(np.arange(rung)[None] < lens_s[:, None])
    for i in range(B):
        compare(f"{what} row {i} ({int(lens_s[i])} frames)",
                torch.from_numpy(mel_s[i])[live[i]], mel_c[i][live[i]], 0.02, 0.2)
    compare(f"{what} mel, live frames, card kernels vs CPU plain (bf16 band)",
            torch.from_numpy(mel_s)[live], mel_c[:B][live], 0.02, 0.2)


def main_path_phase(torch, results):
    import numpy as np

    from fastspeech2_tpu_torch.config import Config
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2

    mel_kernels = ("attention_block", "ffn_block", "variance_adaptor", "postnet")
    cfg = Config()
    torch.manual_seed(0)
    model = FastSpeech2(cfg)  # device None: the card
    with torch.no_grad():
        model.duration_predictor.out.bias.fill_(1.87)
    synth = Synthesizer(model, bf16=True)
    b32 = batch(32)
    synth.mel_from_token_batch(b32)  # warm: packs the kernel weights
    torch.cuda.synchronize()

    reset_counts()
    outs = {}
    for n in (1, 8, 32):
        mel, lens, trunc = synth.mel_from_token_batch(batch(n, offset=n), return_truncated=True)
        outs[n] = (mel, lens)
        assert np.isfinite(mel).all(), f"B={n}: non-finite mel"
        assert (lens > 0).all(), f"B={n}: empty output"
        log(f"main path B={n}: mel {mel.shape}, frames {int(lens.sum())}, "
            f"truncated {int(trunc.sum())}")
    counts = read_counts()
    log(f"mel path launches (B=1,8,32): {counts}")
    for k in mel_kernels:
        assert counts[k] > 0, f"kernel {k} was not launched on the mel path"
        results[k]["launches"] = counts[k]

    # per B=32 call: how often each kernel runs (with the 2-way split)
    reset_counts()
    synth.mel_from_token_batch(b32)
    log(f"launches per B=32 mel call: {read_counts()}")

    hold_b8_vs_cpu(torch, synth, cfg, "B=8 served")

    # B=32 throughput, CUDA events around whole serving calls
    frames = int(outs[32][1].sum())
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        _, lens = synth.mel_from_token_batch(b32)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    frames = int(lens.sum())
    ms = statistics.median(times)
    log(f"B=32 serving call: {ms:.3f} ms median of 5, {frames} mel frames, "
        f"{frames / ms * 1e3:.0f} mel-frames/s")
    profile_phase(torch, lambda: synth.mel_from_token_batch(b32), "B=32 mel call")
    return ms, frames, synth


def profile_phase(torch, call, what):
    """Where one serving call's time goes: device time by kernel name and
    the device's busy share of the call (torch.profiler, CUPTI). Returns
    {kernel name: device ms}."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        log(f"profile {what}: no device events recorded (device time not measured)")
        return {}
    by_name, busy, end = {}, 0.0, float("-inf")
    for a, b, name in sorted(spans):
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    log(f"profile {what}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({busy / wall_us:.3f} of wall), {len(spans)} device events")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  {us / 1e3:8.3f} ms  {us / wall_us:6.3f}  {name[:90]}")
    log(f"profile {what}, host side (self CPU time by op):")
    for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]:
        log(f"  {e.self_cpu_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:80]}")
    return {k: v / 1e3 for k, v in by_name.items()}


def reset_counts():
    from fastspeech2_tpu_torch.ops.kernels import reset_launch_counts

    reset_launch_counts()


def read_counts():
    from fastspeech2_tpu_torch.ops.kernels import launch_counts

    return launch_counts()


def timed_calls(torch, call, n=5):
    """Median ms of n calls, CUDA events around each whole call."""
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def wav_path_phase(torch, results, synth):
    """The fused text -> wav path: default MelGAN (bf16, seed 0) attached to
    the mel phase's synthesizer."""
    import numpy as np

    from fastspeech2_tpu_torch.infer.synthesize import mel_floor_mask, pcm16
    from fastspeech2_tpu_torch.vocoder.melgan import MelGANGenerator

    gen = MelGANGenerator(bf16=True, seed=0)  # device None: the card
    synth.attach_vocoder(gen)
    hop = synth.hop_length
    t0 = time.perf_counter()
    calls = synth.warmup(batch_sizes=(1, 32), token_lens=(32, 128))
    torch.cuda.synchronize()
    log(f"wav path warmup: {calls} calls in {time.perf_counter() - t0:.1f} s "
        f"(peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")

    reset_counts()
    outs = {}
    for n in (1, 8, 32):
        before = read_counts()["resstack"]
        outs[n] = synth.wav_from_token_batch(batch(n, offset=n), return_truncated=True)
        per_call = read_counts()["resstack"] - before
        # 4 stages per decode group; the B=32 batch splits 2 ways
        assert per_call == 8 if n == 32 else per_call in (4, 8), (n, per_call)
    counts = read_counts()
    log(f"wav path launches (B=1,8,32): {counts}")
    for k in ("attention_block", "ffn_block", "variance_adaptor", "postnet", "resstack"):
        assert counts[k] > 0, f"kernel {k} was not launched on the wav path"
    results["resstack"]["launches"] = counts["resstack"]
    for n, (mel, wav, wav_lens, trunc) in outs.items():
        mel_m, lens_m = synth.mel_from_token_batch(batch(n, offset=n))
        assert wav.dtype == np.int16 and wav.shape == (n, mel.shape[1] * hop), wav.shape
        assert np.array_equal(wav_lens, lens_m * hop), "wav_lens != out_lens * hop"
        dmel = float(np.abs(mel - mel_m).max())
        assert dmel <= 1e-6, f"B={n}: wav path's mel differs from the mel path's ({dmel})"
        live = np.arange(wav.shape[1])[None] < wav_lens[:, None]
        assert np.abs(wav[live]).max() > 0, f"B={n}: silent output"
        log(f"wav path B={n}: wav {wav.shape} int16, {int(wav_lens.sum())} samples, "
            f"peak |pcm| {int(np.abs(wav[live]).max())}, truncated {int(trunc.sum())}, "
            f"mel == mel path (max diff {dmel:.1e})")

    # B=8: the card's wav against the CPU port's generator (plain versions of
    # the kernel, every op rounded to bf16) fed the card's mel, two rows of
    # each decode group at the group's own rung (a buffer's end is a
    # reflection edge). Band: the relative size of the JAX package's own
    # fused-vs-unfused bf16 gap that tests/test_torch_port_vocoder.py holds
    # the port inside (max 0.12, mean 0.04 of the output's peak).
    groups = []
    real = synth._decode_groups
    synth._decode_groups = lambda dem: (groups.append(real(dem)), groups[-1])[1]
    try:
        mel, wav, wav_lens = synth.wav_from_token_batch(batch(8, offset=8))
    finally:
        del synth._decode_groups
    assert len(groups[-1]) == 2, "the 2-way split did not engage on the B=8 wav batch"
    lens = wav_lens // hop
    cpu_gen = MelGANGenerator(bf16=True, fused_resstack=True, device="cpu")
    cpu_gen.load_state_dict({k: v.cpu() for k, v in gen.state_dict().items()})
    for rows, rung in groups[-1]:
        rows = np.asarray([r for r in rows if r < 8][:2])
        m = torch.from_numpy(mel[rows, :rung])
        want = pcm16(cpu_gen(mel_floor_mask(m, torch.from_numpy(lens[rows])))).numpy()
        got = wav[rows, :rung * hop]
        peak = float(np.abs(want).max())
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        log(f"B=8 wav rows {rows.tolist()} at rung {rung} vs CPU plain generator: "
            f"max {int(d.max())} LSB, mean {d.mean():.2f} LSB, peak {int(peak)} "
            f"(tolerance max<{0.12 * peak:.0f} mean<{0.04 * peak:.1f})")
        assert d.max() < 0.12 * peak and d.mean() < 0.04 * peak, "card wav off the CPU plain"

    b32 = batch(32)
    ms_mel, _ = timed_calls(torch, lambda: synth.mel_from_token_batch(b32))
    ms, out = timed_calls(torch, lambda: synth.wav_from_token_batch(b32))
    secs = float(out[2].sum()) / 22050.0
    log(f"B=32 wav call: {ms:.3f} ms median of 5, {secs:.1f} s of audio, "
        f"{secs / ms * 1e3:.0f} audio-seconds/s; same batch as mel only {ms_mel:.3f} ms: "
        f"vocoder + PCM + wav copy take {(ms - ms_mel) / ms:.3f} of the call")
    # what device.py's process-wide switch costs the serving path: the same
    # two calls with reduced-precision reductions of bf16 GEMMs refused (the
    # port's setting), allowed, allowed, refused, inside one run
    matmul = torch.backends.cuda.matmul
    for allow in (False, True, True, False):
        matmul.allow_bf16_reduced_precision_reduction = allow
        synth.wav_from_token_batch(b32)
        ab_mel, _ = timed_calls(torch, lambda: synth.mel_from_token_batch(b32))
        ab_wav, _ = timed_calls(torch, lambda: synth.wav_from_token_batch(b32))
        log(f"B=32 calls with bf16 reduced-precision reduction "
            f"{'allowed' if allow else 'refused'}: mel {ab_mel:.3f} ms, wav {ab_wav:.3f} ms")
    by_name = profile_phase(torch, lambda: synth.wav_from_token_batch(b32), "B=32 wav call")
    rs = sum(v for k, v in by_name.items() if "resstack" in k)
    if by_name:
        log(f"profile B=32 wav call: resstack kernels {rs:.3f} ms of "
            f"{sum(by_name.values()):.3f} ms device time")
    return ms, secs


def wide_vocoder_phase(torch, results, synth, default_ms):
    """A base_channels: 1024 MelGAN (stages 512, 256, 128, 64; bf16, seed 0)
    attached to the main path's synthesizer: kernel 13's launches per call
    (the 512-channel stage on the wide path, two launches a dilated block),
    one row of each decode group of the B=8 wav call against the CPU port's
    generator (plain versions, bf16) on the first 96 frames of the card's mel
    (compared over the first 64: the receptive field is ~10 frames), in the
    band wav_path_phase holds the default generator to; the B=32 wav call
    timed beside the default generator's. Then f32 generators at
    base_channels 1024 and 500 (stages 250, 125, 62, 31: zero-padded to 256,
    128, 64, 32) vocode a B=2 mel on the card and on the CPU: max < 1e-4 of
    the peak, the band the golden phase holds the f32 tier's mel to. The
    default generator is attached again at the end."""
    import numpy as np

    from fastspeech2_tpu_torch.infer.synthesize import mel_floor_mask, pcm16
    from fastspeech2_tpu_torch.vocoder.melgan import MelGANConfig, MelGANGenerator

    t_phase = time.perf_counter()
    default = synth._voc
    gen = MelGANGenerator(MelGANConfig(base_channels=1024), bf16=True, seed=0)
    synth.attach_vocoder(gen)
    hop = synth.hop_length
    try:
        groups = []
        real = synth._decode_groups
        synth._decode_groups = lambda dem: (groups.append(real(dem)), groups[-1])[1]
        try:
            reset_counts()
            mel, wav, wav_lens = synth.wav_from_token_batch(batch(8, offset=8))
            per_call = read_counts()["resstack"]
        finally:
            del synth._decode_groups
        n_groups = len(groups[-1])
        log(f"wide MelGAN (base_channels 1024, bf16): {per_call} kernel 13 launches a B=8 "
            f"call of {n_groups} decode groups (expected {n_groups} x (6 + 1 + 1 + 1))")
        assert per_call == 9 * n_groups, (per_call, n_groups)
        results["resstack"]["launches_wide_melgan_b8"] = per_call
        lens = wav_lens // hop
        cpu_gen = MelGANGenerator(MelGANConfig(base_channels=1024), bf16=True,
                                  fused_resstack=True, device="cpu")
        cpu_gen.load_state_dict({k: v.cpu() for k, v in gen.state_dict().items()})
        for rows, rung in groups[-1]:
            row = int([r for r in rows if r < 8][0])
            m = torch.from_numpy(mel[row:row + 1, :rung])
            m = mel_floor_mask(m, torch.from_numpy(lens[row:row + 1]))[:, :96]
            with torch.inference_mode():
                want = pcm16(cpu_gen(m)).numpy()[0, :64 * hop]
            got = wav[row, :64 * hop]
            peak = float(np.abs(want).max())
            d = np.abs(got.astype(np.int32) - want.astype(np.int32))
            log(f"wide MelGAN B=8 row {row} (rung {rung}), first 64 frames vs CPU plain "
                f"generator: max {int(d.max())} LSB, mean {d.mean():.2f} LSB, peak {int(peak)} "
                f"(tolerance max<{0.12 * peak:.0f} mean<{0.04 * peak:.1f})")
            assert d.max() < 0.12 * peak and d.mean() < 0.04 * peak, "wide wav off the CPU plain"
        b32 = batch(32)
        synth.wav_from_token_batch(b32)
        reset_counts()
        ms, out = timed_calls(torch, lambda: synth.wav_from_token_batch(b32))
        per_call = read_counts()["resstack"] // 5
        secs = float(out[2].sum()) / 22050.0
        log(f"wide MelGAN B=32 wav call: {ms:.3f} ms median of 5 ({secs / ms * 1e3:.0f} "
            f"audio-seconds/s; {per_call} kernel 13 launches a call) against the default "
            f"generator's {default_ms:.3f} ms in this run ({ms / default_ms:.2f}x)")
        results["resstack"]["wide_melgan_b32_ms"] = ms
        results["resstack"]["launches_wide_melgan_b32"] = per_call
    finally:
        synth.attach_vocoder(default)
    del gen, cpu_gen
    torch.cuda.empty_cache()

    g = torch.Generator().manual_seed(500)
    mel = torch.randn(2, 64, 80, generator=g) - 4.0
    for base, expect in ((1024, 9), (500, 4)):
        cfg = MelGANConfig(base_channels=base)
        gen = MelGANGenerator(cfg, seed=0)  # f32, on the card
        cpu_gen = MelGANGenerator(cfg, fused_resstack=True, device="cpu")
        cpu_gen.load_state_dict({k: v.cpu() for k, v in gen.state_dict().items()})
        with torch.inference_mode():
            reset_counts()
            got = gen(mel.to("cuda")).cpu()
            launched = read_counts()["resstack"]
            want = cpu_gen(mel)
        peak = float(want.abs().max())
        widths = [base // 2 ** (i + 1) for i in range(4)]
        log(f"f32 MelGAN base_channels {base} (stages {widths}), B=2 x 64 frames, card vs "
            f"CPU port: {launched} kernel 13 launches (expected {expect})")
        assert launched == expect, (launched, expect)
        compare(f"f32 MelGAN {base}", got, want, 1e-5 * peak, 1e-4 * peak)
        del gen, cpu_gen
    torch.cuda.empty_cache()
    log(f"wide vocoder phase: {time.perf_counter() - t_phase:.1f} s")


@contextlib.contextmanager
def serving(synth):
    """infer.server.serve in a thread on 127.0.0.1 (an ephemeral port);
    yields its URL, then stops it and checks that it shut down."""
    import socket

    from fastspeech2_tpu_torch.config import Config
    from fastspeech2_tpu_torch.infer.server import serve

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ready, stop = threading.Event(), threading.Event()
    th = threading.Thread(target=serve, args=(synth, Config()), daemon=True,
                          kwargs=dict(host="127.0.0.1", port=port, max_batch=16,
                                      max_wait_ms=20.0, ready_event=ready, stop_event=stop))
    th.start()
    assert ready.wait(timeout=60), "server did not come up"
    try:
        yield f"http://127.0.0.1:{port}"
    finally:
        stop.set()
        th.join(timeout=60)
    assert not th.is_alive(), "the server did not shut down"


def http_post(url, path, payload):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.headers, r.read()


def riff_samples(body):
    """Sample count of a 16-bit mono RIFF body with its sizes filled in."""
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE", body[:12]
    n = struct.unpack("<I", body[40:44])[0] // 2
    assert n > 0 and n % 256 == 0 and len(body) == 44 + 2 * n, (n, len(body))
    return n


def server_phase(torch, synth):
    """serve() in a thread on 127.0.0.1 with the wav synthesizer: concurrent
    text and phoneme requests, a stream, a mel request, healthz, shutdown."""
    with serving(synth) as url:
        server_rounds(url)
    log("server: shut down cleanly")


def healthz(url):
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        return json.loads(r.read())


def concurrent_round(url, n_req, fmt):
    """n_req concurrent /synthesize requests (even: text, odd: phonemes) in
    ``fmt`` ("wav": RIFF bodies, "mel": JSON); returns (wall s, latencies s,
    batches used, total samples or frames, healthz after)."""
    lat, total, errors = [0.0] * n_req, [0] * n_req, []

    def go(i):
        payload = ({"text": TEXTS[(i // 2) % len(TEXTS)]} if i % 2 == 0 else
                   {"phonemes": SENTENCES[(i // 2) % len(SENTENCES)]})
        t0 = time.perf_counter()
        try:
            _, body = http_post(url, "/synthesize", {**payload, "format": fmt})
            if fmt == "wav":
                total[i] = riff_samples(body)
            else:
                obj = json.loads(body)
                assert obj["frames"] == len(obj["mel"]) > 0 and len(obj["mel"][0]) == 80
                total[i] = obj["frames"]
        except Exception as e:  # reported below: a thread cannot fail the run
            errors.append(f"request {i}: {e!r}")
        lat[i] = time.perf_counter() - t0

    stats0 = healthz(url)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=go, args=(i,)) for i in range(n_req)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "a request did not return"
    wall = time.perf_counter() - t0
    assert not errors, errors
    stats = healthz(url)
    n_batches = stats["batches"] - stats0["batches"]
    assert stats["requests"] - stats0["requests"] == n_req and n_batches < n_req, stats
    return wall, lat, n_batches, sum(total), stats


def server_rounds(url):
    # the batcher's two threads are new to the card: their first calls pay
    # for their own cuBLAS/cuDNN handles, which Synthesizer.warmup (run
    # from the main thread) cannot warm. Two requests, one after the
    # other, before the timed ones.
    first = []
    for text in TEXTS[:2]:
        t0 = time.perf_counter()
        riff_samples(http_post(url, "/synthesize", {"text": text, "format": "wav"})[1])
        first.append((time.perf_counter() - t0) * 1e3)
    log(f"server: first two requests after start {first[0]:.1f} ms, {first[1]:.1f} ms")
    n_req = 16

    # round 1 meets its batch shapes (token buffer x batch size) for the
    # first time; round 2 repeats them warm and is the one reported
    wall1, lat1, nb1, _, _ = concurrent_round(url, n_req, "wav")
    log(f"server: round 1 (first use of its shapes): {n_req} requests in {nb1} batches, "
        f"{n_req / wall1:.1f} requests/s, median latency "
        f"{statistics.median(lat1) * 1e3:.1f} ms, max {max(lat1) * 1e3:.1f} ms")
    wall, lat, n_batches, total, stats = concurrent_round(url, n_req, "wav")
    log(f"server: {n_req} concurrent wav requests (8 text, 8 phonemes) in "
        f"{n_batches} batches, {total / 22050.0:.1f} s of audio")
    log(f"server: {n_req / wall:.1f} requests/s, median latency "
        f"{statistics.median(lat) * 1e3:.1f} ms, max {max(lat) * 1e3:.1f} ms "
        f"(sorted ms: {[round(x * 1e3) for x in sorted(lat)]})")

    headers, body = http_post(url, "/stream", {"text": PARAGRAPH})
    assert headers.get("Transfer-Encoding") == "chunked"
    assert body[:4] == b"RIFF" and body[4:8] == b"\xff\xff\xff\xff"
    n_stream = (len(body) - 44) // 2
    assert n_stream > 0 and n_stream % 256 == 0, n_stream
    _, one = http_post(url, "/stream", {"text": PARAGRAPH.split(".")[0] + "."})
    assert len(body) > len(one), "three sentences streamed no more than one"
    obj = json.loads(http_post(url, "/synthesize", {"phonemes": SENTENCES[0]})[1])
    assert obj["frames"] == len(obj["mel"]) > 0 and len(obj["mel"][0]) == 80
    stats = {k: v for k, v in stats.items() if k != "launches"}
    log(f"server: /stream {n_stream} samples over 3 sentences, mel request "
        f"{obj['frames']} frames, healthz {stats}")


def switch_phase(torch, results, synth):
    """flags.FUSED_ATT_QKV off: q/k/v projected with plain ops, then the
    q/k/v-given attention kernel; flags.FUSED_ATT_RES off: the bare attention
    kernel inside plain projections; each held to the fused route."""
    from fastspeech2_tpu_torch.ops import flags

    model = synth.model
    seqs = batch(8, offset=8)
    B, t_pad, _, xs, ilens, alphas = synth._pad_batch(seqs, 1.0)
    with synth._cd():
        hs_f, d_f = model.encode(xs, ilens)
        mel_f, lens_f = model.decode_frames(hs_f, d_f, ilens, out_maxlen=1024, alpha=alphas)
    reset_counts()
    flags.FUSED_ATT_QKV = False
    try:
        mel_s, lens_s = synth.mel_from_token_batch(seqs)
        counts = read_counts()
        with synth._cd():
            hs_x, d_x = model.encode(xs, ilens)
            # the fused route's durations: one flipped duration would shift
            # every later frame and hide what the decoder blocks do
            mel_x, lens_x = model.decode_frames(hs_x, d_f, ilens, out_maxlen=1024,
                                                alpha=alphas)
    finally:
        flags.FUSED_ATT_QKV = True
    log(f"switch FUSED_ATT_QKV=off, B=8 mel call: launches {counts}")
    assert counts["attention_res_ln"] > 0 and counts["attention_block"] == 0, counts
    results["attention_res_ln"]["launches"] = counts["attention_res_ln"]
    assert mel_s.shape[0] == 8 and (lens_s > 0).all()
    agree = float((d_x == d_f).float().mean())
    log(f"  durations agree with the fused-QKV route on {agree:.4f} of tokens")
    assert agree > 0.98
    compare("switch: encoder states vs fused-QKV route (bf16 band)", hs_x, hs_f, 0.02, 0.2)
    assert torch.equal(lens_x, lens_f)
    live = torch.arange(1024, device=mel_f.device)[None] < lens_f[:, None]
    compare("switch: mel, live frames, same durations (bf16 band)", mel_x[live],
            mel_f[live], 0.02, 0.2)

    # FUSED_ATT_RES off: the bare attention kernel inside plain projections,
    # the residual and the post-LN LayerNorm as plain ops; the FFN kernel
    reset_counts()
    flags.FUSED_ATT_RES = False
    try:
        mel_s, lens_s = synth.mel_from_token_batch(seqs)
        counts = read_counts()
        with synth._cd():
            hs_x, d_x = model.encode(xs, ilens)
            mel_x, lens_x = model.decode_frames(hs_x, d_f, ilens, out_maxlen=1024,
                                                alpha=alphas)
    finally:
        flags.FUSED_ATT_RES = True
    log(f"switch FUSED_ATT_RES=off, B=8 mel call: launches {counts}")
    assert counts["fused_attention_packed"] > 0 and counts["ffn_block"] > 0, counts
    assert counts["attention_block"] == counts["attention_res_ln"] == 0, counts
    results["fused_attention_packed"]["launches_switch"] = counts["fused_attention_packed"]
    assert mel_s.shape[0] == 8 and (lens_s > 0).all()
    agree = float((d_x == d_f).float().mean())
    log(f"  durations agree with the fused route on {agree:.4f} of tokens")
    assert agree > 0.98
    compare("switch: encoder states vs fused route (bf16 band)", hs_x, hs_f, 0.02, 0.2)
    assert torch.equal(lens_x, lens_f)
    compare("switch: mel, live frames, same durations (bf16 band)", mel_x[live],
            mel_f[live], 0.02, 0.2)


def synthetic_utterance(n: int, g):
    """LJSpeech-like stand-in audio: a harmonic series on a slowly varying
    f0 in 90-250 Hz, a syllable-rate amplitude envelope, breath noise and a
    few unvoiced (noise-only) gaps; float32 in [-1, 1]."""
    import numpy as np

    t = np.arange(n) / 22050.0
    f0 = np.clip(g.uniform(100, 230) * (1 + 0.15 * np.sin(
        2 * np.pi * g.uniform(0.2, 0.8) * t + g.uniform(0, 6.3))), 90, 250)
    ph = 2 * np.pi * np.cumsum(f0) / 22050.0
    y = sum(g.uniform(0.2, 1.0) / k * np.sin(k * ph) for k in range(1, 9))
    y = 0.15 * y * (0.3 + 0.7 * np.sin(2 * np.pi * g.uniform(1.5, 4.0) * t) ** 2)
    for _ in range(max(1, n // 33075)):
        a = int(g.integers(0, n - 4000))
        y[a:a + int(g.integers(1500, 4000))] = 0.0
    y = y + 0.003 * g.normal(size=n)
    return np.clip(y, -1, 1).astype(np.float32)


def stft_flops(frames, n_fft, n_mels, mel_nnz):
    """The least f32 operations of STFT magnitude -> mel -> log, plus energy:
    per frame the window, a real FFT (a complex FFT of n_fft/2 points,
    5 (n/2) log2(n/2), then a twiddle product and four adds per bin), the
    power and its root, the mel projection over the filterbank's nonzero
    weights, the clamp and log, and the energy's sum and root."""
    half = n_fft // 2
    n_freq = half + 1
    per_frame = (n_fft + 5 * half * (half.bit_length() - 1) + 10 * n_freq
                 + 4 * n_freq + 2 * mel_nnz + 2 * n_mels + n_freq + 1)
    return frames * per_frame


def hann(win_length):
    """The periodic hann window in float64."""
    import numpy as np

    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win_length) / win_length)


def cufft_mel_energy(torch, y, fb, n_fft, hop, win_length, clip=1e-5):
    """Kernel 14's function composed of PyTorch calls on cuFFT, its library
    yardstick (the port never calls it): torch.stft (center, reflect pad,
    the periodic hann window) -> |X| -> the f32 mel product -> clamp/log, and
    the energy."""
    window = torch.from_numpy(hann(win_length)).float().to(y.device)
    X = torch.stft(y, n_fft, hop_length=hop, win_length=win_length, window=window,
                   center=True, pad_mode="reflect", return_complex=True)
    mag = X.abs()
    return torch.log(torch.clamp(fb @ mag, min=clip)), torch.sqrt((mag * mag).sum(1))


def f64_errors(y, fb, hop, win_length, mel, en, clip=1e-5):
    """Against numpy's float64 rfft of the float64-padded, float64-windowed
    frames and the float64 mel product: the max abs log-mel error over the
    entries whose mel exceeds 10 clip (0 where none does: a filterbank of a
    few bins at hop 1), and the max energy error over the energy's peak."""
    import numpy as np

    n_fft = 4 * hop
    yp = np.pad(y.double().cpu().numpy(), ((0, 0), (n_fft // 2, n_fft // 2)),
                mode="reflect")
    lpad = (n_fft - win_length) // 2
    w = np.pad(hann(win_length), (lpad, n_fft - win_length - lpad))
    F = y.shape[1] // hop + 1
    frames = np.lib.stride_tricks.sliding_window_view(yp, n_fft, axis=1)[:, ::hop][:, :F]
    mag = np.abs(np.fft.rfft(frames * w, axis=-1))
    tmel = np.einsum("mk,bfk->bmf", fb.double().cpu().numpy(), mag)
    te = np.sqrt((mag ** 2).sum(-1))
    live = tmel > 10 * clip
    lm = np.log(np.maximum(tmel, clip))
    return (float(np.abs(mel.double().cpu().numpy() - lm)[live].max(initial=0.0)),
            float(np.abs(en.double().cpu().numpy() - te).max() / te.max()))


# kernel 14's shapes: the preprocess path's longest bucket and its shortest
# (22.05 kHz, hop 256), and 10.4 s rows at 16 kHz (hop 200) and 44.1 kHz
# (hop 512), n_fft = 4 hop
STFT_SHAPES = ((8, 229_376, 256, 80), (8, 16_384, 256, 80), (8, 163_840, 200, 80),
               (8, 458_752, 512, 80))
# the hops past kernel 14's first range, in 10 s rows of their corpora: 7
# and 28 (under 32: 15 and 57 bins), 220 and 275 (22.05 kHz at 10 and 12.5
# ms: factors 11), 257 (a direct DFT pass of 257 points), 441 (44.1 kHz at
# 10 ms: 7s), 600 (48 kHz at 12.5 ms), 1024 (four frames a block)
STFT_NEW_SHAPES = ((8, 220_500, 7, 8), (8, 220_500, 28, 40), (8, 220_500, 220, 80),
                (8, 220_500, 257, 80), (8, 220_500, 275, 80), (8, 441_000, 441, 80),
                (8, 480_000, 600, 80), (8, 480_000, 1024, 80))
# hops past 1024 in 10 s rows at 96 kHz: 1025 (a direct DFT pass of 41)
# and 1200 (12.5 ms) at four frames a block, 1536 and 2048 at two, and the
# bound 2616 (a direct pass of 109) at one
STFT_PAST_1024_SHAPES = ((4, 960_000, 1025, 80), (4, 960_000, 1200, 80),
                         (4, 960_000, 1536, 80), (4, 960_000, 2048, 80),
                         (4, 960_000, 2616, 80))


def stft_kernel_phase(torch, results):
    """Kernel 14 against its plain version (full f32) at STFT_SHAPES, row 0
    silent after its first tenth (a bucket's zero tail); float64 errors of
    the kernel, the plain version and the cuFFT composition; events and
    profiler device time beside the bound and the cuFFT composition's; no
    ptxas spill in the library."""
    import numpy as np

    from fastspeech2_tpu_torch.audio.stft import mel_filterbank
    from fastspeech2_tpu_torch.ops.kernels import common
    from fastspeech2_tpu_torch.ops.kernels import stft as KS

    report = [ln.strip() for ln in common.ptxas_report("stft").splitlines()
              if "spill" in ln or "registers" in ln]
    for ln in report:
        log(f"  ptxas stft: {ln}")
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        "\n".join(report))
    assert spills and all(sp == ("0", "0") for sp in spills), "ptxas spilled in stft"
    dev = torch.device("cuda")
    g = np.random.default_rng(14)
    r = results.setdefault("stft_mel_energy", {
        "name": "stft_mel_energy", "route": "cuda",
        "source": "fastspeech2_tpu_torch/csrc/stft.cu",
        "replaces": "fastspeech2_tpu/ops/pallas/stft.py:68", "max_abs_err": 0.0,
        "ms": {}, "plain_ms": {}, "bound_ms": {}, "bound_by": {}, "library_ms": {},
        "main_shape": "B=8,N=229376,hop=256"})  # the longest bucket of the corpus
    for B, N, hop, n_mels in STFT_SHAPES + STFT_NEW_SHAPES + STFT_PAST_1024_SHAPES:
        n_fft, F = 4 * hop, N // hop + 1
        key = f"B={B},N={N},hop={hop}"
        kw = dict(n_fft=n_fft, hop_length=hop, win_length=n_fft)
        sr = 96000 if (B, N, hop, n_mels) in STFT_PAST_1024_SHAPES else 22050
        fb = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels)).to(dev)
        ys = np.stack([synthetic_utterance(N, g) for _ in range(B)])
        ys[0, N // 10:] = 0.0
        y = torch.from_numpy(ys).to(dev)
        mel, en = KS.stft_mel_energy(y, fb, **kw)
        pmel, pen = KS.stft_mel_energy_plain(y, fb, **kw)
        lmel, len_ = cufft_mel_energy(torch, y, fb, n_fft, hop, n_fft)
        torch.cuda.synchronize()
        assert mel.shape == (B, n_mels, F) and en.shape == (B, F)
        log(f"kernel stft_mel_energy {key} (F={F}, n_fft={n_fft}, {n_mels} mels, "
            f"{KS.frames_per_block(hop, n_mels)[0]} frames a block)")
        # the TPU kernel's tolerance (tests/test_pallas.py): rtol 1e-4, atol
        # 1e-4 (of the peak for energy); the mean abs error under atol
        tol = 1e-4 * float(pen.abs().max())
        err = max(compare("log-mel", mel, pmel, 1e-4, 1e-4, rtol=1e-4),
                  compare("energy", en, pen, tol, tol, rtol=1e-4))
        e64 = {name: f64_errors(y, fb, hop, n_fft, m, e)
               for name, (m, e) in (("kernel", (mel, en)), ("plain", (pmel, pen)),
                                    ("cuFFT composition", (lmel, len_)))}
        log("  against float64 (max abs log-mel error where mel > 10 clip, max energy "
            "error / peak): " + "; ".join(f"{k} {a:.3e}, {b:.3e}" for k, (a, b) in e64.items()))
        ms = cuda_time_ms(lambda: KS.stft_mel_energy(y, fb, **kw))
        pms = cuda_time_ms(lambda: KS.stft_mel_energy_plain(y, fb, **kw))
        lms = cuda_time_ms(lambda: cufft_mel_energy(torch, y, fb, n_fft, hop, n_fft))
        dev_k = device_ms_by_kernel(torch, lambda: KS.stft_mel_energy(y, fb, **kw))
        dev_l = device_ms_by_kernel(torch, lambda: cufft_mel_energy(torch, y, fb, n_fft,
                                                                    hop, n_fft))
        d_k, d_l = sum(dev_k.values()) or None, sum(dev_l.values()) or None
        # the bound counts what the function needs (an FFT, the sparse mel
        # projection); bytes: the signal, both outputs and the mel basis, each once
        flops = stft_flops(B * F, n_fft, n_mels, int((fb != 0).sum()))
        nb = 4 * (B * N + B * n_mels * F + B * F + fb.numel())
        b_ms, by = bound_ms(flops, nb, PEAK_F32_FLOPS)
        log(f"  stft_mel_energy: kernel {ms:.4f} ms (device {d_k} ms), plain {pms:.4f} ms, "
            f"cuFFT composition {lms:.4f} ms (device {d_l} ms: "
            f"{', '.join(f'{n} {v:.4f}' for n, v in dev_l.items())}), bound {b_ms:.4f} ms "
            f"({by}: {flops / 1e9:.4f} GFLOP at 67 TF/s, {nb / 1e6:.2f} MB at 3.35 TB/s); "
            f"kernel {(d_k or ms) / b_ms:.1f}x its bound by device time, "
            f"{(d_k or ms) / (d_l or lms):.2f}x the cuFFT composition's")
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"][key], r["plain_ms"][key], r["bound_ms"][key], r["bound_by"][key] = (
            ms, pms, b_ms, by)
        r["library_ms"][key] = lms
        r.setdefault("device_ms", {})[key] = d_k
        r.setdefault("library_device_ms", {})[key] = d_l
        r.setdefault("f64_errors", {})[key] = e64
        if (B, N, hop, n_mels) in STFT_NEW_SHAPES:
            # the hops past the first range, held to float64 as the card tests
            # hold them: energy no less accurate than the plain version's,
            # log-mel within twice its max error
            (k_mel, k_en), (p_mel, p_en) = e64["kernel"], e64["plain"]
            assert k_en <= p_en and k_mel <= 2 * p_mel, (hop, e64)
        if (B, N, hop, n_mels) in STFT_PAST_1024_SHAPES:
            # the kernel's errors within twice the plain version's
            (k_mel, k_en), (p_mel, p_en) = e64["kernel"], e64["plain"]
            assert k_en <= 2 * p_en and k_mel <= 2 * p_mel, (hop, e64)


def preprocess_phase(torch, results):
    """Path A: `preprocess` and `stats` on 160 seeded synthetic wavs (16-bit,
    22,050 Hz, 1.5-10 s: three of cmd_preprocess's chunks) on the card; the store is checked, held against the
    CPU port on four files, and read by the port's dataset."""
    import io
    import shutil
    import tempfile

    import numpy as np
    from scipy.io.wavfile import write as write_wav

    from fastspeech2_tpu_torch import cli, native
    from fastspeech2_tpu_torch.audio import pitch as pitch_mod
    from fastspeech2_tpu_torch.audio.stft import MelSpectrogram
    from fastspeech2_tpu_torch.data.dataset import TTSDataset
    from fastspeech2_tpu_torch.ops.kernels import stft as KS

    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="fs2_pre_", dir=str(ROOT / "build"))
    spans = {"kernel": 0.0, "mel": 0.0, "dio": 0.0, "read": 0.0}
    real = (KS.stft_mel_energy, MelSpectrogram.mel_and_energy, pitch_mod.extract_pitch,
            cli.read_wav_float)

    def timed(name, fn, sync=False):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            spans[name] += time.perf_counter() - t0
            return out
        return run

    try:
        wav_dir, store = Path(work, "wavs"), f"{work}/store"
        wav_dir.mkdir()
        g = np.random.default_rng(2024)
        lens = [int(g.uniform(1.5, 10.0) * 22050) for _ in range(160)]
        for i, n in enumerate(lens):
            pcm = np.round(synthetic_utterance(n, g) * 32767).astype(np.int16)
            write_wav(str(wav_dir / f"SYN-{i:04d}.wav"), 22050, pcm)
        # the bucketed path's batches: per chunk of files, up to 8 rows per
        # 16,384-sample bucket
        n_batches = 0
        for c in range(0, len(lens), cli.CHUNK):
            groups = {}
            for n in lens[c:c + cli.CHUNK]:
                k = -(-(n + 512) // 16384)
                groups[k] = groups.get(k, 0) + 1
            n_batches += sum(-(-v // 8) for v in groups.values())
        t0 = time.perf_counter()
        assert native.available(), "the native DIO did not build"
        secs = sum(lens) / 22050.0
        log(f"preprocess: {len(lens)} wavs, {secs:.1f} s of audio, "
            f"{min(lens) / 22050:.2f}-{max(lens) / 22050:.2f} s; native DIO ready in "
            f"{time.perf_counter() - t0:.2f} s; {n_batches} bucket batches expected")

        KS.stft_mel_energy = timed("kernel", real[0], sync=True)
        MelSpectrogram.mel_and_energy = timed("mel", real[1], sync=True)
        pitch_mod.extract_pitch = timed("dio", real[2])
        cli.read_wav_float = timed("read", real[3])
        try:
            reset_counts()
            t0 = time.perf_counter()
            cli.main(["preprocess", "-d", str(wav_dir), "-o", store])  # device: the card
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
        finally:
            (KS.stft_mel_energy, MelSpectrogram.mel_and_energy, pitch_mod.extract_pitch,
             cli.read_wav_float) = real
        log(f"preprocess launches: {counts}")
        assert counts["stft_mel_energy"] == n_batches, (counts, n_batches)
        assert sum(counts.values()) == n_batches, "another kernel ran in preprocess"
        results["stft_mel_energy"]["launches"] = counts["stft_mel_energy"]
        other = wall - spans["mel"] - spans["dio"] - spans["read"]
        log(f"preprocess: {wall:.2f} s wall, {len(lens) / wall:.1f} wavs/s, "
            f"{secs / wall:.1f} audio-seconds/s; shares of wall: kernel 14 (wrapper + "
            f"kernel, synchronised) {spans['kernel'] / wall:.3f}, mel/energy batches "
            f"(host padding and copies included) {spans['mel'] / wall:.3f}, host DIO "
            f"{spans['dio'] / wall:.3f}, wav reads {spans['read'] / wall:.3f}, .npy "
            f"writes and the rest {other / wall:.3f}")

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["stats", "-d", store])
        stats = json.loads(buf.getvalue())
        keys = {"e_mean", "e_std", "e_min", "e_max", "f0_mean", "f0_std", "p_min", "p_max"}
        assert set(stats) == keys and all(np.isfinite(v) for v in stats.values()), stats
        log(f"stats: {json.dumps(stats)}")

        lines = []
        for i, n in enumerate(lens):
            F = n // 256 + 1
            for kind, shape, dt in (("mels", (80, F), np.float32), ("energy", (F,), np.float32),
                                    ("pitch", (F,), np.float64)):
                a = np.load(f"{store}/{kind}/SYN-{i:04d}.npy")
                assert a.shape == shape and a.dtype == dt and np.isfinite(a).all(), (
                    kind, i, a.shape, a.dtype)
            durs = [F // 4] * 3 + [F - 3 * (F // 4)]
            starts = np.concatenate([[0], np.cumsum(durs)[:-1]])
            lines.append(f"synthetic|{' '.join(map(str, starts))}|{' '.join(map(str, durs))}"
                         f"|HH AH0 L OW1|SYN-{i:04d}.wav")
        voiced = np.mean([(np.load(f"{store}/pitch/SYN-{i:04d}.npy") > 0).mean()
                          for i in range(len(lens))])
        log(f"preprocess: one mel (80, F) f32, energy (F,) f32 and pitch (F,) f64 per wav; "
            f"{voiced:.3f} of frames voiced")

        # four utterances (the longest, the shortest, two others) against the
        # CPU port's matmul path on the same files
        cpu = MelSpectrogram(device="cpu")
        for i in sorted({int(np.argmax(lens)), int(np.argmin(lens)), 0, 1}):
            w = cli.read_wav_float(str(wav_dir / f"SYN-{i:04d}.wav"), 22050)
            m, e = cpu.mel_and_energy(torch.from_numpy(w)[None])
            log(f"preprocess SYN-{i:04d} ({lens[i] / 22050:.2f} s), card store vs CPU port:")
            tol = 1e-4 * float(e.abs().max())
            compare("log-mel", torch.from_numpy(np.load(f"{store}/mels/SYN-{i:04d}.npy")),
                    m[0], 1e-4, 1e-4, rtol=1e-4)
            compare("energy", torch.from_numpy(np.load(f"{store}/energy/SYN-{i:04d}.npy")),
                    e[0], tol, tol, rtol=1e-4)

        fl = f"{work}/filelist.txt"
        Path(fl).write_text("\n".join(lines) + "\n")
        ds = TTSDataset(store, fl)
        for i in range(len(ds)):
            u = ds[i]
            F = lens[i] // 256 + 1
            assert u.mel.shape == (F, 80) and u.energy.shape == u.pitch.shape == (F,)
            assert int(u.durations.sum()) == F
        log(f"preprocess: the port's TTSDataset loads all {len(ds)} utterances")
        return len(lens) / wall, secs / wall
    finally:
        shutil.rmtree(work, ignore_errors=True)


# kernel 14's corpora: (sample rate, hop) with n_fft = 4 hop, win_length =
# n_fft, 80 mels: 10 ms at 22.05 and 44.1 kHz, 12.5 ms at 48 and 96 kHz
PREPROCESS_CORPORA = ((22050, 220), (44100, 441), (48000, 600), (96000, 1200))


def preprocess_corpora_phase(torch, results):
    """`preprocess` through cli.main on 12 seeded synthetic wavs (1.5-4 s) at
    each of PREPROCESS_CORPORA, its audio: section overridden in a YAML:
    kernel 14 launched once a bucket batch and no other kernel; two files'
    stored mel and energy held to the plain version on the card (1e-4) and
    to float64 (the kernel's errors within twice the plain version's);
    wavs/s."""
    import shutil
    import tempfile

    import numpy as np
    from scipy.io.wavfile import write as write_wav

    from fastspeech2_tpu_torch import cli
    from fastspeech2_tpu_torch.audio.stft import mel_filterbank
    from fastspeech2_tpu_torch.ops.kernels import stft as KS

    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    g = np.random.default_rng(441)
    per = {}
    for sr, hop in PREPROCESS_CORPORA:
        n_fft = 4 * hop
        work = tempfile.mkdtemp(prefix=f"fs2_pre{sr}_", dir=str(ROOT / "build"))
        try:
            wav_dir, store = Path(work, "wavs"), f"{work}/store"
            wav_dir.mkdir()
            lens = [int(g.uniform(1.5, 4.0) * sr) for _ in range(12)]
            for i, n in enumerate(lens):
                pcm = np.round(synthetic_utterance(n, g) * 32767).astype(np.int16)
                write_wav(str(wav_dir / f"C{sr}-{i:02d}.wav"), sr, pcm)
            cfg = Path(work, "audio.yaml")
            cfg.write_text(f"audio:\n  sample_rate: {sr}\n  n_fft: {n_fft}\n"
                           f"  hop_length: {hop}\n  win_length: {n_fft}\n  n_mels: 80\n")
            groups = {}
            for n in lens:
                k = -(-(n + n_fft // 2) // 16384)
                groups[k] = groups.get(k, 0) + 1
            n_batches = sum(-(-v // 8) for v in groups.values())
            reset_counts()
            t0 = time.perf_counter()
            cli.main(["preprocess", "-d", str(wav_dir), "-o", store, "-c", str(cfg)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            log(f"preprocess {sr} Hz, hop {hop}, n_fft {n_fft} (plan {KS.plan(n_fft)}): "
                f"{len(lens)} wavs in {wall:.2f} s, {len(lens) / wall:.1f} wavs/s; launches "
                f"{ {k: v for k, v in counts.items() if v} } ({n_batches} bucket batches)")
            assert counts["stft_mel_energy"] == n_batches and sum(counts.values()) == n_batches
            fb = torch.from_numpy(mel_filterbank(sr, n_fft, 80)).cuda()
            for i in (int(np.argmax(lens)), int(np.argmin(lens))):
                w = cli.read_wav_float(str(wav_dir / f"C{sr}-{i:02d}.wav"), sr)
                y = torch.from_numpy(w)[None].cuda()
                F = lens[i] // hop + 1
                mel = torch.from_numpy(np.load(f"{store}/mels/C{sr}-{i:02d}.npy"))[None].cuda()
                en = torch.from_numpy(np.load(f"{store}/energy/C{sr}-{i:02d}.npy"))[None].cuda()
                assert mel.shape == (1, 80, F) and en.shape == (1, F)
                pm, pe = KS.stft_mel_energy_plain(y, fb, n_fft, hop, n_fft)
                tol = 1e-4 * float(pe.abs().max())
                compare(f"preprocess {sr} log-mel", mel, pm, 1e-4, 1e-4, rtol=1e-4)
                compare(f"preprocess {sr} energy", en, pe, tol, tol, rtol=1e-4)
                (k_mel, k_en) = f64_errors(y, fb, hop, n_fft, mel, en)
                (p_mel, p_en) = f64_errors(y, fb, hop, n_fft, pm, pe)
                log(f"  against float64: kernel {k_mel:.3e}, {k_en:.3e}; plain {p_mel:.3e}, "
                    f"{p_en:.3e}")
                assert k_mel <= 2 * p_mel and k_en <= 2 * p_en, (k_mel, p_mel, k_en, p_en)
            per[f"{sr}/{hop}"] = {"wavs_per_s": len(lens) / wall,
                                  "launches": counts["stft_mel_energy"]}
        finally:
            shutil.rmtree(work, ignore_errors=True)
    results["stft_mel_energy"]["corpora"] = per
    log(f"preprocess corpora phase: {time.perf_counter() - t_phase:.1f} s")


def griffin_lim_phase(torch, model):
    """Path B: a Synthesizer with no vocoder; Griffin-Lim (30 iterations) on
    the card against the CPU port from the same mel and initial phase; then
    the server answers wav and stream requests with Griffin-Lim audio."""
    import numpy as np

    from fastspeech2_tpu_torch.config import Config
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer, vocode

    synth = Synthesizer(model, bf16=True)
    assert not synth.has_vocoder
    cfg = Config()
    mel = synth.synth_phonemes(SENTENCES[1])
    vocode(mel, cfg)  # first call: cuBLAS plans, the bases to the card
    ms, wav = timed_calls(torch, lambda: vocode(mel, cfg))  # a host array: synchronised
    secs = len(wav) / 22050.0
    assert wav.shape == ((len(mel) - 1) * 256,) and np.isfinite(wav).all()
    log(f"griffin-lim: B=1 sentence, {len(mel)} frames -> {len(wav)} samples; vocode "
        f"(30 iterations, card) {ms:.2f} ms median of 5, {secs / ms * 1e3:.1f} audio-seconds/s")
    t0 = time.perf_counter()
    want = vocode(mel, cfg, device="cpu")
    d = np.abs(wav - want)
    peak = float(np.abs(want).max())
    # band: the CPU port in f32 against itself in f64 differs by 1.3e-5 of
    # the peak after 30 iterations; the card may sum in other orders
    log(f"griffin-lim card vs CPU port ({time.perf_counter() - t0:.1f} s on the CPU), same mel "
        f"and initial phase: max {d.max() / peak:.3e}, mean {d.mean() / peak:.3e} of the peak "
        f"{peak:.3f} (tolerance max < 1e-3 of the peak)")
    assert d.max() < 1e-3 * peak, "card Griffin-Lim off the CPU port"

    with serving(synth) as url:
        obj = json.loads(http_post(url, "/synthesize", {"phonemes": SENTENCES[2]})[1])
        want_n = (obj["frames"] - 1) * 256
        t0 = time.perf_counter()
        headers, body = http_post(url, "/synthesize", {"phonemes": SENTENCES[2], "format": "wav"})
        lat = (time.perf_counter() - t0) * 1e3
        assert headers["Content-Type"] == "audio/wav" and riff_samples(body) == want_n
        headers, body = http_post(url, "/stream", {"phonemes": SENTENCES[2]})
        assert headers.get("Transfer-Encoding") == "chunked"
        assert body[:4] == b"RIFF" and body[4:8] == b"\xff\xff\xff\xff"
        assert (len(body) - 44) // 2 == want_n, (len(body), want_n)
    log(f"griffin-lim server: /synthesize wav ({obj['frames']} frames, {want_n} samples, "
        f"{lat:.1f} ms) and /stream answered 200 with RIFF audio; shut down cleanly")
    return ms, secs


def prenorm_kernel_phase(torch, results, record):
    """Kernels 6-10 against their plain versions on the card: 6 (pre-LN
    attention half), 7 (bare attention, heads packed) and 8 (its (B, H, T,
    dk) twin) at the encoder shape (B=32, T=128, D=256) and the decoder rung
    (B=16, T=768, D=384); 9 (pre-LN FFN half) and 10 (bare FFN, O = D) at
    both shapes, H=1024, k=9, with their device times by the profiler. q/k/v
    come from a block's projections of LN(x); random lengths with one full
    and one short row. Dead rows hold their exact constants: res + bo (6),
    zeros (7, 8), x + c (9, within 1e-5) and c (10, bit for bit) from len + 4
    on, c the call's one bias-only row. Library: one
    scaled_dot_product_attention call with a boolean key mask for 7 and 8
    (the same function on the live rows)."""
    import torch.nn.functional as F

    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.ops import nn
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF
    from fastspeech2_tpu_torch.ops.precision import compute_dtype

    dev, bf16, H, K, HID = torch.device("cuda"), torch.bfloat16, 2, 9, 1024
    gen = torch.Generator().manual_seed(6)
    src_a = "fastspeech2_tpu_torch/csrc/attention.cu"
    src_f = "fastspeech2_tpu_torch/csrc/ffn.cu"
    for B, T, D in ((32, 128, 256), (16, 768, 384)):
        key, dk = f"B={B},T={T},D={D}", D // H
        torch.manual_seed(B + T + D + 6)
        blk = FFTBlock(EncoderConfig(idim=D, attention_dim=D, attention_heads=H,
                                     linear_units=HID, positionwise_conv_kernel_size=K),
                       device=dev)
        with torch.no_grad():  # LayerNorm affines with something to do
            for ln in (blk.norm1, blk.norm2):
                ln.weight.add_(0.2 * torch.randn(D, generator=gen).to(dev))
                ln.bias.add_(0.1 * torch.randn(D, generator=gen).to(dev))
        x = (2.0 * torch.randn(B, T, D, generator=gen) + 0.5).to(dev)
        lens = torch.randint(T // 4, T + 1, (B,), generator=gen, dtype=torch.int32)
        lens[0], lens[-1] = T, max(1, T // 5)
        lc, lens = lens.tolist(), lens.to(dev)
        live_qkv = 3 * sum(lc) * D * 2  # q/k/v rows past a length are not read
        with torch.inference_mode(), compute_dtype(bf16):
            y = nn.layer_norm(x, blk.norm1.weight, blk.norm1.bias)
            q, k, v = (nn.linear(y, p.weight, p.bias, out_dtype=bf16)
                       for p in (blk.attn.q, blk.attn.k, blk.attn.v))
            wo = blk.attn.out.weight.to(bf16).contiguous()
            bo = blk.attn.out.bias.float().contiguous()

            # kernel 6
            a6 = (q, k, v, x, wo, bo, lens, H)
            got, want = KA.attention_res(*a6), KA.attention_res_plain(*a6)
            torch.cuda.synchronize()
            log(f"kernel attention_res {key}")
            err = compare("attention_res", got, want, 2e-3, 0.1)
            for b, n in enumerate(lc):
                assert torch.equal(got[b, n:], x[b, n:] + bo), f"attention_res dead row {b}"
            log("  attention_res: rows at or past each length == res + bo exactly")
            record("attention_res", src_a, "fastspeech2_tpu/ops/pallas/attention.py:358",
                   err, cuda_time_ms(lambda: KA.attention_res(*a6)),
                   cuda_time_ms(lambda: KA.attention_res_plain(*a6)),
                   sum(4 * l * l * D + 2 * l * D * D for l in lc),
                   live_qkv + nbytes(x, got, wo, bo), key)
            record_device_ms(torch, results, "attention_res", key,
                             lambda: KA.attention_res(*a6))

            # kernels 7 and 8, and the library call on the same values
            mask = (torch.arange(T, device=dev)[None] < lens[:, None])[:, None, None, :]
            q4, k4, v4 = (t.view(B, T, H, dk).transpose(1, 2) for t in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)  # noqa: E731
            lib_ms = cuda_time_ms(lib)
            flops = sum(4 * l * l * D for l in lc)
            got7 = KA.fused_attention_packed(q, k, v, lens, H)
            want = KA.fused_attention_packed_plain(q, k, v, lens, H)
            torch.cuda.synchronize()
            log(f"kernel fused_attention_packed {key}")
            err = compare("fused_attention_packed", got7, want, 2e-3, 0.1)
            for b, n in enumerate(lc):
                assert not got7[b, n:].any(), f"fused_attention_packed dead row {b}"
            live = torch.arange(T, device=dev)[None] < lens[:, None]
            ref = lib().transpose(1, 2).reshape(B, T, D)
            compare("fused_attention_packed vs the library call, live rows", got7[live],
                    ref[live], 2e-3, 0.1)
            record("fused_attention_packed", src_a,
                   "fastspeech2_tpu/ops/pallas/attention.py:190", err,
                   cuda_time_ms(lambda: KA.fused_attention_packed(q, k, v, lens, H)),
                   cuda_time_ms(lambda: KA.fused_attention_packed_plain(q, k, v, lens, H)),
                   flops, live_qkv + nbytes(got7), key, library_ms=lib_ms)
            q8, k8, v8 = (t.contiguous() for t in (q4, k4, v4))
            got8 = KA.fused_attention(q8, k8, v8, lens)
            want = KA.fused_attention_plain(q8, k8, v8, lens)
            torch.cuda.synchronize()
            log(f"kernel fused_attention {key} (B, H, T, dk)")
            err = compare("fused_attention", got8, want, 2e-3, 0.1)
            for b, n in enumerate(lc):
                assert not got8[b, :, n:].any(), f"fused_attention dead row {b}"
            assert torch.equal(got8.transpose(1, 2).reshape(B, T, D), got7), \
                "kernels 7 and 8 (one body) differ"
            log("  rows at or past each length are zeros; kernel 8 == kernel 7 bit for bit")
            lib8 = lambda: F.scaled_dot_product_attention(q8, k8, v8, attn_mask=mask)  # noqa: E731
            record("fused_attention", src_a, "fastspeech2_tpu/ops/pallas/attention.py:101",
                   err, cuda_time_ms(lambda: KA.fused_attention(q8, k8, v8, lens)),
                   cuda_time_ms(lambda: KA.fused_attention_plain(q8, k8, v8, lens)),
                   flops, live_qkv + nbytes(got8), key, library_ms=cuda_time_ms(lib8))
            # device time per call (the profiler's kernel durations summed):
            # events around one call also hold the host's launch time
            for name, kern, library in (
                    ("fused_attention_packed",
                     lambda: KA.fused_attention_packed(q, k, v, lens, H), lib),
                    ("fused_attention", lambda: KA.fused_attention(q8, k8, v8, lens), lib8)):
                d_k, d_l = (sum(device_ms_by_kernel(torch, f).values()) or None
                            for f in (kern, library))
                results[name].setdefault("device_ms", {})[key] = d_k
                results[name].setdefault("library_device_ms", {})[key] = d_l
                log(f"  {name} {key}: device time per call (profiler) {d_k} ms, the "
                    f"library call's {d_l} ms")

            # kernels 9 and 10 at both shapes: the FFN over l + 4 rows; rows
            # from len + 4 on carry the one bias-only row c of the call
            fp = blk.ffn_pack(bf16)
            w = fp[:4]
            c = ffn_bias_row(torch, KF, w, K)
            ffn_flops = sum(min(l + (K - 1) // 2, T) * 2 * (K * D * HID + HID * D) for l in lc)
            got = KF.ffn_block_pre(x, *fp, lens, K)
            want = KF.ffn_block_pre_plain(x, *fp, lens, K)
            torch.cuda.synchronize()
            log(f"kernel ffn_block_pre {key}, H={HID}, k={K}")
            err = compare("ffn_block_pre", got, want, 2e-3, 0.1)
            ffn_dead_rows("ffn_block_pre", got, lens, K, lambda b, t0: x[b, t0:] + c)
            # x is read whole (every output row is x + ...), the output written whole
            record("ffn_block_pre", src_f, "fastspeech2_tpu/ops/pallas/ffn.py:228", err,
                   cuda_time_ms(lambda: KF.ffn_block_pre(x, *fp, lens, K)),
                   cuda_time_ms(lambda: KF.ffn_block_pre_plain(x, *fp, lens, K)),
                   ffn_flops, nbytes(x, got, *fp), key)
            record_device_ms(torch, results, "ffn_block_pre", key,
                             lambda: KF.ffn_block_pre(x, *fp, lens, K))
            xb = y.to(bf16)
            got = KF.fused_ffn(xb, *w, lens, K)
            want = KF.fused_ffn_plain(xb, *w, lens, K)
            torch.cuda.synchronize()
            log(f"kernel fused_ffn {key}, H={HID}, O={D}, k={K}, bf16 out")
            err = compare("fused_ffn", got, want, 2e-3, 0.1)
            ffn_dead_rows("fused_ffn", got, lens, K, lambda b, t0: c.to(bf16), exact=True)
            got32 = KF.fused_ffn(xb, *w, lens, K, torch.float32)
            err = max(err, compare("fused_ffn f32 out", got32,
                                   KF.fused_ffn_plain(xb, *w, lens, K, torch.float32),
                                   2e-3, 0.1))
            ffn_dead_rows("fused_ffn f32 out", got32, lens, K, lambda b, t0: c, exact=True)
            record("fused_ffn", src_f, "fastspeech2_tpu/ops/pallas/ffn.py:101", err,
                   cuda_time_ms(lambda: KF.fused_ffn(xb, *w, lens, K)),
                   cuda_time_ms(lambda: KF.fused_ffn_plain(xb, *w, lens, K)),
                   ffn_flops, sum(lc) * D * 2 + nbytes(got, *w), key)
            record_device_ms(torch, results, "fused_ffn", key,
                             lambda: KF.fused_ffn(xb, *w, lens, K))
            results["fused_ffn"]["main_shape"] = "B=16,T=768,D=384"
    for name in ("fused_attention", "fused_ffn"):
        # launches: read from the prenorm path's counted run
        results[name]["note"] = "no model route reaches it (as in the JAX package)"
    bare_attention_checks(torch, results)


FFN_EDGES = ((3, 40, 256, 1024, 9), (2, 200, 384, 1024, 9), (2, 160, 512, 1024, 9),
             (2, 100, 1024, 4096, 9), (3, 130, 256, 1056, 3), (3, 96, 384, 1024, 1),
             (2, 70, 384, 1024, 3),
             # any width, D and H padded to 32 in the kernels: D = 260 and 36
             # (16-byte f32 rows, not bf16), 200, 40, and 30 (a value at a time)
             (2, 100, 260, 1000, 9), (3, 70, 200, 1000, 9), (3, 40, 36, 100, 3),
             (2, 64, 40, 72, 1), (2, 50, 30, 72, 3),
             # the x tile in 512-column chunks: the first chunked width at
             # k = 9, the wide model's 1536 and 2048 at H = 4096, a last chunk
             # of 480 columns at k = 31, rows of 4- and 1-float alignment
             (2, 200, 1376, 1024, 9), (2, 150, 1536, 4096, 9), (2, 100, 2048, 4096, 9),
             (3, 70, 1500, 1000, 31), (2, 80, 2044, 200, 9), (2, 90, 2047, 100, 3))


def ffn_edges_phase(torch, results):
    """Kernels 2, 9 and 10 at shapes their tiling makes risky, against their
    plain versions (mean < 2e-3, max < 0.1): (B, T, D, H, k) with T under one
    64-row tile and no multiple of the tiles, D = 512 (fewer ring stages),
    D = 1024 at H = 4096 (64-row conv tiles, two column passes, the row
    LayerNorm launch), H = 1056, k = 1 and 3; kernel 10 also at O = 80 and
    200, 30; at widths no multiple of 32 (D 260, 200, 40, 36, 30; H 1000,
    100, 72), which the kernels pad to 32. Lengths 0, 1 and T; every row from
    len + (k - 1) / 2 on holds c, x + c or LN(x + c) for the call's one
    bias-only row c."""
    from fastspeech2_tpu_torch.ops import nn
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(9)

    def weights(D, H, O, k):
        w1 = (torch.randn(H, k * D, generator=g) / (k * D) ** 0.5).to(bf16).to(dev)
        w2 = (torch.randn(O, H, generator=g) / H ** 0.5).to(bf16).to(dev)
        return w1, (0.1 * torch.randn(H, generator=g)).to(dev), w2, \
            (0.1 * torch.randn(O, generator=g)).to(dev)

    with torch.inference_mode():
        for B, T, D, H, k in FFN_EDGES:
            w = weights(D, H, D, k)
            ln_g = (1.0 + 0.2 * torch.randn(D, generator=g)).to(dev)
            ln_b = (0.1 * torch.randn(D, generator=g)).to(dev)
            x = (2.0 * torch.randn(B, T, D, generator=g) + 0.5).to(dev)
            lens = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
            lens[0], lens[-1] = T, 0
            lens[1] = 1 if B > 2 else lens[1]
            lens = lens.to(dev)
            c = ffn_bias_row(torch, KF, w, k)
            log(f"kernels ffn_block, ffn_block_pre, fused_ffn at B={B}, T={T}, D={D}, H={H}, "
                f"k={k}: plan {tuple(KF.plan(D, H, k, D))}")
            xb = x.to(bf16)
            for name, got, want, dead, exact in (
                    ("ffn_block", KF.ffn_block(x, *w, ln_g, ln_b, lens, k),
                     KF.ffn_block_plain(x, *w, ln_g, ln_b, lens, k),
                     lambda b, t0: nn.layer_norm(x[b, t0:] + c, ln_g, ln_b), False),
                    ("ffn_block_pre", KF.ffn_block_pre(x, *w, ln_g, ln_b, lens, k),
                     KF.ffn_block_pre_plain(x, *w, ln_g, ln_b, lens, k),
                     lambda b, t0: x[b, t0:] + c, False),
                    ("fused_ffn", KF.fused_ffn(xb, *w, lens, k, torch.float32),
                     KF.fused_ffn_plain(xb, *w, lens, k, torch.float32),
                     lambda b, t0: c, True)):
                torch.cuda.synchronize()
                err = compare(name, got, want, 2e-3, 0.1)
                ffn_dead_rows(name, got, lens, k, dead, exact)
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        for O in (80, 200, 30):
            B, T, D, H, k = 3, 160, 384, 1024, 9
            w = weights(D, H, O, k)
            xb = torch.randn(B, T, D, generator=g).to(bf16).to(dev)
            lens = torch.tensor([T, 1, 0], dtype=torch.int32).to(dev)
            log(f"kernel fused_ffn at B={B}, T={T}, D={D}, H={H}, k={k}, O={O}, bf16 out")
            got = KF.fused_ffn(xb, *w, lens, k)
            err = compare("fused_ffn", got, KF.fused_ffn_plain(xb, *w, lens, k), 2e-3, 0.1)
            ffn_dead_rows("fused_ffn", got, lens, k, lambda b, t0: got[-1, -1], True)
            results["fused_ffn"]["max_abs_err"] = max(results["fused_ffn"]["max_abs_err"], err)


# (D, batch rows, bins) of kernel 3 and (C, C0, k, layers) of kernel 4 held
# at their tiling edges (the card tests' widths): the parent's range, then
# the widths the JAX routes give them past it
ADAPTOR_EDGES = ((200, 4, 256), (256, 4, 256), (384, 4, 256), (512, 4, 256), (1024, 4, 256),
                 (256, 48, 256), (36, 4, 256), (60, 4, 256), (100, 4, 256), (1100, 4, 256),
                 (1504, 4, 256), (2048, 4, 256), (256, 4, 8192), (256, 4, 65536))
POSTNET_EDGES = ((256, 80, 5, 5), (512, 80, 5, 5), (200, 88, 7, 5), (256, 128, 9, 5),
                 (512, 80, 9, 8), (500, 100, 5, 5), (256, 100, 5, 1), (256, 80, 11, 5),
                 (256, 80, 31, 3), (256, 80, 5, 12), (1024, 80, 5, 5), (768, 513, 11, 10),
                 (1024, 1024, 5, 2))


def adaptor_flip_share(D, nb):
    """The share of live frames kernel 3 may put one bucket off its plain
    version: 1% at the shapes it took before its widths were opened (D a
    multiple of 8 in 64-1024, at most 4,096 bins), 5% at other widths (the
    band the CPU tests hold the port to against the JAX kernel in bf16),
    and past 4,096 bins none of its own (1.0): there the edges lie closer
    than one bf16 step of the head's sum, every raw difference moves a
    bucket, and the raw band holds them (two reference implementations
    differ so in up to 1.1% of frames at 8,192 bins,
    scripts/adaptor_flip_band.py)."""
    if nb > 4096:
        return 1.0
    return 0.01 if D % 8 == 0 and 64 <= D <= 1024 else 0.05


def hold_adaptor(torch, got, graw, want, wraw, lens, pack, hs, idx, share):
    """Kernel 3 against its plain version: rows past out_len exactly 0, raw
    too; raw within mean 1e-2, max 0.5; at most ``share`` of live frames
    one bucket off (``adaptor_flip_share``); every live row exactly the
    gathered state plus the embedding rows of the buckets of the kernel's
    own raw predictions; the rows whose buckets agree within mean 2e-3, max
    0.1 of the plain rows. Returns (flipped, raw differs, live,
    max_abs_err)."""
    bins, emb_w, emb_b = pack[10], pack[11], pack[12]
    L, D = got.shape[1:]
    live = torch.arange(L, device=got.device)[None] < lens[:, None]
    assert torch.all(got[~live] == 0) and torch.all(graw.transpose(0, 1)[:, ~live] == 0)
    bk = lambda r, i: (bins[i][None, None] < r[:, i][..., None]).sum(-1)  # noqa: E731
    flip = torch.stack([bk(graw, i) != bk(wraw, i) for i in (0, 1)], 1) & live[:, None]
    same = ~flip.any(1) & live
    flipped, n_live = int((~same & live).sum()), int(live.sum())
    differs = int(((graw != wraw).any(1) & live).sum())
    assert flipped <= share * n_live, "too many bucket flips"
    e = torch.gather(hs, 1, idx.long()[..., None].expand(-1, -1, D))
    rows = (e + (emb_w[0, :, :D].float()[bk(graw, 0)] + emb_b[0, :D])) + \
        (emb_w[1, :, :D].float()[bk(graw, 1)] + emb_b[1, :D])
    assert torch.equal(torch.where(live[..., None], rows, 0), got), "rows off their buckets"
    keep = same[..., None]
    err = max(compare("variance_adaptor.raw", graw, wraw, 1e-2, 0.5),
              compare("variance_adaptor", torch.where(keep, got, 0),
                      torch.where(keep, want, 0), 2e-3, 0.1))
    return flipped, differs, n_live, err


def adaptor_postnet_edges_phase(torch, results):
    """Kernels 3 and 4 against their plain versions at the widths their
    tilings make risky, on an L off every tile (331 and 301 frames) with
    lengths L, 1 and 0 and one inside: the adaptor at D = 200 (each tap
    zero-padded to the K step), 256 and 384 (128-column ring tiles), 512
    (64-column tiles), 1024 (one ring stage), over 48 batch rows, at D = 36,
    60 and 100 (packed weights padded to 40, 64 and 104; rows read a value
    or four at a time), 1100 (one ring stage), 1504 and 2048 (the x tile in
    chunks of 512 columns) and at 8,192 and 65,536 bins (edges counted 4,096
    at a time), by ``hold_adaptor``. The postnet at (C, C0, k, layers) =
    (256, 80, 5, 5), (512, 80, 5, 5) (64-row stages), (200, 88, 7, 5),
    (256, 128, 9, 5), (512, 80, 9, 8) (two launches through a bf16 plane),
    (500, 100, 5, 5), (256, 100, 5, 1) (one layer, C0 -> C0), (256, 80, 11,
    5), (256, 80, 31, 3), (256, 80, 5, 12), and on the wide path (one launch
    a stage, two planes in turn): (1024, 80, 5, 5), (768, 513, 11, 10),
    (1024, 1024, 5, 2): mean 2e-3, max 0.1, and every row from len + halo on
    the last stage's BN of zero, bit for bit."""
    from fastspeech2_tpu_torch.models.postnet import Postnet, PostnetConfig
    from fastspeech2_tpu_torch.models.predictors import Predictor, PredictorConfig
    from fastspeech2_tpu_torch.ops.kernels import adaptor as KAd
    from fastspeech2_tpu_torch.ops.kernels import postnet as KP
    from fastspeech2_tpu_torch.ops.quantize import linear_bins, log_bins

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(11)
    with torch.inference_mode():
        for D, B, nb in ADAPTOR_EDGES:
            L, T = 331, 40
            torch.manual_seed(D)
            preds = [Predictor(PredictorConfig(idim=D), device=dev) for _ in range(2)]
            embs = [torch.nn.Linear(nb, D, device=dev) for _ in range(2)]
            for p, bias in zip(preds, (200.0, 40.0)):  # spread the predictions over the bins
                p.out.weight.mul_(8.0)
                p.out.bias.fill_(bias)
            lens = torch.tensor([L, 1, 0, 200] + torch.randint(0, L + 1, (B - 4,),
                                                                generator=g).tolist(),
                                dtype=torch.int32).to(dev)
            hs = torch.randn(B, T, D, generator=g).to(dev)
            idx = torch.sort(torch.randint(0, T, (B, L), generator=g, dtype=torch.int32),
                             -1)[0].to(dev)
            pack = KAd.pack_weights(*preds, *embs,
                                    torch.from_numpy(log_bins(71.0, 676.0, nb)).to(dev),
                                    torch.from_numpy(linear_bins(0.0, 130.0, nb)).to(dev), bf16)
            got, graw = KAd.variance_adaptor(hs, idx, lens, *pack)
            want, wraw = KAd.variance_adaptor_plain(hs, idx, lens, *pack)
            torch.cuda.synchronize()
            share = adaptor_flip_share(D, nb)
            log(f"kernel variance_adaptor at B={B}, L={L}, D={D}, {nb} bins: plan "
                f"{tuple(KAd.plan(D, nb))}")
            flipped, differs, n_live, err = hold_adaptor(torch, got, graw, want, wraw, lens,
                                                         pack, hs, idx, share)
            log(f"  variance_adaptor: {flipped}/{n_live} live frames one bucket off (tolerance "
                f"{share:.0%}), {differs} with raw predictions not bit for bit; rows at their "
                "buckets bit for bit; rows past out_len exactly 0")
            results["variance_adaptor"]["max_abs_err"] = max(
                results["variance_adaptor"]["max_abs_err"], err)
            results["variance_adaptor"].setdefault("edges", {})[f"D{D}-nb{nb}"] = {
                "flipped": flipped, "raw_differs": differs, "live": n_live, "max_abs_err": err}
        for C, C0, k, n in POSTNET_EDGES:
            L = 301
            torch.manual_seed(C + C0 + k)
            net = Postnet(PostnetConfig(odim=C0, n_layers=n, n_chans=C, n_filts=k), device=dev)
            for layer in net.layers:
                c = layer.bn.running_mean.shape[0]
                layer.bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                layer.bn.running_var.copy_(1.0 + torch.rand(c, generator=g))
            w, bn, hidden = KP.pack_weights(net.layers, bf16)
            lens = torch.tensor([L, 1, 0, 150], dtype=torch.int32).to(dev)
            mel = torch.randn(4, L, C0, generator=g).to(dev)
            got = KP.postnet(mel, w, bn, lens, n, hidden, k)
            want = KP.postnet_plain(mel, w, bn, lens, n, hidden, k)
            torch.cuda.synchronize()
            pl = KP.plan(C0, hidden, k, n)
            log(f"kernel postnet at L={L}, C={C}, C0={C0}, k={k}, layers={n}: plan {tuple(pl)}, "
                f"{len(KP.launch_stages(pl, n))} launch(es)")
            err = compare("postnet", got, want, 2e-3, 0.1)
            s = bn[n - 1, :, :C0]
            dead, halo, rows = ((0.0 - s[0]) * s[1]) * s[2] + s[3], n * (k - 1) // 2, 0
            for b, m in enumerate(lens.tolist()):
                if m + halo < L:
                    assert torch.equal(got[b, m + halo:], dead.expand(L - m - halo, C0)), b
                    rows += L - m - halo
            log(f"  postnet: {rows} rows from len + {halo} on are the last stage's BN of zero, "
                "bit for bit")
            results["postnet"]["max_abs_err"] = max(results["postnet"]["max_abs_err"], err)
            results["postnet"].setdefault("edges", {})[f"C{C}-C0{C0}-k{k}-n{n}"] = {
                "launches": len(KP.launch_stages(pl, n)), "max_abs_err": err}


def bare_attention_checks(torch, results):
    """Kernel 7 against kernel 11's forward at rate 0, bit for bit (one body
    in its SERVE and TRAIN modes), at the kernel phase's two shapes and at
    T = 2048; there also kernels 7 and 8 against their plain versions (the
    bf16 band), dead rows zero, kernel 8 == kernel 7."""
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT

    dev, H = torch.device("cuda"), 2
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for B, T, D in ((32, 128, 256), (16, 768, 384), (8, 2048, 384)):
            key = f"B={B},T={T},D={D}"
            q, k, v = (torch.randn(B, T, D, generator=gen).to(torch.bfloat16).to(dev)
                       for _ in range(3))
            lens = torch.randint(T // 4, T + 1, (B,), generator=gen, dtype=torch.int32)
            lens[0], lens[-1] = T, max(1, T // 5)
            lc, lens = lens.tolist(), lens.to(dev)
            got = KA.fused_attention_packed(q, k, v, lens, H)
            k11 = KT.fused_attention_train_packed(q, k, v, lens, 0, H, 0.0)
            torch.cuda.synchronize()
            assert torch.equal(got, k11), f"kernel 7 != kernel 11's forward at rate 0, {key}"
            log(f"kernel fused_attention_packed {key}: == attention_train_packed's forward "
                "at rate 0, bit for bit")
            if T != 2048:
                continue
            want = KA.fused_attention_packed_plain(q, k, v, lens, H)
            err = compare(f"fused_attention_packed {key}", got, want, 2e-3, 0.1)
            split = lambda t: t.view(B, T, H, D // H).transpose(1, 2).contiguous()  # noqa: E731
            got8 = KA.fused_attention(split(q), split(k), split(v), lens)
            assert torch.equal(got8, split(got)), f"kernel 8 != kernel 7, {key}"
            for b, n in enumerate(lc):
                assert not got[b, n:].any(), f"fused_attention_packed dead row {b}, {key}"
            log("  rows at or past each length are zeros; kernel 8 == kernel 7 bit for bit")
            for name in ("fused_attention_packed", "fused_attention"):
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)


#: head dims of the kernel phases past the 128/192/256 instantiations: padded
#: with zero columns (40, 64 to 128; 136, 160 to 192) or cut into column
#: parts (320-1024)
NEW_HEAD_DIMS = (20, 40, 64, 130, 136, 160, 320, 384, 512, 1024)
#: head dims run at two heads, so that a column past d_k is the next head's
#: (20 and 130: no multiple of 8, run zero-padded to 24 and 136)
TWO_HEAD_DIMS = (20, 40, 130, 136, 160)
#: (d_k, heads) timed at the decoder rung's (16, 768)
TIMED_HEAD_DIMS = ((160, 2), (384, 1), (1024, 1), (130, 2), (20, 2))
#: (D, heads) of kernels 1, 5 and 6 past d_k 256 (d_k 384, 160, 1024) and at
#: head dims no multiple of 8 (d_k 130 at D = 260, 20 at D = 40)
HALF_HEAD_DIMS = ((384, 1), (320, 2), (1024, 1), (260, 2), (40, 2))
#: the wide kernel phase (head_dim_kernel_phase's arguments): d_k past 1024,
#: 1500 zero-padded to 1504 and two heads of 1536 (a box past d_k is the next
#: head's); kernels 1, 5, 6 at D 1536 and 2048 (their projections over x
#: tiles in 512-column chunks), two heads of 1024 at D 2048, and d_k 1500
WIDE_HEAD_DIMS = dict(dims=(1500, 1536, 2048), two=(1536,), f32=((1500, 1), (2048, 1)),
                      halves=((1536, 1), (2048, 1), (2048, 2), (1500, 1)),
                      timed=((1536, 1), (2048, 1)), tag="wide")


def sdpa_backend(names):
    """The backend of a scaled_dot_product_attention call, from the names of
    the kernels it launched."""
    low = " ".join(names).lower()
    for key, what in (("flash", "flash"), ("cudnn", "cuDNN"), ("fmha", "memory-efficient"),
                      ("mem_eff", "memory-efficient"), ("efficient", "memory-efficient")):
        if key in low:
            return what
    return "math (" + ", ".join(sorted(names)) + ")"


def head_dim_kernel_phase(torch, results, dims=NEW_HEAD_DIMS, two=TWO_HEAD_DIMS,
                          f32=((160, 2), (384, 1)), halves=HALF_HEAD_DIMS,
                          timed=TIMED_HEAD_DIMS, tag="head_dims"):
    """Kernels 7, 8, 11 and 12 at every d_k of ``dims`` (two heads at
    ``two``, so that a load or store that crosses into the next head's
    columns shows; one head otherwise) at B=4, T=200 with lengths T, 0, one
    random and a short one: 7 and 8 against their plain versions (bf16 band),
    kernel 8 == kernel 7 and kernel 7 == kernel 11's forward at rate 0 bit
    for bit, rows at or past each length zeros; 11 and 12 at rate 0.2,
    forward and the three gradients against the plain version's autograd
    (max < 2^-6, mean < 1e-4 of the peak), padded rows exactly zero, a
    second call bit for bit; the f32 instantiations at the (d_k, H) of
    ``f32``. Then kernels 1, 5 and 6 at (D, H) of ``halves`` with their dead
    rows (6: res + bo bit for bit; 1 and 5: kernel 5 at length 0, itself
    within 1e-5 of the plain LN(res + bo)). At ``timed`` every kernel
    is timed at (16, 768) beside its plain version, its bound and, for 7, 8,
    11 and 12, SDPA (whose backend is named from its kernels). Results go
    under each kernel's ``tag`` key."""
    import torch.nn.functional as F

    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(17)

    def lengths(B, T):
        ls = torch.randint(T // 4, T + 1, (B,), generator=gen, dtype=torch.int32)
        ls[0], ls[1], ls[-1] = T, 0, max(1, T // 5)
        return ls.tolist(), ls.to(dev)

    def note(name, key, **kw):
        results[name].setdefault(tag, {}).setdefault(key, {}).update(kw)
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], kw.get("max_abs_err", 0.0))

    def train_grads(fn, q, k, v, do):
        o = fn(q, k, v)
        return (o, *torch.autograd.grad(o, (q, k, v), do))

    B, T = 4, 200
    for dk in dims:
        H = 2 if dk in two else 1
        D, key = H * dk, f"dk={dk},H={H},B={B},T={T}"
        lc, lens = lengths(B, T)
        split = lambda t: t.view(B, T, H, dk).transpose(1, 2).contiguous()  # noqa: E731
        q, k, v, do = (torch.randn(B, T, D, generator=gen).to(bf16).to(dev) for _ in range(4))
        with torch.no_grad():
            got7 = KA.fused_attention_packed(q, k, v, lens, H)
            got8 = KA.fused_attention(split(q), split(k), split(v), lens)
            k11 = KT.fused_attention_train_packed(q, k, v, lens, 0, H, 0.0)
            want = KA.fused_attention_packed_plain(q, k, v, lens, H)
        torch.cuda.synchronize()
        log(f"kernel fused_attention_packed / fused_attention {key}")
        err = compare(f"fused_attention_packed {key}", got7, want, 2e-3, 0.1)
        for b, n in enumerate(lc):
            assert not got7[b, n:].any(), f"fused_attention_packed dead row {b}, {key}"
        assert torch.equal(split(got7), got8), f"kernel 8 != kernel 7, {key}"
        assert torch.equal(got7, k11), f"kernel 7 != kernel 11's forward at rate 0, {key}"
        log("  rows at or past each length zeros; kernel 8 == kernel 7 == kernel 11's "
            "forward at rate 0, bit for bit")
        for name in ("fused_attention_packed", "fused_attention"):
            note(name, key, max_abs_err=err)
        for packed, name in ((True, "attention_train_packed"), (False, "attention_train")):
            shape = (B, T, D) if packed else (B, H, T, dk)
            qq, kk, vv, dd = ((t if packed else split(t)) for t in (q, k, v, do))
            qq, kk, vv = (t.detach().clone().requires_grad_() for t in (qq, kk, vv))
            kern, plain = train_attention_fns(KT, packed, lens, 0xFFFFFFF2, H, 0.2)
            got, again = (train_grads(kern, qq, kk, vv, dd) for _ in range(2))
            want = train_grads(plain, qq, kk, vv, dd)
            torch.cuda.synchronize()
            pad = torch.arange(T, device=dev)[None] >= lens[:, None]
            pad = pad[:, :, None] if packed else pad[:, None, :, None]
            err = 0.0
            for what, g, g2, w in zip(("o", "dq", "dk", "dv"), got, again, want):
                assert g.shape == shape and torch.equal(g, g2), f"{name}.{what} {key}: two calls"
                assert float(torch.where(pad, g.detach().float().abs(), 0).max()) == 0.0
                peak = float(w.detach().float().abs().max())
                err = max(err, compare(f"{name}.{what} {key} rate 0.2 (peak {peak:.3f})",
                                       g.detach(), w.detach(), 1e-4 * peak, 2.0 ** -6 * peak))
            log(f"  {name} {key}: padded rows exactly zero, a second call bit for bit")
            note(name, key, max_abs_err=err)
    # the f32 instantiations (plain multiply-adds) past the old head dims
    for dk, H in f32:
        D, key = H * dk, f"f32,dk={dk},H={H},B=2,T=120"
        ls = torch.tensor([120, 37], dtype=torch.int32, device=dev)
        q, k, v, do = (torch.randn(2, 120, D, generator=gen).to(dev) for _ in range(4))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        kern, plain = train_attention_fns(KT, True, ls, 2 ** 32 - 3, H, 0.2)
        got, want = train_grads(kern, q, k, v, do), train_grads(plain, q, k, v, do)
        torch.cuda.synchronize()
        for what, g, w in zip(("o", "dq", "dk", "dv"), got, want):
            peak = float(w.detach().abs().max())
            compare(f"attention_train_packed.{what} {key}", g.detach(), w.detach(),
                    2e-6 * peak, 2e-5 * peak)

    # kernels 1, 5, 6 at the new head dims: correctness at B=4, T=200
    for D, H in halves:
        half_heads_case(torch, results, gen, 4, 200, D, H, timed=False, tag=tag)

    # timings at the decoder rung
    B, T = 16, 768
    for dk, H in timed:
        D, key = H * dk, f"dk={dk},H={H},B={B},T={T}"
        lc, lens = lengths(B, T)
        live_qkv = 3 * sum(lc) * D * 2
        q, k, v, do = (torch.randn(B, T, D, generator=gen).to(bf16).to(dev) for _ in range(4))
        mask = (torch.arange(T, device=dev)[None] < lens[:, None])[:, None, None, :]
        q4, k4, v4 = (t.view(B, T, H, dk).transpose(1, 2).contiguous() for t in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)  # noqa: E731
        with torch.no_grad():
            backend = sdpa_backend(device_ms_by_kernel(torch, lib))
            lib_ms, lib_dev = cuda_time_ms(lib), sum(device_ms_by_kernel(torch, lib).values())
            flops = sum(4 * l * l * D for l in lc)
            b_ms, by = bound_ms(flops, live_qkv + B * T * D * 2)
            for name, fn, plain in (
                    ("fused_attention_packed", lambda: KA.fused_attention_packed(q, k, v, lens, H),
                     lambda: KA.fused_attention_packed_plain(q, k, v, lens, H)),
                    ("fused_attention", lambda: KA.fused_attention(q4, k4, v4, lens),
                     lambda: KA.fused_attention_plain(q4, k4, v4, lens))):
                ms, pms = cuda_time_ms(fn), cuda_time_ms(plain, reps=5)
                dms = sum(device_ms_by_kernel(torch, fn).values()) or None
                log(f"  {name} {key}: kernel {ms:.4f} ms (device {dms}), plain {pms:.4f}, "
                    f"SDPA {lib_ms:.4f} (device {lib_dev:.4f}; backend {backend}), bound "
                    f"{b_ms:.4f} ({by})")
                note(name, key, ms=ms, device_ms=dms, plain_ms=pms, library_ms=lib_ms,
                     library_device_ms=lib_dev, library_backend=backend, bound_ms=b_ms,
                     bound_by=by)
        pairs = sum(l * l for l in lc) * H * dk
        live, whole = sum(lc) * D * 2, B * T * D * 2
        fb, fby = bound_ms(4 * pairs, 3 * live + whole)
        bb, bby = bound_ms(10 * pairs, 4 * live + 3 * whole)
        for packed, name in ((True, "attention_train_packed"), (False, "attention_train")):
            qq, kk, vv, dd = ((t if packed else t.view(B, T, H, dk).transpose(1, 2).contiguous())
                              for t in (q, k, v, do))
            qq, kk, vv = (t.detach().clone().requires_grad_() for t in (qq, kk, vv))
            tm = train_attention_times(torch, KT, packed, qq, kk, vv, dd, lens, H, 0.2)
            kern, plain = train_attention_fns(KT, packed, lens, 12345, H, 0.2)
            o = plain(qq, kk, vv)
            with torch.no_grad():
                pf_ms = cuda_time_ms(lambda: plain(qq, kk, vv), reps=3)
            pb_ms = cuda_time_ms(lambda: torch.autograd.grad(o, (qq, kk, vv), dd,
                                                             retain_graph=True), reps=3)
            del o
            so = F.scaled_dot_product_attention(
                *((t if not packed else t.view(B, T, H, dk).transpose(1, 2))
                  for t in (qq, kk, vv)), attn_mask=mask | (~mask).all(-1, keepdim=True),
                dropout_p=0.2)
            tb = sdpa_backend(device_ms_by_kernel(
                torch, lambda: torch.autograd.grad(so, (qq, kk, vv), torch.ones_like(so),
                                                   retain_graph=True)))
            del so
            log(f"  {name} {key} rate 0.2: forward {tm['fwd']:.4f} ms (device "
                f"{tm['device_fwd']}), backward {tm['bwd']:.4f} ms (device {tm['device_bwd']}; "
                f"launches {tm['bwd_launches']}); plain {pf_ms:.3f} / {pb_ms:.3f}; SDPA "
                f"{tm['sdpa_fwd']:.4f} / {tm['sdpa_bwd']:.4f} (device {tm['device_sdpa_fwd']} / "
                f"{tm['device_sdpa_bwd']}; backward backend {tb}); bound {fb:.4f} ({fby}) / "
                f"{bb:.4f} ({bby})")
            note(name, key, ms=tm["fwd"], device_ms=tm["device_fwd"], plain_ms=pf_ms,
                 library_ms=tm["sdpa_fwd"], library_device_ms=tm["device_sdpa_fwd"],
                 bound_ms=fb, bound_by=fby, library_backend=backend,
                 bwd={"ms": tm["bwd"], "device_ms": tm["device_bwd"], "plain_ms": pb_ms,
                      "library_ms": tm["sdpa_bwd"], "library_device_ms": tm["device_sdpa_bwd"],
                      "bound_ms": bb, "bound_by": bby, "library_backend": tb,
                      "launches_ms": tm["bwd_launches"]})
    for dk, H in timed:
        if (H * dk, H) in halves:
            half_heads_case(torch, results, gen, B, T, H * dk, H, timed=True, tag=tag)


def half_heads_case(torch, results, gen, B, T, D, H, timed, tag="head_dims"):
    """Kernels 1, 5 and 6 at (B, T, D, H) against their plain versions on
    random weights (q/k/v of 5 and 6: column blocks of one q|k|v buffer, as
    kernel 1 rounds them), lengths T, 0, one random and a short one; the dead
    rows as attention_halves_dk256 holds them; timed: events, device time,
    plain version and bound."""
    from fastspeech2_tpu_torch.ops import nn
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.precision import compute_dtype

    dev, bf16, dk = torch.device("cuda"), torch.bfloat16, D // H
    key = f"dk={dk},H={H},B={B},T={T}"

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    x = rnd(B, T, D, scale=2.0) + 0.5
    wqkv, wo = (rnd(3 * D, D) / D ** 0.5).to(bf16), (rnd(D, D) / D ** 0.5).to(bf16)
    bqkv, bo = rnd(3 * D, scale=0.1), rnd(D, scale=0.1)
    g, be = 1.0 + rnd(D, scale=0.2), rnd(D, scale=0.1)
    ls = torch.randint(T // 4, T + 1, (B,), generator=gen, dtype=torch.int32)
    ls[0], ls[1], ls[-1] = T, 0, max(1, T // 5)
    lc, lens = ls.tolist(), ls.to(dev)
    with torch.inference_mode(), compute_dtype(bf16):
        qkv = (x.to(bf16).float() @ wqkv.float().t()).to(bf16).float().add(bqkv).to(bf16)
        q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        a1 = (x, wqkv, bqkv, wo, bo, g, be, lens, H)
        a5 = (q, k, v, x, wo, bo, g, be, lens, H)
        a6 = (q, k, v, x, wo, bo, lens, H)
        dead = KA.attention_res_ln(q, k, v, x, wo, bo, g, be, torch.zeros_like(lens), H)
        torch.cuda.synchronize()
        worst = float((dead - nn.layer_norm(x + bo, g, be)).abs().max())
        assert worst < 1e-5, f"kernel 5 at length 0 vs LN(res + bo): {worst}, {key}"
        small = sum(4 * l * l * D + 2 * l * D * D for l in lc)
        live_qkv = 3 * sum(lc) * D * 2
        for name, fn, plain, args, flops, nb, want_dead in (
                ("attention_block", KA.attention_block, KA.attention_block_plain, a1,
                 sum(8 * l * D * D + 4 * l * l * D for l in lc), nbytes(x, x, *a1[1:7]), dead),
                ("attention_res_ln", KA.attention_res_ln, KA.attention_res_ln_plain, a5,
                 small, live_qkv + nbytes(x, x, wo, bo, g, be), dead),
                ("attention_res", KA.attention_res, KA.attention_res_plain, a6,
                 small, live_qkv + nbytes(x, x, wo, bo), x + bo)):
            got, want = fn(*args), plain(*args)
            torch.cuda.synchronize()
            log(f"kernel {name} {key}")
            err = compare(f"{name} {key}", got, want, 2e-3, 0.1)
            for b, n in enumerate(lc):
                assert torch.equal(got[b, n:], want_dead[b, n:]), f"{name} dead row {b}, {key}"
            log(f"  {name}: rows at or past each length bit for bit the dead-row constant "
                f"(kernel 5 at length 0 within {worst:.2e} of the plain LN(res + bo))")
            entry = {"max_abs_err": err}
            if timed:
                ms, pms = cuda_time_ms(lambda: fn(*args)), cuda_time_ms(lambda: plain(*args),
                                                                         reps=5)
                dms = sum(device_ms_by_kernel(torch, lambda: fn(*args)).values()) or None
                b_ms, by = bound_ms(flops, nb)
                log(f"  {name} {key}: kernel {ms:.4f} ms (device {dms}), plain {pms:.4f}, bound "
                    f"{b_ms:.4f} ({by})")
                entry.update(ms=ms, device_ms=dms, plain_ms=pms, bound_ms=b_ms, bound_by=by)
            results[name].setdefault(tag, {}).setdefault(key, {}).update(entry)
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)


#: (D, H) of kernels 2, 9 and 10 timed at the decoder rung's (16, 768), k = 9:
#: D and H no multiple of 32 (the kernels pad them to 288 / 224 and 1024)
#: beside the width they pad to, in turns (A, B, C, A, B, C)
WIDTH_FFN_TIMED = ((256, 1024), (260, 1000), (200, 1000))
#: the same at the one-head wide model's widths (WIDE_MODEL): the x tile in
#: 512-column chunks, H = 4096
WIDE_FFN_TIMED = ((1536, 4096), (2048, 4096))


def widths_kernel_phase(torch, results, timed=WIDTH_FFN_TIMED, tag="widths"):
    """Kernels 2, 9 and 10 at (16, 768), k = 9, at the (D, H) of
    ``timed``: against their plain versions, then in turns CUDA-event
    ms, profiler device ms, the plain version's ms and the bound at the real
    widths (the function's FLOPs on the live rows, its bytes at the real
    widths); the weights packed as the model packs them (``FFTBlock.
    ffn_pack``: padded once); results under each kernel's ``tag`` key. Then
    (tag "widths") the copy that kernels 5 and 6 make of
    q/k/v whose d_k is no multiple of 8 (D = 260, two heads: zero-filled to
    136 a head) at (16, 768), timed beside kernel 5 there."""
    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(23)
    B, T, k = 16, 768, 9
    ls = torch.randint(T // 4, T + 1, (B,), generator=gen, dtype=torch.int32)
    ls[0], ls[-1] = T, max(1, T // 5)
    lc, lens = ls.tolist(), ls.to(dev)
    cases = {}
    for D, H in timed:
        torch.manual_seed(D + H)
        blk = FFTBlock(EncoderConfig(idim=D, attention_dim=D, attention_heads=2,
                                     linear_units=H, positionwise_conv_kernel_size=k),
                       device=dev)
        with torch.inference_mode():
            fp = blk.ffn_pack(bf16)
        x = torch.randn(B, T, D, generator=gen).to(dev)
        cases[(D, H)] = (x, x.to(bf16), fp)
    rows = sum(min(l + (k - 1) // 2, T) for l in lc)

    def calls(x, xb, fp):
        return (("ffn_block", lambda: KF.ffn_block(x, *fp, lens, k),
                 lambda: KF.ffn_block_plain(x, *fp, lens, k), 8),
                ("ffn_block_pre", lambda: KF.ffn_block_pre(x, *fp, lens, k),
                 lambda: KF.ffn_block_pre_plain(x, *fp, lens, k), 8),
                ("fused_ffn", lambda: KF.fused_ffn(xb, *fp[:4], lens, k),
                 lambda: KF.fused_ffn_plain(xb, *fp[:4], lens, k), 4))

    with torch.inference_mode():
        for (D, H), case in cases.items():
            for name, fn, plain, _ in calls(*case):
                got, want = fn(), plain()
                torch.cuda.synchronize()
                err = compare(f"{name} D={D},H={H},B={B},T={T},k={k}", got, want, 2e-3, 0.1)
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
        for (D, H), case in list(cases.items()) * 2:
            key = f"D={D},H={H},B={B},T={T},k={k}"
            flops = rows * 2 * (k * D * H + H * D)
            wbytes = (k * D * H + H * D) * 2 + (H + 3 * D) * 4
            for name, fn, plain, io in calls(*case):
                ms = cuda_time_ms(fn)
                dms = sum(device_ms_by_kernel(torch, fn).values()) or None
                entry = results[name].setdefault(tag, {}).setdefault(key, {})
                if "plain_ms" not in entry:
                    entry["plain_ms"] = cuda_time_ms(plain, reps=3)
                b_ms, by = bound_ms(flops, B * T * D * io + wbytes)
                log(f"  {name} {key}: kernel {ms:.4f} ms (device {dms}), plain "
                    f"{entry['plain_ms']:.4f}, bound {b_ms:.4f} ({by})")
                entry.setdefault("ms", []).append(ms)
                entry.setdefault("device_ms", []).append(dms)
                entry.update(bound_ms=b_ms, bound_by=by)
        if tag != "widths":
            return
        D, H = 260, 2
        q, kk, v, x = (torch.randn(B, T, D, generator=gen).to(dev) for _ in range(4))
        q, kk, v = (t.to(bf16) for t in (q, kk, v))
        wo = (torch.randn(D, D, generator=gen) / D ** 0.5).to(bf16).to(dev)
        bo, g, be = (torch.randn(D, generator=gen).to(dev) for _ in range(3))

        def copy():
            return KA._head_operands(q, kk, v, H)

        ms_copy = cuda_time_ms(copy)
        dms_copy = sum(device_ms_by_kernel(torch, copy).values()) or None
        ms5 = cuda_time_ms(lambda: KA.attention_res_ln(q, kk, v, x, wo, bo, g, be, lens, H))
        moved = 3 * B * T * (D + H * 136) * 2
        b_ms, _ = bound_ms(0, moved)
        log(f"  q/k/v copy at d_k 130 (D={D}, two heads, B={B}, T={T}): {ms_copy:.4f} ms "
            f"(device {dms_copy}; bound {b_ms:.4f} ms for {moved} bytes) of kernel 5's "
            f"{ms5:.4f} ms with it")
        results["attention_res_ln"].setdefault("widths", {})[f"qkv_copy dk=130,B={B},T={T}"] = \
            dict(ms=ms_copy, device_ms=dms_copy, bound_ms=b_ms, kernel5_ms=ms5)


#: the model of the widths phases: ``configs/default.yaml`` with these model
#: keys (encoder d_k 100, which both packages route to plain attention; the
#: decoder's d_k 130 through kernel 1; FFNs of 1,000 units through kernel 2)
WIDTH_MODEL = dict(adim=200, ddim=260, eunits=1000, dunits=1000)


def width_config(**model_keys):
    from fastspeech2_tpu_torch.config import Config, config_from_dict

    raw = Config().to_dict()
    raw["model"].update(WIDTH_MODEL, **model_keys)
    return config_from_dict(raw)


def widths_path_phase(torch, results):
    """The WIDTH_MODEL model (seed 0, duration bias 1.87) served in bf16:
    B=8 mel against the CPU port fed the card's durations (the band of the
    other models), the B=32 call's time and launches (kernel 1 in the
    decoder's blocks, kernel 2 in every block), a B=8 wav call through the
    default MelGAN; then a B=8 call with pre-LN blocks (kernels 6 and 9) and
    one through the int8 tier (kernel 1 on dequantized weights)."""
    import numpy as np

    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.vocoder.melgan import MelGANGenerator

    cfg = width_config()
    synth = Synthesizer(seeded_model(torch, cfg), bf16=True)
    b32, seqs = batch(32), batch(8, offset=8)
    synth.mel_from_token_batch(b32)  # warm: packs the kernel weights
    hold_b8_vs_cpu(torch, synth, cfg, "adim 200 / ddim 260 B=8", split=False)
    reset_counts()
    ms, (_, lens) = timed_calls(torch, lambda: synth.mel_from_token_batch(b32))
    per = {k: v // 5 for k, v in read_counts().items() if v}
    frames = int(lens.sum())
    log(f"adim 200 / ddim 260 B=32 mel call: {ms:.3f} ms median of 5, {frames} frames "
        f"({frames / ms * 1e3:.0f} mel-frames/s); launches a call {per}")
    # the encoder's 4 blocks take kernel 2 once; each decode group runs the
    # decoder's 4 blocks through kernels 1 and 2
    assert per["attention_block"] > 0 and per["ffn_block"] == per["attention_block"] + 4, per
    for k in ("variance_adaptor", "postnet"):
        assert per[k] > 0, per
    widths = results["attention_block"].setdefault("widths", {})
    widths.update({"model B=32 launches a call": per["attention_block"], "model B=32 ms": ms})
    results["ffn_block"].setdefault("widths", {})["model B=32 launches a call"] = \
        per["ffn_block"]

    synth.attach_vocoder(MelGANGenerator(bf16=True, seed=0))
    reset_counts()
    mel, wav, wav_lens = synth.wav_from_token_batch(seqs)
    counts = read_counts()
    live = np.arange(wav.shape[1])[None] < wav_lens[:, None]
    log(f"adim 200 / ddim 260 B=8 wav call: wav {wav.shape} int16, {int(wav_lens.sum())} "
        f"samples; launches { {k: v for k, v in counts.items() if v} }")
    assert wav.dtype == np.int16 and np.abs(wav[live]).max() > 0 and counts["resstack"] > 0
    del synth

    for what, keys, int8, want in (
            ("pre-LN", {k: True for k in PRENORM_KEYS}, False, ("attention_res", "ffn_block_pre")),
            ("int8", {}, True, ("attention_block",))):
        s2 = Synthesizer(seeded_model(torch, width_config(**keys)), bf16=True, int8=int8)
        s2.mel_from_token_batch(seqs)
        reset_counts()
        mel, lens = s2.mel_from_token_batch(seqs)
        counts = read_counts()
        log(f"adim 200 / ddim 260 {what} B=8: {int(lens.sum())} frames; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        assert np.isfinite(mel).all() and (lens > 0).all()
        for k in want:
            assert counts[k] > 0, (what, counts)
            results[k].setdefault("widths", {})[f"model {what} B=8 launches"] = counts[k]
        assert counts["ffn_block"] == 0 and (int8 or counts["attention_block"] == 0), counts
        del s2


#: the one-head wide model: ``configs/default.yaml`` at full depth (4 + 4
#: blocks, k = 9 FFNs, 5-layer postnet) with these model keys: encoder d_k
#: 1536, decoder d_k 2048 (kernel 1's projections and kernel 2's conv over x
#: tiles in 512-column chunks), 4,096-unit FFNs
WIDE_MODEL = dict(adim=1536, ddim=2048, aheads=1, eunits=4096, dunits=4096)
# cli_train_phase's depth: its commands and the CPU port's checks, not the blocks
CLI_TRAIN_DEPTH = dict(elayers=2, dlayers=2)
# wide_model_train_phase's depth: the widest train step is the run's longest;
# one block each still takes kernel 11 at d_k 1536 (encoder) and 2048 (decoder)
WIDE_TRAIN_DEPTH = dict(elayers=1, dlayers=1)


def wide_config(**model_keys):
    """``configs/default.yaml``'s Config with WIDE_MODEL and ``model_keys``."""
    from fastspeech2_tpu_torch.config import Config, config_from_dict

    raw = Config().to_dict()
    raw["model"].update(WIDE_MODEL, **model_keys)
    return config_from_dict(raw)


def wide_model_path_phase(torch, results, default_ms, default_wav_ms):
    """The WIDE_MODEL model (seed 0, duration bias 1.87) served in bf16:
    B=1, 8 and 32 mel calls through kernel 1 and 2 in all 8 blocks with
    kernels 3 and 4; B=8 against the CPU port fed the card's durations; the
    B=32 mel call timed beside the default model's (``default_ms``, this
    run); a B=32 wav call with the default MelGAN beside the default model's
    (``default_wav_ms``); then B=8 calls with pre-LN blocks (kernels 6 and
    9), through the int8 tier (kernel 1 on dequantized weights, 3 and 4;
    with FUSED_ATT_QKV off kernel 5) and with concat_after (kernel 7); and a
    two-head model (decoder d_k 1024, encoder 768) on the chunked FFN path."""
    import numpy as np

    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.ops import flags
    from fastspeech2_tpu_torch.vocoder.melgan import MelGANGenerator

    cfg = wide_config()
    synth = Synthesizer(seeded_model(torch, cfg), bf16=True)
    n_params = sum(p.numel() for p in synth.model.parameters())
    b32, seqs = batch(32), batch(8, offset=8)
    synth.mel_from_token_batch(b32)  # warm: packs the kernel weights
    reset_counts()
    for n in (1, 8, 32):
        mel, lens = synth.mel_from_token_batch(batch(n, offset=n))
        assert np.isfinite(mel).all() and (lens > 0).all(), f"wide model B={n}"
        log(f"wide model ({n_params / 1e6:.1f} M parameters) B={n}: mel {mel.shape}, "
            f"frames {int(lens.sum())}")
    counts = read_counts()
    log(f"wide model B=1, 8, 32 launches: { {k: v for k, v in counts.items() if v} }")
    for k in ("attention_block", "ffn_block", "variance_adaptor", "postnet"):
        assert counts[k] > 0, k
    assert counts["attention_block"] == counts["ffn_block"], counts
    results["attention_block"]["launches_wide_model"] = counts["attention_block"]
    results["ffn_block"]["launches_wide_model"] = counts["ffn_block"]
    reset_counts()
    ms, (_, lens) = timed_calls(torch, lambda: synth.mel_from_token_batch(b32))
    per = {k: v // 5 for k, v in read_counts().items() if v}
    frames = int(lens.sum())
    log(f"wide model B=32 mel call: {ms:.3f} ms median of 5 ({default_ms:.3f} ms for "
        f"default.yaml in this run, {ms / default_ms:.2f}x), {frames} frames "
        f"({frames / ms * 1e3:.0f} mel-frames/s); launches a call {per}")
    assert per["attention_block"] >= 8 and per["ffn_block"] == per["attention_block"], per
    for k in ("attention_block", "ffn_block"):
        results[k].setdefault("wide", {}).update({
            "model B=32 launches a call": per[k], "model B=32 ms": ms,
            "default model B=32 ms": default_ms})
    hold_b8_vs_cpu(torch, synth, cfg, "wide model B=8", split=False)
    profile_phase(torch, lambda: synth.mel_from_token_batch(b32), "wide model B=32 mel call")

    synth.attach_vocoder(MelGANGenerator(bf16=True, seed=0))
    synth.wav_from_token_batch(b32)  # warm
    reset_counts()
    wms, (mel, wav, wav_lens) = timed_calls(torch, lambda: synth.wav_from_token_batch(b32), n=3)
    counts = {k: v // 3 for k, v in read_counts().items() if v}
    live = np.arange(wav.shape[1])[None] < wav_lens[:, None]
    log(f"wide model B=32 wav call: {wms:.3f} ms median of 3 ({default_wav_ms:.3f} ms for "
        f"default.yaml in this run), wav {wav.shape} int16, {int(wav_lens.sum())} samples; "
        f"launches a call {counts}")
    assert wav.dtype == np.int16 and np.abs(wav[live]).max() > 0 and counts["resstack"] > 0
    results["ffn_block"]["wide"]["model B=32 wav ms"] = wms
    results["ffn_block"]["wide"]["default model B=32 wav ms"] = default_wav_ms
    del synth
    torch.cuda.empty_cache()

    for what, keys, int8, want, off in (
            ("pre-LN", {k: True for k in PRENORM_KEYS}, False,
             ("attention_res", "ffn_block_pre"), ("attention_block", "ffn_block")),
            ("int8", {}, True, ("attention_block", "variance_adaptor", "postnet"),
             ("ffn_block",)),
            ("concat_after", {"encoder_concat_after": True, "decoder_concat_after": True},
             False, ("fused_attention_packed", "ffn_block"), ("attention_block",)),
            ("two heads (d_k 768 / 1024)", {"aheads": 2}, False,
             ("attention_block", "ffn_block"), ())):
        s2 = Synthesizer(seeded_model(torch, wide_config(**keys)), bf16=True, int8=int8)
        s2.mel_from_token_batch(seqs)
        reset_counts()
        mel, lens = s2.mel_from_token_batch(seqs)
        counts = read_counts()
        log(f"wide model {what} B=8: {int(lens.sum())} frames; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        assert np.isfinite(mel).all() and (lens > 0).all()
        for k in want:
            assert counts[k] > 0, (what, counts)
            results[k].setdefault("wide", {})[f"model {what} B=8 launches"] = counts[k]
        assert all(counts[k] == 0 for k in off), (what, counts)
        if int8:
            reset_counts()
            flags.FUSED_ATT_QKV = False
            try:
                mel, lens = s2.mel_from_token_batch(seqs)
            finally:
                flags.FUSED_ATT_QKV = True
            counts = read_counts()
            log(f"wide model int8 FUSED_ATT_QKV=off B=8: launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            assert counts["attention_res_ln"] > 0 and counts["attention_block"] == 0, counts
            assert np.isfinite(mel).all() and (lens > 0).all()
            results["attention_res_ln"].setdefault("wide", {})["model int8 B=8 launches"] = \
                counts["attention_res_ln"]
        del s2
        torch.cuda.empty_cache()


def wide_model_train_phase(torch, results, store):
    """``train()`` on the seeded store with the WIDE_MODEL model cut to
    one encoder and one decoder block (WIDE_TRAIN_DEPTH: the widths kept,
    the depth cut to keep the run inside its time limit) in bf16, batch 16
    x accum 4: 2 steps through kernel 11 at d_k 1536 and 2048 (8 / 8
    launches a step), finite losses; the single-process step on one window
    run twice from the same start, its gradients bit for bit; one step with
    FUSED_ATT_TRAIN_PACKED off (kernel 12, 8 / 8)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from fastspeech2_tpu_torch.config import DataConfig
    from fastspeech2_tpu_torch.data.batching import BucketBatcher
    from fastspeech2_tpu_torch.data.dataset import TTSDataset
    from fastspeech2_tpu_torch.data.prefetch import batch_to_device
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.ops import flags
    from fastspeech2_tpu_torch.train.loop import train
    from fastspeech2_tpu_torch.train.optimizer import NoamAdam
    from fastspeech2_tpu_torch.train.seeds import SeedSchedule
    from fastspeech2_tpu_torch.train.step import TrainState, make_train_step, trainable

    work = tempfile.mkdtemp(prefix="fs2_trainwide_", dir=str(ROOT / "build"))
    try:
        root, fl = store
        cfg = wide_config(**WIDE_TRAIN_DEPTH)
        blocks = WIDE_TRAIN_DEPTH["elayers"] + WIDE_TRAIN_DEPTH["dlayers"]
        accum = cfg.train.accum_grad
        cfg = dataclasses.replace(
            cfg, data=DataConfig(data_dir=root, train_filelist=fl, valid_filelist=fl),
            train=dataclasses.replace(cfg.train, bf16=True, summary_interval=1,
                                      save_interval=10 ** 6, validation_step=10 ** 6))
        reset_counts()
        t0 = time.perf_counter()
        ts = train(cfg, "wide", f"{work}/out", max_steps=2)
        torch.cuda.synchronize()
        counts = read_counts()
        recs = [json.loads(ln) for ln in open(f"{work}/out/logs/wide/train_metrics.jsonl")]
        main = [r for r in recs if "main/loss" in r]
        assert [r["step"] for r in main] == [1, 2] and all(
            np.isfinite(r["main/loss"]) and np.isfinite(r["main/grad_norm"]) for r in main), main
        got = (counts["attention_train_packed"], counts["attention_train_packed.bwd"])
        log(f"wide model train(): 2 steps in {time.perf_counter() - t0:.1f} s, loss "
            f"{main[0]['main/loss']:.1f} -> {main[1]['main/loss']:.1f}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; kernel 11 launches {got}")
        assert got == (2 * blocks * accum,) * 2 and counts["attention_train"] == 0, counts
        results["attention_train_packed"].setdefault("wide", {})["model step launches"] = \
            got[0] // 2

        # the single-process step twice from the same start: the same bits
        ds = TTSDataset(root, fl)
        batch_np, shape = next(iter(BucketBatcher(
            ds, batch_size=cfg.train.batch_size * accum, seed=1).epoch(0)))
        dev_batch = batch_to_device(batch_np, ts.model.device)
        del ts
        torch.cuda.empty_cache()

        def gradients():
            model = FastSpeech2(cfg, generator=torch.Generator().manual_seed(0))
            opt = NoamAdam(trainable(model), cfg)
            kept = []
            opt.step = lambda grads: kept.extend(t.detach().clone() for t in grads) or \
                torch.zeros((), device=model.device)
            seeds = SeedSchedule(model.dropout_sites(), seed=0)
            make_train_step(model, opt, accum, bf16=True)(
                TrainState(model, opt), dev_batch, [seeds.draw() for _ in range(accum)])
            return kept

        a = gradients()
        torch.cuda.empty_cache()
        b = gradients()
        differ = sum(not torch.equal(x, y) for x, y in zip(a, b))
        log(f"wide model step (16 x 4, pad {shape}) run twice: {differ} of {len(a)} "
            "gradients differ")
        assert differ == 0 and all(bool(torch.isfinite(x).all()) for x in a)
        del a, b
        torch.cuda.empty_cache()

        reset_counts()
        flags.FUSED_ATT_TRAIN_PACKED = False
        try:
            train(cfg, "wide12", f"{work}/out", max_steps=1)
            torch.cuda.synchronize()
        finally:
            flags.FUSED_ATT_TRAIN_PACKED = True
        counts = read_counts()
        got = (counts["attention_train"], counts["attention_train.bwd"])
        log(f"wide model FUSED_ATT_TRAIN_PACKED=off, 1 step: kernel 12 launches {got}")
        assert got == (blocks * accum,) * 2 and counts["attention_train_packed"] == 0, counts
        results["attention_train"].setdefault("wide", {})["model step launches"] = got[0]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def widths_train_phase(torch, results, store):
    """``train()`` on the seeded store with the WIDTH_MODEL model in bf16,
    batch 16 x accum 4: 4 steps through kernel 11 at d_k 130 in the
    decoder's blocks (the encoder's d_k 100 takes plain attention), run
    twice from the same seed; the two runs' parameters and loss records bit
    for bit."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from fastspeech2_tpu_torch.config import DataConfig
    from fastspeech2_tpu_torch.train.loop import train

    work = tempfile.mkdtemp(prefix="fs2_trainw_", dir=str(ROOT / "build"))
    try:
        root, fl = store
        cfg = width_config()
        accum = cfg.train.accum_grad
        cfg = dataclasses.replace(
            cfg, data=DataConfig(data_dir=root, train_filelist=fl, valid_filelist=fl),
            train=dataclasses.replace(cfg.train, bf16=True, summary_interval=1,
                                      save_interval=10 ** 6, validation_step=10 ** 6))
        runs = []
        for i in range(2):
            reset_counts()
            t0 = time.perf_counter()
            ts = train(cfg, f"widths{i}", f"{work}/out", max_steps=4)
            torch.cuda.synchronize()
            counts = read_counts()
            recs = [json.loads(ln) for ln in
                    open(f"{work}/out/logs/widths{i}/train_metrics.jsonl")]
            main = [r for r in recs if "main/loss" in r]
            assert [r["step"] for r in main] == [1, 2, 3, 4] and all(
                np.isfinite(r["main/loss"]) for r in main), main
            got = (counts["attention_train_packed"], counts["attention_train_packed.bwd"])
            log(f"adim 200 / ddim 260 train() run {i}: 4 steps in "
                f"{time.perf_counter() - t0:.1f} s, loss {main[0]['main/loss']:.1f} -> "
                f"{main[-1]['main/loss']:.1f}; kernel 11 launches {got}")
            # 4 decoder blocks x accum x 4 steps; the encoder's d_k 100 is plain
            assert got == (4 * accum * 4,) * 2, counts
            results["attention_train_packed"].setdefault("widths", {})[
                "model train step launches"] = got[0] // 4
            runs.append(([r["main/loss"] for r in main],
                         [p.detach().clone() for p in ts.model.parameters()]))
            del ts
        differ = sum(not torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
        log(f"adim 200 / ddim 260 train() twice: losses {runs[0][0]} / {runs[1][0]}; "
            f"{differ} of {len(runs[0][1])} parameters differ after 4 steps")
        assert runs[0][0] == runs[1][0] and differ == 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


def one_head_path_phase(torch, results):
    """``configs/default.yaml`` with ``aheads: 1`` (encoder 4 blocks at d_k
    256, decoder 4 at d_k 384; seed 0, duration bias 1.87): B=1, 8 and 32
    mel calls through kernel 1 in all 8 blocks (12 launches a B=32 call, as at
    two heads) with kernels 2-4; B=8 against the CPU port fed the card's
    durations; a B=8 call each with FUSED_ATT_QKV off (kernel 5), with
    pre-LN blocks (kernel 6) and with concat_after (kernel 7). Then
    ``adim: 320`` at two heads (encoder d_k 160) serves a B=8 call through
    kernel 1, held the same way."""
    import numpy as np

    from fastspeech2_tpu_torch.config import Config, config_from_dict
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.ops import flags

    raw = Config().to_dict()
    raw["model"].update(aheads=1)
    cfg = config_from_dict(raw)
    synth = Synthesizer(seeded_model(torch, cfg), bf16=True)
    b32 = batch(32)
    synth.mel_from_token_batch(b32)  # warm: packs the kernel weights
    reset_counts()
    for n in (1, 8, 32):
        mel, lens = synth.mel_from_token_batch(batch(n, offset=n))
        assert np.isfinite(mel).all() and (lens > 0).all(), f"one head B={n}"
        log(f"one head (d_k 256 / 384) B={n}: mel {mel.shape}, frames {int(lens.sum())}")
    counts = read_counts()
    log(f"one head B=1, 8, 32 launches: { {k: v for k, v in counts.items() if v} }")
    for k in ("attention_block", "ffn_block", "variance_adaptor", "postnet"):
        assert counts[k] > 0, k
    results["attention_block"]["launches_one_head"] = counts["attention_block"]
    reset_counts()
    ms, (_, lens) = timed_calls(torch, lambda: synth.mel_from_token_batch(b32))
    counts = read_counts()
    per = {k: v // 5 for k, v in counts.items() if v}
    log(f"one head B=32 mel call: {ms:.3f} ms median of 5, {int(lens.sum())} frames; "
        f"launches a call {per}")
    assert per["attention_block"] == 12 and per["ffn_block"] == 12, per
    results["attention_block"]["launches_one_head_b32"] = per["attention_block"]
    hold_b8_vs_cpu(torch, synth, cfg, "one head B=8")

    seqs = batch(8, offset=8)
    reset_counts()
    flags.FUSED_ATT_QKV = False
    try:
        mel, lens = synth.mel_from_token_batch(seqs)
    finally:
        flags.FUSED_ATT_QKV = True
    counts = read_counts()
    log(f"one head FUSED_ATT_QKV=off B=8: launches { {k: v for k, v in counts.items() if v} }")
    assert counts["attention_res_ln"] > 0 and counts["attention_block"] == 0, counts
    assert np.isfinite(mel).all() and (lens > 0).all()
    results["attention_res_ln"]["launches_one_head_b8"] = counts["attention_res_ln"]
    del synth
    for what, keys, kernel in (("pre-LN", PRENORM_KEYS, "attention_res"),
                               ("concat_after", ("encoder_concat_after",
                                                 "decoder_concat_after"),
                                "fused_attention_packed")):
        raw2 = Config().to_dict()
        raw2["model"].update(aheads=1, **{k: True for k in keys})
        cfg2 = config_from_dict(raw2)
        s2 = Synthesizer(seeded_model(torch, cfg2), bf16=True)
        s2.mel_from_token_batch(seqs)
        reset_counts()
        mel, lens = s2.mel_from_token_batch(seqs)
        counts = read_counts()
        log(f"one head {what} B=8: {int(lens.sum())} frames; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        assert counts[kernel] > 0 and counts["attention_block"] == 0, counts
        assert np.isfinite(mel).all() and (lens > 0).all()
        results[kernel]["launches_one_head_b8"] = counts[kernel]
        del s2

    raw3 = Config().to_dict()
    raw3["model"].update(adim=320, aheads=2)
    cfg3 = config_from_dict(raw3)
    s3 = Synthesizer(seeded_model(torch, cfg3), bf16=True)
    s3.mel_from_token_batch(seqs)
    reset_counts()
    mel, lens = s3.mel_from_token_batch(seqs)
    counts = read_counts()
    log(f"adim 320, two heads (encoder d_k 160) B=8: {int(lens.sum())} frames; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    assert counts["attention_block"] > 0 and np.isfinite(mel).all() and (lens > 0).all()
    results["attention_block"]["launches_dk160_b8"] = counts["attention_block"]
    # this model's durations put the whole batch on one rung
    hold_b8_vs_cpu(torch, s3, cfg3, "adim 320 B=8", split=False)


def one_head_train_phase(torch, results, store):
    """``train()`` on the seeded store with ``aheads: 1`` at full width in
    bf16, batch 16 x accum 4 (T <= 896): 2 steps through kernel 11 at d_k
    256 and 384 (32 / 32 launches a step); the single-process step on one
    window run twice from the same start, its gradients bit for bit; one
    step with FUSED_ATT_TRAIN_PACKED off (kernel 12, 32 / 32)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from fastspeech2_tpu_torch.config import Config, DataConfig
    from fastspeech2_tpu_torch.data.batching import BucketBatcher
    from fastspeech2_tpu_torch.data.dataset import TTSDataset
    from fastspeech2_tpu_torch.data.prefetch import batch_to_device
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.ops import flags
    from fastspeech2_tpu_torch.train.loop import train
    from fastspeech2_tpu_torch.train.optimizer import NoamAdam
    from fastspeech2_tpu_torch.train.seeds import SeedSchedule
    from fastspeech2_tpu_torch.train.step import TrainState, make_train_step, trainable

    work = tempfile.mkdtemp(prefix="fs2_train1h_", dir=str(ROOT / "build"))
    try:
        root, fl = store
        cfg = Config()
        accum = cfg.train.accum_grad
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, aheads=1),
            data=DataConfig(data_dir=root, train_filelist=fl, valid_filelist=fl),
            train=dataclasses.replace(cfg.train, bf16=True, summary_interval=1,
                                      save_interval=10 ** 6, validation_step=10 ** 6))
        reset_counts()
        t0 = time.perf_counter()
        ts = train(cfg, "one_head", f"{work}/out", max_steps=2)
        torch.cuda.synchronize()
        counts = read_counts()
        recs = [json.loads(ln) for ln in open(f"{work}/out/logs/one_head/train_metrics.jsonl")]
        main = [r for r in recs if "main/loss" in r]
        assert [r["step"] for r in main] == [1, 2] and all(
            np.isfinite(r["main/loss"]) and np.isfinite(r["main/grad_norm"]) for r in main), main
        got = (counts["attention_train_packed"], counts["attention_train_packed.bwd"])
        log(f"one head train(): 2 steps in {time.perf_counter() - t0:.1f} s, loss "
            f"{main[0]['main/loss']:.1f} -> {main[1]['main/loss']:.1f}; kernel 11 launches {got}")
        assert got == (2 * 8 * accum,) * 2 and counts["attention_train"] == 0, counts
        results["attention_train_packed"]["launches_one_head_step"] = got[0] // 2

        # the single-process step twice from the same start: the same bits
        ds = TTSDataset(root, fl)
        batch_np, shape = next(iter(BucketBatcher(
            ds, batch_size=cfg.train.batch_size * accum, seed=1).epoch(0)))
        dev_batch = batch_to_device(batch_np, ts.model.device)

        def gradients():
            model = FastSpeech2(cfg, generator=torch.Generator().manual_seed(0))
            opt = NoamAdam(trainable(model), cfg)
            kept = []
            opt.step = lambda grads: kept.extend(t.detach().clone() for t in grads) or \
                torch.zeros((), device=model.device)
            seeds = SeedSchedule(model.dropout_sites(), seed=0)
            make_train_step(model, opt, accum, bf16=True)(
                TrainState(model, opt), dev_batch, [seeds.draw() for _ in range(accum)])
            return kept

        a, b = gradients(), gradients()
        differ = sum(not torch.equal(x, y) for x, y in zip(a, b))
        log(f"one head step (16 x 4, pad {shape}) run twice: {differ} of {len(a)} gradients "
            "differ")
        assert differ == 0 and all(bool(torch.isfinite(x).all()) for x in a)

        reset_counts()
        flags.FUSED_ATT_TRAIN_PACKED = False
        try:
            train(cfg, "one_head12", f"{work}/out", max_steps=1)
            torch.cuda.synchronize()
        finally:
            flags.FUSED_ATT_TRAIN_PACKED = True
        counts = read_counts()
        got = (counts["attention_train"], counts["attention_train.bwd"])
        log(f"one head FUSED_ATT_TRAIN_PACKED=off, 1 step: kernel 12 launches {got}")
        assert got == (8 * accum,) * 2 and counts["attention_train_packed"] == 0, counts
        results["attention_train"]["launches_one_head_step"] = got[0]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def seeded_model(torch, cfg):
    """The main path's model for ``cfg``: torch's generator seeded with 0,
    duration bias 1.87 (as bench.py does), on the card."""
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2

    torch.manual_seed(0)
    model = FastSpeech2(cfg)
    with torch.no_grad():
        model.duration_predictor.out.bias.fill_(1.87)
    return model


def override_config(work, name, model_keys):
    """A minimal override YAML in ``work``, loaded onto Config()."""
    from fastspeech2_tpu_torch.config import load_config

    path = Path(work, f"{name}.yaml")
    path.write_text("model:\n" + "".join(f"  {k}: true\n" for k in model_keys))
    return load_config(str(path))


PRENORM_KEYS = ("encoder_normalize_before", "decoder_normalize_before")


def cli_server_phase(ckpt, work, what="prenorm CLI server", extra_args=("--warmup",),
                     rounds=2, expect=("attention_res", "ffn_block_pre"),
                     absent=("attention_block", "ffn_block")):
    """`python -m fastspeech2_tpu_torch serve -p CKPT [extra_args]` (default
    ``--warmup``) as a subprocess on the card (no -c: the config comes from
    the checkpoint): two requests, ``rounds`` rounds of 16 concurrent mel
    requests (the last reported), a Griffin-Lim wav request; its launch
    counts from /healthz: every kernel of ``expect`` launched, none of
    ``absent``. The process is stopped in every case."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    log_path = Path(work, "serve.log")
    t0 = time.perf_counter()
    with open(log_path, "wb") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "fastspeech2_tpu_torch", "serve", "-p", ckpt,
             "--host", "127.0.0.1", "--port", str(port), "--max_batch", "16", *extra_args],
            cwd=str(ROOT), env={**os.environ, "PYTHONPATH": str(ROOT)}, stdout=logf,
            stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError("the CLI server exited:\n" + log_path.read_text()[-3000:])
            try:
                healthz(url)
                break
            except OSError:
                assert time.perf_counter() - t0 < 300, "the CLI server did not come up in 300 s"
                time.sleep(0.25)
        log(f"{what}: up in {time.perf_counter() - t0:.1f} s (process start, "
            f"checkpoint load{', ' + ' '.join(extra_args) if extra_args else ''})")
        first = []
        for text in TEXTS[:2]:
            t1 = time.perf_counter()
            http_post(url, "/synthesize", {"text": text})
            first.append((time.perf_counter() - t1) * 1e3)
        walls = [concurrent_round(url, 16, "mel")[0] for _ in range(rounds - 1)]
        wall, lat, nb, frames, _ = concurrent_round(url, 16, "mel")
        rps, med = 16 / wall, statistics.median(lat) * 1e3
        log(f"{what}: first two requests {first[0]:.1f}, {first[1]:.1f} ms; "
            + "".join(f"round {i + 1} {16 / w:.1f} requests/s; " for i, w in enumerate(walls))
            + f"round {rounds}: 16 concurrent mel requests in {nb} batches, "
            f"{frames} frames, {rps:.1f} requests/s, median latency {med:.1f} ms, max "
            f"{max(lat) * 1e3:.1f} ms")
        headers, body = http_post(url, "/synthesize", {"phonemes": SENTENCES[2], "format": "wav"})
        assert headers["Content-Type"] == "audio/wav"
        n = riff_samples(body)
        launches = healthz(url)["launches"]
        log(f"{what}: Griffin-Lim wav request {n} samples; the server's launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        assert all(launches[k] > 0 for k in expect), launches
        assert not any(launches[k] for k in absent), launches
        return rps, med
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        log(f"{what}: stopped (exit code {proc.returncode})")


def prenorm_path_phase(torch, results):
    """The pre-LN model at full width and depth (``prenorm``): through the
    CLI server in a subprocess, in process at B=1/8/32, against the CPU
    port, and through the CLI synth command."""
    import shutil
    import tempfile

    import numpy as np
    from scipy.io.wavfile import read as read_wav

    from fastspeech2_tpu_torch import cli
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.train.checkpoint import save_checkpoint

    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="fs2_prenorm_", dir=str(ROOT / "build"))
    try:
        cfg = override_config(work, "prenorm", PRENORM_KEYS)
        assert cfg.model.encoder_normalize_before and cfg.model.decoder_normalize_before
        model = seeded_model(torch, cfg)
        ckpt = f"{work}/prenorm.npz"
        save_checkpoint(ckpt, model, None, 0, cfg)
        rps, med = cli_server_phase(ckpt, work)

        synth = Synthesizer(model, bf16=True)
        b32 = batch(32)
        synth.mel_from_token_batch(b32)  # warm: packs, handles, allocator
        reset_counts()
        for n in (1, 8, 32):
            mel, lens = synth.mel_from_token_batch(batch(n, offset=n))
            assert np.isfinite(mel).all() and (lens > 0).all(), f"prenorm B={n}"
        counts = read_counts()
        log(f"prenorm launches (B=1,8,32): { {k: v for k, v in counts.items() if v} }")
        for k in ("attention_res", "ffn_block_pre", "variance_adaptor", "postnet"):
            assert counts[k] > 0, f"kernel {k} was not launched on the prenorm path"
        assert counts["attention_block"] == counts["ffn_block"] == 0, counts
        assert counts["fused_attention_packed"] == counts["attention_res_ln"] == 0, counts
        # kernels 8 and 10: no model route reaches them, as in the JAX package
        assert counts["fused_attention"] == counts["fused_ffn"] == 0, counts
        for k in ("attention_res", "ffn_block_pre", "fused_attention", "fused_ffn"):
            results[k]["launches"] = counts[k]
        reset_counts()
        synth.mel_from_token_batch(b32)
        per = read_counts()
        log(f"prenorm launches per B=32 mel call: { {k: v for k, v in per.items() if v} }")
        # 4 encoder blocks + 4 decoder blocks x 2 decode groups
        assert per["attention_res"] == per["ffn_block_pre"] == 12, per
        ms, (_, lens) = timed_calls(torch, lambda: synth.mel_from_token_batch(b32))
        frames = int(lens.sum())
        log(f"prenorm B=32 mel call: {ms:.3f} ms median of 5, {frames} mel frames, "
            f"{frames / ms * 1e3:.0f} mel-frames/s")
        profile_phase(torch, lambda: synth.mel_from_token_batch(b32), "prenorm B=32 mel call")
        hold_b8_vs_cpu(torch, synth, cfg, "prenorm B=8")

        out = Path(work, "synth")
        t0 = time.perf_counter()
        cli.main(["synth", "-p", ckpt, "--phonemes", "--text", SENTENCES[0], "-o", str(out)])
        mel = np.load(out / "mel.npy")
        sr, wav = read_wav(str(out / "test_tts.wav"))
        assert mel.shape[0] == 80 and mel.shape[1] > 0 and np.isfinite(mel).all(), mel.shape
        assert sr == 22050 and len(wav) == (mel.shape[1] - 1) * 256 > 0, (sr, len(wav))
        log(f"prenorm synth command on the card (f32 tier, Griffin-Lim): mel.npy {mel.shape}, "
            f"test_tts.wav {len(wav)} samples in {time.perf_counter() - t0:.1f} s")
        return {"ms": ms, "frames": frames, "rps": rps, "median_ms": med}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def prenorm_concat_phase(torch, results):
    """``prenorm_concat``: pre-LN and concat_after in both stacks, a B=8 mel
    call: the bare attention kernel (7) and the pre-LN FFN kernel (9), not
    kernel 6; the served rows held against the CPU port."""
    import shutil
    import tempfile

    import numpy as np

    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer

    work = tempfile.mkdtemp(prefix="fs2_concat_", dir=str(ROOT / "build"))
    try:
        cfg = override_config(work, "prenorm_concat", PRENORM_KEYS + (
            "encoder_concat_after", "decoder_concat_after"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    assert cfg.model.encoder_concat_after and cfg.model.decoder_normalize_before
    synth = Synthesizer(seeded_model(torch, cfg), bf16=True)
    seqs = batch(8, offset=8)
    synth.mel_from_token_batch(seqs)
    reset_counts()
    mel, lens = synth.mel_from_token_batch(seqs)
    counts = read_counts()
    log(f"prenorm_concat B=8 mel call: {int(lens.sum())} frames; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    assert np.isfinite(mel).all() and (lens > 0).all()
    assert counts["fused_attention_packed"] > 0 and counts["ffn_block_pre"] > 0, counts
    assert counts["attention_res"] == counts["attention_block"] == 0, counts
    assert counts["fused_attention"] == counts["fused_ffn"] == 0, counts
    results["fused_attention_packed"]["launches"] = counts["fused_attention_packed"]
    hold_b8_vs_cpu(torch, synth, cfg, "prenorm_concat B=8")


def dk256_path_phase(torch, results):
    """A post-LN model with one head of 256 in both stacks (``adim`` and
    ``ddim`` 256, ``aheads`` 1; otherwise the default config, seed 0,
    duration bias 1.87) serves a B=8 mel call through kernel 1 at d_k 256,
    which its launch counter shows, and the served rows are held against
    the CPU port fed the card's durations."""
    import numpy as np

    from fastspeech2_tpu_torch.config import Config, config_from_dict
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer

    raw = Config().to_dict()
    raw["model"].update(adim=256, ddim=256, aheads=1)
    cfg = config_from_dict(raw)
    synth = Synthesizer(seeded_model(torch, cfg), bf16=True)
    seqs = batch(8, offset=8)
    synth.mel_from_token_batch(seqs)  # warm: packs the kernel weights
    reset_counts()
    mel, lens = synth.mel_from_token_batch(seqs)
    counts = read_counts()
    log(f"d_k 256 (adim = ddim = 256, one head) B=8 mel call: {int(lens.sum())} frames; "
        f"launches { {k: v for k, v in counts.items() if v} }")
    assert np.isfinite(mel).all() and (lens > 0).all()
    assert counts["attention_block"] > 0 and counts["ffn_block"] > 0, counts
    assert counts["attention_res_ln"] == counts["fused_attention_packed"] == 0, counts
    results["attention_block"]["launches_dk256_b8"] = counts["attention_block"]
    hold_b8_vs_cpu(torch, synth, cfg, "d_k 256 B=8")


def wide_postnet_path_phase(torch, results):
    """A post-LN model with the Tacotron-2 / ESPnet2 postnet width
    (``postnet_chans`` 512: kernel 4's 64-row stages) and ``adim`` 384
    (kernel 3 at D = 384; otherwise the default config, seed 0, duration
    bias 1.87) serves a B=8 mel call through kernels 3 and 4, which their
    launch counters show, and the served rows are held against the CPU port
    fed the card's durations."""
    import numpy as np

    from fastspeech2_tpu_torch.config import Config, config_from_dict
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer

    raw = Config().to_dict()
    raw["model"].update(adim=384, postnet_chans=512)
    cfg = config_from_dict(raw)
    synth = Synthesizer(seeded_model(torch, cfg), bf16=True)
    seqs = batch(8, offset=8)
    synth.mel_from_token_batch(seqs)  # warm: packs the kernel weights
    reset_counts()
    mel, lens = synth.mel_from_token_batch(seqs)
    counts = read_counts()
    log(f"wide postnet (postnet_chans 512, adim 384) B=8 mel call: {int(lens.sum())} frames; "
        f"launches { {k: v for k, v in counts.items() if v} }")
    assert np.isfinite(mel).all() and (lens > 0).all()
    assert counts["variance_adaptor"] > 0 and counts["postnet"] > 0, counts
    assert counts["attention_block"] > 0 and counts["ffn_block"] > 0, counts
    results["variance_adaptor"]["launches_wide_b8"] = counts["variance_adaptor"]
    results["postnet"]["launches_wide_b8"] = counts["postnet"]
    hold_b8_vs_cpu(torch, synth, cfg, "wide postnet B=8")


#: the variance adaptor's and the postnet's width phases: ``model`` and
#: ``audio`` keys over configs/default.yaml
CONV_WIDTH_MODELS = {
    "narrow": ({"adim": 60, "postnet_chans": 500}, {"num_mels": 100}),
    "wide": ({"adim": 1280, "variance_n_bins": 8192, "postnet_chans": 1024,
              "postnet_filts": 11, "postnet_layers": 10}, {}),
}


def conv_widths_path_phase(torch, results, which):
    """A CONV_WIDTH_MODELS model at full depth (seed 0, duration bias 1.87)
    served in bf16: narrow (``adim`` 60, two heads of d_k 30; 100 mels;
    ``postnet_chans`` 500: kernel 3 at D = 60, kernel 4 at C = 500, C0 =
    100) or wide (``adim`` 1280, two heads of d_k 640; 8,192 bins;
    ``postnet_chans`` 1024, k = 11, 10 layers: kernel 3 with the x tile in
    chunks and the edges counted in chunks, kernel 4 on its wide path). A
    B=8 mel call held against the CPU port fed the card's durations, then
    the B=32 call's time and launches; kernels 3 and 4 must launch in
    both."""
    from fastspeech2_tpu_torch.config import Config, config_from_dict
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer

    model_keys, audio_keys = CONV_WIDTH_MODELS[which]
    raw = Config().to_dict()
    raw["model"].update(model_keys)
    raw["audio"].update(audio_keys)
    cfg = config_from_dict(raw)
    synth = Synthesizer(seeded_model(torch, cfg), bf16=True)
    b32 = batch(32)
    synth.mel_from_token_batch(b32)  # warm: packs the kernel weights
    reset_counts()
    hold_b8_vs_cpu(torch, synth, cfg, f"{which} adaptor/postnet B=8", split=False)
    b8 = read_counts()
    reset_counts()
    ms, (mel, lens) = timed_calls(torch, lambda: synth.mel_from_token_batch(b32))
    per = {k: v // 5 for k, v in read_counts().items() if v}
    frames = int(lens.sum())
    log(f"{which} adaptor/postnet model {model_keys} {audio_keys} B=32 mel call: {ms:.3f} ms "
        f"median of 5, {frames} frames, mel {tuple(mel.shape)}; launches a call {per}; "
        f"B=8 launches { {k: v for k, v in b8.items() if v} }")
    for k in ("variance_adaptor", "postnet"):
        assert b8[k] > 0 and per.get(k, 0) > 0, (which, k, b8, per)
        results[k].setdefault("widths", {}).update({
            f"{which} model B=32 launches a call": per[k], f"{which} model B=32 ms": ms})
    del synth


#: the export phase's artifact signature (the batch, and the JAX defaults'
#: max_frames; 128 tokens cover the longest of the B=8 rows)
EXPORT_B, EXPORT_T, EXPORT_L = 8, 128, 1024


def export_phase(torch, results, smi):
    """``infer/export.py`` on the card, through the CLI ``export`` (the JAX
    command's flags): the main path's model (post-LN, seed 0, duration bias
    1.87) with ``--bf16``, with and without a baked MelGAN (the default
    generator, seed 0, written in the seungwonpark format), a pre-LN
    checkpoint, and one ``--bf16 --int8`` export. Each artifact is loaded
    (``load_exported``) and called at B=8: the kernels' launches from the
    counters (the expected numbers, one call); the mel (and wav) held to
    ``Synthesizer``'s on the same rows, lengths equal, live frames in
    ``hold_b8_vs_cpu``'s bf16 band (``Synthesizer`` at the artifact's
    matmul precision, the CLI's default); the artifact's call (outputs
    copied to the host) and ``Synthesizer``'s timed with CUDA events,
    median of 5.
    Returns (work directory, the MelGAN checkpoint, the post-LN model) for
    the golden phase; the caller removes the directory."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="fs2_export_", dir=str(ROOT / "build"))
    try:
        return _export_cases(torch, results, smi, work, t_phase)
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise


def _export_cases(torch, results, smi, work, t_phase):
    import numpy as np

    from fastspeech2_tpu_torch.config import Config
    from fastspeech2_tpu_torch.infer.export import load_exported
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.train.checkpoint import save_checkpoint
    from fastspeech2_tpu_torch.vocoder import (MelGANGenerator, load_melgan_params,
                                               melgan_state_dict)

    voc = f"{work}/melgan.pt"
    torch.save({"model_g": melgan_state_dict(MelGANGenerator(seed=0, device="cpu"))}, voc)
    seqs = batch(EXPORT_B, offset=8)
    xs = np.zeros((EXPORT_B, EXPORT_T), np.int32)
    ilens = np.asarray([len(s) for s in seqs], np.int32)
    for i, s in enumerate(seqs):
        xs[i, :len(s)] = s
    post = {"attention_block": 8, "ffn_block": 8, "variance_adaptor": 1, "postnet": 1}
    cases = (("post-LN", None, [], post),
             ("post-LN + MelGAN", None, ["--vocoder", voc], {**post, "resstack": 4}),
             ("pre-LN", PRENORM_KEYS, [],
              {"attention_res": 8, "ffn_block_pre": 8, "variance_adaptor": 1, "postnet": 1,
               "attention_block": 0, "ffn_block": 0}),
             ("int8", None, ["--int8"], {**post, "ffn_block": 0}))
    models = {}
    for name, keys, flags, want in cases:
        if keys not in models:
            cfg = override_config(work, "prenorm", keys) if keys else Config()
            models[keys] = seeded_model(torch, cfg)
            save_checkpoint(f"{work}/{'pre' if keys else 'post'}.npz", models[keys], None, 0,
                            cfg)
        model = models[keys]
        out = f"{work}/{name.replace(' ', '').replace('+', '_')}.pt2"
        _, secs = cli_main(torch, ["export", "-p", f"{work}/{'pre' if keys else 'post'}.npz",
                                   "-o", out, "--batch", str(EXPORT_B), "--max_tokens",
                                   str(EXPORT_T), "--max_frames", str(EXPORT_L), "--bf16",
                                   *flags])
        call = load_exported(out)
        call(xs, ilens)  # warm
        torch.cuda.synchronize()
        reset_counts()
        outs = [t.cpu().numpy() for t in call(xs, ilens)]
        counts = read_counts()
        log(f"export {name}: traced and saved in {secs:.1f} s "
            f"({Path(out).stat().st_size / 2**20:.1f} MiB); B=8 launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        bad = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
        assert not bad, f"export {name}: launches (got, want) {bad}"
        if name in ("post-LN + MelGAN", "pre-LN"):
            for k, n in want.items():
                if n:
                    results[k]["launches_export_b8"] = counts[k]
        # the artifact's precision: the CLI's default, TF32 for its f32 products
        # (the duration head) as Synthesizer(matmul_precision="default")
        synth = Synthesizer(model, bf16=True, int8="--int8" in flags,
                            matmul_precision="default")
        if flags and flags[0] == "--vocoder":
            synth.attach_vocoder(load_melgan_params(voc, bf16=True))
            s_mel, s_wav, s_wl = synth.wav_from_token_batch(seqs)
            s_lens = s_wl // 256
        else:
            s_mel, s_lens = synth.mel_from_token_batch(seqs)
        mel, lens = outs[0], outs[-1]
        assert np.array_equal(lens, s_lens), (name, lens, s_lens)
        assert mel.shape == (EXPORT_B, EXPORT_L, 80) and np.isfinite(mel).all()
        n = min(mel.shape[1], s_mel.shape[1])
        live = torch.from_numpy(np.arange(n)[None] < lens[:, None])
        compare(f"export {name} B=8 mel vs Synthesizer, live frames",
                torch.from_numpy(mel[:, :n])[live], torch.from_numpy(s_mel[:, :n])[live],
                0.02, 0.2)
        if len(outs) == 3:
            wav = outs[1]
            assert wav.dtype == np.int16 and wav.shape == (EXPORT_B, EXPORT_L * 256)
            n = min(wav.shape[1], s_wav.shape[1])
            live = torch.from_numpy(np.arange(n)[None] < s_wl[:, None])
            compare(f"export {name} B=8 wav vs Synthesizer (int16 PCM / 32768, live samples)",
                    torch.from_numpy(wav[:, :n].astype(np.float32) / 32768)[live],
                    torch.from_numpy(s_wav[:, :n].astype(np.float32) / 32768)[live],
                    0.02, 0.5)
        art_ms, _ = timed_calls(torch, lambda: [t.cpu() for t in call(xs, ilens)])
        syn = (synth.wav_from_token_batch if len(outs) == 3 else synth.mel_from_token_batch)
        syn_ms, _ = timed_calls(torch, lambda: syn(seqs))
        log(f"export {name} B=8 call: artifact {art_ms:.3f} ms (every row decoded at "
            f"{EXPORT_L} frames), Synthesizer {syn_ms:.3f} ms (demand rungs), median of 5 "
            f"on {smi}")
        del synth, call
        torch.cuda.empty_cache()
    log(f"export phase: {time.perf_counter() - t_phase:.1f} s")
    return work, voc, models[None]


GOLDEN_PHONEMES = (SENTENCES[0], SENTENCES[1])


def golden_phase(torch, results, work, voc, model):
    """``compat/golden.py`` on the card: a stand-in reference ``.pth`` at the
    default widths (the main path's model, through ``compat/torch_saver.py``)
    and the export phase's MelGAN. The CPU port's f32 run of the same
    functions writes the golden mel and wav. ``golden`` (``cli.main``) on
    the card in mel mode holds its mel to the CPU's within 1e-4 (max over
    the overlap, frames equal); in wav mode (``--vocoder``) it runs kernel
    13 in f32 and kernel 14 (its log-mel distance), both counted."""
    import numpy as np
    from scipy.io.wavfile import write as write_wav

    from fastspeech2_tpu_torch.compat import golden
    from fastspeech2_tpu_torch.compat.torch_saver import save_torch_checkpoint

    t_phase = time.perf_counter()
    pth = f"{work}/standin_58k.pth"
    save_torch_checkpoint(pth, model, model.cfg, step=58000)
    mel_cpu, _, _ = golden.synth_with_torch_checkpoint(pth, phoneme_strs=list(GOLDEN_PHONEMES),
                                                       device="cpu")
    np.save(f"{work}/golden.npy", mel_cpu)
    wav_cpu, sr, _ = golden.synth_wav_with_torch_checkpoints(
        pth, voc, phoneme_strs=list(GOLDEN_PHONEMES), device="cpu")
    write_wav(f"{work}/golden.wav", sr, (np.clip(wav_cpu, -1, 1) * 32768).clip(
        -32768, 32767).astype(np.int16))
    t_cpu = time.perf_counter() - t_phase
    args = ["golden", "-p", pth, "--phonemes", "|".join(GOLDEN_PHONEMES)]
    out, secs = cli_main(torch, args + ["--golden", f"{work}/golden.npy"])
    rep = json.loads(out)
    log(f"golden (mel) on the card vs the CPU port's f32 mel ({mel_cpu.shape}): "
        f"{ {k: rep[k] for k in ('mel_shape', 'frames_match', 'mae_overlap', 'max_abs_overlap')} }"
        f" in {secs:.1f} s (CPU reference {t_cpu:.1f} s)")
    assert rep["frames_match"] and rep["max_abs_overlap"] <= 1e-4, rep
    reset_counts()
    out, secs = cli_main(torch, args + ["--vocoder", voc, "--golden_wav", f"{work}/golden.wav",
                                        "--out_wav", f"{work}/out.wav"])
    counts = read_counts()
    rep = json.loads(out)
    keys = ("samples", "golden_samples", "duration_ratio", "log_mel_l1", "log_mel_rms")
    log(f"golden (wav, MelGAN f32) on the card vs the CPU port's wav: "
        f"{ {k: rep[k] for k in keys} } in {secs:.1f} s; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    assert rep["duration_ratio"] == 1.0 and rep["log_mel_l1"] < 0.05, rep
    assert counts["resstack"] > 0 and counts["stft_mel_energy"] > 0, counts
    results["resstack"]["launches_golden_f32"] = counts["resstack"]
    results["stft_mel_energy"]["launches_golden"] = counts["stft_mel_energy"]
    log(f"golden phase: {time.perf_counter() - t_phase:.1f} s")


def demo_phase():
    """``examples/demo_torch.py`` on the card (its default device), in its
    own process: a few train steps, reload, synthesis, Griffin-Lim wav."""
    import tempfile

    import numpy as np

    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="fs2_demo_", dir=str(ROOT / "build"))
    try:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(ROOT / "examples" / "demo_torch.py"),
                            "--workdir", work, "--steps", "4"], cwd=str(ROOT),
                           capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, f"demo_torch.py exited {r.returncode}:\n{r.stderr[-3000:]}"
        assert "trained 4 steps on cuda" in r.stdout, r.stdout
        mel = np.load(f"{work}/mel.npy")
        assert mel.shape[0] == 80 and np.isfinite(mel).all() and Path(work, "demo.wav").exists()
        log(f"examples/demo_torch.py on the card: {r.stdout.strip().splitlines()[-1]} in "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)


def held_bytes(torch, modules):
    """Bytes of every tensor the modules hold: parameters, buffers and
    cached kernel packs, each storage once."""
    seen, total = set(), 0

    def add(t):
        nonlocal total
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
        elif isinstance(t, (tuple, list)):
            for x in t:
                add(x)
        elif isinstance(t, dict):
            for x in t.values():
                add(x)

    for m in modules:
        for sub in m.modules():
            for t in (*sub.parameters(recurse=False), *sub.buffers(recurse=False)):
                add(t)
            add(sub.__dict__.get("_kernel_pack"))
    return total


def quant8_device_ms(torch, call):
    """Device time of one call's int8 work, by ``ops/quant8.py`` function:
    each wrapped in a profiler range for the call, the device time of the
    kernels launched inside it summed (ranges nest: int8_conv1d holds its
    dynamic_quantize and int_mm). {name: (ms, calls)}."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from fastspeech2_tpu_torch.ops import quant8

    names = ("dynamic_quantize", "int_mm", "int8_conv1d", "int8_linear",
             "dequantize_attention")
    real = {n: getattr(quant8, n) for n in names}

    def wrapped(n):
        def fn(*a, **k):
            with record_function(f"quant8.{n}"):
                return real[n](*a, **k)
        return fn

    try:
        for n in names:
            setattr(quant8, n, wrapped(n))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
    finally:
        for n, fn in real.items():
            setattr(quant8, n, fn)
    out = {}
    for e in prof.key_averages():
        if e.key.startswith("quant8."):
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            out[e.key[len("quant8."):]] = (us / 1e3, e.count)
    return out


def int8_path_phase(torch, smi):
    """The int8 (W8A8) tier at the default config, full width and depth,
    bf16, seed 0, duration bias 1.87: ``Synthesizer(bf16=True, int8=True)``
    beside the bf16 Synthesizer of the same model; launch counts, B=8 held
    against the CPU port's int8, the tiers' mel gap, resident memory, the
    B=32 call in both tiers; the pre-LN int8 route; ``serve --int8`` in its
    own process; ``synth --int8`` at both precisions. Returns (the bf16
    Synthesizer, a scratch dir, the default config's checkpoint) for the
    WaveGlow phase; the caller removes the dir."""
    import tempfile

    import numpy as np

    from fastspeech2_tpu_torch import cli
    from fastspeech2_tpu_torch.config import Config
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.ops import flags, make_non_pad_mask, quant8
    from fastspeech2_tpu_torch.text import phonemes_to_sequence
    from fastspeech2_tpu_torch.train.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    cfg = Config()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated()
    model = seeded_model(torch, cfg)
    bf = Synthesizer(model, bf16=True)
    b32 = batch(32)
    bf.mel_from_token_batch(b32)  # warm: packs, handles, allocator
    torch.cuda.synchronize()
    m_bf = torch.cuda.memory_allocated() - m0
    i8 = Synthesizer(model, bf16=True, int8=True)
    assert i8.model is not model and quant8.attention_is_quantized(i8.model.decoder.layers[0].attn)
    i8.mel_from_token_batch(b32)
    torch.cuda.synchronize()
    m_i8 = torch.cuda.memory_allocated() - m0 - m_bf
    fft_bf = held_bytes(torch, [model.encoder, model.decoder])
    fft_i8 = held_bytes(torch, [i8.model.encoder, i8.model.decoder])
    log(f"int8 tier, resident memory after warmup (torch.cuda.memory_allocated, {smi}): "
        f"bf16 tier {m_bf / 2**20:.1f} MiB, int8 tier {m_i8 / 2**20:.1f} MiB; of it the "
        f"encoder + decoder FFT blocks (weights and cached packs): bf16 {fft_bf / 2**20:.1f} "
        f"MiB, int8 {fft_i8 / 2**20:.1f} MiB")
    assert fft_i8 < 0.5 * fft_bf, (fft_i8, fft_bf)

    reset_counts()
    i8.mel_from_token_batch(b32)
    per = read_counts()
    log(f"int8 launches per B=32 mel call: { {k: v for k, v in per.items() if v} }")
    # 4 encoder + 4 decoder blocks x 2 decode groups; no FFN kernel under int8
    assert per["attention_block"] == 12 and per["variance_adaptor"] == per["postnet"] == 2, per
    assert per["ffn_block"] == per["ffn_block_pre"] == per["fused_ffn"] == 0, per

    cpu = FastSpeech2(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    hold_b8_vs_cpu(torch, i8, cfg, "int8 B=8", cpu_model=quant8.quantize_model(cpu))
    del cpu

    # the tiers' gap on the card: one B=8 batch, both decodes fed the bf16
    # tier's durations
    seqs = batch(8, offset=8)
    B, t_pad, _, xs, ilens, alphas = bf._pad_batch(seqs, 1.0)
    with bf._cd():
        hb, db = bf.model.encode(xs, ilens)
        mb, lb = bf.model.decode_frames(hb, db, ilens, out_maxlen=1024, alpha=alphas)
        hq, dq = i8.model.encode(xs, ilens)
        mq, lq = i8.model.decode_frames(hq, db, ilens, out_maxlen=1024, alpha=alphas)
    tok = make_non_pad_mask(ilens, t_pad)
    same = float((dq == db)[tok].float().mean())
    assert torch.equal(lq, lb)
    live = torch.arange(mb.shape[1], device=mb.device)[None] < lb[:, None]
    d = (mq - mb).abs()[live]
    log(f"int8 vs bf16 tier on the card, B=8 ({int(live.sum())} live frames, the bf16 "
        f"durations fed to both): mel gap mean {float(d.mean()):.4e}, max "
        f"{float(d.max()):.4e}; the tiers' own durations agree on {same:.4f} of tokens")
    assert torch.isfinite(mq).all()

    # the switches under int8: kernel 5 behind dequantized projections,
    # kernel 7 inside W8A8 projections; never an FFN kernel
    for flag, kernel in (("FUSED_ATT_QKV", "attention_res_ln"),
                         ("FUSED_ATT_RES", "fused_attention_packed")):
        setattr(flags, flag, False)
        try:
            reset_counts()
            mel, lens = i8.mel_from_token_batch(seqs)
            counts = read_counts()
        finally:
            setattr(flags, flag, True)
        log(f"int8 B=8 mel call with {flag} off: {int(lens.sum())} frames, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        assert np.isfinite(mel).all() and counts[kernel] > 0, counts
        assert counts["attention_block"] == counts["ffn_block"] == 0, counts

    ms_bf, _ = timed_calls(torch, lambda: bf.mel_from_token_batch(b32))
    ms_i8, (_, lens) = timed_calls(torch, lambda: i8.mel_from_token_batch(b32))
    frames = int(lens.sum())
    by = quant8_device_ms(torch, lambda: i8.mel_from_token_batch(b32))
    log(f"B=32 mel call ({smi}), CUDA events, median of 5: bf16 tier {ms_bf:.3f} ms, "
        f"int8 tier {ms_i8:.3f} ms ({frames} frames, {frames / ms_i8 * 1e3:.0f} "
        f"mel-frames/s); int8 work by function, device ms per call (calls): "
        + ", ".join(f"{n} {v[0]:.3f} ({v[1]})" for n, v in sorted(by.items())))
    assert by.get("int_mm", (0, 0))[1] > 0, by
    profile_phase(torch, lambda: bf.mel_from_token_batch(b32), "bf16 tier B=32 mel call")
    profile_phase(torch, lambda: i8.mel_from_token_batch(b32), "int8 tier B=32 mel call")
    del i8, hb, hq, mb, mq
    torch.cuda.empty_cache()

    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="fs2_int8_", dir=str(ROOT / "build"))
    pcfg = override_config(work, "prenorm", PRENORM_KEYS)
    p8 = Synthesizer(seeded_model(torch, pcfg), bf16=True, int8=True)
    reset_counts()
    mel, lens = p8.mel_from_token_batch(batch(8, offset=8))
    counts = read_counts()
    log(f"int8 prenorm B=8 mel call: {int(lens.sum())} frames, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    assert np.isfinite(mel).all() and (lens > 0).all()
    assert counts["attention_res"] > 0 and counts["ffn_block_pre"] == 0, counts
    assert counts["attention_block"] == counts["ffn_block"] == 0, counts
    del p8
    torch.cuda.empty_cache()

    ckpt = f"{work}/default.npz"
    save_checkpoint(ckpt, model, None, 0, cfg)
    cli_server_phase(ckpt, work, what="int8 CLI server", extra_args=("--int8",), rounds=1,
                     expect=("attention_block", "variance_adaptor", "postnet"),
                     absent=("ffn_block", "ffn_block_pre", "fused_ffn"))

    mels = {}
    for prec in ("highest", "default"):
        out = Path(work, f"synth_{prec}")
        cli.main(["synth", "-p", ckpt, "--int8", "--precision", prec, "--phonemes",
                  "--text", SENTENCES[3], "-o", str(out)])
        mels[prec] = np.load(out / "mel.npy")
        assert np.isfinite(mels[prec]).all() and (out / "test_tts.wav").exists()
    assert not (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32)
    durs = {}
    toks = np.asarray(phonemes_to_sequence(SENTENCES[3]), np.int64)  # what synth reads
    for prec in mels:
        s8 = Synthesizer(model, int8=True, matmul_precision=prec)
        _, _, _, xs1, il1, _ = s8._pad_batch([toks], 1.0)
        with s8._cd():
            durs[prec] = s8.model.encode(xs1, il1)[1][0, :len(toks)].cpu()
        del s8
    a, b = mels["highest"], mels["default"]
    gap = (f"max {np.abs(a - b).max():.4e}, mean {np.abs(a - b).mean():.4e}"
           if a.shape == b.shape else f"frames differ ({a.shape[1]} against {b.shape[1]})")
    log(f"synth --int8 (f32 tier) --precision highest against default (TF32): mel.npy "
        f"{a.shape} and {b.shape}, gap {gap}; durations "
        f"{'equal' if torch.equal(durs['highest'], durs['default']) else 'differ'} "
        f"({int((durs['highest'] != durs['default']).sum())} tokens of "
        f"{durs['highest'].numel()})")
    log(f"int8 phase: {time.perf_counter() - t_phase:.1f} s")
    return bf, work, ckpt


def group_scales_off(scales):
    """Of two shards' recorded (own amax, returned scale) per quantization:
    (quantizations per shard, how many scales are not the int8 scale of the
    max of both shards' own amax, exactly, in f32; whether the shards' own
    amax differ anywhere)."""
    import numpy as np

    r0, r1 = (np.asarray(scales[s], np.float64).reshape(-1, 2) for s in (0, 1))
    assert len(r0) == len(r1) > 0, (len(r0), len(r1))
    amax = np.maximum(np.maximum(r0[:, 0], r1[:, 0]).astype(np.float32),
                      np.finfo(np.float32).tiny)
    want = (amax / np.float32(127.0)).astype(np.float64)
    off = int((r0[:, 1] != want).sum() + (r1[:, 1] != want).sum())
    return len(r0), off, bool((r0[:, 0] != r1[:, 0]).any())


def local_int8_mesh_phase(torch, results, smi, device="cuda", cfg=None):
    """The int8 tier over a local mesh of two entries of the card
    (``Synthesizer(bf16=True, int8=True, mesh=make_mesh(devices=["cuda:0",
    "cuda:0"]))``: one thread a shard, the collectives over a group of
    threads) at the default config, full width and depth, seed 0, duration
    bias 1.87: a B=32 mel call against the unsharded int8 call (lengths
    exact, live frames in the bf16 band), every activation scale the max of
    both shards' own amax, launches of kernels 1, 3, 4 per call; a B=8 wav
    call with MelGAN attached (kernel 13); 20 calls in a row with the same
    bits; the B=32 call timed beside the unsharded one; one concurrent
    server round of 16 wav requests. ``device="cpu"`` with a narrow
    ``cfg`` rehearses it on the CPU (plain versions, nothing counted or
    timed)."""
    import numpy as np

    from fastspeech2_tpu_torch.config import Config
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.ops import quant8
    from fastspeech2_tpu_torch.parallel.mesh import current_shard, make_mesh
    from fastspeech2_tpu_torch.vocoder.melgan import MelGANConfig, MelGANGenerator

    t_phase = time.perf_counter()
    on_card = torch_device_type(device) == "cuda"
    model = FastSpeech2(cfg or Config(), device=device,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.duration_predictor.out.bias.fill_(1.87)
    entry = "cuda:0" if on_card else "cpu"
    one = Synthesizer(model, bf16=True, int8=True, device=device)
    sharded = Synthesizer(model, bf16=True, int8=True, device=device,
                          mesh=make_mesh(devices=[entry, entry]))
    b32 = batch(32)
    mel1, lens1 = one.mel_from_token_batch(b32)
    sharded.mel_from_token_batch(b32)  # warm
    scales = {0: [], 1: []}
    quantize = quant8.dynamic_quantize

    def recording(x):
        q, sc = quantize(x)
        scales[current_shard().data_index].append((float(x.float().abs().amax()), float(sc)))
        return q, sc

    quant8.dynamic_quantize = recording
    try:
        reset_counts()
        mel2, lens2 = sharded.mel_from_token_batch(b32)
        counts = read_counts()
    finally:
        quant8.dynamic_quantize = quantize
    n_q, off, differ = group_scales_off(scales)
    log(f"local int8 mesh (2 entries of {entry}) B=32: mel {mel2.shape} (unsharded "
        f"{mel1.shape}), launches { {k: v for k, v in counts.items() if v} }; {n_q} "
        f"quantizations a shard, {off} scales off the group's max, the shards' own amax "
        f"{'differ' if differ else 'agree'}")
    assert off == 0 and differ, (n_q, off, differ)
    assert np.array_equal(lens1, lens2), "local int8 mesh out_lens differ"
    L = min(mel1.shape[1], mel2.shape[1])
    live = torch.from_numpy(np.arange(L)[None] < lens1[:, None])
    compare("local int8 mesh B=32 vs unsharded int8, live frames",
            torch.from_numpy(mel2[:, :L])[live], torch.from_numpy(mel1[:, :L])[live],
            0.02, 0.2)
    log(f"local int8 mesh B=32 mel bits equal to the unsharded int8 call's: "
        f"{mel1.shape == mel2.shape and np.array_equal(mel1, mel2)}")
    if on_card:
        # 4 encoder blocks a shard, 4 decoder blocks a shard and decode group
        assert counts["attention_block"] == 24 and counts["variance_adaptor"] == 4, counts
        assert counts["postnet"] == 4 and counts["ffn_block"] == 0, counts
        for k in ("attention_block", "variance_adaptor", "postnet"):
            results[k]["launches_local_int8_b32"] = counts[k]
    for i in range(20):
        m, ln = sharded.mel_from_token_batch(b32)
        assert np.array_equal(m, mel2) and np.array_equal(ln, lens2), f"call {i} differs"
    log("local int8 mesh: 20 B=32 calls in a row, the same bits")
    if on_card:
        ms1, _ = timed_calls(torch, lambda: one.mel_from_token_batch(b32))
        ms2, _ = timed_calls(torch, lambda: sharded.mel_from_token_batch(b32))
        frames = int(lens2.sum())
        log(f"B=32 int8 mel call ({smi}), CUDA events, median of 5: unsharded {ms1:.3f} "
            f"ms, local mesh of 2 entries of the card {ms2:.3f} ms ({ms2 / ms1:.2f}x; "
            f"{frames / ms2 * 1e3:.0f} mel-frames/s)")
        results["attention_block"]["local_int8_ms"] = {"unsharded": ms1, "local_mesh": ms2}
        profile_phase(torch, lambda: sharded.mel_from_token_batch(b32),
                      "local int8 mesh B=32 mel call")

    gen = (MelGANGenerator(bf16=True, seed=0, device=device) if on_card else
           MelGANGenerator(MelGANConfig(base_channels=16), bf16=True, seed=0, device=device))
    one.attach_vocoder(gen)
    sharded.attach_vocoder(gen)
    b8 = batch(8, offset=5)
    wm1, w1, wl1 = one.wav_from_token_batch(b8)
    reset_counts()
    wm2, w2, wl2 = sharded.wav_from_token_batch(b8)
    counts = read_counts()
    assert np.array_equal(wl1, wl2), (wl1, wl2)
    if on_card:
        assert counts["resstack"] > 0 and counts["attention_block"] > 0, counts
        results["resstack"]["launches_local_int8_wav_b8"] = counts["resstack"]
    n = min(w1.shape[1], w2.shape[1])
    live = torch.from_numpy(np.arange(n)[None] < wl1[:, None])
    compare("local int8 mesh B=8 wav vs unsharded (int16 PCM / 32768, live samples)",
            torch.from_numpy(w2[:, :n].astype(np.float32) / 32768)[live],
            torch.from_numpy(w1[:, :n].astype(np.float32) / 32768)[live], 0.02, 0.5)
    np.testing.assert_array_equal(wm2, sharded.mel_from_token_batch(b8)[0])
    log(f"local int8 mesh B=8 wav: launches { {k: v for k, v in counts.items() if v} }; "
        f"its mel the mel call's bits")

    with serving(sharded) as url:
        for text in TEXTS[:2]:  # the batcher threads' first calls
            riff_samples(http_post(url, "/synthesize", {"text": text, "format": "wav"})[1])
        wall, lat, nb, total, _ = concurrent_round(url, 16, "wav")
    log(f"local int8 mesh server: 16 concurrent wav requests in {nb} batches, "
        f"{total / 22050.0:.1f} s of audio, {16 / wall:.1f} requests/s, median latency "
        f"{statistics.median(lat) * 1e3:.1f} ms ({smi})")
    del one, sharded, model, gen
    if on_card:
        torch.cuda.empty_cache()
    log(f"local int8 mesh phase: {time.perf_counter() - t_phase:.1f} s")


def waveglow_phase(torch, bf, work, ckpt, smi):
    """WaveGlow at the widths of NVIDIA's waveglow_256channels checkpoint,
    seeded random weights written in NVIDIA's weight-normed key format: a
    B=8 wav call through attach_vocoder_fn (bf16 mel kernels, bf16
    WaveGlow), bf16 against f32 on the card with pinned noise, ``serve
    --vocoder`` and ``synth --vocoder``."""
    import numpy as np
    from scipy.io.wavfile import read as read_wav

    from fastspeech2_tpu_torch import cli
    from fastspeech2_tpu_torch.vocoder import detect_vocoder_kind
    from fastspeech2_tpu_torch.vocoder import waveglow as W

    t_phase = time.perf_counter()
    cfg = W.WaveGlowConfig(wn_channels=256)
    path = str(Path(work, "waveglow_256channels.pt"))
    wg_cpu = W.init_waveglow(cfg, seed=0, device="cpu")
    n_params = sum(p.numel() for p in wg_cpu.parameters())
    torch.save(W.nvidia_state_dict(wg_cpu), path)
    del wg_cpu
    assert detect_vocoder_kind(path) == "waveglow"
    voc = W.load_waveglow(path, bf16=True)
    assert voc.waveglow.cfg == cfg and voc.hop_length == 256
    log(f"waveglow: {n_params / 1e6:.1f} M parameters ({cfg.n_flows} flows, {cfg.wn_layers} "
        f"WN layers of {cfg.wn_channels} channels), written weight-normed and loaded in "
        f"{time.perf_counter() - t_phase:.1f} s")

    bf.attach_vocoder_fn(voc)
    seqs = batch(8, offset=8)
    bf.wav_from_token_batch(seqs)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms, (mel, wav, wav_lens) = timed_calls(torch, lambda: bf.wav_from_token_batch(seqs), n=3)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    secs = float(wav_lens.sum()) / 22050.0
    log(f"waveglow B=8 wav call ({smi}): {ms:.3f} ms median of 3, {secs:.1f} s of audio, "
        f"{secs / ms * 1e3:.1f} audio-seconds/s, mel {mel.shape}, peak device memory "
        f"{peak / 2**30:.2f} GiB; launches (3 calls) "
        f"{ {k: v for k, v in counts.items() if v} }")
    for k in ("attention_block", "ffn_block", "variance_adaptor", "postnet"):
        assert counts[k] > 0, f"kernel {k} was not launched on the WaveGlow wav path"
    live = np.arange(wav.shape[1])[None] < wav_lens[:, None]
    assert wav.dtype == np.int16 and np.abs(wav[live]).max() > 0 and not wav[~live].any()

    # bf16 against f32 on the card, one served mel, the same pinned noise,
    # relative to the f32 output, within WAVEGLOW_BAND
    wf = W.load_waveglow_params(path)
    L = int(wav_lens[0] // 256)
    m = torch.from_numpy(mel[:1, :L]).cuda()
    g = torch.Generator().manual_seed(1)
    Lg = L * 256 // cfg.n_group
    zs = [torch.randn((1, Lg, c), generator=g)
          for c in [cfg.n_remaining] + [cfg.n_early_size] * (cfg.n_draws - 1)]
    a32, a16 = wf.infer(m, zs=zs), voc.waveglow.infer(m, zs=zs)
    d = (a16 - a32).abs()
    rel_mean = float(d.mean() / a32.pow(2).mean().sqrt())
    rel_max = float(d.max() / a32.abs().max())
    log(f"waveglow bf16 vs f32 on the card, {L} frames, pinned noise: mean {float(d.mean()):.4e}"
        f" ({rel_mean:.5f} of rms), max {float(d.max()):.4e} ({rel_max:.5f} of peak); band "
        f"{WAVEGLOW_BAND[0]} / {WAVEGLOW_BAND[1]}")
    assert torch.isfinite(a16).all() and rel_mean < WAVEGLOW_BAND[0] and rel_max < WAVEGLOW_BAND[1]
    del wf, a32, a16, d

    out = Path(work, "synth_waveglow")
    t0 = time.perf_counter()
    cli.main(["synth", "-p", ckpt, "--phonemes", "--text", SENTENCES[0], "--vocoder", path,
              "-o", str(out)])
    mel1 = np.load(out / "mel.npy")
    sr, wav1 = read_wav(str(out / "test_tts.wav"))
    assert sr == 22050 and len(wav1) == mel1.shape[1] * 256 and np.abs(wav1).max() > 0
    log(f"synth --vocoder (WaveGlow, f32 tier): mel.npy {mel1.shape}, test_tts.wav "
        f"{len(wav1)} samples in {time.perf_counter() - t0:.1f} s")
    waveglow_server_round(ckpt, path, work)
    log(f"waveglow phase: {time.perf_counter() - t_phase:.1f} s")
    return secs / ms * 1e3


def waveglow_server_round(ckpt, voc_path, work):
    """`serve -p CKPT --vocoder WAVEGLOW` in its own process: two requests,
    then one round of 16 concurrent wav requests."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    log_path = Path(work, "serve_waveglow.log")
    t0 = time.perf_counter()
    with open(log_path, "wb") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "fastspeech2_tpu_torch", "serve", "-p", ckpt, "--vocoder",
             voc_path, "--host", "127.0.0.1", "--port", str(port), "--max_batch", "16"],
            cwd=str(ROOT), env={**os.environ, "PYTHONPATH": str(ROOT)}, stdout=logf,
            stderr=subprocess.STDOUT)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError("the WaveGlow server exited:\n"
                                     + log_path.read_text()[-3000:])
            try:
                healthz(url)
                break
            except OSError:
                assert time.perf_counter() - t0 < 300, "the WaveGlow server did not come up"
                time.sleep(0.25)
        up = time.perf_counter() - t0
        for text in TEXTS[:2]:
            riff_samples(http_post(url, "/synthesize", {"text": text, "format": "wav"})[1])
        wall, lat, nb, total, stats = concurrent_round(url, 16, "wav")
        assert "WaveGlow" in log_path.read_text()
        log(f"WaveGlow CLI server: up in {up:.1f} s; 16 concurrent wav requests in {nb} "
            f"batches, {total / 22050.0:.1f} s of audio, {16 / wall:.1f} requests/s, median "
            f"latency {statistics.median(lat) * 1e3:.1f} ms; launches "
            f"{ {k: v for k, v in stats['launches'].items() if v} }")
        assert stats["launches"]["attention_block"] > 0, stats["launches"]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        log(f"WaveGlow CLI server: stopped (exit code {proc.returncode})")


def wgmma_kernels_sass():
    """The bf16 kernels built on csrc/hopper.cuh are wgmma kernels: HGMMA in
    their SASS and no mma.sync HMMA (cuobjdump), and ptxas spills nothing in
    them. attention_train's library: the forward in its TRAIN mode, dQ and
    dK/dV (the tile bodies at DK 128, 192, 256 and both grid splits, 14
    kernels; the wide bodies at parts of 192 and 256 columns, 6); attention's:
    the forward in its SERVE mode (kernels 7 and 8, launch B of 1, 5 and 6;
    the tile body 6 kernels, the wide body 2), which also keeps no stack
    frame (its two score arrays stay in registers), and the q|k|v and out
    projections of kernels 1, 5 and 6 on ffn_body.cuh (2 + 8 kernels);
    resstack's: the bf16 residual stack at each of its 12 widths and the wide
    path's conv and out kernels (kernel 13; the f32 kernels are exempt); ffn's: the k-tap conv (3 inputs x 2 tilings)
    and the k=1 conv with its epilogue (3 entries x 4 widths) of kernels 2,
    9 and 10; adaptor's: kernel 3 at its two ring-tile widths and with the x
    tile in chunks (3 kernels); postnet's: kernel 4's chain at its nine (row
    tiling, hidden and last widths) and its wide path's stage kernel.
    The SERVE, resstack, ffn, adaptor and postnet kernels carry no ptxas
    note that it serialized wgmma (C7512/C7514/C7515: their overlap would
    be gone)."""
    import shutil

    from fastspeech2_tpu_torch.ops.kernels import common

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib, kinds, want in (
            ("attention_train", ("attn_fwd_kernel", "train_bwd_dq_kernel",
                                 "train_bwd_dkv_kernel", "attn_fwd_wide_kernel",
                                 "train_bwd_dq_wide_kernel", "train_bwd_dkv_wide_kernel"), 20),
            ("attention", ("attn_fwd_kernel", "attn_fwd_wide_kernel", "ffn_conv_kernel",
                           "ffn_out_kernel"), 19),
            ("resstack", ("resstack_wgmma_kernel", "resstack_wide_conv_kernel",
                          "resstack_wide_out_kernel"), 14),
            ("ffn", ("ffn_conv_kernel", "ffn_out_kernel"), 21),
            ("adaptor", ("adaptor_kernel",), 3),
            ("postnet", ("postnet_kernel", "postnet_wide_kernel"), 10)):
        log_text = common.ptxas_report(lib)
        for line in log_text.splitlines():
            if "serialized" in line or re.search(r"C75(12|14|15|19)", line):
                log(f"  ptxas {lib}: {line.strip()}")
                # the head dims' wide bodies in either library: no wgmma
                # serialized by a guard on d_k or on the part
                assert "wide_kernel" not in line, line
                assert lib == "attention_train", line
        # the overlap of these kernels exists only if ptxas kept wgmma asynchronous
        assert lib == "attention_train" or "serialized" not in log_text, "wgmma serialized"
        props = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes stack frame, "
                           r"(\d+) bytes spill stores, (\d+) bytes spill loads", log_text, re.S)
        sass = subprocess.run([tool, "-sass", str(common._lib_path(lib))], check=True,
                              capture_output=True, text=True, timeout=120).stdout
        seen, fences = 0, {}
        for part in sass.split("Function : ")[1:]:
            fn = part.split()[0]
            kind = next((k for k in kinds if k in fn), None)
            if kind is None:
                continue
            seen += 1
            hg, hm = part.count("HGMMA"), len(re.findall(r"\bHMMA\b", part))
            stack, st, ld = next(((a, b, c) for n, a, b, c in props if n == fn), ("?",) * 3)
            fence = part.count("FENCE.VIEW.ASYNC.S")
            generic = len(re.findall(r"\b(?:ST|LD)\.E\b", part))
            log(f"  sass {lib} {kind}{fn[fn.index(kind) + len(kind):][:14]}: {hg} HGMMA, "
                f"{hm} HMMA, ptxas spill stores/loads {st}/{ld} bytes, stack frame {stack}, "
                f"{fence} fence.proxy.async, {generic} generic ST.E/LD.E")
            assert hg > 0 and hm == 0 and (st, ld) == ("0", "0"), fn
            assert not kind.startswith("attn_fwd") or lib != "attention" or stack == "0", fn
            if kind == "ffn_conv_kernel":
                fences.setdefault("Lb1E" in fn, []).append(fence)
        assert seen == want, f"expected {want} bf16 wgmma kernels in {lib}, found {seen}"
        if fences:
            # the chunked x tile (launch 1 past what fits whole) is written by
            # threads and read by the products' descriptors once a chunk: a
            # fence.proxy.async behind each chunk's load, one more than the
            # whole tile's
            assert len(fences[True]) == (3 if lib == "ffn" else 1), fences
            assert min(fences[True]) > max(fences[False]) >= 1, fences



# -- data and tensor parallelism (parallel/) on the one card --------------------

PARALLEL_STEPS = 2
PARALLEL_FLAG = "--parallel-worker"
#: the parallel routes against the single process (bf16). On the H100 the
#: unchanged code read at most 6.6e-6 in a report term other than the
#: duration's (relative), 1.4e-4 in the duration term, 5.7e-3 in a module
#: group's gradient (the largest error of its norm and projections, over its
#: norm) and 1.4e-4 in the BatchNorm running statistics (over their largest
#: magnitude; equal across ranks), in two runs. Trees with a fault read far above the
#: bands: the decoder's TP attention all-reduce dropped, mel terms 3.1e-3 and
#: decoder gradients 0.32; the gradients after the encoder's left unsummed
#: over the data group, 0.22 and more; BatchNorm statistics over a rank's
#: rows, ranks 6.2e-3 apart and 4.7e-3 off.
PARALLEL_LOSS_BAND = 1e-4
PARALLEL_DURATION_BAND = 1e-3
PARALLEL_GRAD_BAND = 5e-2
PARALLEL_BN_BAND = 1e-3
#: the NCCL group of one runs the single process's route: with a
#: reproducible step (the length regulator's deterministic backward) every
#: report term and gradient reading agrees within this, at both steps
PARALLEL_NCCL_BAND = 1e-6


def parallel_cfg():
    """configs/default.yaml at full width, bf16 training, dropout rates 0 so
    that the parallel routes and the single-process step compute one
    function."""
    import dataclasses

    from fastspeech2_tpu_torch.config import load_config

    cfg = load_config(str(ROOT / "configs" / "default.yaml"))
    return dataclasses.replace(
        cfg, model=dataclasses.replace(
            cfg.model, transformer_dropout_rate=0.0, postnet_dropout_rate=0.0,
            duration_predictor_dropout_rate=0.0, variance_predictor_dropout_rate=0.0),
        train=dataclasses.replace(cfg.train, bf16=True))


def parallel_windows(cfg, T=96, L=640, seed=7):
    """PARALLEL_STEPS seeded global windows of batch_size x accum_grad rows
    of T tokens and L frames, numpy."""
    import numpy as np

    rows = cfg.train.batch_size * cfg.train.accum_grad
    odim = cfg.audio.num_mels
    g = np.random.default_rng(seed)
    out = []
    for _ in range(PARALLEL_STEPS):
        ilens = g.integers(T // 2, T + 1, rows).astype(np.int32)
        xs, ds = np.zeros((rows, T), np.int32), np.zeros((rows, T), np.int32)
        olens = np.zeros(rows, np.int32)
        ys = np.zeros((rows, L, odim), np.float32)
        es, ps = np.zeros((rows, L), np.float32), np.zeros((rows, L), np.float32)
        for b in range(rows):
            n = ilens[b]
            xs[b, :n] = g.integers(1, 68, n)
            d = g.integers(1, L // T + 1, n)
            ds[b, :n] = d
            olens[b] = f = d.sum()
            ys[b, :f] = g.normal(-5, 2, (f, odim))
            es[b, :f] = g.uniform(0.02, 100, f)
            ps[b, :f] = g.uniform(71, 600, f)
        out.append(dict(xs=xs, ilens=ilens, ys=ys, olens=olens, ds=ds, es=es, ps=ps))
    return out


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


#: the report's terms, each held to the single process on its own
LOSS_TERMS = ("loss", "before_loss", "after_loss", "duration_loss", "energy_loss",
              "pitch_loss")
GRAD_PROJECTIONS = 4


def module_group(name: str) -> str:
    """The group of a parameter in the gradient check: each stack's attention
    and the rest of it, the variance adaptor, feat_out, the postnet."""
    top = name.split(".")[0]
    if top in ("encoder", "decoder"):
        return f"{top}.attn" if ".attn." in name else f"{top}.other"
    return top if top in ("postnet", "feat_out") else "variance_adaptor"


def grad_fingerprint(torch, names, grads, mesh):
    """Per module group of the window's summed gradient: [norm, GRAD_PROJECTIONS
    dot products with seeded normal vectors of each leaf's full shape]. A
    tensor-parallel rank dots its shard with its block of the vector and sums
    over the model group, so every route yields the single process's numbers
    without moving the gradients; a dot product's error over the norm reads
    the gradient's relative error."""
    from fastspeech2_tpu_torch.parallel.mesh import all_reduce
    from fastspeech2_tpu_torch.parallel.sharding import shard_dim

    keys = sorted({module_group(n) for n in names})
    tp = mesh.tp if mesh is not None else 1
    acc = torch.zeros((2, len(keys), 1 + GRAD_PROJECTIONS), dtype=torch.float64,
                      device=grads[0].device)
    for i, (n, g) in enumerate(zip(names, grads)):
        d = shard_dim(n) if tp > 1 else None
        full = list(g.shape)
        if d is not None:
            full[d] *= tp
        gen = torch.Generator(device=g.device).manual_seed(1000 + i)
        r = torch.randn((GRAD_PROJECTIONS, *full), generator=gen, device=g.device)
        if d is not None:
            r = r.narrow(d + 1, mesh.model_index * g.shape[d], g.shape[d])
        g64 = g.detach().double()
        dots = (r.double() * g64).reshape(GRAD_PROJECTIONS, -1).sum(1)
        acc[int(d is not None), keys.index(module_group(n))] += torch.cat(
            [g64.square().sum()[None], dots])
    if tp > 1:
        all_reduce(acc[1], mesh.model_group)
    tot = acc.sum(0)
    tot[:, 0] = tot[:, 0].sqrt()
    return dict(zip(keys, tot.tolist()))


def parallel_steps(torch, cfg, windows, device, mesh=None):
    """PARALLEL_STEPS train steps from the seed-0 model (this rank's part of
    ``mesh``): per step the report's terms, the gradient's fingerprint per
    module group and the launches; then the postnet's BatchNorm running
    statistics."""
    from fastspeech2_tpu_torch.models.fastspeech2 import Batch, FastSpeech2
    from fastspeech2_tpu_torch.parallel.mesh import window_rows
    from fastspeech2_tpu_torch.parallel.sharding import shard_model
    from fastspeech2_tpu_torch.train.optimizer import NoamAdam
    from fastspeech2_tpu_torch.train.seeds import SeedSchedule
    from fastspeech2_tpu_torch.train.step import TrainState, make_train_step, trainable

    accum = cfg.train.accum_grad
    model = FastSpeech2(cfg, device=device, generator=torch.Generator().manual_seed(0))
    opt = NoamAdam(trainable(model), cfg)
    if mesh is not None and mesh.tp > 1:
        shard_model(model, mesh, opt)
    names = [n for n, _ in model.named_parameters()]
    prints = []
    apply = opt.step

    def step_and_print(grads):  # the summed gradients, before clipping
        prints.append(grad_fingerprint(torch, names, grads, mesh))
        return apply(grads)

    opt.step = step_and_print
    step = make_train_step(model, opt, accum, bf16=True, mesh=mesh)
    ts, seeds = TrainState(model, opt, 0), SeedSchedule(model.dropout_sites(), seed=0)
    rows = window_rows(mesh, accum, cfg.train.batch_size)
    out = []
    for w in windows:
        b = Batch(**{k: torch.from_numpy(v[rows]).to(device) for k, v in w.items()})
        reset_counts()
        ts, rep = step(ts, b, [seeds.draw() for _ in range(accum)])
        sync(torch, device)
        counts = read_counts()
        out.append({"report": {k: float(rep[k]) for k in (*LOSS_TERMS, "grad_norm")},
                    "grads": prints[-1], "launches": counts})
    bn = torch.cat([t.flatten() for n, t in model.named_buffers() if ".running_" in n])
    return {"steps": out, "bn": bn.tolist()}


def parallel_tp_inference(torch, cfg, device, mesh):
    """TP inference of the seed-0 model (duration bias 1.87) at B=8 on this
    rank's head shard, held to the same model unsharded on this device: the
    encoder output and durations, then both decoders fed the unsharded
    durations (so the frames align); then ``Synthesizer(mesh=)`` serving the
    sharded model beside the unsharded Synthesizer (frames, launches).
    Returns (errors, launches of the forward)."""
    import copy

    import numpy as np

    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.ops.precision import compute_dtype
    from fastspeech2_tpu_torch.parallel.sharding import shard_model

    model = FastSpeech2(cfg, device=device, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.duration_predictor.out.bias.fill_(1.87)
    ref = copy.deepcopy(model)
    shard_model(model, mesh)
    seqs = batch(8, offset=3)
    T = -(-max(len(s) for s in seqs) // 32) * 32
    xs = torch.zeros((8, T), dtype=torch.int64)
    for i, s in enumerate(seqs):
        xs[i, :len(s)] = torch.from_numpy(s)
    xs = xs.to(device)
    il = torch.tensor([len(s) for s in seqs], dtype=torch.int32, device=device)
    with compute_dtype(torch.bfloat16), torch.inference_mode():
        hs_r, d_r = ref.encode(xs, il)
        L = -(-int(d_r.sum(1).max()) // 256) * 256
        mel_r, lens_r = ref.decode_frames(hs_r, d_r, il, out_maxlen=L)
        reset_counts()
        hs_t, d_t = model.encode(xs, il)
        mel_t, lens_t = model.decode_frames(hs_t, d_r, il, out_maxlen=L)
        sync(torch, device)
        counts = read_counts()
    valid = torch.arange(T, device=device)[None] < il[:, None]
    live = torch.arange(L, device=device)[None] < lens_r[:, None]
    dh = (hs_t - hs_r)[valid].abs()
    dm = (mel_t - mel_r)[live].abs()
    _, lens_1 = Synthesizer(ref, bf16=True, device=device).mel_from_token_batch(seqs)
    reset_counts()
    mel_s, lens_s = Synthesizer(model, bf16=True, device=device,
                                mesh=mesh).mel_from_token_batch(seqs)
    sync(torch, device)
    synth = read_counts()
    return {"dur_agree": float((d_t == d_r)[valid].float().mean()),
            "lens_equal": bool(torch.equal(lens_t, lens_r)),
            "hs_max": float(dh.max()), "hs_mean": float(dh.mean()),
            "mel_max": float(dm.max()), "mel_mean": float(dm.mean()),
            "frames": int(lens_r.sum()),
            "synth_frames": int(lens_s.sum()), "synth_frames_one": int(lens_1.sum()),
            "synth_finite": bool(np.isfinite(mel_s).all()),
            "synth_sum": float(mel_s.astype(np.float64).sum()),
            "synth_launches": {k: v for k, v in synth.items() if v}}, counts


def parallel_worker(argv) -> int:
    """One rank of the parallel phase (``chip_smoke.py --parallel-worker
    TASK RANK WORLD PORT WORK DEVICE``), the config and windows from WORK:
    ``gloo2``: a data-parallel then a tensor-parallel pair of steps and TP
    inference, two gloo ranks sharing the device; ``nccl1``: the pair of
    steps over a formed NCCL group of one."""
    task, rank, world, port, work, device = argv[:6]
    rank, world = int(rank), int(world)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.distributed as dist

    from fastspeech2_tpu_torch.config import load_config
    from fastspeech2_tpu_torch.device import resolve_device
    from fastspeech2_tpu_torch.parallel.mesh import Mesh, initialize_multihost, make_mesh_2d

    device = resolve_device(device)
    cfg = load_config(f"{work}/cfg.yaml")
    w = np.load(f"{work}/windows.npz")
    windows = [{k.split("/", 1)[1]: w[k] for k in w.files if k.startswith(f"{i}/")}
               for i in range(PARALLEL_STEPS)]
    res = {}
    if task == "gloo2":
        assert initialize_multihost(f"localhost:{port}", world, rank, backend="gloo",
                                    device=device) == world
        res["dp"] = parallel_steps(torch, cfg, windows, device, make_mesh_2d(world, 1, device))
        res["tp"] = parallel_steps(torch, cfg, windows, device, make_mesh_2d(1, world, device))
        res["tp_infer"] = parallel_tp_inference(torch, cfg, device, make_mesh_2d(1, world, device))
    else:  # a formed group of one: the step's all-reduces go through NCCL
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0)
        mesh = Mesh([device], 1, data_group=dist.group.WORLD)
        res["nccl"] = parallel_steps(torch, cfg, windows, device, mesh)
        res["nccl_version"] = ".".join(map(str, torch.cuda.nccl.version()))
        res["backend"] = dist.get_backend()
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "fastspeech2_tpu" or m.startswith("fastspeech2_tpu.")]
    assert not bad, bad
    json.dump(res, open(f"{work}/{task}.{rank}.json", "w"))
    dist.destroy_process_group()
    return 0


def two_rank_serve_phase(work, device):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    fastspeech2_tpu_torch serve --backend gloo`` sharing the one card: rank
    0 answers, each batch is split over both ranks. Requests, /healthz
    launch counts; the process group is stopped in every case."""
    import os
    import signal
    import socket

    def free():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    port = free()
    url = f"http://127.0.0.1:{port}"
    log_path = Path(work, "serve2.log")
    t0 = time.perf_counter()
    with open(log_path, "wb") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
             "--nproc_per_node", "2", "--master_addr", "localhost", "--master_port",
             str(free()), "-m", "fastspeech2_tpu_torch", "serve", "-c",
             f"{work}/cfg.yaml", "--backend", "gloo", "--host", "127.0.0.1", "--port",
             str(port), "--max_batch", "16", "--device", str(device)],
            cwd=str(ROOT), env={**os.environ, "PYTHONPATH": str(ROOT)}, stdout=logf,
            stderr=subprocess.STDOUT, start_new_session=True)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError("the two-rank server exited:\n"
                                     + log_path.read_text()[-3000:])
            try:
                healthz(url)
                break
            except OSError:
                assert time.perf_counter() - t0 < 300, "the two-rank server did not come up"
                time.sleep(0.25)
        log(f"two-rank serve: up in {time.perf_counter() - t0:.1f} s")
        http_post(url, "/synthesize", {"text": TEXTS[0]})
        wall, lat, nb, frames, _ = concurrent_round(url, 8, "mel")
        headers, body = http_post(url, "/synthesize", {"phonemes": SENTENCES[1],
                                                        "format": "wav"})
        assert headers["Content-Type"] == "audio/wav" and riff_samples(body) > 0
        launches = healthz(url)["launches"]
        log(f"two-rank serve: 8 concurrent mel requests in {nb} batches, {frames} frames, "
            f"{wall * 1e3:.1f} ms wall; a Griffin-Lim wav request; rank 0's launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        if torch_device_type(device) == "cuda":
            for k in ("attention_block", "ffn_block", "variance_adaptor", "postnet"):
                assert launches[k] > 0, (k, launches)
        text = log_path.read_text()
        for r in (0, 1):
            assert f"serving data-parallel over 2 ranks (rank {r})" in text, text[-2000:]
        return launches
    finally:
        try:
            os.killpg(proc.pid, signal.SIGTERM)
            proc.wait(timeout=30)
        except (ProcessLookupError, subprocess.TimeoutExpired):
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait(timeout=30)
        log(f"two-rank serve: stopped (exit code {proc.returncode})")


def torch_device_type(device) -> str:
    return str(device).split(":")[0]


def parallel_phase(torch, results, device="cuda", cfg=None, windows=None):
    """parallel/ on the one card. Two gloo ranks share it: a data-parallel
    pair of steps at full width (default config, bf16, dropout 0) and the
    same at tensor_parallel=2 (one head per rank), both held to the
    single-process steps on the same windows within the bf16 band, kernel
    12's launches per rank per step logged; TP inference (kernel 7 per head
    shard) held to the unsharded model. The single process's steps run
    twice and must agree bit for bit; a formed NCCL group of one takes the
    same steps, held to them within ``PARALLEL_NCCL_BAND``.
    ``Synthesizer(mesh=)`` over a two-entry mesh of the card at
    B=32 against the unsharded call (and a B=8 wav call, kernel 13 per
    shard), then ``serve`` under two ranks. ``device``/``cfg``/``windows``
    other than the defaults rehearse the phase (gloo only) on the CPU."""
    import os
    import shutil
    import socket
    import tempfile

    import numpy as np

    t_phase = time.perf_counter()
    cfg = cfg or parallel_cfg()
    on_card = torch_device_type(device) == "cuda"
    accum = cfg.train.accum_grad
    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="fs2_parallel_", dir=str(ROOT / "build"))
    try:
        windows = windows or parallel_windows(cfg)
        open(f"{work}/cfg.yaml", "w").write(cfg.to_yaml())
        np.savez(f"{work}/windows.npz", **{f"{i}/{k}": v for i, w in enumerate(windows)
                                           for k, v in w.items()})
        procs = []

        def start(task, world):
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            for r in range(world):
                logf = open(f"{work}/{task}.{r}.log", "wb")
                procs.append((task, r, logf, subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), PARALLEL_FLAG, task,
                     str(r), str(world), str(port), work, str(device)], cwd=str(ROOT),
                    env={**os.environ, "PYTHONPATH": str(ROOT)}, stdout=logf,
                    stderr=subprocess.STDOUT)))

        start("gloo2", 2)
        if on_card:
            start("nccl1", 1)
        try:
            # meanwhile, in this process: the single-process reference steps
            ref = parallel_steps(torch, cfg, windows, device)
            again = parallel_steps(torch, cfg, windows, device)
            mesh_synth_phase(torch, results, device, cfg)
            for task, r, logf, p in procs:
                try:
                    rc = p.wait(timeout=600)
                finally:
                    logf.close()
                if rc != 0:
                    raise AssertionError(f"parallel worker {task} rank {r} failed ({rc}):\n"
                                         + Path(f"{work}/{task}.{r}.log").read_text()[-4000:])
        finally:
            for _, _, logf, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        g = [json.load(open(f"{work}/gloo2.{r}.json")) for r in (0, 1)]
        runs = [("dp=2", [x["dp"] for x in g]), ("tp=2", [x["tp"] for x in g])]
        if on_card:
            n1 = json.load(open(f"{work}/nccl1.0.json"))
            log(f"parallel: NCCL {n1['nccl_version']} group of one, backend {n1['backend']}")
            runs.append(("NCCL world of one", [n1["nccl"]]))
        want = 8 * accum if on_card else 0  # kernel 11's single-process count per step
        for s, (ref_s, again_s) in enumerate(zip(ref["steps"], again["steps"])):
            same = (ref_s["report"] == again_s["report"] and ref_s["grads"] == again_s["grads"])
            log(f"parallel step {s + 1} single process run twice: report and gradient "
                f"readings {'bit-equal' if same else 'DIFFER'}")
            assert same, (ref_s, again_s)
        assert ref["bn"] == again["bn"], "BatchNorm statistics differ run to run"
        bad = []
        for s, ref_s in enumerate(ref["steps"]):
            rr, counts = ref_s["report"], ref_s["launches"]
            assert counts["attention_train_packed"] == want, counts
            log(f"parallel step {s + 1} single process: "
                + ", ".join(f"{k} {rr[k]:.6g}" for k in (*LOSS_TERMS, "grad_norm"))
                + f"; kernel 11 {counts['attention_train_packed']}")
            log("  gradient norms: " + ", ".join(
                f"{k} {v[0]:.4g}" for k, v in ref_s["grads"].items()))
            for name, per_rank in runs:
                for r, run in enumerate(per_rank):
                    got = run["steps"][s]
                    c2 = got["launches"]
                    terms = {k: (got["report"][k] - rr[k]) / abs(rr[k]) for k in LOSS_TERMS}
                    grads = {k: max(abs(a - b) for a, b in zip(v, ref_s["grads"][k]))
                             / ref_s["grads"][k][0] for k, v in got["grads"].items()}
                    log(f"  {name} rank {r}: relative error " + ", ".join(
                        f"{k} {v:+.2e}" for k, v in terms.items())
                        + "; gradient (max over norm and projections, over the norm) "
                        + ", ".join(f"{k} {v:.2e}" for k, v in grads.items())
                        + f"; kernel 12 {c2['attention_train']}/"
                        f"{c2['attention_train.bwd']} fwd/bwd, kernel 11 "
                        f"{c2['attention_train_packed']}")
                    bad += [(name, r, s, k, v) for k, v in terms.items()
                            if not abs(v) <= (PARALLEL_DURATION_BAND if k == "duration_loss"
                                              else PARALLEL_LOSS_BAND)]
                    bad += [(name, r, s, k, v) for k, v in grads.items()
                            if not v <= PARALLEL_GRAD_BAND]
                    if name.startswith("NCCL"):
                        bad += [(name, r, s, k, v) for k, v in {**terms, **grads}.items()
                                if not abs(v) <= PARALLEL_NCCL_BAND]
                    if name.startswith("NCCL"):
                        assert c2["attention_train_packed"] == want, c2
                    else:
                        assert c2["attention_train"] == c2["attention_train.bwd"] == want, c2
                        assert c2["attention_train_packed"] == 0, c2
        bn_ref = np.asarray(ref["bn"])
        for name, per_rank in runs:
            bns = [np.asarray(run["bn"]) for run in per_rank]
            across = max(float(np.abs(b - bns[0]).max()) for b in bns)
            err = float(np.abs(bns[0] - bn_ref).max() / np.abs(bn_ref).max())
            log(f"  {name}: BatchNorm running statistics after {PARALLEL_STEPS} steps, "
                f"max difference across ranks {across:.3g}, against the single "
                f"process {err:.2e} of its largest")
            if across != 0 or not err <= PARALLEL_BN_BAND:
                bad.append((name, "bn", across, err))
        assert not bad, f"parallel routes off the single process: {bad}"
        for r, x in enumerate(g):
            err, counts = x["tp_infer"]
            log(f"parallel TP=2 inference rank {r} vs unsharded (B=8, {err['frames']} "
                f"frames): durations agree on {err['dur_agree']:.4f} of tokens; encoder "
                f"max {err['hs_max']:.3e} mean {err['hs_mean']:.3e}; mel (unsharded "
                f"durations) max {err['mel_max']:.3e} mean {err['mel_mean']:.3e}; "
                f"launches {({k: v for k, v in counts.items() if v})}")
            log(f"parallel Synthesizer(mesh=tp 2) rank {r}: {err['synth_frames']} frames "
                f"(unsharded Synthesizer {err['synth_frames_one']}), launches "
                f"{err['synth_launches']}")
            assert err["lens_equal"] and err["dur_agree"] >= 0.97, err
            assert err["mel_mean"] < 0.02 and err["mel_max"] < 0.2, err
            assert err["hs_mean"] < 0.02, err
            assert counts["fused_attention_packed"] == (8 if on_card else 0), counts
            for k in ("attention_block", "ffn_block", "variance_adaptor", "postnet"):
                assert counts[k] == 0, (k, counts)
                assert k not in err["synth_launches"], (k, err)
            assert err["synth_finite"] and err["synth_sum"] == g[0]["tp_infer"][0]["synth_sum"]
            assert (abs(err["synth_frames"] - err["synth_frames_one"])
                    <= 0.02 * err["synth_frames_one"]), err
            if on_card:
                assert err["synth_launches"]["fused_attention_packed"] >= 8, err
        if on_card:
            results["attention_train"]["launches_dp2_rank_step"] = (
                g[0]["dp"]["steps"][0]["launches"]["attention_train"])
            results["attention_train"]["launches_tp2_rank_step"] = (
                g[0]["tp"]["steps"][0]["launches"]["attention_train"])
            results["fused_attention_packed"]["launches_tp2_infer"] = (
                g[0]["tp_infer"][1]["fused_attention_packed"])
        two_rank_serve_phase(work, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"parallel phase: {time.perf_counter() - t_phase:.1f} s")


def mesh_synth_phase(torch, results, device, cfg):
    """``Synthesizer(mesh=)`` over a two-entry local mesh of the one card: a
    B=32 mel call held to the unsharded call (lengths exact, live frames in
    the bf16 band), kernels 1-4 launched per shard; a B=8 wav call with
    MelGAN attached, kernel 13 per shard."""
    import numpy as np

    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.parallel.mesh import make_mesh
    from fastspeech2_tpu_torch.vocoder.melgan import MelGANGenerator

    on_card = torch_device_type(device) == "cuda"
    model = FastSpeech2(cfg, device=device, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.duration_predictor.out.bias.fill_(1.87)
    one = Synthesizer(model, bf16=True, device=device)
    entry = "cuda:0" if on_card else "cpu"
    sharded = Synthesizer(model, bf16=True, device=device,
                          mesh=make_mesh(devices=[entry, entry]))
    b32 = batch(32)
    mel1, lens1 = one.mel_from_token_batch(b32)
    sharded.mel_from_token_batch(b32)  # warm
    reset_counts()
    mel2, lens2 = sharded.mel_from_token_batch(b32)
    counts = read_counts()
    log(f"Synthesizer(mesh=2 entries of {entry}) B=32: mel {mel2.shape} (unsharded "
        f"{mel1.shape}), launches {({k: v for k, v in counts.items() if v})}")
    assert np.array_equal(lens1, lens2), "sharded out_lens differ"
    L = min(mel1.shape[1], mel2.shape[1])
    live = torch.from_numpy(np.arange(L)[None] < lens1[:, None])
    compare("Synthesizer(mesh=) B=32 vs unsharded, live frames",
            torch.from_numpy(mel2[:, :L])[live], torch.from_numpy(mel1[:, :L])[live],
            0.02, 0.2)
    if on_card:
        for k in ("attention_block", "ffn_block", "variance_adaptor", "postnet"):
            assert counts[k] > 0, (k, counts)
            results[k]["launches_mesh2_b32"] = counts[k]
    gen = MelGANGenerator(bf16=True, seed=0, device=device)
    one.attach_vocoder(gen)
    sharded.attach_vocoder(gen)
    b8 = batch(8, offset=5)
    _, w1, wl1 = one.wav_from_token_batch(b8)
    reset_counts()
    _, w2, wl2 = sharded.wav_from_token_batch(b8)
    counts = read_counts()
    assert np.array_equal(wl1, wl2), (wl1, wl2)
    n = min(w1.shape[1], w2.shape[1])
    live = torch.from_numpy(np.arange(n)[None] < wl1[:, None])
    compare("Synthesizer(mesh=) B=8 wav vs unsharded (int16 PCM / 32768, live samples)",
            torch.from_numpy(w2[:, :n].astype(np.float32) / 32768)[live],
            torch.from_numpy(w1[:, :n].astype(np.float32) / 32768)[live], 0.02, 0.5)
    if on_card:
        assert counts["resstack"] > 0, counts
        results["resstack"]["launches_mesh2_wav_b8"] = counts["resstack"]
    log(f"Synthesizer(mesh=) B=8 wav: launches {({k: v for k, v in counts.items() if v})}")

def main(parallel_only: bool = False) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (ROOT / "fastspeech2_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(fastspeech2_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()

    smi = smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)

    from fastspeech2_tpu_torch.ops.kernels import common
    secs = common.build_all()
    log(f"build: {secs:.1f} s (nvcc {' '.join(common.NVCC_FLAGS)})")
    for name in common.KERNEL_SOURCES:
        for line in common.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    if parallel_only:
        import collections

        parallel_phase(torch, collections.defaultdict(dict))
        log(f"parallel phase alone: {time.perf_counter() - t_start:.1f} s on {smi}")
        return 0
    wgmma_kernels_sass()

    results = {}
    kernel_phase(torch, results)
    train_kernel_phase(torch, results)
    t_hd = time.perf_counter()
    head_dim_kernel_phase(torch, results)
    log(f"head-dim kernel phase: {time.perf_counter() - t_hd:.1f} s")
    t_w = time.perf_counter()
    widths_kernel_phase(torch, results)
    log(f"widths kernel phase: {time.perf_counter() - t_w:.1f} s")
    t_w = time.perf_counter()
    widths_kernel_phase(torch, results, WIDE_FFN_TIMED, "wide")
    head_dim_kernel_phase(torch, results, **WIDE_HEAD_DIMS)
    log(f"wide kernel phase: {time.perf_counter() - t_w:.1f} s")
    stft_kernel_phase(torch, results)
    ms, frames, synth = main_path_phase(torch, results)
    wav_ms, wav_secs = wav_path_phase(torch, results, synth)
    wide_vocoder_phase(torch, results, synth, wav_ms)
    server_phase(torch, synth)
    switch_phase(torch, results, synth)
    gl_ms, gl_secs = griffin_lim_phase(torch, synth.model)
    del synth
    torch.cuda.empty_cache()
    pre = prenorm_path_phase(torch, results)
    prenorm_concat_phase(torch, results)
    dk256_path_phase(torch, results)
    t_oh = time.perf_counter()
    one_head_path_phase(torch, results)
    log(f"one-head path phase: {time.perf_counter() - t_oh:.1f} s")
    torch.cuda.empty_cache()
    t_w = time.perf_counter()
    widths_path_phase(torch, results)
    log(f"widths path phase: {time.perf_counter() - t_w:.1f} s")
    torch.cuda.empty_cache()
    wide_postnet_path_phase(torch, results)
    torch.cuda.empty_cache()
    for which in CONV_WIDTH_MODELS:
        t_w = time.perf_counter()
        conv_widths_path_phase(torch, results, which)
        log(f"{which} adaptor/postnet path phase: {time.perf_counter() - t_w:.1f} s")
        torch.cuda.empty_cache()
    t_w = time.perf_counter()
    wide_model_path_phase(torch, results, ms, wav_ms)
    log(f"wide model path phase: {time.perf_counter() - t_w:.1f} s")
    torch.cuda.empty_cache()
    import shutil

    bf, work, ckpt = int8_path_phase(torch, smi)
    try:
        wg_secs_per_s = waveglow_phase(torch, bf, work, ckpt, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del bf
    torch.cuda.empty_cache()
    local_int8_mesh_phase(torch, results, smi)
    export_work, voc, export_model = export_phase(torch, results, smi)
    try:
        golden_phase(torch, results, export_work, voc, export_model)
    finally:
        shutil.rmtree(export_work, ignore_errors=True)
    del export_model
    torch.cuda.empty_cache()
    demo_phase()
    train_step_vs_cpu_phase(torch)
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="fs2_store_", dir=str(ROOT / "build"))
    try:
        store = seeded_store(store_dir)
        step_ms, step_frames = train_path_phase(torch, results, store)
        torch.cuda.empty_cache()
        t_oh = time.perf_counter()
        one_head_train_phase(torch, results, store)
        log(f"one-head train phase: {time.perf_counter() - t_oh:.1f} s")
        torch.cuda.empty_cache()
        t_w = time.perf_counter()
        widths_train_phase(torch, results, store)
        log(f"widths train phase: {time.perf_counter() - t_w:.1f} s")
        torch.cuda.empty_cache()
        t_w = time.perf_counter()
        wide_model_train_phase(torch, results, store)
        log(f"wide model train phase: {time.perf_counter() - t_w:.1f} s")
        torch.cuda.empty_cache()
        t_cli = time.perf_counter()
        cli_train_phase(torch, results, store, smi)
        log(f"CLI train phase: {time.perf_counter() - t_cli:.1f} s")
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    wavs_per_s, pre_secs_per_s = preprocess_phase(torch, results)
    preprocess_corpora_phase(torch, results)
    torch.cuda.empty_cache()
    parallel_phase(torch, results)
    assert "jax" not in sys.modules and not any(
        m == "fastspeech2_tpu" or m.startswith("fastspeech2_tpu.") for m in sys.modules)

    kernels = []
    for r in results.values():
        # the decoder-rung shape, or the phase's own main shape
        key = r.get("main_shape") or max(r["ms"], key=lambda k: r["ms"][k])
        kernels.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"][key],
            "plain_ms": r["plain_ms"][key], "bound_ms": r["bound_ms"][key],
            "bound_by": r["bound_by"][key],
            "library_ms": r["library_ms"][key] if "library_ms" in r else None,
            "shape": key, **({"note": r["note"]} if "note" in r else {}),
            **{k: r[k] for k in ("launches_cli_train_step", "launches_bucketed_b32",
                                 "launches_dp2_rank_step", "launches_tp2_rank_step",
                                 "launches_tp2_infer", "launches_mesh2_b32",
                                 "launches_mesh2_wav_b8", "launches_local_int8_b32",
                                 "launches_local_int8_wav_b8", "local_int8_ms",
                                 "launches_export_b8",
                                 "launches_golden_f32", "launches_golden",
                                 "op_dispatch", "launches_one_head", "launches_one_head_b32",
                                 "launches_one_head_b8", "launches_dk160_b8",
                                 "launches_one_head_step", "head_dims", "widths", "wide",
                                 "launches_wide_model",
                                 "launches_wide_melgan_b8", "launches_wide_melgan_b32",
                                 "wide_melgan_b32_ms", "corpora") if k in r},
            **({"device_ms": r["device_ms"][key],
                "library_device_ms": r.get("library_device_ms", {}).get(key)}
               if "device_ms" in r else {}),
            "all_shapes": {k: {"ms": r["ms"][k], "plain_ms": r["plain_ms"][k],
                               "bound_ms": r["bound_ms"][k]} for k in r["ms"]}})
        if "bwd" in r:  # the training kernels: "ms" is the forward's time
            kernels[-1].update(launches_bwd=r["launches_bwd"], bwd=r["bwd"][key],
                               bwd_all_shapes=r["bwd"])
    log(f"total {time.perf_counter() - t_start:.1f} s; B=32 {frames / ms * 1e3:.0f} "
        f"mel-frames/s, {wav_secs / wav_ms * 1e3:.0f} audio-seconds/s, train step "
        f"{step_ms:.1f} ms ({step_frames / step_ms * 1e3:.0f} mel-frames/s), preprocess "
        f"{wavs_per_s:.1f} wavs/s ({pre_secs_per_s:.1f} audio-seconds/s), Griffin-Lim "
        f"{gl_secs / gl_ms * 1e3:.1f} audio-seconds/s, WaveGlow B=8 wav call "
        f"{wg_secs_per_s:.1f} audio-seconds/s; prenorm B=32 mel call {pre['ms']:.3f} ms "
        f"({pre['frames'] / pre['ms'] * 1e3:.0f} mel-frames/s), its CLI server "
        f"{pre['rps']:.1f} requests/s, median {pre['median_ms']:.1f} ms on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == PARALLEL_FLAG:
        sys.exit(parallel_worker(sys.argv[2:]))
    sys.exit(main(parallel_only=sys.argv[1:] == ["--parallel-only"]))
