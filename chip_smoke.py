#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: refuse to run without CUDA; print the card's name and power limit.
2. build: compile the five CUDA sources of fastspeech2_tpu_torch/csrc with
   nvcc for sm_90a (all sources at once) and print the build seconds and the
   ptxas register/shared-memory report.
3. kernels: each of the six kernels against its plain PyTorch version on the
   card, on the same bf16-tier inputs at the serving path's shapes (the
   FFT-block and decoder kernels with lengths that leave dead tiles, the
   MelGAN residual stack at the four stage shapes of a B=16, 768-frame rung,
   at a single-tile length and in f32); max/mean abs error against the stated
   tolerance; kernel and plain times (CUDA events, median of 25) beside the
   least time the card could take for the same work.
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
   the vocoder's share, a profile.
6. server: infer.server.serve in a thread on 127.0.0.1 with the same
   synthesizer: 16 concurrent /synthesize wav requests (text and phonemes), a
   /stream of a three-sentence paragraph, a mel request, /healthz; RIFF
   headers, sample counts, batching engaged; requests/s and median latency;
   clean shutdown.
7. switch: flags.FUSED_ATT_QKV off: the split attention kernel carries a B=8
   mel batch and its output is held to the fused route's.

The line before the last is a JSON object listing the kernels; the last line
is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
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


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare(name, got, want, mean_tol, max_tol):
    d = (got.float() - want.float()).abs()
    mx, mn = float(d.max()), float(d.mean())
    ok = mx < max_tol and mn < mean_tol
    log(f"  {name}: max_abs={mx:.3e} mean_abs={mn:.3e} "
        f"(tolerance max<{max_tol:g} mean<{mean_tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return mx


def kernel_phase(torch, results):
    """Each kernel against its plain version at the serving path's shapes."""
    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.models.postnet import Postnet, PostnetConfig
    from fastspeech2_tpu_torch.models.predictors import Predictor, PredictorConfig
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

    def record(name, src, replaces, err, ms, plain_ms, flops, nb, key=None):
        key = key or shape_key
        b_ms, by = bound_ms(flops, nb)
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({by})")
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
            fp = blk.ffn_pack(bf16)
            got = KF.ffn_block(x, *fp, lens, 9)
            want = KF.ffn_block_plain(x, *fp, lens, 9)
            torch.cuda.synchronize()
            log(f"kernel ffn_block {shape_key}")
            err = compare("ffn_block", got, want, 2e-3, 0.1)
            ms = cuda_time_ms(lambda: KF.ffn_block(x, *fp, lens, 9))
            pms = cuda_time_ms(lambda: KF.ffn_block_plain(x, *fp, lens, 9))
            flops = sum(min(l + 4, T) * 2 * (9 * D * 1024 + 1024 * D) for l in lc)
            record("ffn_block", "fastspeech2_tpu_torch/csrc/ffn.cu",
                   "fastspeech2_tpu/ops/pallas/ffn.py:344", err, ms, pms, flops,
                   nbytes(x, x, *fp))

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
    resstack_phase(torch, results, record)
    attention_res_ln_phase(torch, results, record)


def resstack_phase(torch, results, record):
    """Kernel 13 against its plain version: bf16 at the four stage shapes of
    a B=16, 768-frame rung and at a single-tile length, f32 at a smaller
    shape. Weights are the default generator's (seed 0), the input is unit
    normal noise in bf16."""
    from fastspeech2_tpu_torch.ops.kernels import resstack as KR
    from fastspeech2_tpu_torch.vocoder.melgan import MelGANGenerator

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = MelGANGenerator(seed=0)
    g = torch.Generator().manual_seed(13)
    packs = {b.stacks[0].c1.weight.shape[0]: b.stacks for b in gen.blocks}

    def check(B, S, C, cd, time_it):
        ws = KR.pack_weights(packs[C], cd)
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
        return err, ms, pms

    with torch.inference_mode():
        check(2, 2048, 64, bf16, False)   # single tile of the JAX kernel
        check(1, 128, 256, bf16, False)   # one block holds both ends
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
            # f32 product of the same bf16 values: q/k/v differ by rare
            # one-ulp flips, so the outputs agree in the band, not bit for bit
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


def main_path_phase(torch, results):
    import numpy as np

    from fastspeech2_tpu_torch.config import Config
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.ops import make_non_pad_mask
    from fastspeech2_tpu_torch.ops.length_regulator import frame_demand, scale_durations
    from fastspeech2_tpu_torch.ops.precision import compute_dtype

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

    # one B=8 batch served through the timed path with the 2-way split
    # engaged; every served row is held against the same port on the CPU
    # (plain versions) fed the card's durations (live frames do not depend
    # on the decode rung, so one CPU decode at the longer rung covers both)
    seqs = batch(8, offset=8)
    mel_s, lens_s = synth.mel_from_token_batch(seqs)
    B, t_pad, _, xs_g, il_g, alphas = synth._pad_batch(seqs, 1.0)
    with synth._cd():
        _, d_g = model.encode(xs_g, il_g)
        demand = frame_demand(scale_durations(d_g, alphas), make_non_pad_mask(il_g, t_pad))
    groups = synth._decode_groups(demand.cpu().numpy())
    log(f"B=8 decode groups (rows, rung): {[(g.tolist(), r) for g, r in groups]}")
    assert len(groups) == 2, "the 2-way split did not engage on the B=8 batch"
    rung = max(r for _, r in groups)
    assert mel_s.shape[1] == rung, (mel_s.shape, rung)
    cpu_model = FastSpeech2(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    xs_c, il_c, d_g = xs_g.cpu(), il_g.cpu(), d_g.cpu()
    with compute_dtype(torch.bfloat16), torch.inference_mode():
        hs_c, d_c = cpu_model.encode(xs_c, il_c)
        mel_c, lens_c = cpu_model.decode_frames(hs_c, d_g, il_c, out_maxlen=rung)
    dur_match = float((d_c == d_g).float().mean())
    log(f"B=8 served on the card vs CPU plain versions: durations agree on "
        f"{dur_match:.4f} of tokens")
    assert np.array_equal(lens_s, lens_c[:B].numpy()), "out_lens differ"
    live = torch.from_numpy(np.arange(rung)[None] < lens_s[:, None])
    for i in range(B):
        compare(f"B=8 served row {i} ({int(lens_s[i])} frames)",
                torch.from_numpy(mel_s[i])[live[i]], mel_c[i][live[i]], 0.02, 0.2)
    compare("B=8 served mel, live frames, card kernels vs CPU plain (bf16 band)",
            torch.from_numpy(mel_s)[live], mel_c[:B][live], 0.02, 0.2)

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


def kernel_modules():
    from fastspeech2_tpu_torch.ops.kernels import adaptor, attention, ffn, postnet, resstack

    return {"attention_block": (attention, "launches"), "ffn_block": (ffn, "launches"),
            "variance_adaptor": (adaptor, "launches"), "postnet": (postnet, "launches"),
            "resstack": (resstack, "launches"),
            "attention_res_ln": (attention, "res_ln_launches")}


def reset_counts():
    for mod, attr in kernel_modules().values():
        setattr(mod, attr, 0)


def read_counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in kernel_modules().items()}


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
    by_name = profile_phase(torch, lambda: synth.wav_from_token_batch(b32), "B=32 wav call")
    rs = sum(v for k, v in by_name.items() if "resstack" in k)
    if by_name:
        log(f"profile B=32 wav call: resstack kernels {rs:.3f} ms of "
            f"{sum(by_name.values()):.3f} ms device time")
    return ms, secs


def server_phase(torch, synth):
    """serve() in a thread on 127.0.0.1 with the wav synthesizer: concurrent
    text and phoneme requests, a stream, a mel request, healthz, shutdown."""
    import socket

    from fastspeech2_tpu_torch.config import Config
    from fastspeech2_tpu_torch.infer.server import serve

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    url = f"http://127.0.0.1:{port}"
    ready, stop = threading.Event(), threading.Event()
    th = threading.Thread(target=serve, args=(synth, Config()), daemon=True,
                          kwargs=dict(host="127.0.0.1", port=port, max_batch=16,
                                      max_wait_ms=20.0, ready_event=ready, stop_event=stop))
    th.start()
    assert ready.wait(timeout=60), "server did not come up"

    def post(path, payload):
        req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.headers, r.read()

    def samples(body):
        assert body[:4] == b"RIFF" and body[8:12] == b"WAVE", body[:12]
        n = struct.unpack("<I", body[40:44])[0] // 2
        assert n > 0 and n % 256 == 0 and len(body) == 44 + 2 * n, (n, len(body))
        return n

    def healthz():
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            return json.loads(r.read())

    try:
        # the batcher's two threads are new to the card: their first calls pay
        # for their own cuBLAS/cuDNN handles, which Synthesizer.warmup (run
        # from the main thread) cannot warm. Two requests, one after the
        # other, before the timed ones.
        first = []
        for text in TEXTS[:2]:
            t0 = time.perf_counter()
            samples(post("/synthesize", {"text": text, "format": "wav"})[1])
            first.append((time.perf_counter() - t0) * 1e3)
        log(f"server: first two requests after start {first[0]:.1f} ms, {first[1]:.1f} ms")
        n_req = 16

        def round_of_requests():
            lat, total, errors = [0.0] * n_req, [0] * n_req, []

            def go(i):
                payload = ({"text": TEXTS[(i // 2) % len(TEXTS)]} if i % 2 == 0 else
                           {"phonemes": SENTENCES[(i // 2) % len(SENTENCES)]})
                t0 = time.perf_counter()
                try:
                    _, body = post("/synthesize", {**payload, "format": "wav"})
                    total[i] = samples(body)
                except Exception as e:  # reported below: a thread cannot fail the run
                    errors.append(f"request {i}: {e!r}")
                lat[i] = time.perf_counter() - t0

            stats0 = healthz()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=go, args=(i,)) for i in range(n_req)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
                assert not t.is_alive(), "a request did not return"
            wall = time.perf_counter() - t0
            assert not errors, errors
            stats = healthz()
            n_batches = stats["batches"] - stats0["batches"]
            assert stats["requests"] - stats0["requests"] == n_req and n_batches < n_req, stats
            return wall, lat, n_batches, sum(total), stats

        # round 1 meets its batch shapes (token buffer x batch size) for the
        # first time; round 2 repeats them warm and is the one reported
        wall1, lat1, nb1, _, _ = round_of_requests()
        log(f"server: round 1 (first use of its shapes): {n_req} requests in {nb1} batches, "
            f"{n_req / wall1:.1f} requests/s, median latency "
            f"{statistics.median(lat1) * 1e3:.1f} ms, max {max(lat1) * 1e3:.1f} ms")
        wall, lat, n_batches, total, stats = round_of_requests()
        log(f"server: {n_req} concurrent wav requests (8 text, 8 phonemes) in "
            f"{n_batches} batches, {total / 22050.0:.1f} s of audio")
        log(f"server: {n_req / wall:.1f} requests/s, median latency "
            f"{statistics.median(lat) * 1e3:.1f} ms, max {max(lat) * 1e3:.1f} ms "
            f"(sorted ms: {[round(x * 1e3) for x in sorted(lat)]})")

        headers, body = post("/stream", {"text": PARAGRAPH})
        assert headers.get("Transfer-Encoding") == "chunked"
        assert body[:4] == b"RIFF" and body[4:8] == b"\xff\xff\xff\xff"
        n_stream = (len(body) - 44) // 2
        assert n_stream > 0 and n_stream % 256 == 0, n_stream
        _, one = post("/stream", {"text": PARAGRAPH.split(".")[0] + "."})
        assert len(body) > len(one), "three sentences streamed no more than one"
        obj = json.loads(post("/synthesize", {"phonemes": SENTENCES[0]})[1])
        assert obj["frames"] == len(obj["mel"]) > 0 and len(obj["mel"][0]) == 80
        log(f"server: /stream {n_stream} samples over 3 sentences, mel request "
            f"{obj['frames']} frames, healthz {stats}")
    finally:
        stop.set()
        th.join(timeout=60)
    assert not th.is_alive(), "the server did not shut down"
    log("server: shut down cleanly")


def switch_phase(torch, results, synth):
    """flags.FUSED_ATT_QKV off: q/k/v projected with plain ops, then the
    q/k/v-given attention kernel; held to the fused-QKV route."""
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


def main() -> int:
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

    results = {}
    kernel_phase(torch, results)
    ms, frames, synth = main_path_phase(torch, results)
    wav_ms, wav_secs = wav_path_phase(torch, results, synth)
    server_phase(torch, synth)
    switch_phase(torch, results, synth)
    assert "jax" not in sys.modules and not any(
        m == "fastspeech2_tpu" or m.startswith("fastspeech2_tpu.") for m in sys.modules)

    kernels = []
    for r in results.values():
        key = max(r["ms"], key=lambda k: r["ms"][k])  # the decoder-rung shape
        kernels.append({
            "name": r["name"], "route": r["route"], "source": r["source"],
            "replaces": r["replaces"], "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"][key],
            "plain_ms": r["plain_ms"][key], "bound_ms": r["bound_ms"][key],
            "bound_by": r["bound_by"][key], "library_ms": None, "shape": key,
            "all_shapes": {k: {"ms": r["ms"][k], "plain_ms": r["plain_ms"][k],
                               "bound_ms": r["bound_ms"][k]} for k in r["ms"]}})
    log(f"total {time.perf_counter() - t_start:.1f} s; B=32 {frames / ms * 1e3:.0f} "
        f"mel-frames/s, {wav_secs / wav_ms * 1e3:.0f} audio-seconds/s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
