#!/usr/bin/env python3
"""Time the FFT-block attention halves (kernels 1, 5 and 6) of one tree of
this repository on the card, at the serving path's shapes.

    python scripts/time_attention.py [--tree DIR] [--label NAME] [--digest-only]

--tree is a checkout whose ``fastspeech2_tpu_torch`` is timed (default: this
one), for example a parent commit unpacked with ``git archive`` into an
ignored directory; its kernels are built from its own sources. The timing
helpers come from this checkout's ``chip_smoke.py``. Kernel 1 (post-LN,
``attention_block``), kernel 5 (q/k/v given, ``attention_res_ln``) and
kernel 6 (pre-LN, ``attention_res``) run at the decoder rung (16, 768, 384)
and the encoder shape (32, 128, 256) with two heads, and at (16, 768, 256)
with one head (d_k 256), and at the wide widths: D = 1536 and 2048 with one
head and D = 2048 with two (d_k 1536, 2048, 1024; the projections over x
tiles in column chunks); a tree whose kernels refuse a shape prints the
error.
Weights are a seeded ``FFTBlock``'s (bf16), inputs seeded noise, lengths
random with one full and one short row: the same in every tree. Kernel 5
takes q/k/v projected from x by plain ops, kernel 6 from LN(x), with x as
the residual. For each case it prints the card's name and power limit,
then one JSON line: ``ms`` (CUDA events, median of 25 calls),
``device_ms`` (the profiler's device time per call: every launch of the
entry) and ``device_ms_by_kernel``, ``host_ms`` (the host's time to
enqueue one call; 200 calls back to back), ``bound_ms`` (8 l D^2 + 4 l^2 D
FLOPs for kernel 1, 2 l D^2 + 4 l^2 D for 5 and 6, per row of length l, at
989 TFLOP/s against the bytes chip_smoke.py counts at 3.35 TB/s) and
``digest`` (a hash of the output's bits); ``--digest-only`` prints the
digests alone, as one JSON object. To compare two trees, run parent,
change, change, parent in one command on the same card.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = ((16, 768, 384, 2), (32, 128, 256, 2), (16, 768, 256, 1), (16, 768, 1536, 1),
         (16, 768, 2048, 1), (16, 768, 2048, 2))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--digest-only", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.ops import nn
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.kernels import common
    from fastspeech2_tpu_torch.ops.precision import compute_dtype

    common.build_all(["attention"])
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    digests = {}
    with torch.no_grad(), compute_dtype(bf16):
        for B, T, D, H in CASES:
            g = torch.Generator().manual_seed(B * T + D + H)
            torch.manual_seed(D + H)
            blk = FFTBlock(EncoderConfig(idim=D, attention_dim=D, attention_heads=H,
                                         linear_units=1024), device="cpu").to(dev)
            apk = blk.attn_pack(bf16)
            x = (2.0 * torch.randn(B, T, D, generator=g) + 0.5).to(dev)
            lens = torch.randint(T // 4, T + 1, (B,), generator=g, dtype=torch.int32)
            lens[0], lens[-1] = T, max(1, T // 5)
            lc, lens = lens.tolist(), lens.to(dev)
            proj = lambda y: [nn.linear(y, p.weight, p.bias, out_dtype=bf16)  # noqa: E731
                              for p in (blk.attn.q, blk.attn.k, blk.attn.v)]
            qkv5 = proj(x)
            qkv6 = proj(nn.layer_norm(x, blk.norm1.weight, blk.norm1.bias))
            live_qkv = 3 * sum(lc) * D * 2  # q/k/v rows past a length are not read
            small = sum(2 * l * D * D + 4 * l * l * D for l in lc)
            fns = {
                "attention_block": (lambda: KA.attention_block(x, *apk, lens, H),
                                    sum(8 * l * D * D + 4 * l * l * D for l in lc),
                                    smoke.nbytes(x, x, *apk)),
                "attention_res_ln": (lambda: KA.attention_res_ln(*qkv5, x, *apk[2:], lens, H),
                                     small, live_qkv + smoke.nbytes(x, x, *apk[2:])),
                "attention_res": (lambda: KA.attention_res(*qkv6, x, *apk[2:4], lens, H),
                                  small, live_qkv + smoke.nbytes(x, x, *apk[2:4])),
            }
            for name, (fn, flops, nb) in fns.items():
                line = {"label": args.label, "kernel": name,
                        "shape": f"B={B},T={T},D={D},H={H}"}
                try:
                    y = fn()
                    torch.cuda.synchronize()
                except (ValueError, RuntimeError) as e:
                    line["error"] = f"{type(e).__name__}: {e}"
                    if not args.digest_only:
                        print(json.dumps(line), flush=True)
                    continue
                digest = hashlib.sha256(y.float().cpu().numpy().tobytes()).hexdigest()[:16]
                digests[f"{name} {line['shape']}"] = digest
                if args.digest_only:
                    continue
                t0 = time.perf_counter()
                for _ in range(200):
                    fn()
                host = (time.perf_counter() - t0) * 1e3 / 200
                torch.cuda.synchronize()
                b_ms, by = smoke.bound_ms(flops, nb)
                dms = smoke.device_ms_by_kernel(torch, fn)
                line.update({
                    "ms": smoke.cuda_time_ms(fn), "device_ms": sum(dms.values()) or None,
                    "device_ms_by_kernel": {k: round(v, 5) for k, v in dms.items()},
                    "host_ms": host, "bound_ms": b_ms, "bound_by": by, "digest": digest})
                print(smoke.smi_line(), flush=True)
                print(json.dumps(line), flush=True)
    if args.digest_only:
        print(json.dumps({"label": args.label, "digest": digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
