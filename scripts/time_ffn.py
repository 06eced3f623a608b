#!/usr/bin/env python3
"""Time the conv-FFN kernels (2, 9 and 10) of one tree of this repository on
the card, at the serving path's shapes.

    python scripts/time_ffn.py [--tree DIR] [--label NAME] [--digest-only]

--tree is a checkout whose ``fastspeech2_tpu_torch`` is timed (default: this
one), for example a parent commit unpacked with ``git archive`` into an
ignored directory; its kernels are built from its own sources. The timing
helpers come from this checkout's ``chip_smoke.py``. Kernel 2 (post-LN,
``ffn_block``) and kernel 9 (pre-LN, ``ffn_block_pre``) run at the decoder
rung (16, 768, 384) and the encoder shape (32, 128, 256), kernel 10 (bare,
``fused_ffn``) at the decoder rung with O = 384, bf16 out and f32 out
(``fused_ffn_f32``); H = 1024, k = 9. Kernels 2, 9 and 10 also run at
D = 260 with H = 1000 (widths the kernels pad to 32) and at the one-head
wide model's D = 1536 and 2048 with H = 4096 (the x tile in column chunks;
a tree that refuses them prints the error).
Weights are a seeded ``FFTBlock``'s (bf16), inputs seeded noise, lengths
random with one full and one short row: the same in every tree. For each
case it prints the card's name and power limit, then one JSON line: ``ms``
(CUDA events, median of 25 calls), ``device_ms`` (the profiler's device time
per call: every launch of the entry), ``host_ms`` (the host's time to enqueue
one call; 200 calls back to back), ``bound_ms`` (2 (k D H + H O) FLOPs per
row up to len + 4 at 989 TFLOP/s against x, the output and the weights at
3.35 TB/s) and ``digest`` (a hash of the output's bits); ``--digest-only``
prints the digests alone, as one JSON object. To compare two trees, run
parent, change, change, parent in one command on the same card.
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
#: (entry, B, T, D, H)
CASES = (("ffn_block", 16, 768, 384, 1024), ("ffn_block", 32, 128, 256, 1024),
         ("ffn_block_pre", 16, 768, 384, 1024), ("ffn_block_pre", 32, 128, 256, 1024),
         ("fused_ffn", 16, 768, 384, 1024), ("fused_ffn_f32", 16, 768, 384, 1024),
         ("ffn_block", 16, 768, 260, 1000), ("ffn_block_pre", 16, 768, 260, 1000),
         ("fused_ffn", 16, 768, 260, 1000),
         ("ffn_block", 16, 768, 1536, 4096), ("ffn_block_pre", 16, 768, 1536, 4096),
         ("fused_ffn", 16, 768, 1536, 4096), ("ffn_block", 16, 768, 2048, 4096),
         ("ffn_block_pre", 16, 768, 2048, 4096), ("fused_ffn", 16, 768, 2048, 4096))
K = 9


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--digest-only", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_ffn: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.ops.kernels import common
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    common.build_all(["ffn"])
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    digests = {}
    with torch.no_grad():
        for name, B, T, D, H in CASES:
            g = torch.Generator().manual_seed(B * T + D)
            torch.manual_seed(D)
            blk = FFTBlock(EncoderConfig(idim=D, attention_dim=D, linear_units=H,
                                         positionwise_conv_kernel_size=K), device="cpu")
            fp = [t.to(dev) for t in blk.ffn_pack(bf16)]
            x = (2.0 * torch.randn(B, T, D, generator=g) + 0.5).to(dev)
            lens = torch.randint(T // 4, T + 1, (B,), generator=g, dtype=torch.int32)
            lens[0], lens[-1] = T, max(1, T // 5)
            lc, lens = lens.tolist(), lens.to(dev)
            if name.startswith("fused_ffn"):
                xb, od = x.to(bf16), torch.float32 if name.endswith("f32") else bf16
                fn = lambda: KF.fused_ffn(xb, *fp[:4], lens, K, od)  # noqa: E731
                nb = sum(lc) * D * 2 + smoke.nbytes(*fp[:4]) + B * T * D * od.itemsize
            else:
                kern = getattr(KF, name)
                fn = lambda: kern(x, *fp, lens, K)  # noqa: E731
                nb = smoke.nbytes(x, x, *fp)
            shape = f"B={B},T={T},D={D}" + (f",H={H}" if H != 1024 else "")
            try:
                y = fn()
                torch.cuda.synchronize()
            except (ValueError, RuntimeError) as e:
                if not args.digest_only:
                    print(json.dumps({"label": args.label, "kernel": name, "shape": shape,
                                      "error": f"{type(e).__name__}: {e}"}), flush=True)
                continue
            digest = hashlib.sha256(y.float().cpu().numpy().tobytes()).hexdigest()[:16]
            digests[f"{name} {shape}"] = digest
            if args.digest_only:
                continue
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host = (time.perf_counter() - t0) * 1e3 / 200
            torch.cuda.synchronize()
            flops = sum(min(n + (K - 1) // 2, T) for n in lc) * 2 * (K * D * H + H * D)
            b_ms, by = smoke.bound_ms(flops, nb)
            dms = smoke.device_ms_by_kernel(torch, fn)
            line = {"label": args.label, "kernel": name, "shape": shape,
                    "ms": smoke.cuda_time_ms(fn), "device_ms": sum(dms.values()) or None,
                    "device_ms_by_kernel": {k: round(v, 5) for k, v in dms.items()},
                    "host_ms": host, "bound_ms": b_ms, "bound_by": by, "digest": digest}
            print(smoke.smi_line(), flush=True)
            print(json.dumps(line), flush=True)
    if args.digest_only:
        print(json.dumps({"label": args.label, "digest": digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
