#!/usr/bin/env python3
"""Time the attention kernels of one tree of this repository on the card:
the training attention (kernels 11 and 12) beside scaled_dot_product_attention
at the same dropout rate, and the bare attention (kernels 7 and 8) beside
scaled_dot_product_attention with a boolean key mask.

    python scripts/time_attention_train.py [--tree DIR] [--label NAME]

--tree is a checkout whose ``fastspeech2_tpu_torch`` is timed (default: this
one), for example a parent commit unpacked with ``git archive`` into an
ignored directory; its kernels are built from its own sources. The timing
helpers come from this checkout's ``chip_smoke.py``. Training shapes are the
training path's: (16, 896, 384) (decoder) and (16, 128, 256) (encoder), two
heads, the lengths of ``chip_smoke.py``'s kernel phase, rates 0 and 0.2, both
entries; forward and backward ms are CUDA-event medians of 25 calls, device
ms the profiler's kernel time per call. The bare kernels run at the serving
shapes (16, 768, 384) (decoder rung) and (32, 128, 256) (encoder), two heads,
the same kind of lengths; for them also the host's time to enqueue one call
(``host_ms``: wrapper, tensor maps and launch, 200 calls back to back).
Kernels 11 and 12 are also timed at rate 0.2 at d_k 256 with one head
(16, 896, 256) and in f32 at (4, 320, 384) with two heads (d_k 192, the
shape ``chip_smoke.py`` holds them at), (3, 200, 256) with one and two
heads (d_k 256 and 128) and (4, 320, 384) with one (d_k 384; a tree that
refuses it prints the error). ``digest`` holds a hash of each kernel's
outputs (kernel 11 and 12: forward and gradients at rate 0.2 at the decoder
shape and at each of those; kernels 7 and 8: their outputs at both serving
shapes and at d_k 256), so two trees can be checked for the same bits;
``--digest-only`` computes those and skips the timings. Prints the card's
name and power limit, then one JSON line. To compare two trees, run parent,
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--digest-only", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_attention_train: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT
    from fastspeech2_tpu_torch.ops.kernels import common

    common.build_all(["attention", "attention_train"])
    print(smoke.smi_line(), flush=True)
    dev, H = torch.device("cuda"), 2
    out = {"label": args.label, "tree": args.tree, "card": smoke.smi_line(), "times": {},
           "digest": {}}

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().float().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    def host_ms(fn, n=200):
        """Host time per call to enqueue fn (wrapper, tensor maps, launch):
        n calls back to back on the host clock, the device not waited for."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3 / n

    def lengths(gen, B, T):
        lens = torch.randint(T // 4, T + 1, (B,), generator=gen, dtype=torch.int32)
        lens[0], lens[1], lens[-1] = T, T // 2 - 3, max(1, T // 5)
        return lens.to(dev)

    gen = torch.Generator().manual_seed(11)
    for B, T, D in ((16, 896, 384), (16, 128, 256)):
        lens = lengths(gen, B, T)
        for packed in (True, False):
            shape = (B, T, D) if packed else (B, H, T, D // H)
            q, k, v, do = (torch.randn(shape, generator=gen).bfloat16().to(dev)
                           for _ in range(4))
            q, k, v = (t.requires_grad_() for t in (q, k, v))
            name = "k11" if packed else "k12"
            if T == 896:
                kern = smoke.train_attention_fns(KT, packed, lens, 12345, H, 0.2)[0]
                o = kern(q, k, v)
                out["digest"][f"{name} B={B},T={T},D={D}"] = digest(
                    o, *torch.autograd.grad(o, (q, k, v), do))
            for rate in () if args.digest_only else (0.0, 0.2):
                key = f"{name} B={B},T={T},D={D} rate={rate}"
                out["times"][key] = smoke.train_attention_times(
                    torch, KT, packed, q, k, v, do, lens, H, rate)
                print(key, json.dumps(out["times"][key]), flush=True)

    # d_k 256 (one head) in bf16, the f32 kernels at d_k 128, 192 and 256
    # (the tile kernels) and 384 (the wide ones): digests and, unless
    # --digest-only, times; a tree that refuses a head dim prints the error
    gen = torch.Generator().manual_seed(13)
    for B, T, D, h, dt in ((16, 896, 256, 1, torch.bfloat16), (4, 320, 384, 2, torch.float32),
                           (3, 200, 256, 1, torch.float32), (3, 200, 256, 2, torch.float32),
                           (4, 320, 384, 1, torch.float32)):
        lens = lengths(gen, B, T)
        for packed in (True, False):
            shape = (B, T, D) if packed else (B, h, T, D // h)
            q, k, v, do = (torch.randn(shape, generator=gen).to(dt).to(dev) for _ in range(4))
            q, k, v = (t.requires_grad_() for t in (q, k, v))
            key = f"{'k11' if packed else 'k12'} {str(dt)[6:]} B={B},T={T},D={D},H={h}"
            try:
                kern = smoke.train_attention_fns(KT, packed, lens, 12345, h, 0.2)[0]
                o = kern(q, k, v)
            except ValueError as e:
                print(key, "refused:", e, flush=True)
                continue
            out["digest"][key] = digest(o, *torch.autograd.grad(o, (q, k, v), do))
            if not args.digest_only:
                out["times"][key] = smoke.train_attention_times(
                    torch, KT, packed, q, k, v, do, lens, h, 0.2)
                print(key, json.dumps(out["times"][key]), flush=True)
        with torch.no_grad():
            if dt == torch.bfloat16:
                q, k, v = (torch.randn(B, T, D, generator=gen).bfloat16().to(dev)
                           for _ in range(3))
                out["digest"][f"k7 B={B},T={T},D={D},H={h}"] = digest(
                    KA.fused_attention_packed(q, k, v, lens, h))
                out["digest"][f"k8 B={B},T={T},D={D},H={h}"] = digest(KA.fused_attention(
                    *(t.view(B, T, h, D // h).transpose(1, 2).contiguous() for t in (q, k, v)),
                    lens))

    gen = torch.Generator().manual_seed(7)
    for B, T, D in ((16, 768, 384), (32, 128, 256)):
        dk = D // H
        lens = lengths(gen, B, T)
        q, k, v = (torch.randn(B, T, D, generator=gen).bfloat16().to(dev) for _ in range(3))
        q4, k4, v4 = (t.view(B, T, H, dk).transpose(1, 2) for t in (q, k, v))
        q8, k8, v8 = (t.contiguous() for t in (q4, k4, v4))
        mask = (torch.arange(T, device=dev)[None] < lens[:, None])[:, None, None, :]
        with torch.no_grad():
            out["digest"][f"k7 B={B},T={T},D={D}"] = digest(
                KA.fused_attention_packed(q, k, v, lens, H))
            out["digest"][f"k8 B={B},T={T},D={D}"] = digest(
                KA.fused_attention(q8, k8, v8, lens))
            if args.digest_only:
                continue
            for name, fn in (
                    ("k7", lambda: KA.fused_attention_packed(q, k, v, lens, H)),
                    ("sdpa_packed", lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, attn_mask=mask)),
                    ("k8", lambda: KA.fused_attention(q8, k8, v8, lens)),
                    ("sdpa", lambda: F.scaled_dot_product_attention(
                        q8, k8, v8, attn_mask=mask))):
                key = f"{name} B={B},T={T},D={D}"
                out["times"][key] = {
                    "ms": smoke.cuda_time_ms(fn),
                    "device_ms": sum(smoke.device_ms_by_kernel(torch, fn).values()) or None,
                    "host_ms": host_ms(fn)}
                print(key, json.dumps(out["times"][key]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
