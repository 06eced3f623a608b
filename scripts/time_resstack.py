#!/usr/bin/env python3
"""Time the MelGAN residual-stack kernel (kernel 13) of one tree of this
repository on the card, at the four stage shapes of a B=16, 768-frame rung.

    python scripts/time_resstack.py [--tree DIR] [--label NAME] [--widths]

--tree is a checkout whose ``fastspeech2_tpu_torch`` is timed (default: this
one), for example a parent commit unpacked with ``git archive`` into an
ignored directory; its kernels are built from its own sources. The timing
helpers come from this checkout's ``chip_smoke.py``. Weights are the default
generator's (``MelGANGenerator(seed=0)``, bf16), inputs unit normal noise from
a seeded generator, the same in every tree. For each shape it prints the
card's name and power limit, then one JSON line: ``ms`` (CUDA events, median
of 25 calls), ``device_ms`` (the profiler's device time per call: the kernel's),
``host_ms`` (the host's time to enqueue one call: wrapper, two tensor maps,
launch; 200 calls back to back), ``bound_ms`` (operations 2*B*S*12*C^2 at
989 TFLOP/s against the activation's read and write and the weights at 3.35
TB/s) and ``digest`` (a hash of the output's bits). To compare two trees,
run parent, change, change, parent in one command on the same card.
--widths times the widths past the first range instead (``chip_smoke.py``'s
``RESSTACK_WIDTHS``, seeded weights at that width: the wide path at C 320,
512 and 1024 in bf16 and f32, the f32 zero padding at 250), with the plain
version's ``plain_ms`` and, for the f32 tier, the bound at 67 TFLOP/s.
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
SHAPES = ((16, 6144, 256), (16, 49152, 128), (16, 98304, 64), (16, 196608, 32))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--widths", action="store_true",
                    help="the widths past 256 and the f32 padding (RESSTACK_WIDTHS)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_resstack: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from fastspeech2_tpu_torch.ops.kernels import common
    from fastspeech2_tpu_torch.ops.kernels import resstack as KR
    from fastspeech2_tpu_torch.vocoder.melgan import MelGANGenerator

    common.build_all(["resstack"])
    if args.widths:
        return time_widths(torch, smoke, KR, args.label)
    dev = torch.device("cuda")
    gen = MelGANGenerator(seed=0, device="cpu")
    packs = {b.stacks[0].c1.weight.shape[0]: b.stacks for b in gen.blocks}
    g = torch.Generator().manual_seed(13)
    with torch.inference_mode():
        for B, S, C in SHAPES:
            ws = [w.to(dev) for w in KR.pack_weights(packs[C], torch.bfloat16)]
            x = torch.randn(B, S, C, generator=g).to(torch.bfloat16).to(dev)
            fn = lambda: KR.resstack(x, *ws)  # noqa: E731
            y = fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host = (time.perf_counter() - t0) * 1e3 / 200
            torch.cuda.synchronize()
            flops = 2.0 * B * S * 3 * 4 * C * C
            nb = 2 * B * S * C * 2 + 3 * 4 * C * C * 2 + 2 * 3 * C * 4
            b_ms, by = smoke.bound_ms(flops, nb)
            dms = smoke.device_ms_by_kernel(torch, fn)
            line = {"label": args.label, "shape": f"B={B},S={S},C={C}",
                    "ms": smoke.cuda_time_ms(fn),
                    "device_ms": sum(dms.values()) or None,
                    "host_ms": host, "bound_ms": b_ms, "bound_by": by,
                    "digest": hashlib.sha256(
                        y.float().cpu().numpy().tobytes()).hexdigest()[:16]}
            print(smoke.smi_line(), flush=True)
            print(json.dumps(line), flush=True)
    return 0


def time_widths(torch, smoke, KR, label) -> int:
    """One JSON line per ``RESSTACK_WIDTHS`` shape; a tree that refuses a
    width prints the error."""
    from fastspeech2_tpu_torch.ops.precision import round_to

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1024)
    for tier, B, S, C, dil, _ in smoke.RESSTACK_WIDTHS:
        cd = torch.bfloat16 if tier == "bf16" else torch.float32
        n, bound = len(dil), 1.0 / (3 * C) ** 0.5
        w1 = ((torch.rand(n, C, 3 * C, generator=g) * 2 - 1) * bound).to(cd)
        w2 = ((torch.rand(n, C, C, generator=g) * 2 - 1) / C ** 0.5).to(cd)
        b1, b2 = (round_to((torch.rand(n, C, generator=g) * 2 - 1) * bound, cd)
                  for _ in range(2))
        ws = [t.to(dev).contiguous() for t in (w1, b1, w2, b2)]
        x = torch.randn(B, S, C, generator=g).to(cd).to(dev)
        line = {"label": label, "shape": f"{tier} B={B},S={S},C={C},n={n}"}
        fn = lambda: KR.resstack(x, *ws, dil)  # noqa: E731
        with torch.inference_mode():
            try:
                y = fn()
                torch.cuda.synchronize()
            except (ValueError, RuntimeError) as e:
                line["error"] = f"{type(e).__name__}: {e}"
                print(smoke.smi_line(), flush=True)
                print(json.dumps(line), flush=True)
                continue
            dms = smoke.device_ms_by_kernel(torch, fn)
            flops = 2.0 * B * S * n * 4 * C * C
            nb = 2 * B * S * C * x.element_size() + smoke.nbytes(*ws)
            b_ms, by = smoke.bound_ms(flops, nb, smoke.PEAK_BF16_FLOPS if tier == "bf16"
                                      else smoke.PEAK_F32_FLOPS)
            line.update(ms=smoke.cuda_time_ms(fn, reps=10), device_ms=sum(dms.values()) or None,
                        device_ms_by_kernel={k: round(v, 5) for k, v in dms.items()},
                        plain_ms=smoke.cuda_time_ms(lambda: KR.resstack_plain(x, *ws, dil),
                                                    reps=3),
                        bound_ms=b_ms, bound_by=by,
                        digest=hashlib.sha256(y.float().cpu().numpy().tobytes()).hexdigest()[:16])
        print(smoke.smi_line(), flush=True)
        print(json.dumps(line), flush=True)
        del x, ws, y
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
