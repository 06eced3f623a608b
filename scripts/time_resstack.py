#!/usr/bin/env python3
"""Time the MelGAN residual-stack kernel (kernel 13) of one tree of this
repository on the card, at the four stage shapes of a B=16, 768-frame rung.

    python scripts/time_resstack.py [--tree DIR] [--label NAME]

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


if __name__ == "__main__":
    sys.exit(main())
