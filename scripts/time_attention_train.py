#!/usr/bin/env python3
"""Time the training attention kernels 11 and 12 of one tree of this
repository on the card, beside scaled_dot_product_attention at the same
dropout rate.

    python scripts/time_attention_train.py [--tree DIR] [--label NAME]

--tree is a checkout whose ``fastspeech2_tpu_torch`` is timed (default: this
one), for example a parent commit unpacked with ``git archive`` into an
ignored directory; its kernels are built from its own sources. The timing
helpers come from this checkout's ``chip_smoke.py``. Shapes are the
training path's: (16, 896, 384) (decoder) and (16, 128, 256) (encoder), two
heads, the lengths of ``chip_smoke.py``'s kernel phase, rates 0 and 0.2, both
entries; forward and backward ms are CUDA-event medians of 25 calls. Prints
the card's name and power limit, then one JSON line. To compare two trees,
run parent, change, change, parent in one command on the same card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_attention_train: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT
    from fastspeech2_tpu_torch.ops.kernels import common

    common.build_all(["attention_train"])
    print(smoke.smi_line(), flush=True)
    dev, H = torch.device("cuda"), 2
    gen = torch.Generator().manual_seed(11)
    out = {"label": args.label, "tree": args.tree, "card": smoke.smi_line(), "times": {}}
    for B, T, D in ((16, 896, 384), (16, 128, 256)):
        lens = torch.randint(T // 4, T + 1, (B,), generator=gen, dtype=torch.int32)
        lens[0], lens[1], lens[-1] = T, T // 2 - 3, max(1, T // 5)
        lens = lens.to(dev)
        for packed in (True, False):
            shape = (B, T, D) if packed else (B, H, T, D // H)
            q, k, v, do = (torch.randn(shape, generator=gen).bfloat16().to(dev)
                           for _ in range(4))
            q, k, v = (t.requires_grad_() for t in (q, k, v))
            for rate in (0.0, 0.2):
                key = f"{'k11' if packed else 'k12'} B={B},T={T},D={D} rate={rate}"
                out["times"][key] = smoke.train_attention_times(
                    torch, KT, packed, q, k, v, do, lens, H, rate)
                print(key, json.dumps(out["times"][key]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
