#!/usr/bin/env python3
"""Is the port's bf16 training step reproducible run to run on the card?

    python scripts/determinism_probe.py [--tree DIR] [--label NAME] [--steps N]
        [--timing-only]

--tree is a checkout whose ``fastspeech2_tpu_torch`` is run (default: this
one), for example a parent commit unpacked with ``git archive`` into an
ignored directory. The step is ``chip_smoke.py``'s parallel-phase step:
``configs/default.yaml`` at full width, bf16, dropout rates 0, the seed-0
model, one seeded global window of ``batch_size x accum_grad`` rows of 96
tokens and 640 frames (``chip_smoke.py:parallel_windows``).

For each variant the step runs twice from the same seeded model, and the
summed gradients (before clipping) are diffed per parameter:

- ``default``: the port as it runs;
- ``cudnn_deterministic``: ``torch.backends.cudnn.deterministic = True``;
- ``warn``: ``torch.use_deterministic_algorithms(True, warn_only=True)``,
  which names every op that has no deterministic CUDA implementation (the
  warnings are printed, deduplicated).

Then the times (``--timing-only``: these alone): the step's, CUDA events
around each of ``--steps`` steps after two warm ones, the median; and the
length regulator's forward and backward alone at one micro-batch's shape
(16 rows, 96 tokens, 640 frames, D = 256), median of 50. It prints the
card's name and power limit, then one JSON line per variant (``max_abs``:
the largest gradient difference between the two runs; ``params_differ``:
how many parameters differ, and the first few names) and one of the times.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--steps", type=int, default=7)
    ap.add_argument("--timing-only", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("determinism_probe: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from fastspeech2_tpu_torch.models.fastspeech2 import Batch, FastSpeech2
    from fastspeech2_tpu_torch.train.optimizer import NoamAdam
    from fastspeech2_tpu_torch.train.seeds import SeedSchedule
    from fastspeech2_tpu_torch.train.step import TrainState, make_train_step, trainable

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    cfg = smoke.parallel_cfg()
    accum = cfg.train.accum_grad
    window = smoke.parallel_windows(cfg)[0]
    batch = Batch(**{k: torch.from_numpy(v).cuda() for k, v in window.items()})

    def grads_of_one_step():
        model = FastSpeech2(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
        opt = NoamAdam(trainable(model), cfg)
        names = [n for n, _ in model.named_parameters()]
        caught = {}

        def keep(grads):
            caught["g"] = [g.detach().clone() for g in grads]
            return torch.zeros((), device="cuda")

        opt.step = keep
        seeds = SeedSchedule(model.dropout_sites(), seed=0)
        make_train_step(model, opt, accum, bf16=True)(
            TrainState(model, opt), batch, [seeds.draw() for _ in range(accum)])
        torch.cuda.synchronize()
        return names, caught["g"]

    def variant(name):
        names, a = grads_of_one_step()
        _, b = grads_of_one_step()
        diffs = [(float((x - y).abs().max()), n) for n, x, y in zip(names, a, b)]
        differ = [n for d, n in diffs if d != 0]
        print(json.dumps({"label": args.label, "variant": name,
                          "max_abs": max(d for d, _ in diffs),
                          "params_differ": len(differ), "of": len(names),
                          "first": differ[:12]}), flush=True)

    if not args.timing_only:
        variant("default")
        torch.backends.cudnn.deterministic = True
        variant("cudnn_deterministic")
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            variant("warn")
        torch.use_deterministic_algorithms(False)
        for msg in sorted({str(w.message).split("\n")[0] for w in seen}):
            print(f"  warning: {msg[:300]}", flush=True)

    model = FastSpeech2(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    opt = NoamAdam(trainable(model), cfg)
    step = make_train_step(model, opt, accum, bf16=True)
    ts, seeds = TrainState(model, opt), SeedSchedule(model.dropout_sites(), seed=0)
    times = []
    for i in range(args.steps + 2):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        ts, rep = step(ts, batch, [seeds.draw() for _ in range(accum)])
        e1.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append((e0.elapsed_time(e1), (time.perf_counter() - t0) * 1e3))
    ms = np.asarray(times)
    from fastspeech2_tpu_torch.ops.length_regulator import regulate_length

    g = torch.Generator().manual_seed(1)
    hs = torch.randn(16, 96, 256, generator=g).cuda().requires_grad_()
    ds = torch.randint(1, 7, (16, 96), generator=g).cuda()
    tok_mask = torch.ones(16, 96, dtype=torch.bool, device="cuda")
    grad = torch.randn(16, 640, 256, generator=g).cuda()

    def lr_step():
        out, _, _ = regulate_length(hs, ds, tok_mask, 640)
        out.backward(grad)

    lr_ms = smoke.cuda_time_ms(lr_step, reps=50)
    print(json.dumps({"label": args.label, "step_ms_median": float(np.median(ms[:, 0])),
                      "length_regulator_fwd_bwd_ms": lr_ms,
                      "step_ms_all": [round(float(x), 3) for x in ms[:, 0]],
                      "host_ms_median": float(np.median(ms[:, 1])),
                      "rows": int(batch.xs.shape[0]), "frames": int(window["olens"].sum()),
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
