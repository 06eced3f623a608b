#!/usr/bin/env python3
"""Time the bf16 serving mel call of one tree of this repository on the card.

    python scripts/time_mel_call.py [--tree DIR] [--label NAME] [--reps N] [--mesh]
    python scripts/time_mel_call.py --artifacts [--rounds N] [--reps N]
    python scripts/time_mel_call.py --summary LOG [LOG ...]

--tree is a checkout whose ``fastspeech2_tpu_torch`` is timed (default: this
one), for example a parent commit unpacked with ``git archive`` into an
ignored directory. The model is ``chip_smoke.py``'s main-path model
(``configs/default.yaml``, seed 0, duration bias 1.87) behind
``Synthesizer(bf16=True)``; the batches are ``chip_smoke.py:batch`` at B=8
and B=32. For each it prints the card's name and power limit, then one JSON
line: the call's ms (CUDA events around the whole call, which ends in the
host copy; median of ``--reps`` after three warm calls), the host's ms to
run it, and a digest of the mel's bits. To compare two trees, run them in
alternating order (parent, change, change, parent, ...) in one command on
the same card, writing the lines to a log.

--mesh times ``chip_smoke.py:mesh_synth_phase``'s B=32 call instead (its
model: seed 0, duration bias 1.87; its batch: ``batch(32)``): bf16 behind
``Synthesizer(mesh=make_mesh(devices=["cuda:0", "cuda:0"]))``, a local mesh
of two entries of the one card, and behind the unsharded ``Synthesizer`` of
the same model, one JSON line each (labels ``<label> mesh2`` and ``<label>
one``), in alternating order over ``--rounds`` rounds.

--artifacts exports that model with ``infer/export.py`` (bf16, B=8, 128
tokens, 1024 frames, as ``chip_smoke.py``'s export phase) twice: with the
kernel packs frozen into the model before the trace (``freeze_packs``, what
``export_inference`` does) and with ``freeze_packs`` skipped, so that every
pack is built inside the traced graph on each call. It times the two
artifacts' B=8 calls in ``--rounds`` alternating rounds (frozen, in-graph,
in-graph, frozen, ...), one JSON line per round and artifact, and checks
that both return the same mel.

--summary reads such logs and prints, per label and batch, the number of
readings, their median and their interquartile range (ms and host ms).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4, method="inclusive") if len(xs) > 1 else [xs[0]] * 3
    return {"n": len(xs), "median": statistics.median(xs), "q1": q[0], "q3": q[2],
            "iqr": q[2] - q[0]}


def summarize(paths) -> int:
    """Per label and batch: the readings' median and quartiles; and per
    batch, for each two labels of one log, in how many pairs (the i-th
    reading of each, in log order) the second read more ms than the first."""
    rows, log_of = {}, {}
    for p in paths:
        for line in open(p):
            if line.startswith("{") and '"label"' in line:
                r = json.loads(line)
                rows.setdefault((r["label"], r["B"]), []).append(r)
                log_of[r["label"]] = p
    for (label, B), rs in sorted(rows.items()):
        print(json.dumps({"label": label, "B": B,
                          "ms": _quartiles([r["ms"] for r in rs]),
                          "host_ms": _quartiles([r["host_ms"] for r in rs]),
                          "digests": sorted({r["digest"] for r in rs})}))
    for (a, B), ra in sorted(rows.items()):
        for (b, B2), rb in sorted(rows.items()):
            if B2 == B and a < b and log_of[a] == log_of[b]:
                pairs = list(zip(ra, rb))
                print(json.dumps({"B": B, "first": a, "second": b, "pairs": len(pairs),
                                  "second_slower": sum(y["ms"] > x["ms"] for x, y in pairs)}))
    return 0


def _time(torch, fn, reps):
    """(median CUDA-event ms, median host ms, last output) over ``reps``
    calls after three warm calls."""
    for _ in range(3):
        out = fn()
    ev, host = [], []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        ev.append(a.elapsed_time(b))
    return statistics.median(ev), statistics.median(host), out


def time_artifacts(torch, smoke, smi, rounds, reps) -> int:
    import numpy as np

    from fastspeech2_tpu_torch.config import Config
    from fastspeech2_tpu_torch.infer.export import export_inference, load_exported
    from fastspeech2_tpu_torch.ops.kernels import common
    from fastspeech2_tpu_torch.train.checkpoint import save_checkpoint

    B, T, L = smoke.EXPORT_B, smoke.EXPORT_T, smoke.EXPORT_L
    seqs = smoke.batch(B, offset=8)
    xs = np.zeros((B, T), np.int32)
    ilens = np.asarray([len(s) for s in seqs], np.int32)
    for i, s in enumerate(seqs):
        xs[i, :len(s)] = s
    calls = {}
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as work:
        ckpt = f"{work}/post.npz"
        save_checkpoint(ckpt, smoke.seeded_model(torch, Config()), None, 0, Config())
        freeze = common.freeze_packs
        for label in ("frozen", "in-graph"):
            common.freeze_packs = freeze if label == "frozen" else (lambda root: 0)
            try:
                path = export_inference(ckpt, f"{work}/{label}.pt2", batch=B, max_tokens=T,
                                        max_frames=L, bf16=True)
            finally:
                common.freeze_packs = freeze
            calls[label] = (load_exported(path), Path(path).stat().st_size)
        digests = {}
        for r in range(rounds):
            order = ("frozen", "in-graph") if r % 2 == 0 else ("in-graph", "frozen")
            for label in order:
                call, size = calls[label]
                ms, host, out = _time(torch, lambda: [t.cpu() for t in call(xs, ilens)],
                                      reps)
                digests[label] = hashlib.sha256(out[0].numpy().tobytes()).hexdigest()[:16]
                print(json.dumps({"label": f"artifact {label}", "B": B, "ms": ms,
                                  "host_ms": host, "bytes": size,
                                  "digest": digests[label], "card": smi}), flush=True)
    assert digests["frozen"] == digests["in-graph"], digests
    return 0


def time_mesh(torch, smoke, smi, label, rounds, reps) -> int:
    from fastspeech2_tpu_torch.config import Config
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.parallel.mesh import make_mesh

    model = FastSpeech2(Config(), device=torch.device("cuda"),
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.duration_predictor.out.bias.fill_(1.87)
    synths = {"one": Synthesizer(model, bf16=True),
              "mesh2": Synthesizer(model, bf16=True,
                                   mesh=make_mesh(devices=["cuda:0", "cuda:0"]))}
    seqs = smoke.batch(32)
    for r in range(rounds):
        for name in (("one", "mesh2") if r % 2 == 0 else ("mesh2", "one")):
            ms, host, (mel, lens) = _time(
                torch, lambda: synths[name].mel_from_token_batch(seqs), reps)
            print(json.dumps({"label": f"{label} {name}", "B": 32, "ms": ms,
                              "host_ms": host, "frames": int(lens.sum()),
                              "digest": hashlib.sha256(mel.tobytes()).hexdigest()[:16],
                              "card": smi}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--artifacts", action="store_true")
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--summary", nargs="+", default=None)
    args = ap.parse_args()
    if args.summary:
        return summarize(args.summary)
    import torch

    if not torch.cuda.is_available():
        print("time_mel_call: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    smi = smoke.smi_line()
    print(smi, flush=True)
    if args.artifacts:
        return time_artifacts(torch, smoke, smi, args.rounds, args.reps)
    if args.mesh:
        return time_mesh(torch, smoke, smi, args.label, args.rounds, args.reps)
    from fastspeech2_tpu_torch.config import Config
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer

    synth = Synthesizer(smoke.seeded_model(torch, Config()), bf16=True)
    for B in (8, 32):
        seqs = smoke.batch(B, offset=B)
        ms, host, (mel, lens) = _time(torch, lambda: synth.mel_from_token_batch(seqs),
                                      args.reps)
        print(json.dumps({"label": args.label, "B": B, "ms": ms, "host_ms": host,
                          "frames": int(lens.sum()),
                          "digest": hashlib.sha256(mel.tobytes()).hexdigest()[:16],
                          "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
