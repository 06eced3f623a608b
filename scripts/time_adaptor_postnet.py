#!/usr/bin/env python3
"""Time the variance adaptor (kernel 3) and the postnet (kernel 4) of one
tree of this repository on the card, at the serving path's shapes.

    python scripts/time_adaptor_postnet.py [--tree DIR] [--label NAME]

--tree is a checkout whose ``fastspeech2_tpu_torch`` is timed (default: this
one), for example a parent commit unpacked with ``git archive`` into an
ignored directory; its kernels are built from its own sources. The timing
helpers come from this checkout's ``chip_smoke.py``. Both kernels run at
``chip_smoke.py``'s kernel shape, B=16, T=128, L=768: the adaptor at D = 256
and D = 384 (C = 256, 256 bins; expansion by random durations 1-10 of
random token lengths with one full and one short row), the postnet at
5 x k=5 with C0 = 80 and C = 256, and at C = 512 (the Tacotron-2 width; a
tree whose kernel refuses it prints the error). Weights are seeded modules'
(bf16; the postnet's BatchNorm statistics random), inputs seeded noise: the
same in every tree. For each case it prints the card's name and power
limit, then one JSON line: ``ms`` (CUDA events, median of 25 calls),
``device_ms`` (the profiler's device time per call) and
``device_ms_by_kernel``, ``host_ms`` (the host's time to enqueue one call;
200 calls back to back), ``bound_ms`` (the FLOPs of the live frames at 989
TFLOP/s against inputs, outputs and weights at 3.35 TB/s, as
``chip_smoke.py`` counts them) and ``digest`` (a hash of the output's bits).
To compare two trees, run parent, change, change, parent in one command on
the same card.
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
B, T, L, NB = 16, 128, 768, 256
CASES = (("variance_adaptor", 256), ("variance_adaptor", 384), ("postnet", 256),
         ("postnet", 512))


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_adaptor_postnet: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    from fastspeech2_tpu_torch.models.postnet import Postnet, PostnetConfig
    from fastspeech2_tpu_torch.models.predictors import Predictor, PredictorConfig
    from fastspeech2_tpu_torch.ops.kernels import adaptor as KAd
    from fastspeech2_tpu_torch.ops.kernels import common
    from fastspeech2_tpu_torch.ops.kernels import postnet as KP
    from fastspeech2_tpu_torch.ops.length_regulator import expansion_indices
    from fastspeech2_tpu_torch.ops.quantize import linear_bins, log_bins

    common.build_all(["adaptor", "postnet"])
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(16, T + 1, (B,), generator=g, dtype=torch.int32)
    tok[0], tok[-1] = T, T // 5
    ds = torch.randint(1, 11, (B, T), generator=g, dtype=torch.int32)
    tok, ds = tok.to(dev), ds.to(dev)
    with torch.no_grad():
        idx, _, out_lens = expansion_indices(
            ds, torch.arange(T, device=dev)[None] < tok[:, None], L, T)
    lc = out_lens.cpu().tolist()
    with torch.no_grad():
        for name, width in CASES:
            torch.manual_seed(width)
            gi = torch.Generator().manual_seed(width)
            if name == "variance_adaptor":
                D, C = width, 256
                preds = [Predictor(PredictorConfig(idim=D), device="cpu") for _ in range(2)]
                embs = [torch.nn.Linear(NB, D) for _ in range(2)]
                pack = [t.to(dev) for t in KAd.pack_weights(
                    *preds, *embs, torch.from_numpy(log_bins(71.0, 676.2260946528305)),
                    torch.from_numpy(linear_bins(0.01786651276051998, 130.5338592529297)),
                    bf16)]
                hs = torch.randn(B, T, D, generator=gi).to(dev)
                fn = lambda: KAd.variance_adaptor(hs, idx, out_lens, *pack)  # noqa: E731
                flops = sum(lc) * 2 * (2 * 3 * D * C + 2 * 3 * C * C + 2 * C)
                nb = smoke.nbytes(hs, idx, out_lens, *pack) + B * L * (D + 2) * 4
                shape = f"B={B},T={T},L={L},D={D}"
            else:
                C = width
                net = Postnet(PostnetConfig(n_chans=C), device="cpu")
                for layer in net.layers:
                    c = layer.bn.running_mean.shape[0]
                    layer.bn.running_mean.copy_(0.1 * torch.randn(c, generator=gi))
                    layer.bn.running_var.copy_(1.0 + torch.rand(c, generator=gi))
                w, bn, hidden = KP.pack_weights(net.layers, bf16)
                w, bn = w.to(dev), bn.to(dev)
                mel = torch.randn(B, L, 80, generator=gi).to(dev)
                fn = lambda: KP.postnet(mel, w, bn, out_lens, 5, hidden, 5)  # noqa: E731
                first, last = 2 * 5 * (80 * C + 3 * C * C), 2 * 5 * C * 80
                flops = sum(n * first + min(n + 2, L) * last for n in lc)
                nb = smoke.nbytes(mel, mel, w, bn, out_lens)
                shape = f"B={B},L={L},C0=80,C={C},k=5,layers=5"
            line = {"label": args.label, "kernel": name, "shape": shape}
            b_ms, by = smoke.bound_ms(flops, nb)
            line.update(bound_ms=b_ms, bound_by=by)
            try:
                y = fn()
                torch.cuda.synchronize()
            except (ValueError, RuntimeError) as e:
                line["error"] = f"{type(e).__name__}: {e}"
                print(smoke.smi_line(), flush=True)
                print(json.dumps(line), flush=True)
                continue
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host = (time.perf_counter() - t0) * 1e3 / 200
            torch.cuda.synchronize()
            dms = smoke.device_ms_by_kernel(torch, fn)
            line.update(ms=smoke.cuda_time_ms(fn), device_ms=sum(dms.values()) or None,
                        device_ms_by_kernel={k: round(v, 5) for k, v in dms.items()},
                        host_ms=host,
                        digest=digest(*(y if isinstance(y, tuple) else (y,))))
            print(smoke.smi_line(), flush=True)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
