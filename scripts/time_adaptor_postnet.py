#!/usr/bin/env python3
"""Time the variance adaptor (kernel 3) and the postnet (kernel 4) of one
tree of this repository on the card, at the serving path's shapes.

    python scripts/time_adaptor_postnet.py [--tree DIR] [--label NAME] [--widths]

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

--widths times instead the shapes past the kernels' first range, at the same
B, T and L: the adaptor at D = 60, 1280 with 8,192 bins, 2048 and at D = 256
with 65,536 bins; the postnet at (C, C0, k, layers) = (500, 100, 5, 5),
(256, 80, 31, 3), (1024, 80, 11, 10) and (768, 513, 11, 10); each line
also gives ``plain_ms`` (the plain version, CUDA events) and ``launches``
(the postnet's kernel launches a call). The bound counts the embedding rows
the frames read, not the whole tables.
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
B, T, L = 16, 128, 768
# (kernel, (D, bins)) and (kernel, (C, C0, k, layers))
CASES = (("variance_adaptor", (256, 256)), ("variance_adaptor", (384, 256)),
         ("postnet", (256, 80, 5, 5)), ("postnet", (512, 80, 5, 5)))
WIDTH_CASES = (("variance_adaptor", (60, 256)), ("variance_adaptor", (1280, 8192)),
               ("variance_adaptor", (2048, 256)), ("variance_adaptor", (256, 65536)),
               ("postnet", (500, 100, 5, 5)), ("postnet", (256, 80, 31, 3)),
               ("postnet", (1024, 80, 11, 10)), ("postnet", (768, 513, 11, 10)))


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--widths", action="store_true")
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
        for name, shape_args in WIDTH_CASES if args.widths else CASES:
            width = shape_args[0]
            torch.manual_seed(width)
            gi = torch.Generator().manual_seed(width)
            if name == "variance_adaptor":
                (D, NB), C = shape_args, 256
                preds = [Predictor(PredictorConfig(idim=D), device="cpu") for _ in range(2)]
                embs = [torch.nn.Linear(NB, D) for _ in range(2)]
                pack = [t.to(dev) for t in KAd.pack_weights(
                    *preds, *embs, torch.from_numpy(log_bins(71.0, 676.2260946528305, NB)),
                    torch.from_numpy(linear_bins(0.01786651276051998, 130.5338592529297, NB)),
                    bf16)]
                hs = torch.randn(B, T, D, generator=gi).to(dev)
                fn = lambda: KAd.variance_adaptor(hs, idx, out_lens, *pack)  # noqa: E731
                plain = lambda: KAd.variance_adaptor_plain(hs, idx, out_lens, *pack)  # noqa: E731
                flops = sum(lc) * 2 * (2 * 3 * D * C + 2 * 3 * C * C + 2 * C)
                # the embedding rows the live frames read, at most the tables
                emb = min(smoke.nbytes(pack[11]), 2 * sum(lc) * D * 2)
                nb = (smoke.nbytes(hs, idx, out_lens, *pack[:11], pack[12]) + emb
                      + B * L * (D + 2) * 4)
                shape = f"B={B},T={T},L={L},D={D},bins={NB}"
            else:
                C, C0, k, n = shape_args
                net = Postnet(PostnetConfig(odim=C0, n_layers=n, n_chans=C, n_filts=k),
                              device="cpu")
                for layer in net.layers:
                    c = layer.bn.running_mean.shape[0]
                    layer.bn.running_mean.copy_(0.1 * torch.randn(c, generator=gi))
                    layer.bn.running_var.copy_(1.0 + torch.rand(c, generator=gi))
                w, bn, hidden = KP.pack_weights(net.layers, bf16)
                w, bn = w.to(dev), bn.to(dev)
                mel = torch.randn(B, L, C0, generator=gi).to(dev)
                fn = lambda: KP.postnet(mel, w, bn, out_lens, n, hidden, k)  # noqa: E731
                plain = lambda: KP.postnet_plain(mel, w, bn, out_lens, n, hidden, k)  # noqa: E731
                # every stage but the last on the live rows, the last also on
                # the pad rows past the length that its taps reach
                ch = [C0] + [hidden] * (n - 1) + [C0]
                first = sum(2 * k * ch[i] * ch[i + 1] for i in range(n - 1))
                last = 2 * k * ch[n - 1] * C0
                flops = sum(m * first + min(m + (k - 1) // 2, L) * last for m in lc)
                nb = smoke.nbytes(mel, mel, w, bn, out_lens)
                shape = f"B={B},L={L},C0={C0},C={C},k={k},layers={n}"
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
                        device_ms_by_kernel={kn: round(v, 5) for kn, v in dms.items()},
                        host_ms=host,
                        digest=digest(*(y if isinstance(y, tuple) else (y,))))
            if args.widths:
                line.update(plain_ms=smoke.cuda_time_ms(plain, reps=5))
                if name == "postnet":
                    line.update(launches=len(KP.launch_stages(KP.plan(C0, hidden, k, n), n)))
            print(smoke.smi_line(), flush=True)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
