#!/usr/bin/env python3
"""Where a block of the variance adaptor (kernel 3) and of the postnet
(kernel 4) spends its time on the card: ``clock64()`` stamps at the edges
of each phase.

    python scripts/phases_adaptor_postnet.py [--tree DIR] [--work DIR]

Copies the ``fastspeech2_tpu_torch`` of --tree (default: this checkout)
into --work (default ``build/phases``, ignored by git), adds the stamps to
its ``csrc/adaptor.cu``, ``csrc/postnet.cu`` and ``csrc/conv_chain.cuh``
(thread 0 writes ``clock64()`` at each phase edge into a ``__device__``
array; the first thread of each warpgroup adds up, per ring tile, the
cycles it waited for the tile and the cycles of its products; an exported
function copies the array back), builds that copy, and runs each kernel
once at ``chip_smoke.py``'s kernel shape (B=16, T=128, L=768; the adaptor
at D = 256, the postnet at C = 256 and 512, seeded weights) after three
warm calls. For each it prints the card's name and power limit, then one
JSON line: the live blocks, the median block's cycles in each phase, and
the median per-warpgroup sums of tile waits and products. The stamps
perturb the kernel a little; time kernels with
``scripts/time_adaptor_postnet.py``.

The stamps are placed by matching lines of the kernel sources; a source
whose lines moved makes the script stop with the anchor it did not find.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, T, L, NB = 16, 128, 768, 256

PROF = '''__device__ unsigned long long g_prof[8192][24];
#define PROF_BLK (blockIdx.y * gridDim.x + blockIdx.x)
#define PROF_T(k) do { if (threadIdx.x == 0) g_prof[PROF_BLK][4 + (k)] = clock64(); } while (0)
namespace {
'''
READ = '''
FS2_EXPORT int fs2_prof_read(unsigned long long* out, int clear) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  static unsigned long long zero[8192][24];
  if (clear) cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  return (int)e;
}
'''
# (file, anchor, replacement): phase edge k's stamp is slot 4 + k
ACQ = "    const uint32_t bt = ring.acquire(it, load) + boff;\n"
END = "      o[0] = v[0];\n      o[1] = v[1];\n    }\n  }\n}\n"
XS = "  fence_proxy_async_smem();  // the products read xs by descriptor\n  __syncthreads();\n"
PATCHES = [
    ("conv_chain.cuh", "namespace {\n", PROF),
    ("conv_chain.cuh", ACQ, "    const unsigned long long c0 = clock64();\n" + ACQ +
     "    const unsigned long long c1 = clock64();\n"),
    ("conv_chain.cuh", "    fence_regs(acc);\n",
     "    fence_regs(acc);\n    if ((threadIdx.x & 127) == 0) {\n"
     "      atomicAdd(&g_prof[PROF_BLK][threadIdx.x ? 2 : 0], c1 - c0);\n"
     "      atomicAdd(&g_prof[PROF_BLK][threadIdx.x ? 3 : 1], clock64() - c1);\n    }\n"),
    ("adaptor.cu", "  const int nchx = (D + 15) / 16 * 2;",
     "  PROF_T(0);\n  const int nchx = (D + 15) / 16 * 2;"),
    ("adaptor.cu", XS, XS + "  PROF_T(1);\n"),
    ("adaptor.cu", "      it0 += conv_tiles(3, D, KT);\n",
     "      it0 += conv_tiles(3, D, KT);\n      PROF_T(2 + 4 * p);\n"),
    ("adaptor.cu", "      fence_proxy_async_smem();  // conv2 reads H1 by descriptor\n"
     "      __syncthreads();\n",
     "      fence_proxy_async_smem();  // conv2 reads H1 by descriptor\n"
     "      __syncthreads();\n      PROF_T(3 + 4 * p);\n"),
    ("adaptor.cu", "      it0 += conv_tiles(3, AC, KT);\n",
     "      it0 += conv_tiles(3, AC, KT);\n      PROF_T(4 + 4 * p);\n"),
    ("adaptor.cu", "      row_sum(y, red + 256);\n",
     "      row_sum(y, red + 256);\n      PROF_T(5 + 4 * p);\n"),
    ("adaptor.cu", "  // out = (e + (emb_p", "  PROF_T(10);\n  // out = (e + (emb_p"),
    ("adaptor.cu", END, END[:-2] + "  __syncthreads();\n  PROF_T(11);\n}\n"),
    ("postnet.cu", "  const int cin0 = a.i0 == 0", "  PROF_T(0);\n  const int cin0 = a.i0 == 0"),
    ("postnet.cu", XS, XS + "  PROF_T(1);\n"),
    ("postnet.cu", "      it0 += conv_tiles(a.K, cin, KT);\n",
     "      it0 += conv_tiles(a.K, cin, KT);\n      PROF_T(2 + 2 * s);\n"),
    ("postnet.cu", "        fence_proxy_async_smem();  // the next stage reads xs by descriptor\n"
     "        __syncthreads();\n      }\n",
     "        fence_proxy_async_smem();  // the next stage reads xs by descriptor\n"
     "        __syncthreads();\n      }\n      PROF_T(3 + 2 * s);\n"),
    ("postnet.cu", "      cp_async_wait<0>();\n      __syncthreads();  // the BN rows landed\n",
     "      PROF_T(2 + 2 * s);\n      cp_async_wait<0>();\n"
     "      __syncthreads();  // the BN rows landed\n"),
]
ADAPTOR_PHASES = ["gather", "conv1 pitch", "epilogue 1 pitch", "conv2 pitch",
                  "epilogue 2 pitch (LN, head sum)", "bucketize pitch + conv1 energy",
                  "epilogue 1 energy", "conv2 energy", "epilogue 2 energy (LN, head sum)",
                  "bucketize energy", "output rows"]


def instrument(src: Path, work: Path) -> None:
    """A copy of src's package in work with the stamps added."""
    if work.exists():
        shutil.rmtree(work)
    shutil.copytree(src / "fastspeech2_tpu_torch", work / "fastspeech2_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = work / "fastspeech2_tpu_torch" / "csrc"
    for name, anchor, new in PATCHES:
        text = (csrc / name).read_text()
        if text.count(anchor) != 1:
            raise SystemExit(f"phases: anchor not found once in {name}:\n{anchor}")
        (csrc / name).write_text(text.replace(anchor, new))
    for name in ("adaptor.cu", "postnet.cu"):
        (csrc / name).write_text((csrc / name).read_text() + READ)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--work", default=str(ROOT / "build" / "phases"))
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("phases_adaptor_postnet: no CUDA device", file=sys.stderr)
        return 2
    work = Path(args.work).resolve()
    instrument(Path(args.tree).resolve(), work)
    sys.path.insert(0, str(work))
    from fastspeech2_tpu_torch.models.postnet import Postnet, PostnetConfig
    from fastspeech2_tpu_torch.models.predictors import Predictor, PredictorConfig
    from fastspeech2_tpu_torch.ops.kernels import adaptor as KAd
    from fastspeech2_tpu_torch.ops.kernels import common
    from fastspeech2_tpu_torch.ops.kernels import postnet as KP
    from fastspeech2_tpu_torch.ops.length_regulator import expansion_indices
    from fastspeech2_tpu_torch.ops.quantize import linear_bins, log_bins

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    common.build_all(["adaptor", "postnet"])
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(16, T + 1, (B,), generator=g, dtype=torch.int32)
    tok[0], tok[-1] = T, T // 5
    ds = torch.randint(1, 11, (B, T), generator=g, dtype=torch.int32)
    tok, ds = tok.to(dev), ds.to(dev)
    buf = (ctypes.c_ulonglong * (8192 * 24))()

    def report(lib, kernel, shape, names, fn):
        read = common.bind(common.load(lib), "fs2_prof_read", [common.P, common.I])
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        read(ctypes.addressof(buf), 1)
        fn()
        torch.cuda.synchronize()
        read(ctypes.addressof(buf), 1)
        a = np.frombuffer(buf, dtype=np.uint64).reshape(8192, 24).astype(np.int64)
        a = a[a[:, 4] > 0]  # blocks that did products (dead tiles stamp nothing)
        stamps = a[:, 4:5 + len(names)] - a[:, 4:5]
        phases = np.diff(stamps, axis=1)
        print(smoke.smi_line(), flush=True)
        print(json.dumps({
            "kernel": kernel, "shape": shape, "live_blocks": int(len(a)),
            "cycles_per_block": float(np.median(stamps[:, -1])),
            "phase_cycles": {n: float(np.median(phases[:, i])) for i, n in enumerate(names)},
            "tile_wait_cycles": [float(np.median(a[:, 0])), float(np.median(a[:, 2]))],
            "product_cycles": [float(np.median(a[:, 1])), float(np.median(a[:, 3]))]}),
            flush=True)

    with torch.no_grad():
        idx, _, out_lens = expansion_indices(
            ds, torch.arange(T, device=dev)[None] < tok[:, None], L, T)
        torch.manual_seed(256)
        preds = [Predictor(PredictorConfig(idim=256), device="cpu") for _ in range(2)]
        embs = [torch.nn.Linear(NB, 256) for _ in range(2)]
        pack = [t.to(dev) for t in KAd.pack_weights(
            *preds, *embs, torch.from_numpy(log_bins(71.0, 676.2260946528305)),
            torch.from_numpy(linear_bins(0.01786651276051998, 130.5338592529297)), bf16)]
        hs = torch.randn(B, T, 256, generator=g).to(dev)
        report("adaptor", "variance_adaptor", f"B={B},T={T},L={L},D=256", ADAPTOR_PHASES,
               lambda: KAd.variance_adaptor(hs, idx, out_lens, *pack))
        for C in (256, 512):
            net = Postnet(PostnetConfig(n_chans=C), device="cpu")
            for layer in net.layers:
                c = layer.bn.running_mean.shape[0]
                layer.bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                layer.bn.running_var.copy_(1.0 + torch.rand(c, generator=g))
            w, bn, hidden = KP.pack_weights(net.layers, bf16)
            w, bn = w.to(dev), bn.to(dev)
            mel = torch.randn(B, L, 80, generator=g).to(dev)
            names = ["load"] + [f"stage {i} {part}" for i in range(4)
                                for part in ("products", "epilogue")] + ["stage 4"]
            report("postnet", "postnet", f"B={B},L={L},C0=80,C={C},k=5,layers=5", names,
                   lambda: KP.postnet(mel, w, bn, out_lens, 5, hidden, 5))
    return 0


if __name__ == "__main__":
    sys.exit(main())
