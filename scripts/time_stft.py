#!/usr/bin/env python3
"""Time the fused STFT -> log-mel + energy kernel (kernel 14) of one tree of
this repository, or of a parent tree and this one in turns, on the card.

    python scripts/time_stft.py [--tree DIR] [--label NAME] [--hops]
    python scripts/time_stft.py --parent DIR [--hops]

--tree is a checkout whose ``fastspeech2_tpu_torch`` is timed (default: this
one), for example a parent commit unpacked with ``git archive`` into an
ignored directory; its kernel is built from its own sources. The timing
helpers, the shapes and the yardstick come from this checkout's
``chip_smoke.py``: ``STFT_SHAPES`` (the preprocess path's (8, 229,376) and
(8, 16,384) buckets at hop 256, and 10.4 s rows at hop 200 and 512; n_fft =
4 hop, seeded synthetic speech, row 0 silent after its first tenth; a tree
whose kernel refuses a shape prints the error). --parent runs the parent
tree, this one, this one and the parent again, each in its own process, in
one command. For each shape it prints the card's name and power limit, then
one JSON line: ``ms`` (CUDA events, median of 25 calls), ``device_ms`` (the
profiler's device time per call, every launch of the call) and
``device_ms_by_kernel``, the cuFFT composition's ``library_ms`` and
``library_device_ms`` (``chip_smoke.cufft_mel_energy``), ``plain_ms``,
``bound_ms`` (``chip_smoke.stft_flops`` at the shape's n_fft at 67 TFLOP/s
against the signal, outputs and filterbank at 3.35 TB/s), the float64 errors
of the kernel and of the plain version (``chip_smoke.f64_errors``: max abs
log-mel error where mel > 10 clip, max energy error over the peak) and
``digest`` (a hash of the outputs' bits). --hops times ``STFT_NEW_SHAPES``
instead: the hops past the first range (7 to 1024: factors 7, 11,
13, a direct pass of 257 points, four frames a block past ~770).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_tree(tree: str, label: str, hops: bool = False) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_stft: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(Path(tree).resolve()))
    from fastspeech2_tpu_torch.audio.stft import mel_filterbank
    from fastspeech2_tpu_torch.ops.kernels import common
    from fastspeech2_tpu_torch.ops.kernels import stft as KS

    common.build_all(["stft"])
    dev = torch.device("cuda")
    g = np.random.default_rng(14)
    for B, N, hop, n_mels in smoke.STFT_NEW_SHAPES if hops else smoke.STFT_SHAPES:
        n_fft, F = 4 * hop, N // hop + 1
        kw = dict(n_fft=n_fft, hop_length=hop, win_length=n_fft)
        fb = torch.from_numpy(mel_filterbank(22050, n_fft, n_mels)).to(dev)
        ys = np.stack([smoke.synthetic_utterance(N, g) for _ in range(B)])
        ys[0, N // 10:] = 0.0
        y = torch.from_numpy(ys).to(dev)
        line = {"label": label, "shape": f"B={B},N={N},hop={hop},n_mels={n_mels}"}
        flops = smoke.stft_flops(B * F, n_fft, n_mels, int((fb != 0).sum()))
        b_ms, by = smoke.bound_ms(flops, 4 * (B * N + B * n_mels * F + B * F + fb.numel()),
                                  smoke.PEAK_F32_FLOPS)
        line.update(bound_ms=b_ms, bound_by=by)
        lib = lambda: smoke.cufft_mel_energy(torch, y, fb, n_fft, hop, n_fft)  # noqa: E731
        plain = lambda: KS.stft_mel_energy_plain(y, fb, **kw)  # noqa: E731
        ldms = smoke.device_ms_by_kernel(torch, lib)
        line.update(library_ms=smoke.cuda_time_ms(lib),
                    library_device_ms=sum(ldms.values()) or None,
                    plain_ms=smoke.cuda_time_ms(plain),
                    plain_f64_errors=smoke.f64_errors(y, fb, hop, n_fft, *plain()))
        fn = lambda: KS.stft_mel_energy(y, fb, **kw)  # noqa: E731
        try:
            mel, en = fn()
            torch.cuda.synchronize()
        except (ValueError, RuntimeError) as e:
            line["error"] = f"{type(e).__name__}: {e}"
            print(smoke.smi_line(), flush=True)
            print(json.dumps(line), flush=True)
            continue
        dms = smoke.device_ms_by_kernel(torch, fn)
        line.update(ms=smoke.cuda_time_ms(fn), device_ms=sum(dms.values()) or None,
                    device_ms_by_kernel={k: round(v, 5) for k, v in dms.items()},
                    f64_errors=smoke.f64_errors(y, fb, hop, n_fft, mel, en),
                    digest=digest(mel, en))
        print(smoke.smi_line(), flush=True)
        print(json.dumps(line), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--parent", help="run parent, change, change, parent in turns")
    ap.add_argument("--hops", action="store_true", help="the new hops (STFT_NEW_SHAPES)")
    args = ap.parse_args()
    if args.parent is None:
        return time_tree(args.tree, args.label, args.hops)
    rc = 0
    for tree, label in ((args.parent, "parent"), (str(ROOT), "change"),
                        (str(ROOT), "change"), (args.parent, "parent")):
        rc |= subprocess.run([sys.executable, __file__, "--tree", tree, "--label", label]
                             + (["--hops"] if args.hops else [])).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
