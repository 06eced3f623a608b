"""Build, load and launch plumbing shared by the CUDA kernel wrappers.

Every kernel source in ``fastspeech2_tpu_torch/csrc/`` is compiled with
``nvcc`` for ``sm_90a`` into its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds) and bound with ``ctypes``. The
libraries are built at first use from the sources in the checkout, all
``nvcc`` processes started together, into ``build/torch_kernels/`` (or
``$FS2_TORCH_KERNEL_DIR``), under a name that hashes the sources and flags,
so an edited source is rebuilt and a stale library is never loaded.

A wrapper takes its kernel's plain PyTorch version only for tensors on the
CPU. For CUDA tensors it launches the kernel or raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
KERNEL_SOURCES = ("attention", "ffn", "adaptor", "postnet", "resstack",
                  "attention_train", "stft")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: guards the wrappers' ``launches`` counters: a server's dispatch and
#: delivery threads both launch kernels
count_lock = threading.Lock()
_pack_lock = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("FS2_TORCH_KERNEL_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set NVCC or CUDA_HOME)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"libfs2_{name}_{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> float:
    """Compile every missing kernel library, one ``nvcc`` per source, all
    started together. Returns the seconds spent; raises with the compiler's
    output when a build fails. The ``-Xptxas -v`` report (registers, shared
    memory, spills) lands beside each library as ``.log``."""
    with _lock:
        todo = [n for n in names if not _lib_path(n).exists()]
        if not todo:
            return 0.0
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = []
        for n in todo:
            dst = _lib_path(n)
            tmp = dst.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{n}.cu")]
            procs.append((n, dst, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for n, dst, tmp, p in procs:
            log, _ = p.communicate()
            dst.with_suffix(".log").write_text(log)
            if p.returncode != 0:
                failed.append(f"--- {n}.cu (nvcc rc={p.returncode}) ---\n{log}")
            else:
                os.replace(tmp, dst)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        if not _lib_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


def ptxas_report(name: str) -> str:
    p = _lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def bind(lib: ctypes.CDLL, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def launch(fn, *args) -> None:
    """Call a C entry (which returns ``cudaGetLastError()``) and raise on a
    refused launch."""
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel launch {fn.__name__} failed: "
                           f"cudaError {rc}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, device: torch.device,
               tensors: Sequence[Tuple[str, torch.Tensor, torch.dtype,
                                       Optional[Tuple[int, ...]]]]) -> None:
    """Device, dtype, shape and contiguity checks of a kernel's inputs."""
    for arg, t, dtype, shape in tensors:
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {arg} has dtype {t.dtype}, expected {dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """The serving kernels have no backward: raise when autograd would
    record one of their inputs (training takes other routes)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} takes no gradient: it is a serving kernel "
                           "(run it under torch.no_grad or inference_mode)")


def unfold_rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, T, C) -> (B, T, k*C): row t holds rows t-(k-1)/2 .. t+(k-1)/2 of x
    (zeros outside), tap-major -- the im2col of a SAME conv whose weight is
    laid out (out, k, in). Plain versions use it as their conv."""
    pad = (k - 1) // 2
    B, T, C = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad))
    return torch.cat([xp[:, j:j + T] for j in range(k)], dim=-1)


def cached_pack(owner: torch.nn.Module, sources: Sequence[torch.Tensor],
                build):
    """Kernel-layout copies of a module's weights, rebuilt only when a source
    tensor is replaced or modified in place (keyed on storage pointer and
    version counter; an inference tensor, which keeps no counter, by its
    pointer alone). Safe to call from several threads.

    A pack that ``freeze_packs`` froze is the owner's buffers. A traced call
    (``torch.export``) has no address to key on: a pack not frozen is then
    built in the traced graph, as the int8 tier's per-call dequantized
    attention weights are."""
    frozen = owner.__dict__.get("_frozen_pack")
    if frozen is not None:
        return _thaw(owner, frozen)
    if torch.compiler.is_compiling():
        with torch.no_grad():
            return build()
    key = tuple((t.data_ptr(), 0 if t.is_inference() else t._version) for t in sources)
    with _pack_lock:  # two serving threads may ask for the same pack
        hit = owner.__dict__.get("_kernel_pack")
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = (key, build())
            owner.__dict__["_kernel_pack"] = hit
    return hit[1]


class _PackBuffer(str):
    """The name of a frozen pack's tensor among its owner's buffers."""


def _thaw(owner: torch.nn.Module, frozen):
    if isinstance(frozen, _PackBuffer):
        return getattr(owner, frozen)
    if isinstance(frozen, tuple):
        return tuple(_thaw(owner, f) for f in frozen)
    return frozen


def freeze_packs(root: torch.nn.Module) -> int:
    """Make every kernel pack that ``cached_pack`` holds on a module of
    ``root`` that module's non-persistent buffers, and ``cached_pack`` return
    them from then on without reading an address: what ``torch.export``
    traces (``infer/export.py``), which then saves the packs with the
    graph. Run the model once first, so its packs exist. The frozen packs
    no longer follow the weights. Each is a copy that shares no storage
    with a parameter (a pack may hold a parameter itself, such as an f32
    bias). Returns the number of packs frozen."""
    n = 0
    for mod in root.modules():
        hit = mod.__dict__.pop("_kernel_pack", None)
        if hit is None:
            continue
        names = []

        def freeze(v):
            if isinstance(v, torch.Tensor):
                name = _PackBuffer(f"_kernel_pack_{len(names)}")
                mod.register_buffer(name, v.detach().clone(), persistent=False)
                names.append(name)
                return name
            return tuple(freeze(x) for x in v) if isinstance(v, tuple) else v

        mod.__dict__["_frozen_pack"] = freeze(hit[1])
        n += 1
    return n
