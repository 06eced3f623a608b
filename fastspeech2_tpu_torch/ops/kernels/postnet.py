"""Tacotron-2 postnet chain: n x [conv k (no bias) -> inference BatchNorm ->
tanh], no tanh on the last stage, each stage's input re-zeroed past the
length. Returns the residual that is added to the mel.

Port of ``fastspeech2_tpu/ops/pallas/postnet.py:fused_postnet`` (kernel
``_postnet_kernel``). CUDA source: ``csrc/postnet.cu`` (the chain in one
shared-memory buffer, each stage one wgmma product from a TMA weight ring,
the epilogues in registers). ``plan`` picks its tiling per shape; the C side
makes the same choice (``c_plan`` reads it back on the card). It takes every
C that is a multiple of 8 up to 512, every C0 that is a multiple of 8 up to
256, every odd k up to 9 and 2 to 8 layers.

Rounding points follow the TPU kernel: conv operands in the compute dtype,
the product rounded and widened, BatchNorm as ((h - mean) * inv) * g + b in
f32, tanh in f32.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple

import torch

from fastspeech2_tpu_torch.ops.kernels import common
from fastspeech2_tpu_torch.ops.kernels.ffn import SLACK, SMEM_MAX
from fastspeech2_tpu_torch.ops.precision import round_to

launches = 0
_fn = None
_fn_plan = None


class PostnetPlan(NamedTuple):
    """Tiling of one postnet. ``wr`` 2: stages of 128 rows, each warpgroup
    64 rows x all columns, ring tiles of 128 input columns; 1: stages of 64
    rows, the two warpgroups half the columns each, ring tiles of 64.
    ``nh`` and ``nl``: a warpgroup's output columns (wgmma N) in the hidden
    stages and in the last one; ``st`` ring stages; ``smem`` bytes (the
    chain's buffer of 64 wr + k - 1 rows, odd, a stage's BatchNorm rows and
    the ring); ``spl`` stages a launch: a block of a launch of s stages
    gives 64 wr - (s - 1)(k - 1) output frames, and a chain is cut where
    that would fall under half the stage rows (the last launch takes the
    rest; over the shapes taken, two launches at most)."""
    wr: int
    nh: int
    nl: int
    st: int
    smem: int
    spl: int


def _round16(c: int) -> int:
    return -(-c // 16) * 16


def plan(C0: int, C: int, k: int, n_layers: int) -> PostnetPlan:
    """The kernel's tiling, as ``csrc/postnet.cu:pn_make_plan`` picks it.
    Raises ValueError for a shape the kernel does not take: C or C0 not a
    multiple of 8, C > 512, C0 > 256, k even or above 9, fewer than 2 or more
    than 8 layers."""
    if (C0 % 8 or C % 8 or not 8 <= C0 <= 256 or not 8 <= C <= 512
            or k % 2 != 1 or not 1 <= k <= 9 or not 2 <= n_layers <= 8):
        raise ValueError(f"postnet: C={C}, C0={C0}, k={k}, layers={n_layers} "
                         "not supported by the kernel")
    cp, c0p = _round16(C), _round16(C0)
    if cp <= 256:
        wr, nh = 2, 128 if cp <= 128 else 256
        nl = 80 if c0p <= 80 else 128 if c0p <= 128 else 256
        tile = 2 * max(nh, nl) * 128  # 128 input columns a tile
    else:
        wr, nh = 1, 256
        nl = 48 if c0p <= 96 else 64 if c0p <= 128 else 128
        tile = 2 * 256 * 128
    m = 64 * wr
    # the chain's buffer, then a stage's BatchNorm rows (4 x max(C, C0) f32)
    buf = max(cp, c0p) * ((m + k - 1) | 1) * 2 + 16 * max(C, C0)
    st = min(4, (SMEM_MAX - SLACK - buf) // tile)
    if st < 2:
        raise ValueError(f"postnet: no tiling fits C={C}, C0={C0}, k={k}")
    spl = n_layers if k == 1 else min(n_layers, 1 + (m // 2) // (k - 1))
    return PostnetPlan(wr, nh, nl, st, buf + st * tile + SLACK, spl)


def launch_stages(pl: PostnetPlan, n_layers: int) -> List[range]:
    """The stages of each launch of the plan."""
    return [range(i, min(n_layers, i + pl.spl)) for i in range(0, n_layers, pl.spl)]


def scratch_elems(B: int, L: int, C: int, n_launches: int) -> int:
    """bf16 elements of the scratch that carries the masked rows from the
    first launch to the second: none for one launch, one (B, L, C) plane for
    two (the plan never takes more)."""
    return 0 if n_launches == 1 else B * L * C


def c_plan(C0: int, C: int, k: int, n_layers: int) -> PostnetPlan:
    """The tiling the C side picks for a shape (``fs2_postnet_plan``; needs
    the built library)."""
    global _fn_plan
    if _fn_plan is None:
        _fn_plan = common.bind(common.load("postnet"), "fs2_postnet_plan",
                               [common.I] * 4 + [common.P])
    out = (ctypes.c_int * 6)()
    if _fn_plan(C0, C, k, n_layers, out) != 0:
        raise ValueError(f"postnet: no tiling fits C={C}, C0={C0}, k={k}, "
                         f"layers={n_layers}")
    return PostnetPlan(*out)


def _cin_pad(c: int) -> int:
    return (c + 31) // 32 * 32


def _stages(w_flat: torch.Tensor, n_layers: int, C0: int, C: int, k: int
            ) -> List[torch.Tensor]:
    """Split the packed weights into per-stage (Cout, k, Cin) views."""
    out, off = [], 0
    for i in range(n_layers):
        cin = C0 if i == 0 else C
        cout = C0 if i == n_layers - 1 else C
        n = cout * k * _cin_pad(cin)
        out.append(w_flat[off:off + n].view(cout, k, _cin_pad(cin))[..., :cin])
        off += n
    return out


def postnet_plain(x, w_flat, bn, lengths, n_layers: int, C: int, k: int):
    """The function the kernel computes, in plain PyTorch. Compute dtype =
    w_flat.dtype."""
    cd = w_flat.dtype
    B, L, C0 = x.shape
    valid = torch.arange(L, device=x.device)[None, :, None] < \
        lengths.to(x.device)[:, None, None]
    h = round_to(torch.where(valid, x.float(), torch.zeros_like(x, dtype=torch.float32)), cd)
    for i, w in enumerate(_stages(w_flat, n_layers, C0, C, k)):
        cout = w.shape[0]
        acc = common.unfold_rows(h, k) @ w.reshape(cout, -1).float().t()
        mean, inv, g, b = (bn[i, j, :cout] for j in range(4))
        h = ((round_to(acc, cd) - mean) * inv) * g + b
        if i < n_layers - 1:
            h = round_to(torch.where(valid, torch.tanh(h), torch.zeros_like(h)), cd)
    return h


def postnet(x, w_flat, bn, lengths, n_layers: int, C: int, k: int):
    """x (B, L, C0) f32 mel; w_flat: the stages' (Cout, k, Cin_pad) weights
    in the compute dtype, Cin_pad = Cin rounded up to 32 with zeros,
    flattened and concatenated; bn (n_layers, 4, CB) f32 rows
    [mean, rsqrt(var + eps), gamma, beta], zero-padded to CB = max(C, C0);
    C is the hidden width; lengths (B,) int32."""
    global launches, _fn
    if x.device.type == "cpu":
        return postnet_plain(x, w_flat, bn, lengths, n_layers, C, k)
    B, L, C0 = x.shape
    common.check_cuda("postnet", x.device, [
        ("x", x, torch.float32, None), ("w", w_flat, torch.bfloat16, None),
        ("bn", bn, torch.float32, (n_layers, 4, max(C, C0))),
        ("lengths", lengths, torch.int32, (B,))])
    pl = plan(C0, C, k, n_layers)
    if _fn is None:
        P, I = common.P, common.I
        _fn = common.bind(common.load("postnet"), "fs2_postnet",
                          [P] * 6 + [I] * 7 + [P])
    out = torch.empty_like(x)
    n_scratch = scratch_elems(B, L, C, len(launch_stages(pl, n_layers)))
    scratch = torch.empty(n_scratch, dtype=torch.bfloat16, device=x.device) \
        if n_scratch else None
    common.launch(_fn, x.data_ptr(), w_flat.data_ptr(), bn.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(),
                  scratch.data_ptr() if scratch is not None else None, B, L, C0,
                  C, n_layers, k, bn.shape[2], common.stream_of(x))
    with common.count_lock:
        launches += 1
    return out


@torch.no_grad()
def pack_weights(layers, cd: torch.dtype, eps: float = 1e-5):
    """Kernel-layout weights of a postnet: layers[i] has .conv (Conv1d, no
    bias) and .bn (BatchNorm1d with running statistics). Returns
    (w_flat, bn, C) with C the hidden width."""
    C = layers[0].conv.weight.shape[0]
    CB = max(max(l.conv.weight.shape[:2]) for l in layers)
    ws, bn = [], []
    for l in layers:
        w = l.conv.weight.permute(0, 2, 1)  # (Cout, k, Cin)
        w = torch.nn.functional.pad(w, (0, _cin_pad(w.shape[2]) - w.shape[2]))
        ws.append(w.reshape(-1))
        rows = [l.bn.running_mean, torch.rsqrt(l.bn.running_var + eps),
                l.bn.weight, l.bn.bias]
        bn.append(torch.stack([torch.nn.functional.pad(r.float(), (0, CB - r.shape[0]))
                               for r in rows]))
    return torch.cat(ws).to(cd).contiguous(), torch.stack(bn).contiguous(), C
