"""Length regulator as one gather (``fastspeech2_tpu/ops/length_regulator.py``).

For output frame j the source token is ``#(cumsum(d) <= j)``, clipped to
T-1. Durations are zeroed at padded tokens; a row whose durations sum to 0
falls back to one frame per valid token; frames past the expanded length are
zero.

Under autograd the gather's backward is a product with the (T, L) selection
matrix of each row (``_Expand``), not the gather's own backward: that is a
scatter-add, whose CUDA atomics add a token's frames in a varying order, so
the encoder's gradient would differ run to run on the card.
"""

from typing import Tuple, Union

import torch


def effective_durations(ds: torch.Tensor, tok_mask: torch.Tensor) -> torch.Tensor:
    """Masked durations with the all-zero fallback; the one definition shared
    by the expansion and the frame demand."""
    ds = torch.where(tok_mask, ds, torch.zeros_like(ds)).to(torch.int32)
    total = ds.sum(dim=-1, keepdim=True)
    return torch.where(total == 0, tok_mask.to(torch.int32), ds)


def frame_demand(ds: torch.Tensor, tok_mask: torch.Tensor) -> torch.Tensor:
    """Exact pre-clip frame demand per row."""
    return effective_durations(ds, tok_mask).sum(dim=-1, dtype=torch.int32)


def expansion_indices(ds: torch.Tensor, tok_mask: torch.Tensor,
                      out_maxlen: int, num_tokens: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(idx (B, L) int32 source token per frame, frame_mask (B, L) bool,
    out_lens (B,) int32 clipped to the buffer)."""
    ds = effective_durations(ds, tok_mask)
    cum = torch.cumsum(ds, dim=-1, dtype=torch.int32)
    out_lens = torch.clamp_max(cum[:, -1], out_maxlen)
    frames = torch.arange(out_maxlen, device=ds.device, dtype=torch.int32)
    idx = (cum[:, None, :] <= frames[None, :, None]).sum(dim=-1,
                                                           dtype=torch.int32)
    idx = torch.clamp_max(idx, num_tokens - 1)
    frame_mask = frames[None, :] < out_lens[:, None]
    return idx, frame_mask, out_lens


class _Expand(torch.autograd.Function):
    """``out[b, j] = hs[b, idx[b, j]]`` with a deterministic backward: the
    gradient of token t sums its frames' gradients as the product of the
    transposed one-hot selection (B, T, L) with the frames' gradient, in the
    fixed order of one batched matrix product. The selection is a comparison
    with the token positions, not ``F.one_hot``, which may read the indices'
    range on the host and so wait for the device mid-backward."""

    @staticmethod
    def forward(ctx, hs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.num_tokens = hs.shape[1]
        return torch.gather(hs, 1, idx[..., None].expand(-1, -1, hs.shape[2]))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        tokens = torch.arange(ctx.num_tokens, device=idx.device)
        select = (idx[:, None, :] == tokens[None, :, None]).to(grad.dtype)
        return select @ grad, None


def regulate_length(hs: torch.Tensor, ds: torch.Tensor, tok_mask: torch.Tensor,
                    out_maxlen: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expand (B, T, D) token states to (B, L, D) frames by durations;
    returns (expanded, frame_mask, out_lens)."""
    idx, frame_mask, out_lens = expansion_indices(ds, tok_mask, out_maxlen,
                                                  hs.shape[1])
    idx = idx.long()
    if torch.is_grad_enabled() and hs.requires_grad:
        expanded = _Expand.apply(hs, idx)
    else:
        expanded = torch.gather(hs, 1, idx[..., None].expand(-1, -1, hs.shape[2]))
    expanded = torch.where(frame_mask[..., None], expanded,
                           torch.zeros_like(expanded))
    return expanded, frame_mask, out_lens


def scale_durations(ds: torch.Tensor,
                    alpha: Union[float, torch.Tensor]) -> torch.Tensor:
    """Speed control: round(d * alpha), half to even; alpha is a python
    float, a scalar tensor or a per-row (B,) tensor."""
    if isinstance(alpha, (int, float)):
        if alpha == 1.0:
            return ds
        alpha = torch.tensor(alpha, dtype=torch.float32, device=ds.device)
    alpha = alpha.to(device=ds.device, dtype=torch.float32)
    if alpha.ndim == 1:
        alpha = alpha[:, None]
    return torch.round(ds.to(torch.float32) * alpha).to(torch.int32)
