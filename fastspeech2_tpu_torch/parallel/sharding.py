"""Megatron tensor and sequence parallelism over the mesh's model group
(``fastspeech2_tpu/parallel/sharding.py``).

The split is the JAX package's ``_pspec_for_path`` over the port's parameter
names (which follow the JAX tree), with the sharded axis flipped where the
torch layout is transposed (linears (out, in), convs (out, in, k)):

- attention q/k/v weight and bias: the output (head) dim, torch dim 0;
- attention out weight: the input (head) dim, torch dim 1; its bias
  replicated, added after the all-reduce;
- FFN w1 weight and bias: the hidden channels, torch dim 0;
- FFN w2 weight: the hidden channels, torch dim 1; its bias replicated;
- everything else (embeddings, LayerNorms, predictors, postnet, feat_out)
  replicated.

``shard_model`` cuts a full model (and its optimizer's moments) into this
rank's shards in place and binds the mesh to the encoder and decoder, whose
blocks then run column-parallel q/k/v and w1 and row-parallel out and w2
(``models/encoder.py``). The four Megatron functions carry the collectives:
``copy_to_model`` (identity, all-reduce of the cotangent) before a
column-parallel product, ``reduce_from_model`` (all-reduce, identity
cotangent) after a row-parallel one, and under sequence parallelism
``gather_seq`` / ``reduce_scatter_seq`` in their place (the residual stream
between blocks split on time over the model group); ``split_seq`` and
``unsplit_seq`` enter and leave that split, and ``sp_param`` sums the
gradient of a replicated parameter used on the split stream. Sequence
parallelism is placement only: the numbers are those of TP without it.
"""

from __future__ import annotations

from typing import Optional

import torch

# make_mesh_2d is imported for its callers: the JAX package keeps it here
from fastspeech2_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, all_gather, all_reduce, chunk, gather_to_host, make_mesh_2d)

_COL = {"q", "k", "v"}


def shard_dim(name: str) -> Optional[int]:
    """The torch dim a parameter (or its Adam moment) is split along over the
    model group, ``None`` when replicated: the Megatron rule on the names of
    ``...attn.{q,k,v,out}.{weight,bias}`` and ``...ffn.{w1,w2}.{weight,bias}``."""
    parts = name.split(".")
    if len(parts) < 3:
        return None
    owner, proj, leaf = parts[-3:]
    if owner == "attn":
        if proj in _COL:
            return 0
        if proj == "out" and leaf == "weight":
            return 1
    elif owner == "ffn":
        if proj == "w1":
            return 0
        if proj == "w2" and leaf == "weight":
            return 1
    return None


def check_tp_divisibility(cfg, tp: int) -> None:
    """TP must divide every sharded dim (``sharding.py:219-226``)."""
    m = cfg.model
    for name, dim in [("adim", m.adim), ("ddim", m.ddim),
                      ("eunits", m.eunits), ("dunits", m.dunits)]:
        if dim % tp:
            raise ValueError(f"tensor_parallel={tp} does not divide {name}={dim}")


def _cut(t: torch.Tensor, mesh: Mesh, dim: Optional[int]) -> torch.Tensor:
    if dim is None or mesh.tp == 1:
        return t
    size = t.shape[dim] // mesh.tp
    return t.narrow(dim, mesh.model_index * size, size).clone()


@torch.no_grad()
def shard_model(model, mesh: Mesh, optimizer=None):
    """Cut ``model``'s Megatron-sharded parameters (and ``optimizer``'s
    moments, rebinding its parameter list) to this rank's shards in place,
    and bind ``mesh`` to its FFT stacks. Returns the model."""
    if mesh.tp == 1:
        return model
    names = [n for n, _ in model.named_parameters()]
    mods = dict(model.named_modules())
    for n in names:
        d = shard_dim(n)
        if d is None:
            continue
        mod_name, leaf = n.rsplit(".", 1)
        mod = mods[mod_name]
        setattr(mod, leaf, torch.nn.Parameter(_cut(getattr(mod, leaf), mesh, d)))
    if optimizer is not None:
        optimizer.params = [p for _, p in model.named_parameters()]
        optimizer.mu = [_cut(t, mesh, shard_dim(n)) for n, t in zip(names, optimizer.mu)]
        optimizer.nu = [_cut(t, mesh, shard_dim(n)) for n, t in zip(names, optimizer.nu)]
        optimizer.model_parallel([shard_dim(n) is not None for n in names],
                                 mesh.model_group)
    for stack in (model.encoder, model.decoder):
        stack.mesh = mesh
    return model


def gather_full(model, optimizer, mesh: Mesh):
    """The single-device model (and optimizer) of a TP-sharded pair: a
    collective every rank calls; each gets its own full copy on the model's
    device (``gather_to_host`` before a checkpoint, a validation pass)."""
    import copy

    names = [n for n, _ in model.named_parameters()]
    dims = {n: shard_dim(n) for n in names}
    tensors = dict(model.named_parameters())
    if optimizer is not None:
        tensors.update({f"mu/{n}": t for n, t in zip(names, optimizer.mu)})
        tensors.update({f"nu/{n}": t for n, t in zip(names, optimizer.nu)})
        dims.update({f"{k}/{n}": dims[n] for k in ("mu", "nu") for n in names})
    host = gather_to_host(tensors, mesh, dims)
    full = copy.deepcopy(model)
    dev = model.device
    mods = dict(full.named_modules())
    with torch.no_grad():
        for n in names:
            mod_name, leaf = n.rsplit(".", 1)
            setattr(mods[mod_name], leaf,
                    torch.nn.Parameter(torch.from_numpy(host[n]).to(dev)))
    for stack in (full.encoder, full.decoder):
        stack.mesh = None
    if optimizer is None:
        return full, None
    from fastspeech2_tpu_torch.train.optimizer import NoamAdam

    opt = NoamAdam([p for _, p in full.named_parameters()], full.cfg)
    opt.mu = [torch.from_numpy(host[f"mu/{n}"]).to(dev) for n in names]
    opt.nu = [torch.from_numpy(host[f"nu/{n}"]).to(dev) for n in names]
    opt.load_scalars({k: v.detach().cpu().numpy() for k, v in optimizer.scalars().items()})
    return full, opt


# -- the Megatron functions ----------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the cotangent is summed over the group and
    cut back (``reduce_grad``: the gathered tensor feeds sharded work), or
    only cut back (it feeds replicated work)."""

    @staticmethod
    def forward(ctx, x, group, reduce_grad, dim):
        ctx.group, ctx.reduce, ctx.dim = group, reduce_grad, dim
        return all_gather(x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.reduce:
            g = all_reduce(g.clone(), ctx.group)
        return chunk(g, ctx.group, ctx.dim).contiguous(), None, None, None


class _Scatter(torch.autograd.Function):
    """This rank's chunk along ``dim``, summed over the group first
    (``reduce``: a reduce-scatter) or not (a replicated tensor split); the
    cotangent is all-gathered."""

    @staticmethod
    def forward(ctx, x, group, reduce, dim):
        ctx.group, ctx.dim = group, dim
        if reduce:
            x = all_reduce(x.contiguous().clone(), group)
        return chunk(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, dim=ctx.dim), None, None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's f: identity forward, cotangent all-reduced over the model
    group (before a column-parallel product)."""
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's g: sum of the row-parallel partial products."""
    return _ReduceFromModel.apply(x, mesh.model_group)


def gather_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """SP: the split stream gathered into a column-parallel product."""
    return _Gather.apply(x, mesh.model_group, True, 1)


def reduce_scatter_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """SP: a row-parallel partial product summed and split on time."""
    return _Scatter.apply(x, mesh.model_group, True, 1)


def split_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """SP: a replicated stream split on time (entering the blocks)."""
    return _Scatter.apply(x, mesh.model_group, False, 1)


def unsplit_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """SP: the split stream gathered for replicated work (leaving them)."""
    return _Gather.apply(x, mesh.model_group, False, 1)


def gather_cols(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Column-parallel outputs gathered on the last dim for work every rank
    repeats (attention when the heads straddle the shards)."""
    return _Gather.apply(x, mesh.model_group, True, x.ndim - 1)


def sp_param(p: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A replicated parameter used on the split stream: its gradient is the
    sum of the ranks' partial gradients."""
    return _CopyToModel.apply(p, mesh.model_group)
