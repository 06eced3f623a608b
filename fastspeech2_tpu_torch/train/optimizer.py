"""Noam-scheduled Adam (``fastspeech2_tpu/train/optimizer.py``).

lr(step) = factor * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5), steps
1-based, with Adam(betas=(0.9, 0.98), eps=1e-9, eps outside the root, bias
correction on both moments, as optax's ``scale_by_adam``), decoupled weight
decay added after the moment rescale and before the rate (so the decay is
scheduled by the same Noam rate), and global-norm clipping applied before the
update.

Non-finite gradients skip the update entirely: the global norm is computed
once and serves the clipping, the report and one finiteness gate; under a
non-finite norm the parameters, both moments AND both counts stay as they
were, and ``notfinite_count`` rises. ``torch.optim.Adam`` cannot freeze its
state on a skipped step without reading the norm on the host, so the update
is written here with ``torch._foreach_*`` ops and ``torch.where`` on a device
scalar: no ``.item()`` and no host sync in the step.

Under tensor parallelism (``parallel/sharding.py:shard_model``) the global
norm sums the squares of the sharded leaves over the model group and counts
each replicated leaf once; the moments are sharded like their parameters.
Under data parallelism the step hands in gradients already summed over the
data group, so every rank takes the same norm and the same skip decision.

The state mirrors the JAX package's optimizer state leaf for leaf
(``state_dict`` / ``load_state_dict`` speak its checkpoint keys), so a
checkpoint of either package resumes in the other.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from fastspeech2_tpu_torch.config import Config

B1, B2, EPS = 0.9, 0.98, 1e-9


def noam_lr(step: torch.Tensor, d_model: int, warmup: int,
            factor: float) -> torch.Tensor:
    """The Noam rate at a 1-based step (f32 tensor in, f32 tensor out)."""
    s = torch.clamp_min(step, 1).to(torch.float32)
    return (factor * d_model ** -0.5) * torch.minimum(s ** -0.5, s * warmup ** -1.5)


class NoamAdam:
    """The optimizer of ``make_optimizer(cfg)`` over ``params`` (a list of
    leaf tensors, updated in place)."""

    def __init__(self, params: Sequence[torch.Tensor], cfg: Config):
        self.params: List[torch.Tensor] = list(params)
        m = cfg.model
        self.d_model, self.warmup, self.factor = (
            m.adim, m.transformer_warmup_steps, m.transformer_lr)
        self.max_norm = float(cfg.train.grad_clip)
        self.weight_decay = float(cfg.train.weight_decay)
        dev = self.params[0].device
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        #: Adam's count and the schedule's count: equal in every run, two
        #: leaves in the JAX package's state, so two here
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.sched_count = torch.zeros((), dtype=torch.int32, device=dev)
        self.grad_norm = torch.zeros((), dtype=torch.float32, device=dev)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=dev)
        self._sharded: List[bool] = [False] * len(self.params)
        self._model_group = None

    def model_parallel(self, sharded: Sequence[bool], group) -> None:
        """Mark which parameters are split over the model ``group``."""
        self._sharded, self._model_group = list(sharded), group

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        if self._model_group is None:
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        from fastspeech2_tpu_torch.parallel.mesh import all_reduce

        sq = torch.stack(torch._foreach_norm(grads)).square()
        mask = torch.tensor(self._sharded, device=sq.device)
        split = all_reduce(torch.where(mask, sq, torch.zeros_like(sq)).sum(),
                           self._model_group)
        return torch.sqrt(torch.where(mask, torch.zeros_like(sq), sq).sum() + split)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """One update from the (accumulated) gradients; returns the global
        gradient norm before clipping, a device scalar."""
        grads = list(grads)
        norm = self._global_norm(grads)
        finite = torch.isfinite(norm)
        scale = torch.clamp_max(self.max_norm / torch.clamp_min(norm, 1e-12), 1.0)
        g = torch._foreach_mul(grads, scale)

        mu = torch._foreach_mul(self.mu, B1)
        torch._foreach_add_(mu, g, alpha=1 - B1)
        nu = torch._foreach_mul(self.nu, B2)
        torch._foreach_addcmul_(nu, g, g, value=1 - B2)
        count = self.count + 1
        cf = count.to(torch.float32)
        c1 = 1 - torch.pow(B1, cf)
        c2 = 1 - torch.pow(B2, cf)
        upd = torch._foreach_div(mu, c1)
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        lr = noam_lr(self.sched_count + 1, self.d_model, self.warmup, self.factor)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(upd, self.params)  # the new parameters

        for old, new in zip(self.params + self.mu + self.nu, upd + mu + nu):
            old.copy_(torch.where(finite, new, old))
        self.count = torch.where(finite, count, self.count)
        self.sched_count = torch.where(finite, self.sched_count + 1, self.sched_count)
        self.notfinite_count = self.notfinite_count + (~finite).to(torch.int32)
        self.grad_norm = norm
        return norm

    # -- checkpoint form -------------------------------------------------------

    def _sched_key(self) -> str:
        # optax.chain index of scale_by_learning_rate: the decay transform,
        # when present, sits between it and scale_by_adam
        return f"inner/{2 if self.weight_decay else 1}/.count"

    def scalars(self) -> Dict[str, torch.Tensor]:
        """The non-parameter leaves under the JAX package's keys."""
        return {"grad_norm": self.grad_norm, "inner/0/.count": self.count,
                self._sched_key(): self.sched_count,
                "notfinite_count": self.notfinite_count}

    def load_scalars(self, flat) -> None:
        dev = self.count.device
        for key, attr, dt in (("grad_norm", "grad_norm", torch.float32),
                              ("inner/0/.count", "count", torch.int32),
                              (self._sched_key(), "sched_count", torch.int32),
                              ("notfinite_count", "notfinite_count", torch.int32)):
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key}")
            setattr(self, attr, torch.as_tensor(flat[key]).to(device=dev, dtype=dt))
