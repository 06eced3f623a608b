"""The dropout seed schedule of a training run.

The JAX package derives every dropout mask's seed from a threefry key
(``jax.random.split`` down the model). The port draws them from one
``torch.Generator`` on the CPU instead: for each micro-batch one ``uint32`` per
dropout site, on the host (no device sync), in the model's fixed site order
(``FastSpeech2.dropout_sites``). A mask is then a pure function of
(seed, padded shape), as in the JAX package's bf16 tier.

A schedule can also be fed **injected** seeds: a test computes the JAX
package's seeds with JAX and hands them over, so both packages drop the same
elements.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import torch


class SeedSchedule:
    """``draw()`` gives one micro-batch's ``{site: uint32 seed}``.

    sites: the model's dropout sites, in order. seed: seeds the run's CPU
    generator. injected: mappings handed out in order instead of drawing;
    each must name every site; drawing past the last raises."""

    def __init__(self, sites: Sequence[str], seed: int = 0,
                 injected: Optional[Iterable[Mapping[str, int]]] = None):
        self.sites: List[str] = list(sites)
        self.generator = torch.Generator(device="cpu").manual_seed(int(seed))
        self._injected = None if injected is None else iter(list(injected))

    def draw(self) -> Dict[str, int]:
        if self._injected is not None:
            try:
                given = next(self._injected)
            except StopIteration:
                raise RuntimeError("the injected dropout seeds are used up") from None
            missing = [s for s in self.sites if s not in given]
            if missing:
                raise KeyError(f"injected seeds lack the sites {missing[:5]}")
            return {s: int(given[s]) & 0xFFFFFFFF for s in self.sites}
        vals = torch.randint(0, 2 ** 32, (len(self.sites),), dtype=torch.int64,
                             generator=self.generator).tolist()
        return dict(zip(self.sites, vals))
