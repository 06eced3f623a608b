"""Checkpointing: parameters + BatchNorm state + optimizer state + step +
config snapshot, in the JAX package's format
(``fastspeech2_tpu/train/checkpoint.py``), so a checkpoint written by either
package loads in the other.

One ``.npz`` with path-flattened leaves: ``params::``, ``state::`` and ``opt::``
prefixes, ``/``-joined keys and the JAX layouts (linear (in, out), conv
(k, in, out); ``compat/from_jax.py`` converts), and ``__meta__``, a uint8 JSON
buffer with ``step``, ``hp_yaml`` and ``githash``. The write is atomic (same-
directory temp file + rename).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import subprocess
import tempfile
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fastspeech2_tpu_torch.compat import from_jax
from fastspeech2_tpu_torch.config import Config
from fastspeech2_tpu_torch.train.optimizer import NoamAdam


def git_hash() -> str:
    """Code-version provenance."""
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stderr=subprocess.DEVNULL).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def _atomic_savez(path: str, payload: dict, meta: dict) -> None:
    payload = dict(payload)
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def snapshot(model, optimizer: Optional[NoamAdam] = None) -> Dict[str, np.ndarray]:
    """The checkpoint's arrays on the host, under their final keys. This is
    the device-to-host copy; the write can happen on another thread."""
    names = [n for n, _ in model.named_parameters()]
    payload = {f"params::{k}": v for k, v in from_jax.flat_to_jax(
        model, dict(model.named_parameters())).items()}
    payload.update({f"state::{k}": v for k, v in from_jax.state_to_jax(model).items()})
    if optimizer is not None:
        for tag, moments in (("mu", optimizer.mu), ("nu", optimizer.nu)):
            for k, v in from_jax.flat_to_jax(model, dict(zip(names, moments))).items():
                payload[f"opt::inner/0/.{tag}/{k}"] = v
        for k, v in optimizer.scalars().items():
            payload[f"opt::{k}"] = v.detach().cpu().numpy()
    return payload


def _write(path: str, payload: Dict[str, np.ndarray], step: int, cfg: Config) -> None:
    _atomic_savez(path, payload, {"step": int(step), "hp_yaml": cfg.to_yaml(),
                                  "githash": git_hash(), "format": 1})


def save_checkpoint(path: str, model, optimizer: Optional[NoamAdam], step: int,
                    cfg: Config) -> None:
    """Atomic single-file checkpoint write."""
    _write(path, snapshot(model, optimizer), step, cfg)


class AsyncCheckpointer:
    """Overlap checkpoint serialization + disk IO with training.

    ``save()`` snapshots parameters and optimizer state to host memory on the
    caller's thread (the next step updates them in place) and hands the npz
    write + atomic rename + retention pruning to a background thread. One
    write in flight at a time: a new ``save()`` first joins the previous one.
    Writer errors re-raise at the next ``save()``/``wait()``. The thread is
    not a daemon: interpreter shutdown joins it, so an announced checkpoint
    is completed."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._err: list = []

    def save(self, path: str, model, optimizer: Optional[NoamAdam], step: int,
             cfg: Config) -> None:
        self.wait()
        host = snapshot(model, optimizer)

        def _run():
            try:
                _write(path, host, step, cfg)
                prune_checkpoints(os.path.dirname(path), cfg.train.keep_ckpts)
            except BaseException as e:  # re-raised by wait()
                logging.getLogger(__name__).exception(
                    "async checkpoint write to %s FAILED", path)
                self._err.append(e)

        self._thread = threading.Thread(target=_run, daemon=False)
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight write; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err:
            raise self._err.pop(0)


def _read(path: str):
    with np.load(path, allow_pickle=False) as z:
        flat = {"params": {}, "state": {}, "opt": {}}
        meta = json.loads(bytes(z["__meta__"]).decode())
        for k in z.files:
            if k == "__meta__":
                continue
            prefix, rest = k.split("::", 1)
            flat[prefix][rest] = z[k]
    return flat, meta


@torch.no_grad()
def load_checkpoint(path: str, model, optimizer: Optional[NoamAdam] = None
                    ) -> Tuple[int, Config]:
    """Fill ``model`` (and ``optimizer``, when given) in place from a
    checkpoint of either package; returns (step, cfg). Strict: KeyError on a
    missing leaf, ValueError on a shape mismatch; the optimizer state is
    validated before anything is written. ``optimizer=None`` skips it."""
    flat, meta = _read(path)
    new = from_jax.flat_from_jax(model, flat["params"])
    moments = None
    if optimizer is not None:
        moments = []
        for tag in ("mu", "nu"):
            pre = f"inner/0/.{tag}/"
            sub = {k[len(pre):]: v for k, v in flat["opt"].items() if k.startswith(pre)}
            moments.append(from_jax.flat_from_jax(model, sub))
        want = set(optimizer.scalars())
        have = {k for k in flat["opt"] if not k.startswith("inner/0/.mu/")
                and not k.startswith("inner/0/.nu/")}
        if want != have:
            raise KeyError(f"optimizer leaves differ: {sorted(want ^ have)[:5]}")
    from_jax.load_jax_state(model, flat["state"])
    for name, p in model.named_parameters():
        p.copy_(new[name])
    if optimizer is not None:
        names = [n for n, _ in model.named_parameters()]
        for dst, src in ((optimizer.mu, moments[0]), (optimizer.nu, moments[1])):
            for t, n in zip(dst, names):
                t.copy_(src[n])
        optimizer.load_scalars(flat["opt"])
    return int(meta["step"]), Config.from_yaml(meta["hp_yaml"])


def load_checkpoint_meta(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return json.loads(bytes(z["__meta__"]).decode())


#: file extensions of the reference's PyTorch checkpoints
TORCH_EXTS = (".pth", ".pyt", ".pt")


def load_model(path: Optional[str], config_path: Optional[str] = None, device=None):
    """(cfg, ``FastSpeech2`` on ``device``): a ``.npz`` checkpoint of either
    package with its embedded config; a reference ``.pth``/``.pyt``/``.pt``
    (``compat/torch_loader.py``; config from ``config_path``, else its
    ``hp_str``); no path: a random init from seed 0 of the ``config_path``
    config."""
    from fastspeech2_tpu_torch.config import load_config
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2

    if path and path.endswith(TORCH_EXTS):
        from fastspeech2_tpu_torch.compat.torch_loader import load_torch_model

        cfg, _, model = load_torch_model(
            path, load_config(config_path) if config_path else None, device)
    elif path:
        cfg = Config.from_yaml(load_checkpoint_meta(path)["hp_yaml"])
        model = FastSpeech2(cfg, device=device)
        load_checkpoint(path, model)
    else:
        cfg = load_config(config_path)
        model = FastSpeech2(cfg, device=device, generator=torch.Generator().manual_seed(0))
    return cfg, model


def average_checkpoints(paths, out_path: str) -> int:
    """Uniform parameter average of N checkpoints -> one checkpoint. Works
    on the flat npz representation: float parameters and BatchNorm running
    statistics average uniformly (accumulated in f64); the meta comes from
    the newest checkpoint by step; the optimizer state is dropped (an
    averaged model is an inference artifact, not a resume point). Returns the
    newest step. Raises ValueError on a config or key-set mismatch."""
    if len(paths) < 2:
        raise ValueError("need at least 2 checkpoints to average")
    metas = [load_checkpoint_meta(p) for p in paths]
    newest = max(range(len(paths)), key=lambda i: metas[i]["step"])
    for p, m in zip(paths, metas):
        if m["hp_yaml"] != metas[newest]["hp_yaml"]:
            raise ValueError(f"config mismatch: {p} vs {paths[newest]}")
    acc: dict = {}
    dtypes: dict = {}
    keyset = None
    for p in paths:
        with np.load(p, allow_pickle=False) as z:
            keys = {k for k in z.files
                    if k != "__meta__" and not k.startswith("opt::")}
            if keyset is None:
                keyset = keys
            elif keys != keyset:
                raise ValueError(f"key mismatch: {sorted(keys ^ keyset)[:5]} ...")
            for k in keys:
                v = z[k]
                dtypes.setdefault(k, v.dtype)
                if not np.issubdtype(v.dtype, np.floating):
                    acc[k] = v if p == paths[newest] else acc.get(k, v)
                    continue
                acc[k] = acc.get(k, 0.0) + v.astype(np.float64)
    payload = {}
    for k, v in acc.items():
        v = np.asarray(v)  # a 0-dim sum is a numpy scalar
        if v.dtype == np.float64:
            v = (v / len(paths)).astype(dtypes[k])
        payload[k] = v
    meta = dict(metas[newest])
    meta["averaged_from"] = [os.path.basename(p) for p in paths]
    _atomic_savez(out_path, payload, meta)
    return int(metas[newest]["step"])


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Retain only the newest ``keep`` step checkpoints of ``ckpt_dir``
    (``ckpt_{step:08d}.npz`` sorts by step); keep <= 0 keeps everything."""
    if keep <= 0:
        return
    files = sorted(
        f for f in glob.glob(os.path.join(ckpt_dir, "ckpt_*.npz"))
        if re.fullmatch(r"ckpt_\d+\.npz", os.path.basename(f)))
    for f in files[:-keep]:
        try:
            os.unlink(f)
        except OSError:  # already gone / racing writer: retention is advisory
            pass
