"""Reference ``.pth`` weights in and out of the port (``compat/torch_loader.py``,
``compat/torch_saver.py``, the ``convert`` command and ``synth -p x.pth``),
against the JAX package's ``compat`` modules and commands.

Weights: the JAX params tree's own structure (``jax.eval_shape`` of
``init``) filled with seeded numpy draws, at ``conftest.small_cfg`` and at
``configs/default.yaml`` width (params only, no forward); the command tests
run a JAX ``init`` checkpoint at ``small_cfg``. Every comparison is exact: the
conversions only move and transpose f32 arrays.
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from conftest import small_cfg
from fastspeech2_tpu import cli as jcli
from fastspeech2_tpu.compat import torch_loader as jloader
from fastspeech2_tpu.compat import torch_saver as jsaver
from fastspeech2_tpu.config import Config as JConfig
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JFS
from fastspeech2_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from fastspeech2_tpu_torch import cli as tcli
from fastspeech2_tpu_torch.compat import torch_loader as tloader
from fastspeech2_tpu_torch.compat import torch_saver as tsaver
from fastspeech2_tpu_torch.compat.from_jax import load_jax_params
from fastspeech2_tpu_torch.config import config_from_dict
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2 as TFS
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)

PHONEMES = "HH AH0 L OW1 W ER1 L D"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], np.asarray(tree)


def _assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w), sorted(set(g) ^ set(w))[:5]
    for k in w:
        assert g[k].shape == w[k].shape, (k, g[k].shape, w[k].shape)
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _seeded_params(cfg, seed):
    """(params, state) in the JAX tree's structure, seeded draws (running
    variances positive)."""
    g = np.random.default_rng(seed)
    params, state = jax.eval_shape(JFS(cfg).init, jax.random.PRNGKey(0))
    draw = lambda s: g.standard_normal(s.shape).astype(s.dtype)  # noqa: E731
    return jax.tree.map(draw, params), jax.tree.map(lambda s: np.abs(draw(s)), state)


@pytest.fixture(scope="module", params=["small", "default"])
def jax_pth(request, tmp_path_factory):
    """(cfg, params, state, .pth written by the JAX saver at step 7)."""
    cfg = small_cfg() if request.param == "small" else JConfig()
    params, state = _seeded_params(cfg, 3)
    path = str(tmp_path_factory.mktemp(request.param) / "ref.pth")
    jsaver.save_torch_checkpoint(path, params, state, cfg, step=7, githash="abc")
    return cfg, params, state, path


def test_jax_written_pth_loads_into_the_port(jax_pth):
    """The port's state_dict from the .pth equals load_jax_params of the same
    params, bit for bit; the config comes back from hp_str."""
    cfg, params, state, path = jax_pth
    tcfg, step, model = tloader.load_torch_model(path, device="cpu")
    assert step == 7 and tcfg.to_dict() == cfg.to_dict()
    want = load_jax_params(TFS(config_from_dict(cfg.to_dict()), device="cpu"), params, state)
    got, ref = model.state_dict(), want.state_dict()
    assert list(got) == list(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_port_written_pth_loads_in_jax(jax_pth, tmp_path):
    """The port's saver writes the same state_dict as the JAX saver from the
    same weights, and the JAX loader reads every leaf back unchanged."""
    cfg, params, state, ref_path = jax_pth
    model = load_jax_params(TFS(config_from_dict(cfg.to_dict()), device="cpu"), params, state)
    path = str(tmp_path / "port.pth")
    tsaver.save_torch_checkpoint(path, model, config_from_dict(cfg.to_dict()), step=7,
                                 githash="abc")
    got, ref = torch.load(path, weights_only=False), torch.load(ref_path, weights_only=False)
    assert sorted(got["model"]) == sorted(ref["model"])
    for k, v in ref["model"].items():
        assert got["model"][k].dtype == v.dtype and torch.equal(got["model"][k], v), k
    assert {k: got[k] for k in ("optim", "step", "hp_str", "githash")} == \
        {k: ref[k] for k in ("optim", "step", "hp_str", "githash")}
    jp, js, jcfg, step = jloader.load_torch_checkpoint(path)
    assert step == 7 and jcfg.to_dict() == cfg.to_dict()
    _assert_trees_equal(jp, params)
    _assert_trees_equal(js, state)


def _rename(sd):
    return {k.replace(".encoders_.", ".encoders."): v for k, v in sd.items()}


def _shrink(sd):
    sd = dict(sd)
    sd["encoder.embed.0.weight"] = sd["encoder.embed.0.weight"][:56].clone()
    return sd


@pytest.mark.parametrize("trap", ["encoders_rename", "undersized_embedding",
                                  "bare_state_dict", "config_override"])
def test_released_checkpoint_traps(trap, tmp_path, caplog):
    """Each released-checkpoint trap of the JAX loader, on a file holding it:
    the port's loader gives the JAX loader's trees and config."""
    cfg = small_cfg()
    params, state = _seeded_params(cfg, 5)
    path = str(tmp_path / "ref.pth")
    jsaver.save_torch_checkpoint(path, params, state, cfg, step=3)
    ckpt = torch.load(path, weights_only=False)
    override = None
    if trap == "encoders_rename":
        ckpt["model"] = _rename(ckpt["model"])
    elif trap == "undersized_embedding":
        ckpt["model"] = _shrink(ckpt["model"])
    elif trap == "bare_state_dict":
        ckpt = ckpt["model"]
        override = cfg  # no hp_str: the config must be given (or default)
    else:  # -c wins over the embedded hp_str
        override = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, p_max=700.0))
    torch.save(ckpt, path)
    jp, js, jcfg, jstep = jloader.load_torch_checkpoint(path, override)
    with caplog.at_level(logging.WARNING):
        tp, ts, tcfg, tstep = tloader.load_torch_checkpoint(
            path, None if override is None else config_from_dict(override.to_dict()))
    _assert_trees_equal(tp, jp)
    _assert_trees_equal(ts, js)
    assert tcfg.to_dict() == jcfg.to_dict() and tstep == jstep
    emb = tp["encoder"]["embed"]["w"]
    if trap == "undersized_embedding":
        assert "56 symbol rows" in caplog.text
        assert emb.shape[0] == 68 and not emb[56:].any()
        np.testing.assert_array_equal(emb[:56], params["encoder"]["embed"]["w"][:56])
    else:
        _assert_trees_equal(tp, params)
    if trap == "config_override":
        assert tcfg.data.p_max == 700.0 != cfg.data.p_max
    if trap == "bare_state_dict":
        assert tstep == 0
    # and the model takes them
    load_jax_params(TFS(tcfg, device="cpu"), tp, ts)


@pytest.fixture(scope="module")
def small_npz(tmp_path_factory):
    """A JAX-written checkpoint of a JAX ``init`` at step 11."""
    cfg = small_cfg()
    params, state = jax.device_get(jax.jit(JFS(cfg).init)(jax.random.PRNGKey(9)))
    params["duration_predictor"]["out"]["b"] = params["duration_predictor"]["out"]["b"] + 1.8
    path = str(tmp_path_factory.mktemp("npz") / "ckpt_00000011.npz")
    jsave_checkpoint(path, params, state, None, 11, cfg)
    return path


@pytest.mark.parametrize("direction", ["npz_to_pth", "pth_to_npz"])
def test_convert_matches_the_jax_command(direction, small_npz, tmp_path):
    if direction == "npz_to_pth":
        src, name = small_npz, "out.pth"
    else:
        src, name = str(tmp_path / "src.pth"), "out.npz"
        jcli.main(["convert", "-p", small_npz, "-o", src])
    tcli.main(["convert", "-p", src, "-o", str(tmp_path / f"port_{name}"), "--device", "cpu"])
    jcli.main(["convert", "-p", src, "-o", str(tmp_path / f"jax_{name}")])
    if direction == "npz_to_pth":
        got, ref = (torch.load(tmp_path / f"{w}_{name}", weights_only=False)
                    for w in ("port", "jax"))
        assert sorted(got["model"]) == sorted(ref["model"]) and got["step"] == ref["step"] == 11
        for k, v in ref["model"].items():
            assert torch.equal(got["model"][k], v), k
        assert got["hp_str"] == ref["hp_str"]
    else:
        with np.load(tmp_path / f"port_{name}") as g, np.load(tmp_path / f"jax_{name}") as r:
            keys = [k for k in r.files if k != "__meta__"]
            assert sorted(k for k in g.files if k != "__meta__") == sorted(keys)
            for k in keys:
                assert g[k].dtype == r[k].dtype
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)
        # and back to the source .npz: every array bit for bit
        with np.load(small_npz) as z, np.load(tmp_path / f"port_{name}") as g:
            for k in z.files:
                if k != "__meta__":
                    np.testing.assert_array_equal(g[k], z[k], err_msg=k)
    with pytest.raises(SystemExit, match="unsupported conversion"):
        tcli.main(["convert", "-p", src, "-o", str(tmp_path / "x.txt"), "--device", "cpu"])


def test_synth_reads_a_pth_like_its_npz(small_npz, tmp_path):
    """``synth -p x.pth`` gives the ``mel.npy`` of ``synth -p x.npz``."""
    pth = str(tmp_path / "model.pth")
    tcli.main(["convert", "-p", small_npz, "-o", pth, "--device", "cpu"])
    for src, d in ((small_npz, "npz"), (pth, "pth")):
        tcli.main(["synth", "-p", src, "--phonemes", "--text", PHONEMES,
                   "-o", str(tmp_path / d), "--device", "cpu"])
    a, b = (np.load(tmp_path / d / "mel.npy") for d in ("npz", "pth"))
    assert a.shape[0] == 80 and a.shape[1] > 5
    np.testing.assert_array_equal(a, b)
