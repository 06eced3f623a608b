"""Checkpoints, data pipeline and the training loop of the port, against the
JAX package where the two must agree:

- checkpoints cross both ways (parameters, BatchNorm state, optimizer state):
  a checkpoint the JAX package wrote resumes in the port and continues to the
  same loss (1e-5 relative, f32, dropout 0); a checkpoint the port wrote
  loads with ``fastspeech2_tpu.train.checkpoint.load_checkpoint``;
- the async writer, pruning, averaging;
- the same filelist and seed give identical batches in both packages;
- ``train(..., max_steps=4)`` on a fake store on the CPU writes the metrics
  file and the final checkpoint; SIGTERM leaves a checkpoint; resume continues
  the step count; what is not ported raises NotImplementedError.
"""

import dataclasses
import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import small_cfg
from fastspeech2_tpu.data.batching import BucketBatcher as JBatcher
from fastspeech2_tpu.data.dataset import TTSDataset as JDataset
from fastspeech2_tpu.data.dataset import write_fake_feature_store as jwrite_store
from fastspeech2_tpu.models.fastspeech2 import Batch as JBatch
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JFS
from fastspeech2_tpu.train import checkpoint as jckpt
from fastspeech2_tpu.train.optimizer import make_optimizer
from fastspeech2_tpu.train.step import TrainState as JTrainState
from fastspeech2_tpu.train.step import make_train_step as jmake_train_step
from fastspeech2_tpu_torch.compat.from_jax import flat_to_jax, state_to_jax
from fastspeech2_tpu_torch.config import DataConfig, config_from_dict
from fastspeech2_tpu_torch.data.batching import BucketBatcher as TBatcher
from fastspeech2_tpu_torch.data.dataset import TTSDataset as TDataset
from fastspeech2_tpu_torch.data.dataset import write_fake_feature_store as twrite_store
from fastspeech2_tpu_torch.data.prefetch import batch_to_device, prefetch
from fastspeech2_tpu_torch.models.fastspeech2 import Batch as TBatch
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2 as TFS
from fastspeech2_tpu_torch.train import checkpoint as tckpt
from fastspeech2_tpu_torch.train.loop import resolve_dp, train
from fastspeech2_tpu_torch.train.optimizer import NoamAdam
from fastspeech2_tpu_torch.train.seeds import SeedSchedule
from fastspeech2_tpu_torch.train.step import TrainState, make_train_step, trainable
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)

NO_DROPOUT = dict(transformer_dropout_rate=0.0, postnet_dropout_rate=0.0,
                  duration_predictor_dropout_rate=0.0,
                  variance_predictor_dropout_rate=0.0)


def _cfg(**train_kw):
    cfg = small_cfg(**train_kw)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **NO_DROPOUT))


def _batch(seed, B=4, T=12, L=64):
    g = np.random.default_rng(seed)
    ilens = np.full(B, T, np.int32)
    ilens[1:] = g.integers(T // 2, T + 1, B - 1)
    xs, ds = np.zeros((B, T), np.int32), np.zeros((B, T), np.int32)
    for b in range(B):
        xs[b, :ilens[b]] = g.integers(1, 68, ilens[b])
        ds[b, :ilens[b]] = g.integers(1, L // T + 1, ilens[b])
    olens = ds.sum(1).astype(np.int32)
    mask = np.arange(L)[None] < olens[:, None]
    return dict(xs=xs, ilens=ilens, olens=olens, ds=ds,
                ys=(g.normal(-5, 2, (B, L, 80)) * mask[..., None]).astype(np.float32),
                es=(g.uniform(0.02, 100, (B, L)) * mask).astype(np.float32),
                ps=(g.uniform(71, 600, (B, L)) * mask).astype(np.float32))


_INIT = {}


def _jax_init(cfg):
    """The JAX init from PRNGKey(0), as numpy: every test here builds the same
    model (``_cfg`` varies the train section only), so one jit compile."""
    if "params" not in _INIT:
        _INIT["params"] = jax.device_get(jax.jit(JFS(cfg).init)(jax.random.PRNGKey(0)))
    return jax.tree.map(jnp.asarray, _INIT["params"])


def _jax_side(cfg, n_steps):
    """A JAX model trained n_steps (accum 2): (model, TrainState, step fn)."""
    jm = JFS(cfg)
    params, state = _jax_init(cfg)
    jopt = make_optimizer(cfg)
    ts = JTrainState(params, state, jopt.init(params), jnp.asarray(0, jnp.int32))
    step = jax.jit(jmake_train_step(jm, jopt, 2))
    for i in range(n_steps):
        ts, _ = step(ts, JBatch(**{k: jnp.asarray(v) for k, v in _batch(i).items()}),
                     jax.random.PRNGKey(i))
    return jm, jopt, ts, step


def _port_side(cfg):
    tm = TFS(config_from_dict(cfg.to_dict()), device="cpu",
             generator=torch.Generator().manual_seed(3))
    topt = NoamAdam(trainable(tm), tm.cfg)
    return tm, topt, make_train_step(tm, topt, 2)


def _tstep(tm, tstep, ts, i):
    seeds = [SeedSchedule(tm.dropout_sites(), seed=i).draw() for _ in range(2)]
    return tstep(ts, TBatch(**{k: torch.from_numpy(v) for k, v in _batch(i).items()}), seeds)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_jax_checkpoint_resumes_in_port(tmp_path, weight_decay):
    """Two JAX steps, a JAX checkpoint; the port loads parameters, BatchNorm
    state and optimizer state from it and takes the third step to the same
    loss and gradient norm as the JAX package's own third step (1e-5)."""
    cfg = _cfg(weight_decay=weight_decay)
    jm, jopt, jts, jstep = _jax_side(cfg, 2)
    path = str(tmp_path / "ckpt_00000002.npz")
    jckpt.save_checkpoint(path, *jax.device_get((jts.params, jts.model_state,
                                                 jts.opt_state)), 2, cfg)
    tm, topt, tstep = _port_side(cfg)
    step, loaded_cfg = tckpt.load_checkpoint(path, tm, topt)
    assert step == 2 and loaded_cfg.model.adim == cfg.model.adim
    assert int(topt.count) == int(topt.sched_count) == 2
    jts, jrep = jstep(jts, JBatch(**{k: jnp.asarray(v) for k, v in _batch(2).items()}),
                      jax.random.PRNGKey(2))
    _, trep = _tstep(tm, tstep, TrainState(tm, topt, step), 2)
    assert float(trep["loss"]) == pytest.approx(float(jrep["loss"]), rel=1e-5)
    assert float(trep["grad_norm"]) == pytest.approx(float(jrep["grad_norm"]), rel=1e-5)
    want = jckpt._flatten(jax.device_get(jts.params))
    for k, v in flat_to_jax(tm, dict(tm.named_parameters())).items():
        np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-5, err_msg=k)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """Two port steps, a port checkpoint; the JAX package's load_checkpoint
    reads it into its own templates: parameters, BatchNorm state, optimizer
    state (moments, both counts, grad_norm, notfinite_count), step and config;
    the key set is exactly the one the JAX package writes."""
    cfg = _cfg(weight_decay=0.01)
    tm, topt, tstep = _port_side(cfg)
    ts = TrainState(tm, topt, 0)
    for i in range(2):
        ts, rep = _tstep(tm, tstep, ts, i)
    path = str(tmp_path / "ckpt_00000002.npz")
    tckpt.save_checkpoint(path, tm, topt, ts.step, tm.cfg)

    p0, s0 = _jax_init(cfg)  # templates: the loaded values replace them
    o0 = make_optimizer(cfg).init(p0)
    params, state, opt, step, loaded = jckpt.load_checkpoint(path, p0, s0, o0)
    assert step == 2 and loaded.to_dict() == cfg.to_dict()
    own = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(own, p0, s0, o0, 0, cfg)
    with np.load(path) as a, np.load(own) as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
    got = jckpt._flatten(params)
    for k, v in flat_to_jax(tm, dict(tm.named_parameters())).items():
        np.testing.assert_array_equal(got[k], v)
    for k, v in state_to_jax(tm).items():
        np.testing.assert_array_equal(jckpt._flatten(state)[k], v)
    oflat = jckpt._flatten(opt)
    assert int(oflat["inner/0/.count"]) == int(oflat["inner/2/.count"]) == 2
    assert float(oflat["grad_norm"]) == pytest.approx(float(rep["grad_norm"]))
    names = [n for n, _ in tm.named_parameters()]
    for k, v in flat_to_jax(tm, dict(zip(names, topt.nu))).items():
        np.testing.assert_array_equal(oflat[f"inner/0/.nu/{k}"], v)
    # and it round-trips into a fresh port model + optimizer, bit for bit
    tm2, topt2, _ = _port_side(cfg)
    assert tckpt.load_checkpoint(path, tm2, topt2)[0] == 2
    for a, b in zip(list(tm.parameters()) + topt.mu + topt.nu,
                    list(tm2.parameters()) + topt2.mu + topt2.nu):
        assert torch.equal(a, b)
    for a, b in zip(tm.buffers(), tm2.buffers()):
        assert torch.equal(a, b)


def test_optimizer_layout_mismatch_raises_before_writing(tmp_path):
    """A checkpoint whose optimizer layout differs (written with weight
    decay, read without) raises KeyError and leaves the model untouched;
    without the optimizer it loads."""
    tm, topt, _ = _port_side(_cfg(weight_decay=0.01))
    path = str(tmp_path / "c.npz")
    tckpt.save_checkpoint(path, tm, topt, 7, tm.cfg)
    tm2, topt2, _ = _port_side(_cfg())
    with torch.no_grad():
        for p in tm2.parameters():
            p.add_(1.0)
    before = [p.detach().clone() for p in tm2.parameters()]
    with pytest.raises(KeyError):
        tckpt.load_checkpoint(path, tm2, topt2)
    assert all(torch.equal(a, b) for a, b in zip(before, tm2.parameters()))
    assert tckpt.load_checkpoint(path, tm2)[0] == 7
    assert all(torch.equal(a, b) for a, b in zip(tm.parameters(), tm2.parameters()))


def test_async_writer_prune_and_average(tmp_path):
    cfg = _cfg(keep_ckpts=2)
    tm, topt, _ = _port_side(cfg)
    w = tckpt.AsyncCheckpointer()
    d = str(tmp_path / "ck")
    for step in (1, 2, 3):
        with torch.no_grad():
            tm.feat_out.bias.fill_(float(step))
        w.save(os.path.join(d, f"ckpt_{step:08d}.npz"), tm, topt, step, tm.cfg)
        with torch.no_grad():  # the snapshot was taken on this thread
            tm.feat_out.bias.fill_(-1.0)
    w.wait()
    assert sorted(os.listdir(d)) == ["ckpt_00000002.npz", "ckpt_00000003.npz"]
    with np.load(os.path.join(d, "ckpt_00000003.npz")) as z:
        assert np.all(z["params::feat_out/b"] == 3.0)
    out = str(tmp_path / "avg.npz")
    assert tckpt.average_checkpoints(sorted(os.path.join(d, f) for f in os.listdir(d)),
                                     out) == 3
    with np.load(out) as z:
        assert np.allclose(z["params::feat_out/b"], 2.5)
        assert not any(k.startswith("opt::") for k in z.files)
    assert tckpt.load_checkpoint_meta(out)["averaged_from"] == [
        "ckpt_00000002.npz", "ckpt_00000003.npz"]
    # the JAX package averages the same two files to the same numbers
    jout = str(tmp_path / "javg.npz")
    jckpt.average_checkpoints(sorted(os.path.join(d, f) for f in os.listdir(d)), jout)
    with np.load(out) as a, np.load(jout) as b:
        assert set(a.files) == set(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    # a failing write surfaces at wait()
    blocker = tmp_path / "file"
    blocker.write_text("x")
    w.save(str(blocker / "ckpt_00000004.npz"), tm, topt, 4, tm.cfg)
    with pytest.raises(OSError):
        w.wait()


def test_batches_identical_in_both_packages(tmp_path):
    """The same store (the port's writer gives the JAX writer's bytes for the
    same seed), filelist and seed: BucketBatcher.epoch yields identical
    batches in the same order, pad multiples 16/64, max_frames applied."""
    ja, ta = str(tmp_path / "j"), str(tmp_path / "t")
    jfl = jwrite_store(ja, n_utts=24, seed=5, min_tokens=10, max_tokens=40)
    tfl = twrite_store(ta, n_utts=24, seed=5, min_tokens=10, max_tokens=40)
    assert open(jfl).read() == open(tfl).read()
    for sub in ("mels", "energy", "pitch"):
        for f in os.listdir(os.path.join(ja, sub)):
            assert np.array_equal(np.load(os.path.join(ja, sub, f)),
                                  np.load(os.path.join(ta, sub, f)))
    kw = dict(batch_size=4, seed=3, max_frames=150)
    jb = list(JBatcher(JDataset(ja, jfl), **kw).epoch(1))
    tb = list(TBatcher(TDataset(ta, tfl), **kw).epoch(1))
    assert len(jb) == len(tb) > 2
    for (a, sa), (b, sb) in zip(jb, tb):
        assert sa == sb and sa[0] % 16 == 0 and sa[1] % 64 == 0
        assert type(b) is TBatch and a._fields == b._fields
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert int(np.asarray(b.olens).max()) <= 150
    # longer durations on request: the defaults keep the JAX package's draws
    long_fl = twrite_store(str(tmp_path / "l"), n_utts=4, seed=5, min_dur=5, max_dur=7)
    ds = TDataset(str(tmp_path / "l"), long_fl)
    assert all(5 <= d <= 7 for d in ds[0].durations[:-1])


def test_prefetch_keeps_order_moves_to_device_and_reraises():
    items = [TBatch(*(np.full((2, 3), i, np.float32) for _ in range(7))) for i in range(5)]
    dev = torch.device("cpu")
    out = list(prefetch(iter(items), depth=2, transform=lambda b: batch_to_device(b, dev)))
    assert [int(b.xs[0, 0]) for b in out] == list(range(5))
    assert all(isinstance(t, torch.Tensor) for t in out[0])

    def boom():
        yield items[0]
        raise OSError("disk")

    it = prefetch(boom())
    next(it)
    with pytest.raises(OSError):
        next(it)


def _store_cfg(tmp_path, **train_kw):
    root = str(tmp_path / "store")
    fl = twrite_store(root, n_utts=16, seed=1)
    cfg = config_from_dict(_cfg().to_dict())
    train_cfg = dict(accum_grad=2, batch_size=2, save_interval=3, validation_step=2,
                     summary_interval=1, keep_ckpts=2)
    train_cfg.update(train_kw)
    return dataclasses.replace(
        cfg, data=DataConfig(data_dir=root, train_filelist=fl, valid_filelist=fl),
        train=dataclasses.replace(cfg.train, **train_cfg))


def test_train_loop_steps_logs_saves_and_resumes(tmp_path):
    cfg = _store_cfg(tmp_path, bf16=True)
    out = str(tmp_path / "out")
    ts = train(cfg, "run", out, max_steps=4, device="cpu")
    assert ts.step == 4
    assert all(bool(torch.isfinite(p).all()) for p in ts.model.parameters())
    recs = [json.loads(ln) for ln in open(os.path.join(out, "logs", "run",
                                                       "train_metrics.jsonl"))]
    main = [r for r in recs if "main/loss" in r]
    assert [r["step"] for r in main] == [1, 2, 3, 4]
    assert all(np.isfinite(r["main/loss"]) and np.isfinite(r["main/grad_norm"])
               and r["main/mel_frames_per_s"] > 0 for r in main)
    assert {r["step"] for r in recs if "validation/loss" in r} == {2, 4}
    ev = [r for r in recs if "evaluation/Dur_Loss" in r]
    assert [r["step"] for r in ev] == [3] and np.isfinite(ev[0]["evaluation/Pitch_Loss"])
    ckpt_dir = os.path.join(out, "checkpoints", "run")
    assert sorted(os.listdir(ckpt_dir)) == ["ckpt_00000003.npz", "ckpt_00000004.npz"]
    # the JAX package reads the final checkpoint's meta
    assert jckpt.load_checkpoint_meta(os.path.join(ckpt_dir, "ckpt_00000004.npz"))["step"] == 4
    final = [p.detach().clone() for p in ts.model.parameters()]

    ts2 = train(cfg, "run", out, max_steps=2, device="cpu",
                resume_path=os.path.join(ckpt_dir, "ckpt_00000004.npz"))
    assert ts2.step == 6 and int(ts2.optimizer.count) == 6
    assert "ckpt_00000006.npz" in os.listdir(ckpt_dir)
    assert any(not torch.equal(a, b) for a, b in zip(final, ts2.model.parameters()))


def test_sigterm_leaves_a_checkpoint(tmp_path):
    """SIGTERM mid-run checkpoints the in-flight state at the next step
    boundary and returns; the handlers are restored."""
    cfg = _store_cfg(tmp_path, accum_grad=1, save_interval=10 ** 6,
                     validation_step=10 ** 6, summary_interval=10 ** 6, epochs=10 ** 6)
    prev = signal.getsignal(signal.SIGTERM)
    timer = threading.Timer(2.0, signal.raise_signal, [signal.SIGTERM])
    timer.start()
    try:
        ts = train(cfg, "pre", str(tmp_path / "out"), max_steps=10 ** 6, device="cpu")
    finally:
        timer.cancel()
    assert ts.step >= 1
    ckpt_dir = os.path.join(tmp_path, "out", "checkpoints", "pre")
    ckpts = sorted(f for f in os.listdir(ckpt_dir) if f.startswith("ckpt_"))
    assert ckpts == [f"ckpt_{ts.step:08d}.npz"]
    assert tckpt.load_checkpoint_meta(os.path.join(ckpt_dir, ckpts[-1]))["step"] == ts.step
    assert signal.getsignal(signal.SIGTERM) == prev


@pytest.mark.parametrize("kw", [dict(dp_size=2), dict(tensor_parallel=2), dict(num_hosts=2)])
def test_what_is_not_ported_raises(tmp_path, kw):
    """Data and tensor parallelism and several hosts are ported
    (``parallel/``, ``tests/test_torch_port_parallel*.py``); asked of a
    world of one process they raise before any step, as the JAX loop does
    when the devices are missing, and ``resolve_dp`` follows the JAX rule."""
    cfg = _store_cfg(tmp_path, **kw)
    with pytest.raises(ValueError, match="dp_size=2|tensor_parallel=2|num_hosts=2"):
        train(cfg, "x", str(tmp_path / "out"), max_steps=1, device="cpu")
    assert not os.path.exists(tmp_path / "out" / "checkpoints")
    assert resolve_dp(_store_cfg(tmp_path), 4, 1) == 2


def test_train_refuses_to_fall_back_to_the_cpu(tmp_path):
    """Without a card, ``train()`` raises unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(_store_cfg(tmp_path), "x", str(tmp_path / "out"), max_steps=1)
