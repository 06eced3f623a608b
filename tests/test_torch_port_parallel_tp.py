"""The port's Megatron tensor and sequence parallelism
(``fastspeech2_tpu_torch/parallel/sharding.py``) against the JAX package's
GSPMD sharding on the CPU (``tests/test_parallel_tp.py``'s counterparts).

One 4-rank gloo worker run (``test_torch_port_parallel.WORKER``) computes a
dp=2 x tp=2 train step with and without sequence parallelism, the bf16 step
with dropout at the configured rates (the JAX package's seeds injected), a
bf16 step through the training attention kernel per head shard,
``Synthesizer(mesh=)`` serving the TP-sharded model at dp=2 x tp=2 and at
dp=1 x tp=4 (tp above the head count);
the JAX side runs here on ``make_mesh_2d`` meshes of the virtual CPU
devices. Tolerances: the f32 training bar (loss and gradient norm 1e-5,
``assert_update_matches``), also for TP+SP against TP; the bf16 band of
``test_trajectory_bf16_injected_seeds_in_band`` (loss 2e-3, gradient norm
2%); inference durations and lengths exact, mel 2e-5 / 1e-5 as the JAX
package's own TP inference test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import small_cfg
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JFS
from fastspeech2_tpu.parallel.sharding import (make_mesh_2d, shard_inference_fn_tp,
                                               shard_pytree, shard_train_step_tp)
from fastspeech2_tpu.train.optimizer import make_optimizer
from fastspeech2_tpu.train.step import TrainState as JTrainState
from fastspeech2_tpu.train.step import make_train_step as jmake_train_step
from fastspeech2_tpu_torch.parallel.sharding import shard_dim
from test_torch_port_parallel import (assert_update_matches, batch_data, port_model_state,
                                      run_workers)
from test_torch_port_train_model import (NO_DROPOUT, SHORT_WARMUP, _flat, _jax_init,
                                         _with_model, jax_site_seeds, jbatch, make_batch)
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)

STEPS = 2
INFER = dict(B=8, T=32)  # a power of two of rows, tokens a multiple of 32: no padding


def _cfg(**kw):
    return _with_model(small_cfg(), **SHORT_WARMUP, **kw)


def _infer_batch():
    g = np.random.default_rng(3)
    B, T = INFER["B"], INFER["T"]
    xs = g.integers(1, 68, (B, T)).astype(np.int32)
    ilens = g.integers(T // 2, T + 1, (B,)).astype(np.int32)
    for b in range(B):
        xs[b, ilens[b]:] = 0
    return xs, ilens


def _fused_cfg():
    """d_k 128 and ``fused_attention`` on: the bf16 training route through
    the training attention kernels (their plain versions on the CPU)."""
    return _cfg(**NO_DROPOUT, adim=256, ddim=256, aheads=2, fused_attention="on")


def _seeds(cfg, n):
    """The JAX package's per-step dropout seeds (accum_grad 1)."""
    jm = JFS(cfg)
    return [jax_site_seeds(jm, jax.random.PRNGKey(100 + s)) for s in range(n)]


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    f32, bf = _cfg(**NO_DROPOUT), _cfg()
    cfgs, weights, data = {"f32": f32, "bf16": bf, "fused": _fused_cfg()}, {}, {}
    for key, cfg in cfgs.items():
        params, state = _jax_init(cfg, 0)
        weights[key] = port_model_state(cfg, params, state)
    infer_cfg = small_cfg()
    params, state = _jax_init(infer_cfg, 0)
    params["duration_predictor"]["out"]["b"] = params["duration_predictor"]["out"]["b"] + 1.0
    cfgs["infer"], weights["infer"] = infer_cfg, port_model_state(infer_cfg, params, state)
    keys = [f"b{s}" for s in range(STEPS)]
    for s, key in enumerate(keys):
        data.update(batch_data(key, make_batch(300 + s, B=8)))
    xs, ilens = _infer_batch()
    data["inf/xs"], data["inf/ilens"] = xs, ilens
    for f in ("ys", "olens", "ds", "es", "ps"):  # unused by inference
        data[f"inf/{f}"] = np.zeros((len(xs), 1), np.float32)
    seeds = _seeds(bf, STEPS)
    tasks = [dict(name="tp", kind="step", cfg="f32", dp=2, tp=2, accum=1, batches=keys),
             dict(name="tpsp", kind="step", cfg="f32", dp=2, tp=2, accum=1, batches=keys,
                  sp=True),
             dict(name="bf16", kind="step", cfg="bf16", dp=2, tp=2, accum=1, batches=keys,
                  sp=True, bf16=True, seeds=seeds),
             dict(name="fused", kind="step", cfg="fused", dp=2, tp=2, accum=1,
                  batches=keys[:1], bf16=True),
             dict(name="infer22", kind="infer", cfg="infer", dp=2, tp=2, batch="inf"),
             dict(name="infer14", kind="infer", cfg="infer", dp=1, tp=4, batch="inf")]
    outs = run_workers(root, 4, cfgs, weights, data, tasks)
    return outs, data, (infer_cfg, params, state)


def _jax_tp_steps(cfg, data, bf16=False):
    jm = JFS(cfg)
    params, state = _jax_init(cfg, 0)
    start = _flat(params)
    opt = make_optimizer(cfg)
    ts = JTrainState(params, state, opt.init(params), jnp.asarray(0, jnp.int32))
    mesh = make_mesh_2d(2, 2)
    step = shard_train_step_tp(jmake_train_step(jm, opt, 1, bf16=bf16), mesh, ts)
    losses, norms = [], []
    with mesh:
        ts = JTrainState(shard_pytree(ts.params, mesh), ts.model_state,
                         shard_pytree(ts.opt_state, mesh), ts.step)
        for s in range(STEPS):
            b = {f: data[f"b{s}/{f}"] for f in ("xs", "ilens", "ys", "olens", "ds", "es", "ps")}
            ts, rep = step(ts, jbatch(b), jax.random.PRNGKey(100 + s))
            losses.append(float(rep["loss"]))
            norms.append(float(rep["grad_norm"]))
    return (np.asarray(losses), np.asarray(norms), _flat(ts.params),
            _flat(ts.model_state), start)


def _got(r, name, what):
    pre = f"{name}/{what}/"
    return {k[len(pre):]: v for k, v in r.items() if k.startswith(pre)}


@pytest.mark.parametrize("name", ["tp", "tpsp"])
def test_tp_step_matches_jax(tp_run, name):
    """dp=2 x tp=2 (Megatron column/row split, the gradient norm summed over
    the model group), with and without sequence parallelism, against the JAX
    step on ``make_mesh_2d(2, 2)``; every rank gathers the same full model."""
    outs, data, _ = tp_run
    jl, jn, jp, js, start = _jax_tp_steps(_cfg(**NO_DROPOUT), data)
    r0 = outs[0]
    np.testing.assert_allclose(r0[f"{name}/loss"], jl, rtol=1e-5)
    np.testing.assert_allclose(r0[f"{name}/grad_norm"], jn, rtol=1e-5)
    assert_update_matches(_got(r0, name, "params"), jp, start)
    for k, v in _got(r0, name, "state").items():
        np.testing.assert_allclose(v, js[k], rtol=1e-5, atol=1e-5, err_msg=k)
    for r in outs[1:]:
        for k in r0:
            if k.startswith(name + "/"):
                np.testing.assert_array_equal(r[k], r0[k], err_msg=k)


def test_sequence_parallel_is_placement_only(tp_run):
    """TP+SP equals TP without SP (the residual stream split on time between
    blocks, gathered into and reduce-scattered out of them) within the f32
    training bar: only the order of a few sums differs (the LayerNorm
    gradients summed over the time chunks)."""
    r0 = tp_run[0][0]
    np.testing.assert_allclose(r0["tpsp/loss"], r0["tp/loss"], rtol=1e-5)
    np.testing.assert_allclose(r0["tpsp/grad_norm"], r0["tp/grad_norm"], rtol=1e-5)
    start = _flat(_jax_init(_cfg(**NO_DROPOUT), 0)[0])
    assert_update_matches(_got(r0, "tpsp", "params"), _got(r0, "tp", "params"), start)


def test_tp_sp_bf16_dropout_in_band(tp_run):
    """The bf16 tier at the configured dropout rates under dp=2 x tp=2 with
    SP, the JAX package's seeds injected: every rank's dropout masks are the
    blocks of the single-device masks (batch rows, heads, FFN channels, time
    chunks), so the step stays in the bf16 band of the single-device JAX
    step."""
    outs, data, _ = tp_run
    jl, jn, _, _, _ = _jax_tp_steps(_cfg(), data, bf16=True)
    np.testing.assert_allclose(outs[0]["bf16/loss"], jl, rtol=2e-3)
    np.testing.assert_allclose(outs[0]["bf16/grad_norm"], jn, rtol=2e-2)


def test_tp_fused_attention_step_matches_one_device(tp_run):
    """dp=2 x tp=2 through the training attention kernel per head shard
    (kernel 12, one head a rank, its shard seed) against the port's own
    single-device step through the head-packed kernel 11 (held to the JAX
    package by ``test_torch_port_train_model.py:test_kernel_route_matches_jax``),
    bf16, dropout 0: loss 2e-3, gradient norm 2%."""
    from fastspeech2_tpu_torch.compat.from_jax import load_jax_params
    from fastspeech2_tpu_torch.config import config_from_dict
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2 as TFS
    from fastspeech2_tpu_torch.train.optimizer import NoamAdam
    from fastspeech2_tpu_torch.train.seeds import SeedSchedule
    from fastspeech2_tpu_torch.train.step import TrainState, make_train_step, trainable
    from test_torch_port_train_model import tbatch

    outs, data, _ = tp_run
    cfg = _fused_cfg()
    params, state = _jax_init(cfg, 0)
    tm = TFS(config_from_dict(cfg.to_dict()), device="cpu")
    load_jax_params(tm, jax.device_get(params), jax.device_get(state))
    opt = NoamAdam(trainable(tm), tm.cfg)
    b = {f: data[f"b0/{f}"] for f in ("xs", "ilens", "ys", "olens", "ds", "es", "ps")}
    _, rep = make_train_step(tm, opt, 1, bf16=True)(
        TrainState(tm, opt, 0), tbatch(b), [SeedSchedule(tm.dropout_sites()).draw()])
    np.testing.assert_allclose(outs[0]["fused/loss"], [float(rep["loss"])], rtol=2e-3)
    np.testing.assert_allclose(outs[0]["fused/grad_norm"], [float(rep["grad_norm"])],
                               rtol=2e-2)


@pytest.mark.parametrize("name,dp,tp", [("infer22", 2, 2), ("infer14", 1, 4)])
def test_tp_inference_matches_jax(tp_run, name, dp, tp):
    """``Synthesizer(mesh=)`` serving a TP-sharded model, the batch split
    over the data group and gathered back, against ``shard_inference_fn_tp``
    on the same mesh at the Synthesizer's frame buffer (its live frames;
    the durations from the sharded model's encode); tp=4 is above the 2
    heads (attention over the gathered heads)."""
    outs, _, (cfg, params, state) = tp_run
    jm = JFS(cfg)
    xs, ilens = _infer_batch()
    L = outs[0][f"{name}/mel"].shape[1]

    def infer(params, state, xs, ilens, alphas):
        mel, out_lens, d_outs = jm.inference(params, state, xs, ilens,
                                             out_maxlen=L, alpha=alphas)
        return mel, out_lens, d_outs

    mesh = make_mesh_2d(dp, tp)
    fn = shard_inference_fn_tp(infer, mesh, params)
    with mesh:
        mel, lens, durs = fn(shard_pytree(params, mesh), state, jnp.asarray(xs),
                             jnp.asarray(ilens), jnp.ones((len(xs),), jnp.float32))
    live = np.arange(L)[None] < np.asarray(lens)[:, None]
    assert live.sum() > INFER["B"] * INFER["T"] and not live[:, -1].any()  # none cut
    for r in outs:
        np.testing.assert_array_equal(r[f"{name}/durs"], np.asarray(durs))
        np.testing.assert_array_equal(r[f"{name}/lens"], np.asarray(lens))
        np.testing.assert_allclose(r[f"{name}/mel"][live], np.asarray(mel)[live],
                                   rtol=1e-5, atol=2e-5)


def test_shard_rules_match_jax_pspecs():
    """The Megatron rule per parameter name is the JAX ``_pspec_for_path``
    with the torch layout's axis: every sharded JAX leaf is sharded here on
    the flipped axis, every replicated one replicated."""
    from fastspeech2_tpu.parallel.sharding import tree_pspecs
    from fastspeech2_tpu_torch.compat.from_jax import flat_to_jax
    from fastspeech2_tpu_torch.config import config_from_dict
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2 as TFS

    cfg = small_cfg()
    params, _ = _jax_init(cfg, 0)
    specs = _flat(jax.tree.map(lambda s: str(tuple(s)), tree_pspecs(params),
                               is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    tm = TFS(config_from_dict(cfg.to_dict()), device="cpu")
    keys = flat_to_jax(tm, dict(tm.named_parameters()))
    n_sharded = 0
    for (n, _), (key, _) in zip(tm.named_parameters(), keys.items()):
        spec = eval(str(specs[key]))  # a tuple of axis names / None
        jdim = spec.index("model") if "model" in spec else None
        p = dict(tm.named_parameters())[n]
        tdim = shard_dim(n)
        if jdim is None:
            assert tdim is None, n
            continue
        n_sharded += 1
        # JAX layouts: linear (in, out), conv (k, in, out); torch: (out, in[, k])
        if p.ndim == 1:
            want = 0
        elif p.ndim == 2:
            want = 1 - jdim
        else:
            want = {2: 0, 1: 1}[jdim]
        assert tdim == want, (n, spec, tdim)
    assert n_sharded == 2 * 1 * 10
