"""The port's training forward, optimizer and train step against the JAX
package on the CPU: the same weights (``compat.from_jax``), the same numpy
batches and, where dropout is on, the JAX package's own seeds injected into
the port's schedule.

Tolerances (stated where used):
- f32, dropout rates 0, the three masking modes: loss and report 1e-5
  relative, every parameter gradient 2e-5 of that gradient's peak, BatchNorm
  running statistics 1e-5;
- bf16 at the configured rates with injected seeds (both packages take
  ``mha_apply`` at d_k=16): loss 1e-3 relative, gradients in the band of
  ``_assert_bf16_grad_band``;
- the kernel route (d_k=128, Pallas kernel with ``interpret=True`` against the
  plain version): loss 2e-3 relative;
- optimizer against optax and the 5-step trajectory: every parameter's CHANGE
  against the JAX package's change, relative to that change's norm, under a
  50-step warmup so that the changes are ~1e-3 to 1e-2 and a frozen or
  mis-scaled update cannot hide inside the tolerance; stated in each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import small_cfg
from fastspeech2_tpu.config import Config, ModelConfig
from fastspeech2_tpu.models.fastspeech2 import Batch as JBatch
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JFS
from fastspeech2_tpu.ops import nn as jnn
from fastspeech2_tpu.ops.pallas import attention_train as jat
from fastspeech2_tpu.ops.precision import compute_dtype as jcompute_dtype
from fastspeech2_tpu.train.optimizer import make_optimizer
from fastspeech2_tpu.train.step import TrainState as JTrainState
from fastspeech2_tpu.train.step import make_train_step as jmake_train_step
from fastspeech2_tpu_torch.compat.from_jax import flat_to_jax, load_jax_params, state_to_jax
from fastspeech2_tpu_torch.config import config_from_dict
from fastspeech2_tpu_torch.models.fastspeech2 import Batch as TBatch
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2 as TFS
from fastspeech2_tpu_torch.ops.kernels import attention_train as tat
from fastspeech2_tpu_torch.ops.precision import compute_dtype as tcompute_dtype
from fastspeech2_tpu_torch.train.optimizer import NoamAdam, noam_lr
from fastspeech2_tpu_torch.train.seeds import SeedSchedule
from fastspeech2_tpu_torch.train.step import TrainState, make_train_step, trainable

NO_DROPOUT = dict(transformer_dropout_rate=0.0, postnet_dropout_rate=0.0,
                  duration_predictor_dropout_rate=0.0,
                  variance_predictor_dropout_rate=0.0)


def _with_model(cfg, **kw):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **kw))


# With the default 4000-step warmup the Noam rate at adim 32 is ~7e-7 at step
# 1 and a handful of steps moves a weight by ~1e-5 at most: less than any
# absolute tolerance worth stating. 50 steps make it ~5e-4 x step.
SHORT_WARMUP = dict(transformer_warmup_steps=50)


def _assert_changes_match(got, want, start, rel, noise_leaves=()):
    """Every leaf's change (final minus initial) against the JAX package's,
    as ||got - want|| <= rel * ||want||. A leaf that did not move there must
    not move here. ``noise_leaves``: leaves whose gradient is zero in exact
    arithmetic, so both packages step along rounding noise (Adam's first
    steps are sign-like); they are held to the largest movement of any other
    leaf instead."""
    moved = 0.0
    for k in want:
        if not k.endswith(tuple(noise_leaves)):
            moved = max(moved, float(np.abs(want[k] - start[k]).max()))
    assert moved > 1e-3, f"the reference moved by {moved} only: nothing is tested"
    for k in want:
        dw, dg = want[k] - start[k], got[k] - start[k]
        if k.endswith(tuple(noise_leaves)):
            assert np.abs(dg).max() <= moved, k
            continue
        norm = float(np.linalg.norm(dw))
        gap = float(np.linalg.norm(dg - dw))
        assert gap <= rel * norm, f"{k}: change off by {gap / max(norm, 1e-30):.3g} of its norm"


# the JAX init of each (model shapes and init scheme, seed), as numpy: the
# draws do not depend on the dropout rates, the loss masking or the train
# section, so the tests' variants of small_cfg share one jit compile
_INITS = {}


def _jax_init(cfg, seed):
    m = {k: v for k, v in dataclasses.asdict(cfg.model).items()
         if "dropout" not in k and k not in ("use_masking", "use_weighted_masking")}
    key = (repr(sorted(m.items())), cfg.audio.num_mels, seed)
    if key not in _INITS:
        _INITS[key] = jax.device_get(jax.jit(JFS(cfg).init)(jax.random.PRNGKey(seed)))
    return jax.tree.map(jnp.asarray, _INITS[key])


def _pair(cfg, seed=0):
    jm = JFS(cfg)
    params, state = _jax_init(cfg, seed)
    tm = TFS(config_from_dict(cfg.to_dict()), device="cpu")
    load_jax_params(tm, jax.device_get(params), jax.device_get(state))
    return jm, params, state, tm


def make_batch(seed, B=4, T=12, L=64, odim=80):
    g = np.random.default_rng(seed)
    ilens = g.integers(T // 2, T + 1, B).astype(np.int32)
    ilens[0] = T
    xs = np.zeros((B, T), np.int32)
    ds = np.zeros((B, T), np.int32)
    olens = np.zeros(B, np.int32)
    for b in range(B):
        xs[b, :ilens[b]] = g.integers(1, 68, ilens[b])
        d = g.integers(1, L // T + 1, ilens[b])
        ds[b, :ilens[b]] = d
        olens[b] = d.sum()
    ys = np.zeros((B, L, odim), np.float32)
    es, ps = np.zeros((B, L), np.float32), np.zeros((B, L), np.float32)
    for b in range(B):
        n = olens[b]
        ys[b, :n] = g.normal(-5, 2, (n, odim))
        es[b, :n] = g.uniform(0.02, 100, n)
        ps[b, :n] = np.where(g.uniform(size=n) < 0.2, 0, g.uniform(71, 600, n))
    return dict(xs=xs, ilens=ilens, ys=ys, olens=olens, ds=ds, es=es, ps=ps)


def jbatch(b):
    return JBatch(**{k: jnp.asarray(v) for k, v in b.items()})


def tbatch(b):
    return TBatch(**{k: torch.from_numpy(v) for k, v in b.items()})


def jax_site_seeds(jm, rng, fused_train=False):
    """The uint32 seed of every dropout site as the JAX package derives it
    from one micro-batch's key (``fastspeech2.py:250-251``,
    ``encoder.py:226-253``, the predictors' and the postnet's splits)."""
    names = ["encoder", "decoder", "postnet", "dur", "en", "pi"]
    rngs = dict(zip(names, jax.random.split(rng, len(names))))
    seed = lambda k: int(jnn._key_to_seed(k))  # noqa: E731
    out = {}
    for name, ecfg in (("encoder", jm.encoder_cfg), ("decoder", jm.decoder_cfg)):
        rs = jax.random.split(rngs[name], 2 + 4 * ecfg.num_blocks)
        out[f"{name}/input"], out[f"{name}/pos"] = seed(rs[0]), seed(rs[1])
        for i in range(ecfg.num_blocks):
            for j, site in enumerate(("attn", "res", "ffn", "ffn_res")):
                k = rs[2 + 4 * i + j]
                if site == "attn" and fused_train:
                    out[f"{name}/{i}/attn"] = int(jax.random.randint(
                        k, (1,), 0, np.iinfo(np.int32).max, dtype=jnp.int32)[0])
                else:
                    out[f"{name}/{i}/{site}"] = seed(k)
    for name, n in (("postnet", jm.postnet_cfg.n_layers), ("dur", jm.duration_cfg.n_layers),
                    ("en", jm.variance_cfg.n_layers), ("pi", jm.variance_cfg.n_layers)):
        for i, k in enumerate(jax.random.split(rngs[name], n)):
            out[f"{name}/{i}"] = seed(k)
    return out


def _jax_loss_and_grads(jm, params, state, b, rng, bf16):
    def loss_fn(p):
        with jcompute_dtype(jnp.bfloat16 if bf16 else None):
            loss, report, new_state = jm.forward(p, state, b, rng=rng, training=True)
        return loss, (report, new_state)

    (loss, (report, new_state)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return float(loss), jax.device_get(report), jax.device_get(new_state), grads


def _flat(tree):
    from fastspeech2_tpu.train.checkpoint import _flatten

    return _flatten(jax.device_get(tree))


def _torch_loss_and_grads(tm, b, seeds, bf16):
    for p in tm.parameters():
        p.grad = None
    with tcompute_dtype(torch.bfloat16 if bf16 else None):
        loss, report = tm(b, seeds=seeds, training=True)
    loss.backward()
    grads = flat_to_jax(tm, {n: p.grad for n, p in tm.named_parameters()})
    return float(loss), {k: float(v) for k, v in report.items()}, grads


def _grad_gaps(got, want):
    """Sorted |difference| of each gradient relative to that gradient's peak.
    The key biases are left out: their true gradient is zero (a constant added
    to every key shifts a row's scores equally and softmax does not see it),
    and what either package computes there is rounding noise."""
    return _gaps(got, want, np.max)


def _gaps(got, want, reduce, min_size=1):
    assert set(got) == set(want)
    return sorted(float(reduce(np.abs(got[k] - want[k])))
                  / max(float(np.abs(want[k]).max()), 1e-12)
                  for k in want
                  if not k.endswith("attn/k/b") and want[k].size >= min_size)


def _assert_bf16_grad_band(got, want):
    """The bf16 band of a whole-model gradient. Both packages round every
    product and cotangent to bf16 at the same points but sum in another
    order, so single elements land one bf16 step apart (0.4%); a gradient
    that is a sum with heavy cancellation (a BatchNorm gamma, a bias, the
    scalar alpha) amplifies that, and a pre-activation that rounds to the
    other side of a ReLU's zero moves single elements of a weight gradient
    by much more. So: every gradient of 16 elements or more has a mean
    |difference| under 3% of its peak; in every gradient of 1000 elements or
    more fewer than 1 element in 1000 is further than 10% of the peak; no
    element of any gradient is further than 50% of its peak."""
    assert _gaps(got, want, np.mean, min_size=16)[-1] < 0.03
    assert _gaps(got, want, np.max)[-1] < 0.5
    for k, w in want.items():
        if w.size >= 1000 and not k.endswith("attn/k/b"):
            far = np.abs(got[k] - w) > 0.1 * np.abs(w).max()
            assert far.mean() < 1e-3, (k, far.mean())


@pytest.mark.parametrize("mode", ["masked", "weighted", "unmasked"])
def test_forward_loss_and_grads_f32_match_jax(mode):
    flags = {"masked": dict(use_masking=True, use_weighted_masking=False),
             "weighted": dict(use_masking=False, use_weighted_masking=True),
             "unmasked": dict(use_masking=False, use_weighted_masking=False)}[mode]
    cfg = _with_model(small_cfg(), **NO_DROPOUT, **flags)
    jm, params, state, tm = _pair(cfg)
    b = make_batch(1)
    jl, jrep, jstate, jg = _jax_loss_and_grads(jm, params, state, jbatch(b),
                                               jax.random.PRNGKey(3), False)
    seeds = SeedSchedule(tm.dropout_sites(), seed=0).draw()
    tl, trep, tg = _torch_loss_and_grads(tm, tbatch(b), seeds, False)
    assert tl == pytest.approx(jl, rel=1e-5)
    assert set(trep) == {"l1_loss", "before_loss", "after_loss", "duration_loss",
                         "energy_loss", "pitch_loss", "loss"}
    for k, v in trep.items():
        assert v == pytest.approx(float(jrep[k]), rel=1e-5), k
    assert _grad_gaps(tg, _flat(jg))[-1] < 2e-5
    # BatchNorm running statistics after the step
    want = _flat(jstate)
    for k, v in state_to_jax(tm).items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_eval_forward_matches_jax():
    """training=False: no dropout, running statistics, no seeds needed."""
    jm, params, state, tm = _pair(small_cfg())
    b = make_batch(2)
    jl, jrep, _ = jax.jit(lambda p, s, bb: jm.forward(p, s, bb))(params, state, jbatch(b))
    with torch.no_grad():
        tl, trep = tm(tbatch(b))
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    before = state_to_jax(tm)
    for k, v in state_to_jax(tm).items():
        np.testing.assert_array_equal(v, before[k])
    with pytest.raises(ValueError):
        tm(tbatch(b), training=True)


def test_forward_bf16_with_injected_seeds_matches_jax():
    """bf16 tier at the configured dropout rates, the JAX package's seeds
    injected: the same elements are dropped on both sides. On the CPU both
    packages take ``mha_apply`` (d_k=16). Loss within 1e-3 relative (5e-6
    was reached); gradients in the bf16 band of ``_assert_bf16_grad_band``."""
    cfg = small_cfg()
    jm, params, state, tm = _pair(cfg)
    b = make_batch(3)
    rng = jax.random.PRNGKey(11)
    jl, jrep, jstate, jg = _jax_loss_and_grads(jm, params, state, jbatch(b), rng, True)
    sched = SeedSchedule(tm.dropout_sites(), injected=[jax_site_seeds(jm, rng)])
    tl, trep, tg = _torch_loss_and_grads(tm, tbatch(b), sched.draw(), True)
    assert tl == pytest.approx(jl, rel=1e-3)
    _assert_bf16_grad_band(tg, _flat(jg))
    # other seeds give another loss: the injected seeds were really used
    other = SeedSchedule(tm.dropout_sites(), seed=1).draw()
    assert abs(_torch_loss_and_grads(tm, tbatch(b), other, True)[0] - jl) > 1e-4 * jl
    with pytest.raises(RuntimeError):
        sched.draw()


def test_kernel_route_matches_jax(monkeypatch):
    """adim=256, 2 heads (d_k=128), one block each, fused_attention on, bf16,
    training: the JAX package routes every block through the training
    attention Pallas kernel (interpret mode), the port through the wrapper,
    which on the CPU runs the plain version. The serving kernels are never
    reached."""
    from fastspeech2_tpu_torch.ops.kernels import attention as serving_attention
    from fastspeech2_tpu_torch.ops.kernels import ffn as serving_ffn

    cfg = Config(model=ModelConfig(
        adim=256, aheads=2, elayers=1, eunits=64, ddim=256, dlayers=1, dunits=64,
        postnet_layers=2, postnet_chans=32, positionwise_conv_kernel_size=3,
        duration_predictor_chans=16, fused_attention="on"))
    jm, params, state, tm = _pair(cfg)
    b = make_batch(4, B=2, T=8, L=32)
    rng = jax.random.PRNGKey(5)

    def loss_fn(p):
        with jcompute_dtype(jnp.bfloat16):
            return jm.forward(p, state, jbatch(b), rng=rng, training=True)[0]

    # the forward and backward kernels with interpret=True (the HLO
    # interpreter; the custom VJP carries the flag to the backward)
    real_apply = jat.mha_fused_train_apply
    monkeypatch.setattr(jat, "mha_fused_train_apply",
                        lambda *a, **k: real_apply(*a, **{**k, "interpret": True}))
    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(params)
    calls = []
    real = tat.attention_train_plain
    monkeypatch.setattr(tat, "attention_train_plain",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    for mod, fn in ((serving_attention, "attention_block"),
                    (serving_attention, "attention_res_ln"), (serving_ffn, "ffn_block")):
        monkeypatch.setattr(mod, fn, lambda *a, **k: pytest.fail("serving kernel reached"))
    seeds = jax_site_seeds(jm, rng, fused_train=True)
    tl, _, tg = _torch_loss_and_grads(tm, tbatch(b), seeds, True)
    assert len(calls) == 2  # one encoder block + one decoder block
    assert tl == pytest.approx(float(jl), rel=2e-3)
    _assert_bf16_grad_band(tg, _flat(jg))


def test_serving_kernels_refuse_gradients():
    """Kernels 1, 2 and 5 take no gradient: a tensor that requires grad
    reaching them raises."""
    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    blk = FFTBlock(EncoderConfig(idim=256, attention_dim=256, linear_units=64,
                                 positionwise_conv_kernel_size=3), device="cpu")
    x = torch.randn(1, 8, 256, requires_grad=True)
    lens = torch.tensor([8], dtype=torch.int32)
    with torch.no_grad():
        ap, fp = blk.attn_pack(torch.bfloat16), blk.ffn_pack(torch.bfloat16)
    with pytest.raises(RuntimeError, match="no gradient"):
        KA.attention_block(x, *ap, lens, 2)
    with pytest.raises(RuntimeError, match="no gradient"):
        KA.attention_res_ln(x.bfloat16(), x.bfloat16(), x.bfloat16(), x, *ap[2:], lens, 2)
    with pytest.raises(RuntimeError, match="no gradient"):
        KF.ffn_block(x, *fp, lens, 3)
    with torch.no_grad():  # fine without grad mode
        KA.attention_block(x, *ap, lens, 2)


def test_remat_replays_the_same_step():
    """train.remat: each block is recomputed in the backward pass; the seeds
    make the replay identical, so loss and gradients equal the plain run."""
    cfg = small_cfg()
    _, _, _, tm = _pair(cfg)
    b, seeds = tbatch(make_batch(5)), SeedSchedule(tm.dropout_sites(), seed=2).draw()
    l0, _, g0 = _torch_loss_and_grads(tm, b, seeds, True)
    tm.cfg = dataclasses.replace(tm.cfg, train=dataclasses.replace(tm.cfg.train, remat=True))
    l1, _, g1 = _torch_loss_and_grads(tm, b, seeds, True)
    assert l0 == l1
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k])


# -- optimizer -----------------------------------------------------------------

def test_noam_lr_matches_jax():
    from fastspeech2_tpu.train.optimizer import noam_schedule

    steps = np.asarray([0, 1, 2, 100, 3999, 4000, 4001, 100000], np.int32)
    want = np.asarray(noam_schedule(256, 4000, 1.0)(jnp.asarray(steps)))
    got = noam_lr(torch.from_numpy(steps), 256, 4000, 1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _opt_pair(cfg, seed=0):
    jm, params, state, tm = _pair(cfg, seed)
    jopt = make_optimizer(cfg)
    return jm, params, state, tm, jopt, jopt.init(params), NoamAdam(trainable(tm), tm.cfg)


def _fake_grads(tm, seed):
    g = np.random.default_rng(seed)
    return {n: torch.from_numpy(g.normal(0, 0.1, tuple(p.shape)).astype(np.float32))
            for n, p in tm.named_parameters()}


def _jax_tree(tm, params, flat):
    """A JAX params-shaped tree from the port's flat {key: array}."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    keys = ["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
            for path, _ in leaves]
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[k]) for k in keys])


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_optimizer_updates_match_optax(weight_decay):
    """Three updates (clipping active: the fake gradients' norm is > 1),
    with and without decoupled weight decay: every parameter's change 1e-4 of
    that change's norm and the parameters 1e-6, the moments 1e-5 relative
    (1e-6 of a moment's peak absolute), the gradient norm 1e-5 relative."""
    import optax

    cfg = _with_model(small_cfg(weight_decay=weight_decay, grad_clip=1.0), **SHORT_WARMUP)
    jm, params, state, tm, jopt, jstate, topt = _opt_pair(cfg)
    start = _flat(params)
    for i in range(3):
        g = _fake_grads(tm, i)
        jg = _jax_tree(tm, params, flat_to_jax(tm, g))
        upd, jstate = jopt.update(jg, jstate, params)
        params = optax.apply_updates(params, upd)
        norm = topt.step([g[n] for n, _ in tm.named_parameters()])
        assert float(norm) == pytest.approx(float(jstate["grad_norm"]), rel=1e-5)
    want = _flat(params)
    got = flat_to_jax(tm, dict(tm.named_parameters()))
    _assert_changes_match(got, want, start, rel=1e-4)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    jflat = _flat(jstate)
    names = [n for n, _ in tm.named_parameters()]
    for tag, moments in (("mu", topt.mu), ("nu", topt.nu)):
        for k, v in flat_to_jax(tm, dict(zip(names, moments))).items():
            w = jflat[f"inner/0/.{tag}/{k}"]
            np.testing.assert_allclose(v, w, rtol=1e-5, atol=1e-6 * np.abs(w).max(),
                                       err_msg=k)
    for k, v in topt.scalars().items():
        assert float(v) == pytest.approx(float(jflat[k]), rel=1e-5), k


def test_nonfinite_gradient_changes_nothing():
    """A step with a NaN gradient leaves parameters, both moments and both
    counts as they were (as the JAX package's gate does) and counts the skip;
    the next finite step goes on from there."""
    cfg = small_cfg()
    jm, params, state, tm, jopt, jstate, topt = _opt_pair(cfg)
    names = [n for n, _ in tm.named_parameters()]
    g = _fake_grads(tm, 0)
    topt.step([g[n] for n in names])
    before = ([p.detach().clone() for p in topt.params], [m.clone() for m in topt.mu],
              [m.clone() for m in topt.nu], int(topt.count), int(topt.sched_count))
    bad = _fake_grads(tm, 1)
    bad[names[3]][0] = float("nan")
    norm = topt.step([bad[n] for n in names])
    assert not np.isfinite(float(norm))
    for a, b in zip(before[0], topt.params):
        assert torch.equal(a, b)
    for a, b in zip(before[1] + before[2], topt.mu + topt.nu):
        assert torch.equal(a, b)
    assert (int(topt.count), int(topt.sched_count)) == before[3:]
    assert int(topt.notfinite_count) == 1
    # optax: the same three steps
    import optax

    for gg in (g, bad, _fake_grads(tm, 2)):
        upd, jstate = jopt.update(_jax_tree(tm, params, flat_to_jax(tm, gg)), jstate, params)
        params = optax.apply_updates(params, upd)
    g2 = _fake_grads(tm, 2)
    topt.step([g2[n] for n in names])
    want, got = _flat(params), flat_to_jax(tm, dict(tm.named_parameters()))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    assert int(topt.count) == int(_flat(jstate)["inner/0/.count"]) == 2


# -- the slice as a whole ---------------------------------------------------------

def _trajectory(cfg, bf16, n_steps=5, accum=2):
    jm, params, state, tm = _pair(cfg)
    start = _flat(params)
    jopt = make_optimizer(cfg)
    jts = JTrainState(params, state, jopt.init(params), jnp.asarray(0, jnp.int32))
    jstep = jax.jit(jmake_train_step(jm, jopt, accum, bf16=bf16))
    topt = NoamAdam(trainable(tm), tm.cfg)
    tts = TrainState(tm, topt, 0)
    tstep = make_train_step(tm, topt, accum, bf16=bf16)
    rng = jax.random.PRNGKey(7)
    jl, tl, jn, tn = [], [], [], []
    for i in range(n_steps):
        b = make_batch(100 + i, B=2 * accum)
        rng, sub = jax.random.split(rng)
        jts, jrep = jstep(jts, jbatch(b), sub)
        seeds = [jax_site_seeds(jm, k) for k in jax.random.split(sub, accum)]
        tts, trep = tstep(tts, tbatch(b), seeds)
        jl.append(float(jrep["loss"])); tl.append(float(trep["loss"]))
        jn.append(float(jrep["grad_norm"])); tn.append(float(trep["grad_norm"]))
    assert tts.step == n_steps == int(jts.step)
    return (np.asarray(jl), np.asarray(tl), np.asarray(jn), np.asarray(tn),
            _flat(jts.params), flat_to_jax(tm, dict(tm.named_parameters())),
            _flat(jts.model_state), state_to_jax(tm), start)


# softmax over keys is invariant to the key bias: its gradient is zero in
# exact arithmetic and rounding noise in both packages
KEY_BIAS = ("attn/k/b",)


def test_trajectory_f32_matches_jax():
    """Five train steps with accum_grad 2 from the same weights and batches,
    f32, dropout rates 0: the loss sequence and the gradient norms agree to
    1e-5 relative; every parameter's change over the five steps (up to 7.5e-3
    under the 50-step warmup) agrees to 1e-4 of that change's norm (9.6e-6
    reached), and no single weight ends further off than 1e-4, 1.3% of the
    largest movement (2.2e-5 reached, in a weight whose gradient is near zero,
    where Adam's sign-like first steps amplify rounding); the BatchNorm
    statistics to 1e-5."""
    cfg = _with_model(small_cfg(), **NO_DROPOUT, **SHORT_WARMUP)
    jl, tl, jn, tn, jp, tp, js, tst, start = _trajectory(cfg, bf16=False)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(tn, jn, rtol=1e-5)
    _assert_changes_match(tp, jp, start, rel=1e-4, noise_leaves=KEY_BIAS)
    for k in jp:
        if not k.endswith(KEY_BIAS):
            np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-4, err_msg=k)
    for k in js:
        np.testing.assert_allclose(tst[k], js[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_trajectory_bf16_injected_seeds_in_band():
    """The same five steps in the bf16 tier at the configured dropout rates,
    the JAX package's per-micro-batch seeds injected. Band: every loss within
    2e-3 relative, every gradient norm within 2%, every parameter's change
    over the five steps (50-step warmup) within 0.2 of that change's norm
    (0.15 reached: bf16 flips the sign of small gradients, which Adam's first
    steps turn into whole steps)."""
    cfg = _with_model(small_cfg(), **SHORT_WARMUP)
    jl, tl, jn, tn, jp, tp, _, _, start = _trajectory(cfg, bf16=True)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    np.testing.assert_allclose(tn, jn, rtol=2e-2)
    _assert_changes_match(tp, jp, start, rel=0.2, noise_leaves=KEY_BIAS)
