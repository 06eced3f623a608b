"""The port's data parallelism (``fastspeech2_tpu_torch/parallel``) against
the JAX package on the CPU.

Multi-rank checks spawn real ``torch.distributed`` gloo processes, as
``tests/test_multiprocess.py`` spawns JAX processes: a free port, a worker
script that writes its results, ``communicate(timeout=...)`` on every spawn.
One 2-rank worker run computes every step and serving result of this file;
the JAX side runs here on the virtual CPU devices of ``conftest.py``
(``make_mesh(2)``). Weights come from the JAX ``init`` through
``compat.from_jax``, inputs from numpy seeds.

Tolerances: the f32 training bar of ``test_torch_port_train_model.py``
(loss and gradient norm 1e-5 relative, every weight's change 1e-4, the
whole update 1e-4 of its norm, BatchNorm statistics 1e-5); serving the f32 inference
bar (durations and lengths exact, mel 1e-4).
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import small_cfg
from fastspeech2_tpu.infer.synthesize import Synthesizer as JSynth
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JFS
from fastspeech2_tpu.ops import nn as jnn
from fastspeech2_tpu.ops.pallas import attention_train as jat
from fastspeech2_tpu.train.optimizer import make_optimizer
from fastspeech2_tpu.train.step import TrainState as JTrainState
from fastspeech2_tpu.train.step import make_mesh as jmake_mesh
from fastspeech2_tpu.train.step import make_train_step as jmake_train_step
from fastspeech2_tpu.train.step import shard_train_step
from fastspeech2_tpu_torch.compat.from_jax import load_jax_params
from fastspeech2_tpu_torch.config import config_from_dict
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2 as TFS
from fastspeech2_tpu_torch.ops import nn as tnn
from fastspeech2_tpu_torch.ops.kernels import attention_train as tat
from fastspeech2_tpu_torch.parallel import mesh as pmesh
from test_torch_port_train_model import (KEY_BIAS, NO_DROPOUT, SHORT_WARMUP, _flat,
                                         _jax_init, _with_model, jbatch, make_batch)
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# -- spawning ------------------------------------------------------------------


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(args_of_rank, world: int, env_of_rank=None, timeout: int = 600):
    """Run ``world`` processes (argv per rank) to their end; a hang fails
    the test at ``timeout`` instead of holding the suite. Returns outputs."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(args_of_rank(r), env={**env, **(env_of_rank(r) if env_of_rank
                                                             else {})},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode, o[-3000:]) for r, (p, o) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    assert not bad, f"workers failed: {bad}"
    return outs


def port_model_state(cfg, params, state):
    """The port's state dict (numpy) of the JAX weights."""
    tm = TFS(config_from_dict(cfg.to_dict()), device="cpu")
    load_jax_params(tm, jax.device_get(params), jax.device_get(state))
    return {k: v.numpy() for k, v in tm.state_dict().items()}


#: the worker: every task on every rank of a gloo world; rank r writes
#: out{r}.npz. Imports nothing of JAX (checked at its end).
WORKER = r'''
import json, os, sys
rank, world, port, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
import numpy as np
import torch
torch.set_num_threads(1)
from fastspeech2_tpu_torch.compat.from_jax import flat_to_jax, state_to_jax
from fastspeech2_tpu_torch.config import config_from_dict
from fastspeech2_tpu_torch.models.fastspeech2 import Batch, FastSpeech2
from fastspeech2_tpu_torch.parallel import mesh as pm
from fastspeech2_tpu_torch.parallel import sharding as sh
from fastspeech2_tpu_torch.train.optimizer import NoamAdam
from fastspeech2_tpu_torch.train.seeds import SeedSchedule
from fastspeech2_tpu_torch.train.step import make_train_step, TrainState, trainable

assert pm.initialize_multihost(f"localhost:{port}", world, rank, device="cpu") == world
spec = json.load(open(os.path.join(root, "spec.json")))
data = np.load(os.path.join(root, "data.npz"))
out = {}

def model_of(key):
    cfg = config_from_dict(spec["cfgs"][key])
    m = FastSpeech2(cfg, device="cpu")
    w = np.load(os.path.join(root, f"weights_{key}.npz"))
    m.load_state_dict({k: torch.from_numpy(w[k]) for k in w.files})
    return m

def batch_of(key, rows=None):
    b = {f: data[f"{key}/{f}"] for f in Batch._fields}
    if rows is not None:
        b = {f: v[rows] for f, v in b.items()}
    return Batch(**{f: torch.from_numpy(np.ascontiguousarray(v)) for f, v in b.items()})

for task in spec["tasks"]:
    name, kind = task["name"], task["kind"]
    mesh = sh.make_mesh_2d(task["dp"], task["tp"], "cpu")
    m = model_of(task["cfg"])
    if kind == "step":
        opt = NoamAdam(trainable(m), m.cfg)
        sh.shard_model(m, mesh, opt)
        step = make_train_step(m, opt, task["accum"], bf16=task.get("bf16", False),
                               mesh=mesh, sequence_parallel=task.get("sp", False))
        ts = TrainState(m, opt, 0)
        seeds = SeedSchedule(m.dropout_sites(), seed=0, injected=task.get("seeds"))
        losses, norms = [], []
        for key in task["batches"]:
            micro = len(data[f"{key}/xs"]) // task["accum"]
            rows = pm.window_rows(mesh, task["accum"], micro)
            ts, rep = step(ts, batch_of(key, rows),
                           [seeds.draw() for _ in range(task["accum"])])
            losses.append(float(rep["loss"]))
            norms.append(float(rep["grad_norm"]))
        fm, _ = sh.gather_full(m, opt, mesh) if mesh.tp > 1 else (m, opt)
        out[f"{name}/loss"] = np.asarray(losses)
        out[f"{name}/grad_norm"] = np.asarray(norms)
        for k, v in flat_to_jax(fm, dict(fm.named_parameters())).items():
            out[f"{name}/params/{k}"] = v
        for k, v in state_to_jax(fm).items():
            out[f"{name}/state/{k}"] = v
    elif kind == "infer":
        from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
        sh.shard_model(m, mesh)
        b = batch_of(task["batch"])
        seqs = [x[:n] for x, n in zip(b.xs.numpy().astype(np.int64), b.ilens.tolist())]
        mel, lens = Synthesizer(m, device="cpu", mesh=mesh).mel_from_token_batch(seqs)
        with torch.inference_mode():
            _, durs = m.encode(b.xs, b.ilens)
        out[f"{name}/mel"], out[f"{name}/lens"] = mel, lens
        out[f"{name}/durs"] = durs.numpy()
    elif kind == "serve":
        from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
        from fastspeech2_tpu_torch.ops import quant8
        synth = Synthesizer(m, device="cpu", mesh=pm.make_mesh(), **task.get("kw", {}))
        seqs = [np.asarray(s, np.int64) for s in task["seqs"]]
        # every activation quantization of the calls: (this rank's amax of
        # its input, the scale it returned); the encoder's durations
        scales, durs = [], []
        quantize, encode = quant8.dynamic_quantize, synth.model.encode

        def recording_quantize(x):
            q, s = quantize(x)
            scales.append((float(x.float().abs().amax()), float(s)))
            return q, s

        def recording_encode(xs, ilens):
            hs, d = encode(xs, ilens)
            durs.append(d.numpy().copy())
            return hs, d

        quant8.dynamic_quantize, synth.model.encode = recording_quantize, recording_encode
        mel, lens, trunc = synth.mel_from_token_batch(seqs, return_truncated=True)
        mel2, lens2 = synth.mel_from_token_batch(seqs)
        quant8.dynamic_quantize = quantize
        assert np.array_equal(lens, lens2) and np.array_equal(mel, mel2)
        out[f"{name}/mel"], out[f"{name}/lens"], out[f"{name}/trunc"] = mel, lens, trunc
        out[f"{name}/scales"] = np.asarray(scales, np.float64).reshape(-1, 2)
        out[f"{name}/durs"] = durs[0]

bad = [n for n in sys.modules if n == "jax" or n.startswith("jax.")
       or n == "fastspeech2_tpu" or n.startswith("fastspeech2_tpu.")]
assert not bad, bad
assert "fastspeech2_tpu_torch.parallel.sharding" in sys.modules
np.savez(os.path.join(root, f"out{rank}.npz"), **out)
print(f"rank {rank} ok", flush=True)
'''


def run_workers(root, world: int, cfgs: dict, weights: dict, data: dict, tasks: list):
    """Write the spec and run WORKER on ``world`` gloo ranks; returns each
    rank's results."""
    root = str(root)
    json.dump({"cfgs": {k: c.to_dict() for k, c in cfgs.items()}, "tasks": tasks},
              open(os.path.join(root, "spec.json"), "w"))
    np.savez(os.path.join(root, "data.npz"), **data)
    for k, w in weights.items():
        np.savez(os.path.join(root, f"weights_{k}.npz"), **w)
    script = os.path.join(root, "worker.py")
    open(script, "w").write(WORKER)
    port = free_port()
    spawn(lambda r: [sys.executable, script, str(r), str(world), str(port), root], world)
    return [dict(np.load(os.path.join(root, f"out{r}.npz"))) for r in range(world)]


def assert_update_matches(got, want, start, atol=1e-4, rel=1e-4):
    """The f32 training bar on the parameters after the tested steps: every
    weight's change within ``atol`` of the JAX change (the bar of
    ``test_trajectory_f32_matches_jax``), and the whole update (every leaf
    but the key biases, whose true gradient is zero) within ``rel`` of its
    norm. Per leaf, a relative bar is not kept: Adam's sign-like first steps
    turn rounding noise in small gradients into whole steps, and the
    single-device port already lands 1.4e-4 of its norm off on one leaf
    (encoder attn/out/w) over these windows."""
    num = den = moved = 0.0
    for k in want:
        dw, dg = want[k] - start[k], got[k] - start[k]
        assert float(np.abs(dg - dw).max()) <= atol, k
        if not k.endswith(KEY_BIAS):
            num += float(np.square(dg - dw).sum())
            den += float(np.square(dw).sum())
            moved = max(moved, float(np.abs(dw).max()))
    assert moved > 1e-3, f"the reference moved by {moved} only: nothing is tested"
    assert num ** 0.5 <= rel * den ** 0.5, (num ** 0.5, den ** 0.5)


def batch_data(key, b):
    return {f"{key}/{f}": v for f, v in b.items()}


# -- the data-parallel worker run ------------------------------------------------

MODES = {"masked": dict(use_masking=True, use_weighted_masking=False),
         "weighted": dict(use_masking=False, use_weighted_masking=True),
         "unmasked": dict(use_masking=False, use_weighted_masking=False)}
#: each mode: the steps taken, accum_grad 2 over 8-row windows of unequal rows
STEPS = {"masked": 2, "weighted": 2, "unmasked": 2}
SEQS = [[int(x) for x in np.random.default_rng(11).integers(1, 68, n)]
        for n in (5, 9, 7)]
#: the int8 serving batch: shard 0 (rows 0, 1) holds the long rows, so its
#: activations are the larger; the demand split (rungs 256 and 512) pairs a
#: row of each shard in each group
SEQS8 = [[int(x) for x in np.random.default_rng(12).integers(1, 68, n)]
         for n in (120, 3, 24, 2)]


def _dp_cfg(mode):
    return _with_model(small_cfg(), **NO_DROPOUT, **SHORT_WARMUP, **MODES[mode])


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """Two gloo ranks: a dp=2 train step per masking mode (accum_grad 2,
    unequal lengths, the BatchNorm postnet of ``small_cfg``) and 2-rank
    serving."""
    root = tmp_path_factory.mktemp("dp")
    cfgs, weights, data, tasks = {}, {}, {}, []
    for mode in MODES:
        cfg = _dp_cfg(mode)
        params, state = _jax_init(cfg, 0)
        cfgs[mode], weights[mode] = cfg, port_model_state(cfg, params, state)
        keys = [f"{mode}{s}" for s in range(STEPS[mode])]
        for s, key in enumerate(keys):
            data.update(batch_data(key, make_batch(200 + s, B=8)))
        tasks.append(dict(name=f"dp_{mode}", kind="step", cfg=mode, dp=2, tp=1,
                          accum=2, batches=keys))
    serve_cfg = small_cfg()
    params, state = _jax_init(serve_cfg, 0)
    params["duration_predictor"]["out"]["b"] = params["duration_predictor"]["out"]["b"] + 1.0
    cfgs["serve"], weights["serve"] = serve_cfg, port_model_state(serve_cfg, params, state)
    tasks.append(dict(name="serve", kind="serve", cfg="serve", dp=2, tp=1, seqs=SEQS))
    tasks.append(dict(name="serve8", kind="serve", cfg="serve", dp=2, tp=1, seqs=SEQS8,
                      kw={"int8": True}))
    outs = run_workers(root, 2, cfgs, weights, data, tasks)
    return outs, data, (serve_cfg, params, state)


def _jax_dp_run(cfg, data, keys, accum):
    """The JAX step on its 2-device data mesh over the same windows."""
    jm = JFS(cfg)
    params, state = _jax_init(cfg, 0)
    start = _flat(params)
    opt = make_optimizer(cfg)
    ts = JTrainState(params, state, opt.init(params), jnp.asarray(0, jnp.int32))
    mesh = jmake_mesh(2)
    step = shard_train_step(jmake_train_step(jm, opt, accum, tp_mesh=mesh), mesh)
    losses, norms = [], []
    with mesh:
        for s, key in enumerate(keys):
            b = {f: data[f"{key}/{f}"] for f in ("xs", "ilens", "ys", "olens", "ds",
                                                  "es", "ps")}
            ts, rep = step(ts, jbatch(b), jax.random.PRNGKey(s))
            losses.append(float(rep["loss"]))
            norms.append(float(rep["grad_norm"]))
    return np.asarray(losses), np.asarray(norms), _flat(ts.params), _flat(ts.model_state), start


@pytest.mark.parametrize("mode", list(MODES))
def test_dp_step_matches_jax_data_mesh(dp_run, mode):
    """Two ranks, each its rows of every global micro-batch: the loss and
    gradient norm of every step to 1e-5, the parameters' changes to 1e-4
    (``assert_update_matches``), the BatchNorm running statistics (advanced over
    the global (B, T) micro-batch by micro-batch) to 1e-5, and both ranks
    hold the same parameters."""
    outs, data, _ = dp_run
    keys = [f"{mode}{s}" for s in range(STEPS[mode])]
    jl, jn, jp, js, start = _jax_dp_run(_dp_cfg(mode), data, keys, 2)
    r0, r1 = outs
    pre = f"dp_{mode}/"
    np.testing.assert_allclose(r0[pre + "loss"], jl, rtol=1e-5)
    np.testing.assert_allclose(r0[pre + "grad_norm"], jn, rtol=1e-5)
    got = {k[len(pre) + 7:]: v for k, v in r0.items() if k.startswith(pre + "params/")}
    assert_update_matches(got, jp, start)
    for k in js:
        np.testing.assert_allclose(r0[pre + "state/" + k], js[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for k in r0:
        if k.startswith(pre):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_two_rank_serving_matches_jax_sharded(dp_run):
    """``Synthesizer(mesh=)`` over two processes (each rank its row shard,
    outputs all-gathered) against the JAX ``Synthesizer`` on its 2-device
    data mesh: the same mel on both ranks, lengths exact, mel 1e-4."""
    outs, _, (cfg, params, state) = dp_run
    js = JSynth(JFS(cfg), params, state, mesh=jmake_mesh(2))
    mj, lj = js.mel_from_token_batch([np.asarray(s, np.int32) for s in SEQS])
    for r in outs:
        np.testing.assert_array_equal(r["serve/lens"], np.asarray(lj))
        assert r["serve/mel"].shape == mj.shape
        np.testing.assert_allclose(r["serve/mel"], mj, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(outs[0]["serve/mel"], outs[1]["serve/mel"])


def _scale_f32(amax: float) -> np.float32:
    """``quant8._scale`` in float32: max(amax, tiny) / 127."""
    return np.float32(max(np.float32(amax), np.finfo(np.float32).tiny)) / np.float32(127.0)


def _jax_sharded_mel(js, seqs):
    """The JAX sharded ``Synthesizer``'s demand-sized mel call, step by step:
    its encode program, ``_decode_groups`` over the whole batch's demand,
    then each group's decode program with the group's rows placed sharded
    over ``data``, as the programs take them (its own dispatch hands them
    over replicated, which jit refuses once the split engages). Returns
    (mel, out_lens, durations of the padded batch)."""
    from jax.sharding import NamedSharding, PartitionSpec

    data = NamedSharding(js.mesh, PartitionSpec("data"))
    B, B_pad = len(seqs), js._b_pad(len(seqs))
    t_pad = -(-max(len(s) for s in seqs) // js.token_multiple) * js.token_multiple
    xs = np.zeros((B_pad, t_pad), np.int32)
    ilens = np.ones((B_pad,), np.int32)
    for i, s in enumerate(seqs):
        xs[i, :len(s)], ilens[i] = s, len(s)
    ilens_d, alphas_d = jnp.asarray(ilens), jnp.ones((B_pad,), jnp.float32)
    hs, d_outs, dem = js._enc_fn(t_pad)(js.params, jnp.asarray(xs), ilens_d, alphas_d)
    groups = js._decode_groups(np.asarray(dem))
    assert len(groups) == 2  # the split is engaged
    mel = np.zeros((B_pad, max(r for _, r in groups), js.model.odim), np.float32)
    lens = np.zeros((B_pad,), np.int64)
    for rows, rung in groups:
        args = [jax.device_put(jnp.take(t, jnp.asarray(rows), axis=0), data)
                for t in (hs, d_outs, ilens_d, alphas_d)]
        m, ln = js._dec_fn(t_pad, rung)(js.params, js.state, *args)
        mel[rows, :rung], lens[rows] = np.asarray(m), np.asarray(ln)
    return mel[:B], lens[:B], np.asarray(d_outs), ilens, t_pad


def test_two_rank_int8_serving_matches_jax_sharded(dp_run):
    """The int8 tier over two processes (``SEQS8``: shard 0 holds the long
    rows, the 2-way decode split engaged) against the JAX int8
    ``Synthesizer`` on its 2-device data mesh, whose programs take each
    activation's scale over the whole group's rows. The bar of
    ``test_synthesizer_int8_f32_matches_jax``: durations on >= 99% of the
    tokens, out_lens equal, the rows with equal durations within 2e-2; both
    ranks return the same bits. It prints each row's largest mel difference
    to the JAX call (``pytest -s``)."""
    outs, _, (cfg, params, state) = dp_run
    js = JSynth(JFS(cfg), params, state, mesh=jmake_mesh(2), int8=True)
    mj, lj, dj, ilens, t_pad = _jax_sharded_mel(js, [np.asarray(s, np.int32)
                                                     for s in SEQS8])
    r0, r1 = outs
    for k in ("mel", "lens", "trunc"):
        np.testing.assert_array_equal(r0[f"serve8/{k}"], r1[f"serve8/{k}"], err_msg=k)
    np.testing.assert_array_equal(r0["serve8/lens"], lj)
    assert r0["serve8/mel"].shape == mj.shape
    dt = np.concatenate([r0["serve8/durs"], r1["serve8/durs"]])
    live = np.arange(t_pad)[None] < ilens[:, None]
    assert (dj == dt)[live].mean() >= 0.99, (dj != dt)[live].sum()
    same = [i for i in range(len(SEQS8)) if np.array_equal(dj[i], dt[i])]
    assert len(same) >= len(SEQS8) - 1, same
    gaps = [float(np.abs(r0["serve8/mel"][i] - mj[i]).max()) for i in same]
    print("int8 rows' max abs mel difference to the JAX sharded call:", gaps)
    assert max(gaps) < 2e-2, gaps


def test_two_rank_int8_scales_cover_the_whole_group(dp_run):
    """Every activation quantization of the two-rank int8 calls returns, on
    both ranks, the scale of the largest magnitude over the whole group's
    rows (the max of the two ranks' own amax), as the JAX package's sharded
    program does: the two ranks enter the same quantizations in the same
    order. A failure says how many scales were off the group's, of how
    many, and by how much at most (relative)."""
    outs, _, _ = dp_run
    r0, r1 = (o["serve8/scales"] for o in outs)
    n = min(len(r0), len(r1))
    want = np.asarray([_scale_f32(max(a, b)) for a, b in zip(r0[:n, 0], r1[:n, 0])],
                      np.float64)
    rel = np.concatenate([np.abs(r[:n, 1] - want) / want for r in (r0, r1)])
    gap = (f"{int((rel > 0).sum())} of {rel.size} scales off the group's, up to "
           f"{rel.max():.3g} relative; {len(r0)} and {len(r1)} quantizations a rank")
    assert n > 0 and len(r0) == len(r1) and not rel.any(), gap
    assert not np.array_equal(r0[:, 0], r1[:, 0])  # the shards' own amax differ


def test_local_mesh_refuses_int8():
    """A local mesh runs its replicas one after another on one thread, so
    they cannot share a scale per layer: ``int8=True`` is refused there."""
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer

    cfg = config_from_dict(small_cfg().to_dict())
    m = TFS(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="int8"):
        Synthesizer(m, device="cpu", mesh=pmesh.make_mesh(devices=["cpu", "cpu"]),
                    int8=True)


def test_local_mesh_serving_equals_one_device():
    """A local mesh of two entries on one device (as ``chip_smoke.py`` runs
    it on the card): the shards' merged rows equal the unsharded call."""
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer

    cfg = config_from_dict(small_cfg().to_dict())
    m = TFS(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        m.duration_predictor.out.bias.add_(1.0)
    seqs = [np.asarray(s, np.int64) for s in SEQS + [[3, 4, 5, 6, 7, 8, 9, 10, 11] * 6]]
    want = Synthesizer(m, device="cpu").mel_from_token_batch(seqs, return_truncated=True)
    mesh = pmesh.make_mesh(devices=["cpu", "cpu"])
    synth = Synthesizer(m, device="cpu", mesh=mesh)
    got = synth.mel_from_token_batch(seqs, return_truncated=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    assert synth._replicas and list(synth._replicas.values())[0] is synth


def test_tensor_parallel_serving_needs_a_sharded_model():
    """``Synthesizer`` over a mesh with a model axis refuses a model not
    sharded over that mesh, and the int8 tier."""
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer

    cfg = config_from_dict(small_cfg().to_dict())
    m = TFS(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    mesh = pmesh.Mesh([torch.device("cpu")], 1, 2)
    with pytest.raises(ValueError, match="shard_model"):
        Synthesizer(m, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="int8"):
        Synthesizer(m, device="cpu", mesh=mesh, int8=True)


# -- the hash dropout and kernel 12 under a mesh (op level, in process) --------


@pytest.mark.parametrize("origin,split", [((3, 0, 0), None), ((2, 8, 0), (1, 8, 16)),
                                          ((0, 0, 24), (2, 24, 48))])
def test_hash_mask_blocks_are_the_global_mask(origin, split):
    """A rank's block of the bf16 dropout mask, from its first global row
    (data parallelism) and a split axis (tensor/sequence parallelism), is the
    block of the JAX package's mask over the global shape, bit for bit."""
    gshape = (6, 16, 48)
    shape = [2, 16, 48]
    if split is not None:
        shape[split[0]] = gshape[split[0]] // 2
    seed, rate = 0xC0FFEE, 0.3
    want = np.asarray(jnn._hash_keep_mask(jnp.uint32(seed), gshape, rate))
    sl = tuple(slice(o, o + n) for o, n in zip(origin, shape))
    got = tnn._hash_keep_mask(seed, tuple(shape), rate, None, origin, gshape)
    np.testing.assert_array_equal(got.numpy(), want[sl])
    # the same through nn.dropout inside a data shard
    mesh = pmesh.Mesh([torch.device("cpu")], 3)
    x = torch.ones(shape)
    from fastspeech2_tpu_torch.ops.precision import compute_dtype

    with compute_dtype(torch.bfloat16), pmesh.data_shard(
            pmesh.DataShard(mesh, origin[0], gshape[0])):
        y = tnn.dropout(x, rate, seed, deterministic=False,
                        split=None if split is None else
                        (split[0], origin[split[0]], gshape[split[0]]))
    np.testing.assert_array_equal(y.numpy() != 0, want[sl])


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_kernel12_shard_seeds_match_jax_data_mesh(rate):
    """Under a multi-device mesh the JAX package runs kernel 12 on each
    shard's local (B, H, T, dk) with ``seed + shard * 0x9E37``
    (``fused_attention_train_tp``); the port's shards, each through
    ``fused_attention_train`` with ``shard_seed``, give the same output and
    gradients (interpret mode on a 2-device data mesh against the plain
    version, f32)."""
    from jax.sharding import Mesh

    g = np.random.default_rng(7)
    B, H, T, dk = 4, 2, 16, 8
    q, k, v, do = (g.normal(size=(B, H, T, dk)).astype(np.float32) for _ in range(4))
    lens = g.integers(T // 2, T + 1, B).astype(np.int32)
    seed = 123457
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))

    def jloss(q, k, v):
        o = jat.fused_attention_train_tp(q, k, v, jnp.asarray(lens), jnp.asarray([seed],
                                         jnp.int32), rate, mesh, interpret=True)
        return jnp.sum(o * do), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    outs = []
    for d in range(2):
        rows = slice(d * B // 2, (d + 1) * B // 2)
        outs.append(tat.fused_attention_train(tq[rows], tk[rows], tv[rows],
                                              torch.from_numpy(lens[rows]),
                                              tat.shard_seed(seed, d), rate))
    o = torch.cat(outs)
    (o * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=1e-5, atol=1e-6)
    for t, w in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    if rate:  # the offset matters: the unshifted seed draws another mask
        plain = tat.fused_attention_train(tq[2:], tk[2:], tv[2:],
                                          torch.from_numpy(lens[2:]), seed, rate)
        assert not torch.allclose(plain, outs[1])


def test_mesh_shard_routes_training_attention_to_kernel12(monkeypatch):
    """A shard of a multi-device mesh never takes the head-packed kernel 11:
    the encoder hands ``mha_fused_train_apply`` the shard index, which takes
    kernel 12's entry with the shard's seed."""
    cfg = config_from_dict(_with_model(small_cfg(), adim=256, ddim=256, aheads=2,
                                       fused_attention="on").to_dict())
    m = TFS(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    calls = []
    monkeypatch.setattr(tat, "fused_attention_train_packed",
                        lambda *a, **k: pytest.fail("kernel 11 under a mesh"))
    real = tat.fused_attention_train
    monkeypatch.setattr(tat, "fused_attention_train",
                        lambda q, k, v, lens, seed, rate: (calls.append(seed),
                                                           real(q, k, v, lens, seed, rate))[1])
    b = make_batch(5, B=2)
    from fastspeech2_tpu_torch.models.fastspeech2 import Batch
    from fastspeech2_tpu_torch.ops.precision import compute_dtype
    from fastspeech2_tpu_torch.train.seeds import SeedSchedule

    seeds = SeedSchedule(m.dropout_sites(), seed=1).draw()
    mesh = pmesh.Mesh([torch.device("cpu")], 2, data_index=1)
    with compute_dtype(torch.bfloat16), pmesh.data_shard(pmesh.DataShard(mesh, 2, 4)):
        m(Batch(**{k: torch.from_numpy(v) for k, v in b.items()}), seeds=seeds,
          training=True)
    want = [tat.shard_seed(seeds[f"{s}/0/attn"], 1) for s in ("encoder", "decoder")]
    assert calls == want


# -- the training loop, preemption and the CLI across two processes ------------

LOOP_WORKER = r'''
import dataclasses, json, os, signal, sys, threading
root, store, fl = sys.argv[1], sys.argv[2], sys.argv[3]
import numpy as np
import torch
torch.set_num_threads(1)
from fastspeech2_tpu_torch import cli
from fastspeech2_tpu_torch.config import load_config
from fastspeech2_tpu_torch.parallel.mesh import initialize_multihost
from fastspeech2_tpu_torch.train.loop import train

# torchrun's variables: RANK, WORLD_SIZE, MASTER_ADDR/PORT, LOCAL_WORLD_SIZE=1
assert initialize_multihost(device="cpu") == 2
rank = int(os.environ["RANK"])
cfg_path = os.path.join(root, "cfg.yaml")
# the CLI train: two hosts of one rank each, validation at 2, saves at 4
cli.main(["train", "-c", cfg_path, "-n", "mh", "-o", os.path.join(root, "out"),
          "--max_steps", "4", "--device", "cpu"])
# preemption: SIGTERM on rank 1 only; both stop at the same step
cfg = load_config(cfg_path)
cfg = dataclasses.replace(cfg, train=dataclasses.replace(
    cfg.train, validation_step=10**6, save_interval=10**6, summary_interval=10**6,
    epochs=10**6))
if rank == 1:
    threading.Timer(4.0, signal.raise_signal, [signal.SIGTERM]).start()
ts = train(cfg, "pre", os.path.join(root, "out"), max_steps=10**6, device="cpu")
flat = np.concatenate([p.detach().reshape(-1).numpy() for p in ts.model.parameters()])
json.dump({"step": ts.step, "param_sum": float(np.abs(flat).sum()),
           "finite": bool(np.isfinite(flat).all())},
          open(os.path.join(root, f"pre{rank}.json"), "w"))
# tensor_parallel=2 (one head a rank): 3 steps with a save and the validation
# sample (both gather the shards), then a resume that cuts the checkpoint
tp = dataclasses.replace(load_config(cfg_path), train=dataclasses.replace(
    cfg.train, tensor_parallel=2, sequence_parallel=True, save_interval=3,
    validation_step=2, summary_interval=1, epochs=10**6))
out = os.path.join(root, "out")
ts = train(tp, "tp", out, max_steps=3, device="cpu")
ts = train(tp, "tp", out, max_steps=1, device="cpu",
           resume_path=os.path.join(out, "checkpoints", "tp", "ckpt_00000003.npz"))
shapes = {n: list(p.shape) for n, p in ts.model.named_parameters()}
json.dump({"step": ts.step, "count": int(ts.optimizer.count), "shapes": shapes},
          open(os.path.join(root, f"tp{rank}.json"), "w"))
torch.distributed.destroy_process_group()
bad = [n for n in sys.modules if n == "jax" or n.startswith("jax.")
       or n == "fastspeech2_tpu" or n.startswith("fastspeech2_tpu.")]
assert not bad, bad
print(f"rank {rank} ok", flush=True)
'''


def test_two_process_cli_train_and_preemption(tmp_path):
    """Two processes launched as ``torch.distributed.run`` launches them
    (its environment variables, one rank per host): the CLI ``train`` steps
    to max_steps with rank 0 alone writing checkpoints and metrics; then a
    SIGTERM on rank 1 alone stops both ranks at the same step, rank 0 writes
    the one preemption checkpoint, and both hold the same parameters; then
    ``train()`` at tensor_parallel=2 with sequence parallelism saves the
    gathered tree (which the JAX package loads) and resumes from it."""
    import yaml

    from fastspeech2_tpu_torch.data.dataset import write_fake_feature_store
    from fastspeech2_tpu_torch.train.checkpoint import load_checkpoint_meta

    store = str(tmp_path / "store")
    fl = write_fake_feature_store(store, n_utts=32, seed=3)
    d = small_cfg().to_dict()
    d["data"].update(data_dir=store, train_filelist=fl, valid_filelist=fl)
    d["train"].update(batch_size=2, accum_grad=2, validation_step=2, save_interval=4,
                      summary_interval=2)
    open(tmp_path / "cfg.yaml", "w").write(yaml.safe_dump(d))
    script = tmp_path / "loop_worker.py"
    script.write_text(LOOP_WORKER)
    port = free_port()
    spawn(lambda r: [sys.executable, str(script), str(tmp_path), store, fl], 2,
          lambda r: {"RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": "0",
                     "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
                     "MASTER_PORT": str(port)})
    ckpt_dir = tmp_path / "out" / "checkpoints"
    assert sorted(os.listdir(ckpt_dir / "mh")) == ["ckpt_00000004.npz"]
    assert load_checkpoint_meta(str(ckpt_dir / "mh" / "ckpt_00000004.npz"))["step"] == 4
    recs = [json.loads(ln) for ln in open(tmp_path / "out" / "logs" / "mh" /
                                          "train_metrics.jsonl")]
    assert [r["step"] for r in recs if "main/loss" in r] == [2, 4]
    assert {r["step"] for r in recs if "validation/loss" in r} == {2, 4}
    pre = [json.load(open(tmp_path / f"pre{r}.json")) for r in (0, 1)]
    assert pre[0]["step"] == pre[1]["step"] >= 10 and pre[0]["step"] % 10 == 0, pre
    assert pre[0]["param_sum"] == pre[1]["param_sum"] and pre[0]["finite"]
    assert os.listdir(ckpt_dir / "pre") == [f"ckpt_{pre[0]['step']:08d}.npz"]
    # tensor_parallel=2: the shards are cut per rank, rank 0 writes the
    # single-device tree, which the JAX package loads, and the resume cuts it
    tp = [json.load(open(tmp_path / f"tp{r}.json")) for r in (0, 1)]
    assert tp[0]["step"] == tp[1]["step"] == 4 and tp[0]["count"] == 4
    q = "encoder.layers.0.attn.q.weight"
    assert tp[0]["shapes"][q] == [16, 32] == tp[1]["shapes"][q]
    assert sorted(os.listdir(ckpt_dir / "tp")) == ["ckpt_00000003.npz", "ckpt_00000004.npz"]
    from fastspeech2_tpu.train.checkpoint import load_checkpoint as jload

    jm = JFS(small_cfg())
    p0, s0 = _jax_init(small_cfg(), 0)
    p, _, _, step, _ = jload(str(ckpt_dir / "tp" / "ckpt_00000004.npz"), p0, s0)
    assert step == 4 and p["encoder"]["layers"][0]["attn"]["q"]["w"].shape == (32, 32)
    assert jm.encoder_cfg.attention_heads == 2

# -- resolution of the mesh -------------------------------------------------------


def test_resolve_dp_and_hosts_follow_jax():
    """``resolve_dp`` as the JAX loop's (dp_size 0: the largest dp <=
    devices / tp dividing batch_size; the same errors), and the hosts of a
    world."""
    from fastspeech2_tpu.train.loop import resolve_dp as jresolve_dp
    from fastspeech2_tpu_torch.train.loop import resolve_dp, resolve_hosts

    for bs, n, tp, dp_size in [(4, 8, 1, 0), (6, 4, 1, 0), (4, 8, 2, 0), (8, 4, 2, 2),
                               (3, 2, 1, 0)]:
        jc = small_cfg(batch_size=bs, dp_size=dp_size)
        tc = config_from_dict(jc.to_dict())
        assert resolve_dp(tc, n, tp) == jresolve_dp(jc, n, tp)
    for bad in [dict(dp_size=4), dict(dp_size=3, batch_size=4)]:
        jc = small_cfg(**bad)
        with pytest.raises(ValueError):
            jresolve_dp(jc, 2 if "batch_size" not in bad else 4, 1)
        with pytest.raises(ValueError):
            resolve_dp(config_from_dict(jc.to_dict()), 2 if "batch_size" not in bad else 4, 1)
    with pytest.raises(ValueError, match="tensor_parallel=2"):
        resolve_dp(config_from_dict(small_cfg().to_dict()), 1, 2)
    cfg = config_from_dict(small_cfg(num_hosts=2).to_dict())
    assert resolve_hosts(cfg, 4, 3) == (2, 1)
    with pytest.raises(ValueError):
        resolve_hosts(cfg, 3, 0)


def test_window_rows_and_batcher_rows(tmp_path):
    """Each data index takes its contiguous share of every micro-batch of
    the global window; ``epoch_rows`` reads those rows of the hosts'
    concatenated batches (the JAX package's global array) and counts the
    whole window's frames."""
    from fastspeech2_tpu_torch.data.batching import BucketBatcher
    from fastspeech2_tpu_torch.data.dataset import TTSDataset, write_fake_feature_store

    mesh = pmesh.Mesh([torch.device("cpu")], 2, data_index=1)
    np.testing.assert_array_equal(pmesh.window_rows(mesh, 2, 4), [2, 3, 6, 7])
    np.testing.assert_array_equal(pmesh.window_rows(None, 2, 4), np.arange(8))
    root = str(tmp_path / "s")
    fl = write_fake_feature_store(root, n_utts=24, seed=1)
    ds = TTSDataset(root, fl, True, ["english_cleaners"])
    hosts = [list(BucketBatcher(ds, batch_size=4, num_hosts=2, host_id=h).epoch(0))
             for h in (0, 1)]
    rows = list(BucketBatcher(ds, batch_size=4, num_hosts=2).epoch_rows(0, [1, 2, 5, 6]))
    assert len(rows) == len(hosts[0]) >= 2
    for (b, shape, frames), (b0, s0), (b1, s1) in zip(rows, hosts[0], hosts[1]):
        assert shape == s0 == s1
        glob = [np.concatenate([x, y]) for x, y in zip(b0, b1)]
        for got, want in zip(b, glob):
            np.testing.assert_array_equal(got, want[[1, 2, 5, 6]])
        assert frames == int(glob[3].sum())


def test_initialize_multihost_world_of_one_and_backends():
    """A world of one forms no group; NCCL is the backend for the card,
    gloo for the CPU; a 1-D mesh without a group is local."""
    assert pmesh.initialize_multihost(num_processes=1) == 1
    assert not torch.distributed.is_initialized()
    assert pmesh.default_backend("cpu") == "gloo"
    assert pmesh.default_backend(None) == "nccl"
    assert pmesh.default_backend("cuda:0") == "nccl"
    m = pmesh.make_mesh(devices=["cpu", "cpu"])
    assert m.size == 2 and not m.distributed
