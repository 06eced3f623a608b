"""The int8 tier over a local mesh (``Synthesizer(int8=True,
mesh=make_mesh(devices=[...]))``) against the JAX package on the CPU.

A local mesh runs one thread a shard, each the process mesh's sharded call
on its replica, the collectives over a group of threads
(``parallel/mesh.py:ThreadGroup``). Here two entries of the CPU take the
place of the two gloo ranks of ``tests/test_torch_port_parallel.py``, on
its batch ``SEQS8`` (shard 0 holds the long rows, the 2-way decode split
engages), its weights (the JAX ``init`` of ``small_cfg``, duration bias +1,
through ``load_jax_params``) and its oracle, the JAX ``Synthesizer(mesh=
make_mesh(2), int8=True)`` on the virtual CPU devices of ``conftest.py``.

The bar is ``test_two_rank_int8_serving_matches_jax_sharded``'s: durations
equal on at least 99% of the live tokens and on all rows but one, out_lens
equal, the rows with equal durations within 2e-2 (each row's gap printed,
``pytest -s``). Every activation scale is the max of the two shards' own
amax, exactly. The wav route, a failing shard and the HTTP server over the
mesh are held to the port's own unsharded pieces, bit for bit.

The module runs torch on one intra-op thread (``one_thread``), which the
shard threads take from the caller: with two, MKL's multi-threaded GEMM,
called from both shard threads at once, rounds some products of a call
differently now and then (without ``MKL_CBWR``, MKL's results depend on how
its threads were scheduled), so two calls could differ in the last bits and
the bit-for-bit checks would test MKL's scheduling, not the port.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from conftest import small_cfg
from fastspeech2_tpu.infer.synthesize import Synthesizer as JSynth
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JFS
from fastspeech2_tpu.train.step import make_mesh as jmake_mesh
from fastspeech2_tpu_torch.config import config_from_dict
from fastspeech2_tpu_torch.infer.synthesize import Synthesizer, mel_floor_mask, pcm16
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2 as TFS
from fastspeech2_tpu_torch.ops import quant8
from fastspeech2_tpu_torch.parallel import mesh as pmesh
from fastspeech2_tpu_torch.vocoder.melgan import MelGANConfig, MelGANGenerator
from test_torch_port_parallel import SEQS8, _jax_sharded_mel, _scale_f32, port_model_state
from test_torch_port_server import _post, _running
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)
from test_torch_port_train_model import _jax_init

LOCAL = ["cpu", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_thread(torch_threads):  # noqa: F811
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def weights():
    """The JAX init of ``small_cfg`` with the duration bias raised by 1 (as
    ``dp_run`` serves it) and the port's state dict of it."""
    cfg = small_cfg()
    params, state = _jax_init(cfg, 0)
    params["duration_predictor"]["out"]["b"] = params["duration_predictor"]["out"]["b"] + 1.0
    return cfg, params, state, port_model_state(cfg, params, state)


def _model(weights) -> TFS:
    cfg, _, _, sd = weights
    m = TFS(config_from_dict(cfg.to_dict()), device="cpu")
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return m


def _local_int8(weights, **kw) -> Synthesizer:
    return Synthesizer(_model(weights), device="cpu", int8=True,
                       mesh=pmesh.make_mesh(devices=LOCAL), **kw)


def _record(synth, monkeypatch):
    """Per shard (``current_shard().data_index``): every activation
    quantization's (own amax, returned scale) and the encoder's durations."""
    scales, durs = {0: [], 1: []}, {0: [], 1: []}
    quantize, encode = quant8.dynamic_quantize, synth.model.encode

    def shard():
        return pmesh.current_shard().data_index

    def recording_quantize(x):
        q, s = quantize(x)
        scales[shard()].append((float(x.float().abs().amax()), float(s)))
        return q, s

    def recording_encode(xs, ilens):
        hs, d = encode(xs, ilens)
        durs[shard()].append(d.numpy().copy())
        return hs, d

    monkeypatch.setattr(quant8, "dynamic_quantize", recording_quantize)
    monkeypatch.setattr(synth.model, "encode", recording_encode)
    return scales, durs


@pytest.fixture(scope="module")
def jax_oracle(weights):
    cfg, params, state, _ = weights
    js = JSynth(JFS(cfg), params, state, mesh=jmake_mesh(2), int8=True)
    return _jax_sharded_mel(js, [np.asarray(s, np.int32) for s in SEQS8])


@pytest.fixture(scope="module")
def demand_run(weights):
    """One recorded demand-sized call of the local int8 mesh and a second,
    unrecorded one on the same Synthesizer."""
    synth = _local_int8(weights)
    seqs = [np.asarray(s, np.int64) for s in SEQS8]
    with pytest.MonkeyPatch.context() as mp:
        scales, durs = _record(synth, mp)
        out = synth.mel_from_token_batch(seqs, return_truncated=True)
    again = synth.mel_from_token_batch(seqs, return_truncated=True)
    return out, again, scales, durs


def _hold_to_jax(mel, lens, durs, jax_oracle, what):
    mj, lj, dj, ilens, t_pad = jax_oracle
    np.testing.assert_array_equal(lens, lj)
    assert mel.shape == mj.shape, (mel.shape, mj.shape)
    dt = np.concatenate([durs[0][0], durs[1][0]])
    live = np.arange(t_pad)[None] < ilens[:, None]
    assert (dj == dt)[live].mean() >= 0.99, (dj != dt)[live].sum()
    same = [i for i in range(len(SEQS8)) if np.array_equal(dj[i], dt[i])]
    assert len(same) >= len(SEQS8) - 1, same
    gaps = [float(np.abs(mel[i] - mj[i]).max()) for i in same]
    print(f"{what}: rows' max abs mel difference to the JAX sharded call:", gaps)
    assert max(gaps) < 2e-2, gaps


def test_local_int8_mesh_matches_jax_sharded(demand_run, jax_oracle):
    """The demand-sized call of the local int8 mesh against the JAX sharded
    int8 call; a second call returns the same bits."""
    (mel, lens, trunc), again, _, durs = demand_run
    _hold_to_jax(mel, lens, durs, jax_oracle, "local int8 mesh")
    for a, b in zip((mel, lens, trunc), again):
        np.testing.assert_array_equal(a, b)


def _assert_group_scales(scales):
    r0, r1 = (np.asarray(scales[s], np.float64).reshape(-1, 2) for s in (0, 1))
    assert len(r0) == len(r1) > 0, (len(r0), len(r1))
    want = np.asarray([_scale_f32(max(a, b)) for a, b in zip(r0[:, 0], r1[:, 0])],
                      np.float64)
    rel = np.concatenate([np.abs(r[:, 1] - want) / want for r in (r0, r1)])
    assert not rel.any(), (f"{int((rel > 0).sum())} of {rel.size} scales off the "
                           f"group's, up to {rel.max():.3g} relative")
    assert not np.array_equal(r0[:, 0], r1[:, 0])


def test_local_int8_mesh_scales_are_the_groups_max(demand_run):
    """Every quantization of the call returns, on both shards, the scale of
    the max of the two shards' own amax, exactly; both shards enter the same
    number of quantizations, and their own amax differ."""
    _assert_group_scales(demand_run[2])


def test_local_int8_mesh_heuristic_matches_jax_sharded(weights, jax_oracle, monkeypatch):
    """The heuristic dispatch (``demand_sized=False``) of the local int8
    mesh against the JAX sharded int8 call's heuristic dispatch (its
    frames-per-token program, each scale over the whole batch), at the same
    bar; the durations are held to the JAX encode program's, which takes
    the same scales. Every scale is the group's max here too."""
    cfg, params, state, _ = weights
    js = JSynth(JFS(cfg), params, state, mesh=jmake_mesh(2), int8=True, demand_sized=False)
    mj, lj = js.mel_from_token_batch([np.asarray(s, np.int32) for s in SEQS8])
    synth = _local_int8(weights, demand_sized=False)
    scales, durs = _record(synth, monkeypatch)
    mel, lens = synth.mel_from_token_batch([np.asarray(s, np.int64) for s in SEQS8])
    _assert_group_scales(scales)
    _hold_to_jax(mel, lens, durs, (np.asarray(mj), np.asarray(lj), *jax_oracle[2:]),
                 "local int8 mesh, heuristic dispatch")


def test_local_int8_mesh_wav_route(weights, monkeypatch):
    """With MelGAN attached the wav call returns the mel call's mel bit for
    bit, and each row's PCM is the port's MelGAN on that row's mel at its
    decode group's rung on one device (one row a shard per group, as the
    call vocodes it), zero past the rung."""
    synth = _local_int8(weights)
    gen = MelGANGenerator(MelGANConfig(base_channels=16), seed=1, device="cpu")
    synth.attach_vocoder(gen)
    seqs = [np.asarray(s, np.int64) for s in SEQS8]
    mel, lens = synth.mel_from_token_batch(seqs)
    groups, real = [], synth._decode_groups
    monkeypatch.setattr(synth, "_decode_groups",
                        lambda dem: (groups.append(real(dem)), groups[-1])[1])
    wmel, pcm, wav_lens = synth.wav_from_token_batch(seqs)
    np.testing.assert_array_equal(wmel, mel)
    hop = synth.hop_length
    np.testing.assert_array_equal(wav_lens, lens * hop)
    assert len(groups) == 2 and len(groups[0]) == 2, groups  # both shards, split engaged
    with torch.inference_mode():
        for rows, rung in groups[0]:
            for i in rows[rows < len(seqs)]:
                m = torch.from_numpy(mel[i:i + 1, :rung])
                want = pcm16(gen(mel_floor_mask(m, torch.from_numpy(lens[i:i + 1]))))
                np.testing.assert_array_equal(pcm[i, :rung * hop], want[0].numpy())
                assert not pcm[i, rung * hop:].any()


def test_local_mesh_shard_failure_raises_and_next_call_serves(weights, monkeypatch):
    """A shard that raises (shard 1's decode) makes the call raise that
    error within seconds, leaves no shard thread behind, and the next call on
    the same Synthesizer serves the first call's bits."""
    synth = _local_int8(weights)
    seqs = [np.asarray(s, np.int64) for s in SEQS8]
    want = synth.mel_from_token_batch(seqs)
    real = synth.model.decode_frames

    def failing(*a, **k):
        if pmesh.current_shard().data_index == 1:
            raise RuntimeError("shard 1 failed")
        return real(*a, **k)

    monkeypatch.setattr(synth.model, "decode_frames", failing)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        synth.mel_from_token_batch(seqs)
    assert time.perf_counter() - t0 < 30
    assert not [t for t in threading.enumerate() if t.name.startswith("fs2-shard-")]
    monkeypatch.setattr(synth.model, "decode_frames", real)
    for a, b in zip(synth.mel_from_token_batch(seqs), want):
        np.testing.assert_array_equal(a, b)


def test_local_int8_mesh_serves_concurrent_requests(weights):
    """``infer/server.py:serve`` over the local int8 mesh answers 8
    concurrent mel requests; each served batch equals a direct call on the
    same rows (an int8 row depends on its batchmates), and each reply is
    its row of that batch."""
    from fastspeech2_tpu_torch.text import phonemes_to_sequence

    synth = _local_int8(weights)
    batches, real = [], synth.mel_from_token_batch_async

    def recording(seqs, alpha=1.0):
        finish = real(seqs, alpha)

        def done():
            out = finish()
            batches.append(([np.asarray(s) for s in seqs], alpha, out))
            return out
        return done

    synth.mel_from_token_batch_async = recording
    words = "HH AH0 L OW1 W ER1 L D DH IH1 S IH0 Z AH0 T EH1 S T".split()
    phonemes = [" ".join(words[i:] + words[:i + 3]) for i in range(8)]
    replies, errors = [None] * 8, []

    def ask(i):
        try:
            replies[i] = json.loads(_post(url, {"phonemes": phonemes[i]})[1])
        except Exception as e:  # reported below
            errors.append(repr(e))

    with _running(synth, max_batch=4) as url:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not errors, errors
    assert sum(len(b[0]) for b in batches) == 8
    for seqs, alpha, (mel, lens, trunc) in batches:
        for a, b in zip(real(seqs, alpha)(), (mel, lens, trunc)):
            np.testing.assert_array_equal(a, b)
    rows = {tuple(s): (mel[r, :lens[r]]) for seqs, _, (mel, lens, _) in batches
            for r, s in enumerate(seqs)}
    for p, rep in zip(phonemes, replies):
        got = rows[tuple(phonemes_to_sequence(p))]
        assert rep["frames"] == len(got) > 0
        np.testing.assert_array_equal(np.asarray(rep["mel"], np.float32), got)
