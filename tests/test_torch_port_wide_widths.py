"""The conv-FFN body (kernels 2, 9, 10 and the projections of 1, 5, 6) at
every D from 1 to 2048 and the seven attention kernels (1, 5, 6, 7, 8, 11,
12) at every d_k from 1 to 2048, against the JAX package on the CPU.

The JAX functions assert only shapes: ``fused_ffn`` and its blocks take any
D (odd k), the attention functions any d_k with ``D % n_heads == 0``. The
port's FFN holds launch 1's x tile whole where it fits and in column chunks
past that (``ops/kernels/ffn.py:plan``, ``xc``); its attention kernels run
d_k past 256 in column parts (``ops/kernels/attention_train.py:plan``).

Plan level: ``ffn.plan`` covers every D from 1 to 2048 at every odd k from
1 to 31 (H 4096, O = D), and ``attention_train.plan`` every d_k from 1 to
2048 in the serve, train and f32 modes, within 232,448 bytes of shared
memory a block; the wrappers' checks take D and d_k 1500 and 2048 and refuse
2056, naming the bound.

Kernel level: each wrapper's plain version (what a CPU tensor takes, and the
card's reference) against the Pallas function called with ``interpret=True``,
B=2, T=16, lengths (16, 5), inputs from numpy seeds: kernels 2, 9 and 10 at
D 1536 and 2048 (k 9 and 31, H 40); kernels 1, 5-8 at d_k 1500 and 2048
(one head); 11 and 12 at rate 0.2, the output and the three gradients. f32:
1e-5; bf16: mean 2e-3, max 5e-2 (the band of
``tests/test_torch_port_kernels.py``), and 11 and 12 within the JAX
package's own bf16-vs-f32 gap.

Slice level: a one-block, one-head bf16 model at adim 1536 / ddim 2048 with
narrow FFNs loaded with ``load_jax_params``; its mel, fed the JAX durations,
against the JAX model's with its Pallas kernels in interpret mode (mean <
0.02, max < 0.2, as ``tests/test_torch_port_prenorm.py``); the durations
equal.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_wide_widths.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastspeech2_tpu.config import Config, ModelConfig
from fastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JFS
from fastspeech2_tpu.ops.pallas import adaptor as jadaptor
from fastspeech2_tpu.ops.pallas import attention as jattn
from fastspeech2_tpu.ops.pallas import attention_train as jat
from fastspeech2_tpu.ops.pallas import ffn as jffn
from fastspeech2_tpu.ops.pallas import postnet as jpostnet
from fastspeech2_tpu.ops.precision import compute_dtype as jcompute_dtype
from fastspeech2_tpu_torch.compat.from_jax import load_jax_params
from fastspeech2_tpu_torch.config import config_from_dict
from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2 as TFS
from fastspeech2_tpu_torch.ops.kernels import attention as KA
from fastspeech2_tpu_torch.ops.kernels import attention_train as KT
from fastspeech2_tpu_torch.ops.kernels import ffn as KF
from fastspeech2_tpu_torch.ops.precision import compute_dtype as tcompute_dtype
from test_torch_port_threads import torch_threads  # noqa: F401  (autouse)

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
B, T = 2, 16
LENGTHS = np.asarray([16, 5], np.int32)
H = 40  # the FFN's hidden width: narrow, the x tile's width is what is new


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, want, tier):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if tier == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        d = np.abs(got - want)
        assert d.mean() < 2e-3 and d.max() < 5e-2, (d.mean(), d.max())


def _dead_rows(got, want, pad=0):
    """Rows from each length + pad on: the JAX kernel's constants to 1e-5."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    for b, n in enumerate(LENGTHS):
        np.testing.assert_allclose(got[b, n + pad:], want[b, n + pad:], rtol=1e-5, atol=1e-5)


def test_plans_cover_every_width_to_2048_and_refuse_past_it():
    """``ffn.plan`` at every D 1..2048 and odd k 1..31 (H 4096, O = D) fits
    a block, keeps the whole x tile wherever it fits (today's tilings) and
    holds chunks of 512 columns only past that, whose ring walk covers
    every (chunk, tap) column; ``attention_train.plan`` at every d_k 1..2048
    in each mode fits a block with parts of at most 256 columns that cover
    d_k. The checks take D and d_k 1500 and 2048 and refuse 2056."""
    chunked, walked = 0, set()
    for k in range(1, 32, 2):
        for D in range(1, 2049):
            pl = KF.plan(D, 4096, k, D)
            Dp, rows = KF.padded(D), (pl.p + k - 1) | 1
            assert pl.smem1 <= KF.SMEM_MAX and pl.smem2 <= KF.SMEM_MAX, (D, k, pl)
            assert 2 <= pl.st1 <= 4 and pl.passes * 2 * pl.no >= D, (D, k, pl)
            whole = [(p, nh) for p, nh in KF.CONV_TILES
                     if Dp * ((p + k - 1) | 1) * 2 + 2 * nh * 128 + KF.SLACK <= KF.SMEM_MAX]
            if whole:
                assert pl.xc == Dp and (pl.p, pl.nh) == whole[0], (D, k, pl)
                assert pl.smem1 == Dp * rows * 2 + pl.st1 * pl.nh * 128 + KF.SLACK
                continue
            chunked += 1
            assert (pl.p, pl.nh, pl.xc) == (128, 256, 512) and Dp > pl.xc, (D, k, pl)
            assert pl.smem1 == pl.xc * rows * 2 + 8 * rows + pl.st1 * 256 * 128 + KF.SLACK
            if (Dp, k) in walked:
                continue
            walked.add((Dp, k))
            # the walk: each tap of each chunk in 64-column tiles, the last
            # one 32 wide where the chunk's width is 32 past a multiple of 64
            nc = -(-Dp // pl.xc)
            cols = sorted(j * Dp + q * pl.xc + c for q in range(nc) for j in range(k)
                          for c in range(0, min(pl.xc, Dp - q * pl.xc), 16))
            assert cols == list(range(0, k * Dp, 16)), (D, k)
    assert chunked > 0 and KF.plan(1344, 4096, 9, 1344).xc == 1344
    assert KF.plan(1376, 4096, 9, 1376).xc == 512 and KF.plan(1504, 1504, 1, 1504).xc == 1504
    assert KF.plan(2048, 64, 101, 64).xc == 256  # wider halos take narrower chunks
    for dk in range(1, KT.MAX_HEAD_DIM + 1):
        for mode in ("serve", "train", "f32"):
            p = KT.plan(dk, mode)
            assert 0 < max(p.smem.values()) <= KT.SMEM_LIMIT, (dk, mode, p)
            assert p.parts * p.part_width >= dk and (p.parts - 1) * p.part_width < dk
            assert p.part_width <= 256 and p.dkp % 64 == 0 and p.dkp >= max(dk, 128)
    assert KT.MAX_HEAD_DIM == KF.MAX_D == 2048 and KT.plan(2048).parts == 8
    for n in (1500, 2048):
        KA._check_heads("t", n, 1)
        KA.check_head_dim("t", n)
        KF.plan(n, 64, 9, n)
        q = torch.zeros(1, 8, n, dtype=torch.bfloat16)
        KT._check("t", q, q, q, torch.zeros(1, dtype=torch.int32), 1, n)
    with pytest.raises(ValueError, match="D from 1 to 2048"):
        KF.plan(2056, 64, 9, 2056)
    with pytest.raises(ValueError, match="head dim d_k=2056.*1 to 2048"):
        KT.plan(2056)
    with pytest.raises(ValueError, match="d_k=2056"):
        KA._check_heads("t", 2056, 1)
    with pytest.raises(ValueError, match="D from 1 to 2048"):
        KA._check_heads("t", 2 * 1032, 2)  # d_k 1032 is taken, D 2064 is not
    q = torch.zeros(1, 8, 2056, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        KT._check("t", q, q, q, torch.zeros(1, dtype=torch.int32), 1, 2056)


def _ffn_weights(rng, D, O, k):
    """JAX layout: w1 (k, D, H), w2 (1, H, O); LayerNorm g/be of width D."""
    w1 = (rng.normal(size=(k, D, H)) / np.sqrt(k * D)).astype(np.float32)
    b1 = (rng.normal(size=(H,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(1, H, O)) / np.sqrt(H)).astype(np.float32)
    b2 = (rng.normal(size=(O,)) * 0.1).astype(np.float32)
    g = (rng.normal(size=(D,)) * 0.2 + 1.0).astype(np.float32)
    be = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    return w1, b1, w2, b2, g, be


#: each kernel at both widths, k 9 and 31, in both tiers
FFN_CASES = [("post", "bf16", 1536, 9), ("post", "f32", 2048, 31),
             ("pre", "f32", 1536, 31), ("pre", "bf16", 2048, 9),
             ("bare", "f32", 1536, 9), ("bare", "bf16", 2048, 31)]


@pytest.mark.parametrize("kind,tier,D,k", FFN_CASES,
                         ids=[f"{c[0]}-{c[1]}-D{c[2]}-k{c[3]}" for c in FFN_CASES])
def test_ffn_kernels_match_pallas(kind, tier, D, k):
    """Kernels 2 (post), 9 (pre) and 10 (bare, O = D) at widths whose x tile
    the card holds in 512-column chunks; rows whose window lies past the
    length give the JAX kernel's bias-only constants."""
    assert KF.plan(D, H, k, D).xc == 512
    rng = np.random.default_rng(D + k)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    w1, b1, w2, b2, g, be = _ffn_weights(rng, D, D, k)
    jd, td = JAX_DT[tier], TORCH_DT[tier]
    jw = (jnp.asarray(w1, jd), jnp.asarray(b1), jnp.asarray(w2, jd), jnp.asarray(b2))
    lens = torch.from_numpy(LENGTHS)
    tw = (_t(w1.transpose(2, 0, 1).reshape(H, k * D), td), _t(b1), _t(w2[0].T, td), _t(b2))
    if kind == "bare":
        xj = jnp.asarray(x, jd)
        want = jffn.fused_ffn(xj, *jw, jnp.asarray(LENGTHS), interpret=True, block_t=T)
        got = KF.fused_ffn(_t(np.asarray(xj, np.float32), td), *tw, lens, k)
        assert got.dtype == td and got.shape == (B, T, D)
    else:
        fn = jffn.fused_ffn_block_post if kind == "post" else jffn.fused_ffn_block
        want = fn(jnp.asarray(x), jnp.asarray(g), jnp.asarray(be), *jw, jnp.asarray(LENGTHS),
                  cd=jd, interpret=True, block_t=T)
        wrap = KF.ffn_block if kind == "post" else KF.ffn_block_pre
        got = wrap(_t(x), *tw, _t(g), _t(be), lens, k)
        assert got.dtype == torch.float32 and got.shape == (B, T, D)
    _close(got.float(), want, tier)
    _dead_rows(got.float(), want, (k - 1) // 2)


def _qkv(rng, shape, tier):
    """q/k/v as values of the tier's dtype, on both sides."""
    vals = [jnp.asarray(rng.normal(size=shape).astype(np.float32), JAX_DT[tier])
            for _ in range(3)]
    return vals, [_t(np.asarray(v, np.float32), TORCH_DT[tier]) for v in vals]


#: each kernel in both tiers: d_k 1500 (no multiple of 8) in bf16, 2048 in f32
ATTN_CASES = [(kernel, tier, dk) for kernel in (1, 5, 6, 7, 8)
              for tier, dk in (("bf16", 1500), ("f32", 2048))]


@pytest.mark.parametrize("kernel,tier,dk", ATTN_CASES,
                         ids=[f"k{c[0]}-{c[1]}-dk{c[2]}" for c in ATTN_CASES])
def test_attention_kernels_match_pallas(kernel, tier, dk):
    """Kernels 1, 5, 6, 7 (one head, D = d_k: the projections of 1, 5 and 6
    on the chunked FFN body) and 8 at head dims past 1024; dead rows give
    the JAX kernel's constants (zeros for 7 and 8)."""
    rng = np.random.default_rng(kernel * 10000 + dk)
    D = dk
    jd, td = JAX_DT[tier], TORCH_DT[tier]
    lens, jlens = torch.from_numpy(LENGTHS), jnp.asarray(LENGTHS)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    if kernel in (1, 5, 6):
        w = [(rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32) for _ in range(4)]
        bqkv = (rng.normal(size=(3, D)) * 0.1).astype(np.float32)
        bo = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
        g = (rng.normal(size=(D,)) * 0.2 + 1.0).astype(np.float32)
        be = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
        jwo = jnp.asarray(w[3], jd)
        two = _t(np.asarray(jwo, np.float32).T, td)
    if kernel == 1:
        want = jattn.fused_attention_packed_qkv_res_ln(
            jnp.asarray(x), *(jnp.asarray(wi, jd) for wi in w[:3]), jnp.asarray(bqkv), jwo,
            jnp.asarray(bo[None]), jnp.asarray(g), jnp.asarray(be), jlens, 1,
            interpret=True, block_q=T)
        wqkv = torch.cat([_t(np.asarray(jnp.asarray(wi, jd), np.float32).T) for wi in w[:3]])
        got = KA.attention_block(_t(x), wqkv.to(td), _t(bqkv.reshape(-1)), two, _t(bo), _t(g),
                                 _t(be), lens, 1)
    elif kernel in (5, 6):
        (jq, jk, jv), (q, k, v) = _qkv(rng, (B, T, D), tier)
        if kernel == 5:
            want = jattn.fused_attention_packed_res_ln(
                jq, jk, jv, jnp.asarray(x), jwo, jnp.asarray(bo[None]), jnp.asarray(g),
                jnp.asarray(be), jlens, 1, interpret=True, block_q=T)
            got = KA.attention_res_ln(q, k, v, _t(x), two, _t(bo), _t(g), _t(be), lens, 1)
        else:
            want = jattn.fused_attention_packed_res(
                jq, jk, jv, jnp.asarray(x), jwo, jnp.asarray(bo[None]), jlens, 1,
                interpret=True, block_q=T)
            got = KA.attention_res(q, k, v, _t(x), two, _t(bo), lens, 1)
    elif kernel == 7:
        (jq, jk, jv), (q, k, v) = _qkv(rng, (B, T, D), tier)
        want = jattn.fused_attention_packed(jq, jk, jv, jlens, 1, interpret=True, block_q=T)
        got = KA.fused_attention_packed(q, k, v, lens, 1)
        assert got.dtype == td and got.shape == (B, T, D)
    else:
        (jq, jk, jv), (q, k, v) = _qkv(rng, (B, 1, T, dk), tier)
        want = jattn.fused_attention(jq, jk, jv, jlens, interpret=True, block_q=T)
        got = KA.fused_attention(q, k, v, lens)
        assert got.dtype == td and got.shape == (B, 1, T, dk)
        got, want = got[:, 0], want[:, 0]
    _close(got.float(), want, tier)
    _dead_rows(got.float(), want)


def _train_jax(arrays, seed, rate, packed, dtype):
    jq, jk, jv, jdo = (jnp.asarray(a[:, 0] if packed else a, dtype) for a in arrays)
    jl, js = jnp.asarray(LENGTHS), jnp.asarray([np.uint32(seed).astype(np.int32)])
    if packed:
        fn = lambda a, b, c: jat.fused_attention_train_packed(  # noqa: E731
            a, b, c, jl, js, 1, rate, True)
    else:
        fn = lambda a, b, c: jat.fused_attention_train(a, b, c, jl, js, rate, True)  # noqa: E731
    o, vjp = jax.vjp(fn, jq, jk, jv)
    return [np.asarray(t.astype(jnp.float32)) for t in (o, *vjp(jdo))]


def _train_torch(arrays, seed, rate, packed, dtype):
    tq, tk, tv = (torch.tensor(a[:, 0] if packed else a).to(dtype).requires_grad_()
                  for a in arrays[:3])
    lens = torch.from_numpy(LENGTHS)
    if packed:
        o = KT.fused_attention_train_packed(tq, tk, tv, lens, seed, 1, rate)
    else:
        o = KT.fused_attention_train(tq, tk, tv, lens, seed, rate)
    do = arrays[3][:, 0] if packed else arrays[3]
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.tensor(do).to(dtype))
    return [t.detach().float().numpy() for t in (o, *grads)]


@pytest.mark.parametrize("tier,dk", [("bf16", 1500), ("f32", 2048)], ids=["bf16-dk1500",
                                                                       "f32-dk2048"])
def test_attention_train_matches_pallas(tier, dk):
    """Kernels 11 (heads packed) and 12 ((B, H, T, dk)) at one head and rate
    0.2: the output and dQ, dK, dV; f32 to 1e-5 (at one head both layouts
    draw the same mask: one JAX run serves both), bf16 within the JAX
    package's own bf16-vs-f32 gap on the same inputs; padded rows exact
    zeros."""
    rng = np.random.default_rng(7 * dk)
    rate, seed = 0.2, 2 ** 31 + 9
    arrays = [rng.normal(size=(B, 1, T, dk)).astype(np.float32) for _ in range(4)]
    arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]
    want32 = _train_jax(arrays, seed, rate, False, jnp.float32)
    for packed in (True, False):
        got = _train_torch(arrays, seed, rate, packed, TORCH_DT[tier])
        w32 = [w[:, 0] if packed else w for w in want32]
        want = w32 if tier == "f32" else _train_jax(arrays, seed, rate, packed, jnp.bfloat16)
        for i, name in enumerate(("o", "dq", "dk", "dv")):
            g, w = got[i], want[i]
            if tier == "f32":
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
            else:
                bound = np.abs(w - w32[i]).max()
                assert np.abs(g - w).max() <= bound, (packed, name, np.abs(g - w).max(), bound)
            pad = g[1, 5:] if packed else g[1, :, 5:]
            assert np.all(pad == 0.0), f"{name}: padded rows not exactly zero"


def _interpret(monkeypatch):
    """Every Pallas entry the JAX model's post-LN serving route reaches,
    called with interpret=True (the HLO interpreter) instead of on a TPU. At
    these widths the JAX route projects q/k/v with XLA and takes kernel 5
    (``mha_fused_block_ln_apply``: the whole-row weights leave kernel 1 no
    VMEM); the port takes kernel 1, the same function."""
    for mod, names in ((jattn, ("fused_attention_packed_qkv_res_ln",
                                "fused_attention_packed_res_ln")),
                       (jffn, ("fused_ffn_block_post",)),
                       (jadaptor, ("fused_variance_adaptor",)),
                       (jpostnet, ("fused_postnet",))):
        for name in names:
            real = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _r=real, **k: _r(*a, **{
                **k, "interpret": True}))


def _random_params(jm, rng):
    """The JAX model's parameter and state trees (``jax.eval_shape`` of its
    init: no compile) filled from ``rng``: weights w at 1/sqrt(fan-in),
    biases b at 0.1, norm gains g at 1 +- 0.1, alpha 1, running means 0.1
    and variances 1 + 0.1 |n|."""
    def fill(path, leaf):
        name, shape = jax.tree_util.keystr(path).split("'")[-2], leaf.shape
        n = rng.standard_normal(size=shape, dtype=np.float32)
        if name == "w":
            n = n / np.sqrt(max(1, int(np.prod(shape[:-1]))))
        elif name in ("g", "alpha"):
            n = 1.0 + 0.1 * n * (name == "g")
        elif name == "var":
            n = 1.0 + 0.1 * np.abs(n)
        else:
            n = 0.1 * n
        return jnp.asarray(n, leaf.dtype)

    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return tuple(jax.tree_util.tree_map_with_path(fill, t) for t in shapes)


def test_wide_one_head_model_matches_jax(monkeypatch):
    """A bf16 post-LN model with one head at adim 1536, ddim 2048 (d_k 1536
    and 2048: kernel 1's plain version in both blocks, its projections at
    chunked widths), eunits 40, dunits 48 (kernel 2 at D 1536 and 2048),
    one block each, loaded from the JAX parameters; the JAX model through
    its Pallas kernels in interpret mode. The f32 durations are equal and
    the mel fed the JAX durations is in the band."""
    cfg = Config(model=ModelConfig(
        adim=1536, aheads=1, elayers=1, eunits=40, ddim=2048, dlayers=1, dunits=48,
        postnet_layers=2, postnet_chans=16, positionwise_conv_kernel_size=3,
        duration_predictor_chans=16, fused_attention="on"))
    _interpret(monkeypatch)
    jm = JFS(cfg)
    params, state = _random_params(jm, np.random.default_rng(0))
    params["duration_predictor"]["out"]["b"] = params["duration_predictor"]["out"]["b"] + 1.5
    tm = TFS(config_from_dict(cfg.to_dict()), device="cpu")
    load_jax_params(tm, jax.device_get(params), jax.device_get(state))
    xs = np.random.default_rng(9).integers(1, 68, (B, T)).astype(np.int32)
    ilens = LENGTHS
    L = 32

    def enc(p, x, i):
        with jcompute_dtype(jnp.bfloat16):
            return jm.encode(p, x, i)

    def dec(p, s, h, d, i):
        with jcompute_dtype(jnp.bfloat16):
            return jm.decode_frames(p, s, h, d, i, out_maxlen=L)

    hj, dj = jax.jit(enc)(params, jnp.asarray(xs), jnp.asarray(ilens))
    mj, lj = jax.jit(dec)(params, state, hj, dj, jnp.asarray(ilens))

    calls = []
    for mod, name in ((KA, "attention_block_plain"), (KF, "ffn_block_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
            calls.append((_n, a[0].shape[-1])), _r(*a, **k))[1])
    with torch.inference_mode(), tcompute_dtype(torch.bfloat16):
        ht, dt = tm.encode(torch.from_numpy(xs), torch.from_numpy(ilens))
        mt, lt = tm.decode_frames(ht, torch.from_numpy(np.array(dj)),
                                  torch.from_numpy(ilens), out_maxlen=L)
    assert sorted(calls) == [("attention_block_plain", 1536), ("attention_block_plain", 2048),
                             ("ffn_block_plain", 1536), ("ffn_block_plain", 2048)], calls
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    d = np.abs(ht.float().numpy() - np.asarray(hj, np.float32))
    assert d.mean() < 0.02 and d.max() < 0.2, ("encoder", d.mean(), d.max())
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert int(lt.min()) > 0
    d = np.abs(mt.float().numpy() - np.asarray(mj, np.float32))
    assert d.mean() < 0.02 and d.max() < 0.2, ("mel", d.mean(), d.max())
