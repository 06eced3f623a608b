"""Every model width of the conv-FFN kernels (2, 9, 10) and every head dim of
the seven attention kernels (1, 5, 6, 7, 8, 11, 12) against the JAX package
on the CPU.

The JAX functions assert only shapes: ``fused_ffn`` and its blocks take any
D, H and O (odd k: the JAX route takes them for odd k only, and the Pallas
kernel fails at even k), the attention functions any d_k with ``D %
n_heads == 0``. The port's kernels work at D and H rounded up to 32 and at
head dims rounded up to 8 (``ops/kernels/ffn.py:pad_weights``,
``ops/kernels/attention.py:head_layout``), on zero padding that is exact.

Kernel level: each wrapper's plain version (what a CPU tensor takes, and the
card's reference) against the Pallas function called with ``interpret=True``,
B=3, T=32, lengths (32, 13, 1), inputs from numpy seeds: kernels 2, 9 and 10
at (D, H, k) in {(40, 72, 3), (36, 100, 9), (72, 100, 1)}, 10 also at O = 30;
kernels 1, 5-8 at d_k 130 (two heads) and 20; 11 and 12 at rate 0.2, the
output and the three gradients. f32: 1e-5; bf16: mean 2e-3, max 5e-2 (the
band of ``tests/test_torch_port_kernels.py``), and 11 and 12 within the JAX
package's own bf16-vs-f32 gap (``tests/test_torch_port_train_ops.py``).

Padding: the kernels' padded layouts run through the plain versions give
the real-width results to 1e-6. Plan level: ``ffn.plan`` and
``attention_train.plan`` cover the new ranges within 232,448 bytes of shared
memory a block, and the checks still refuse even k and d_k 2056.

Slice level: a bf16 model (``small_cfg``'s depth, adim 72, ddim 260, two
heads, eunits 100, dunits 72: the encoder's FFN at D = 72, H = 100, the
decoder's attention at d_k 130 through kernel 1 and its FFN at D = 260)
loaded with ``load_jax_params``; its mel, fed the JAX durations, against the
JAX model's with its Pallas kernels in interpret mode (mean < 0.02, max <
0.2, as ``tests/test_torch_port_prenorm.py``).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_widths.py -q
"""

import math

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
B, T = 3, 32
LENGTHS = np.asarray([32, 13, 1], np.int32)
TIERS = ("f32", "bf16")
#: (D, H, k) of the conv-FFN cases
FFN_SHAPES = [(40, 72, 3), (36, 100, 9), (72, 100, 1)]
#: (d_k, heads) of the attention cases
HEAD_DIMS = [(130, 2), (20, 2)]


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


def _ffn_weights(rng, D, H, O, k):
    """JAX layout: w1 (k, D, H), w2 (1, H, O); LayerNorm g/be of width D."""
    w1 = (rng.normal(size=(k, D, H)) / np.sqrt(k * D)).astype(np.float32)
    b1 = (rng.normal(size=(H,)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(1, H, O)) / np.sqrt(H)).astype(np.float32)
    b2 = (rng.normal(size=(O,)) * 0.1).astype(np.float32)
    g = (rng.normal(size=(D,)) * 0.2 + 1.0).astype(np.float32)
    be = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    return w1, b1, w2, b2, g, be


def _ffn_torch(w1, b1, w2, b2, td):
    """The port's layout: w1 (H, k*D) (out, tap, in), w2 (O, H)."""
    k, D, H = w1.shape
    return (_t(w1.transpose(2, 0, 1).reshape(H, k * D), td), _t(b1), _t(w2[0].T, td), _t(b2))


#: each kernel in both tiers, each shape in one (the tiers alternate)
FFN_CASES = [(kind, TIERS[(i + j) % 2], D, H, k) for i, kind in enumerate(("post", "pre", "bare"))
             for j, (D, H, k) in enumerate(FFN_SHAPES)]


@pytest.mark.parametrize("kind,tier,D,H,k", FFN_CASES,
                         ids=[f"{c[0]}-{c[1]}-D{c[2]}-H{c[3]}-k{c[4]}" for c in FFN_CASES])
def test_ffn_kernels_match_pallas(kind, tier, D, H, k):
    """Kernels 2 (post), 9 (pre) and 10 (bare; O = D, and O = 30 at D = 72)
    at widths that are no multiple of 32; rows whose window lies past the
    length give the JAX kernel's bias-only constants."""
    rng = np.random.default_rng(D * 1000 + H * 10 + k)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    O = 30 if kind == "bare" and D == 72 else D
    w1, b1, w2, b2, g, be = _ffn_weights(rng, D, H, O, k)
    jd, td = JAX_DT[tier], TORCH_DT[tier]
    jw = (jnp.asarray(w1, jd), jnp.asarray(b1), jnp.asarray(w2, jd), jnp.asarray(b2))
    lens = torch.from_numpy(LENGTHS)
    tw = _ffn_torch(w1, b1, w2, b2, td)
    if kind == "bare":
        xj = jnp.asarray(x, jd)
        want = jffn.fused_ffn(xj, *jw, jnp.asarray(LENGTHS), interpret=True, block_t=8)
        got = KF.fused_ffn(_t(np.asarray(xj, np.float32), td), *tw, lens, k)
        assert got.dtype == td and got.shape == (B, T, O)
    else:
        fn = jffn.fused_ffn_block_post if kind == "post" else jffn.fused_ffn_block
        want = fn(jnp.asarray(x), jnp.asarray(g), jnp.asarray(be), *jw, jnp.asarray(LENGTHS),
                  cd=jd, interpret=True, block_t=8)
        wrap = KF.ffn_block if kind == "post" else KF.ffn_block_pre
        got = wrap(_t(x), *tw, _t(g), _t(be), lens, k)
        assert got.dtype == torch.float32 and got.shape == (B, T, D)
    _close(got.float(), want, tier)
    _dead_rows(got.float(), want, (k - 1) // 2)


def _attn_weights(rng, D):
    """Projection and LayerNorm weights; w in the JAX (in, out) layout."""
    w = [(rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32) for _ in range(4)]
    bqkv = (rng.normal(size=(3, D)) * 0.1).astype(np.float32)
    bo = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    g = (rng.normal(size=(D,)) * 0.2 + 1.0).astype(np.float32)
    be = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
    return w, bqkv, bo, g, be


def _qkv(rng, shape, tier):
    """q/k/v as values of the tier's dtype, on both sides."""
    vals = [jnp.asarray(rng.normal(size=shape).astype(np.float32), JAX_DT[tier])
            for _ in range(3)]
    return vals, [_t(np.asarray(v, np.float32), TORCH_DT[tier]) for v in vals]


#: each kernel in both tiers: d_k 130 (the model's) in bf16, d_k 20 in f32
ATTN_CASES = [(kernel, tier, dk, nh) for kernel in (1, 5, 6, 7, 8)
              for tier, (dk, nh) in zip(("bf16", "f32"), HEAD_DIMS)]


@pytest.mark.parametrize("kernel,tier,dk,nh", ATTN_CASES,
                         ids=[f"k{c[0]}-{c[1]}-dk{c[2]}" for c in ATTN_CASES])
def test_attention_kernels_match_pallas(kernel, tier, dk, nh):
    """Kernels 1 (LN(x + MHA(x Wqkv + bqkv) Wo + bo)), 5 (q/k/v given), 6
    (pre-LN, no LayerNorm), 7 (bare, heads packed) and 8 (bare, (B, H, T,
    dk)) at head dims that are no multiple of 8; dead rows give the JAX
    kernel's constants (zeros for 7 and 8)."""
    rng = np.random.default_rng(kernel * 1000 + dk)
    D = dk * nh
    jd, td = JAX_DT[tier], TORCH_DT[tier]
    lens, jlens = torch.from_numpy(LENGTHS), jnp.asarray(LENGTHS)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    w, bqkv, bo, g, be = _attn_weights(rng, D)
    jwo = jnp.asarray(w[3], jd)
    two = _t(np.asarray(jwo, np.float32).T, td)
    if kernel == 1:
        want = jattn.fused_attention_packed_qkv_res_ln(
            jnp.asarray(x), *(jnp.asarray(wi, jd) for wi in w[:3]), jnp.asarray(bqkv), jwo,
            jnp.asarray(bo[None]), jnp.asarray(g), jnp.asarray(be), jlens, nh,
            interpret=True, block_q=8)
        wqkv = torch.cat([_t(np.asarray(jnp.asarray(wi, jd), np.float32).T) for wi in w[:3]])
        got = KA.attention_block(_t(x), wqkv.to(td), _t(bqkv.reshape(-1)), two, _t(bo), _t(g),
                                 _t(be), lens, nh)
    elif kernel in (5, 6):
        (jq, jk, jv), (q, k, v) = _qkv(rng, (B, T, D), tier)
        if kernel == 5:
            want = jattn.fused_attention_packed_res_ln(
                jq, jk, jv, jnp.asarray(x), jwo, jnp.asarray(bo[None]), jnp.asarray(g),
                jnp.asarray(be), jlens, nh, interpret=True, block_q=8)
            got = KA.attention_res_ln(q, k, v, _t(x), two, _t(bo), _t(g), _t(be), lens, nh)
        else:
            want = jattn.fused_attention_packed_res(
                jq, jk, jv, jnp.asarray(x), jwo, jnp.asarray(bo[None]), jlens, nh,
                interpret=True, block_q=8)
            got = KA.attention_res(q, k, v, _t(x), two, _t(bo), lens, nh)
    elif kernel == 7:
        (jq, jk, jv), (q, k, v) = _qkv(rng, (B, T, D), tier)
        want = jattn.fused_attention_packed(jq, jk, jv, jlens, nh, interpret=True, block_q=8)
        got = KA.fused_attention_packed(q, k, v, lens, nh)
        assert got.dtype == td and got.shape == (B, T, D)
    else:
        (jq, jk, jv), (q, k, v) = _qkv(rng, (B, nh, T, dk), tier)
        want = jattn.fused_attention(jq, jk, jv, jlens, interpret=True, block_q=8)
        got = KA.fused_attention(q, k, v, lens)
        assert got.dtype == td and got.shape == (B, nh, T, dk)
        got, want = got.transpose(1, 2), jnp.swapaxes(want, 1, 2)
    _close(got.float(), want, tier)
    _dead_rows(got.float(), want)


def _pack(a):  # (B, H, T, dk) -> (B, T, H * dk)
    b, h, t, d = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3)).reshape(b, t, h * d)


def _train_jax(arrays, seed, rate, packed, nh, dtype):
    q, k, v, do = ((_pack(a) if packed else a) for a in arrays)
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in (q, k, v, do))
    jl, js = jnp.asarray(LENGTHS), jnp.asarray([np.uint32(seed).astype(np.int32)])
    if packed:
        fn = lambda a, b, c: jat.fused_attention_train_packed(  # noqa: E731
            a, b, c, jl, js, nh, rate, True)
    else:
        fn = lambda a, b, c: jat.fused_attention_train(a, b, c, jl, js, rate, True)  # noqa: E731
    o, vjp = jax.vjp(fn, jq, jk, jv)
    return [np.asarray(t.astype(jnp.float32)) for t in (o, *vjp(jdo))]


def _train_torch(arrays, seed, rate, packed, nh, dtype):
    q, k, v, do = ((_pack(a) if packed else a) for a in arrays)
    tq, tk, tv = (torch.tensor(a).to(dtype).requires_grad_() for a in (q, k, v))
    lens = torch.from_numpy(LENGTHS)
    if packed:
        o = KT.fused_attention_train_packed(tq, tk, tv, lens, seed, nh, rate)
    else:
        o = KT.fused_attention_train(tq, tk, tv, lens, seed, rate)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.tensor(do).to(dtype))
    return [t.detach().float().numpy() for t in (o, *grads)]


@pytest.mark.parametrize("dk,nh", HEAD_DIMS, ids=[f"dk{dk}" for dk, _ in HEAD_DIMS])
def test_attention_train_matches_pallas(dk, nh):
    """Kernels 11 (heads packed) and 12 ((B, H, T, dk)) in bf16 at rate 0.2
    and d_k 130 / 20: the output and dQ, dK, dV within the JAX package's own
    bf16-vs-f32 gap on the same inputs (the two layouts draw the same mask:
    one f32 run gives both gaps); padded rows exact zeros."""
    rng = np.random.default_rng(7 * dk)
    rate, seed = 0.2, 2 ** 31 + 5
    arrays = [rng.normal(size=(B, nh, T, dk)).astype(np.float32) for _ in range(4)]
    arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrays]
    gap32 = _train_jax(arrays, seed, rate, False, nh, jnp.float32)
    for packed in (True, False):
        got = _train_torch(arrays, seed, rate, packed, nh, torch.bfloat16)
        want = _train_jax(arrays, seed, rate, packed, nh, jnp.bfloat16)
        for i, name in enumerate(("o", "dq", "dk", "dv")):
            g, w = got[i], want[i]
            gap = _pack(gap32[i]) if packed else gap32[i]
            bound = np.abs(w - gap).max()
            assert np.abs(g - w).max() <= bound, (packed, name, np.abs(g - w).max(), bound)
            pad = g[2, 1:] if packed else g[2, :, 1:]
            assert np.all(pad == 0.0), f"{name}: padded rows not exactly zero"


def test_padded_layouts_give_the_real_width_results():
    """The kernels' padded layouts, run through the plain versions, give the
    real-width results to 1e-6 (f32): the FFN on x zero-filled to Dp with
    ``pad_weights`` (hidden Hp), the post-LN block with padded weights (its
    LayerNorm over the real D), kernel 1's ``pad_block_weights`` and the
    out projection on head outputs laid dkp apart, and the training and
    bare attention on ``pad_head_dim`` copies at the real d_k's scale."""
    rng = np.random.default_rng(11)
    lens = torch.from_numpy(LENGTHS)
    D, H, k = 36, 100, 9
    x = _t(rng.normal(size=(B, T, D)))
    w1, b1, w2, b2, g, be = _ffn_weights(rng, D, H, D, k)
    real = _ffn_torch(w1, b1, w2, b2, torch.float32)
    padw = KF.pad_weights(real[0], real[1], real[2], D, k)
    Dp, Hp = KF.padded(D), KF.padded(H)
    assert padw[0].shape == (Hp, k * Dp) and padw[1].shape == (Hp,) and padw[2].shape == (D, Hp)
    assert KF.pad_weights(*padw, D, k)[0] is padw[0]  # already at the kernels' widths
    xm = KF._masked(x, lens)
    want = KF._conv_ffn(xm, *real, k, torch.float32)
    got = KF._conv_ffn(torch.nn.functional.pad(xm, (0, Dp - D)), *padw, real[3], k,
                       torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    for plain in (KF.ffn_block_plain, KF.ffn_block_pre_plain):
        np.testing.assert_allclose(
            plain(x, *padw, real[3], _t(g), _t(be), lens, k).numpy(),
            plain(x, *real, _t(g), _t(be), lens, k).numpy(), rtol=0, atol=1e-6)

    dk, nh = 130, 2
    D = dk * nh
    _, dkp, Da, Kp = KA.head_layout(D, nh)
    assert (dkp, Da, Kp) == (136, 272, 288)
    x = _t(rng.normal(size=(B, T, D)))
    wqkv, bqkv, wo = _t(rng.normal(size=(3 * D, D)) / 16), _t(rng.normal(size=(3 * D,))), \
        _t(rng.normal(size=(D, D)) / 16)
    bo, g, be = _t(rng.normal(size=(D,))), _t(rng.normal(size=(D,))), _t(rng.normal(size=(D,)))
    pw = KA.pad_block_weights(wqkv, bqkv, wo, D, nh)
    assert [tuple(t.shape) for t in pw] == [(3 * Da, KF.padded(D)), (3 * Da,), (D, Kp)]
    # the plain version reads the padded layout back bit for bit; its output
    # then differs from the real-width call's by f32 summation order only
    # (the BLAS takes other paths for other addresses), under the LayerNorm
    for a, b_ in zip(KA._real_weights(*pw, D, nh), (wqkv, bqkv, wo)):
        assert torch.equal(a, b_)
    np.testing.assert_allclose(KA.attention_block_plain(x, *pw, bo, g, be, lens, nh).numpy(),
                               KA.attention_block_plain(x, wqkv, bqkv, wo, bo, g, be, lens,
                                                        nh).numpy(), rtol=0, atol=1e-5)
    o = _t(rng.normal(size=(B, T, D)))
    op = torch.nn.functional.pad(KA._pad_heads(o, nh, dkp), (0, Kp - Da))
    np.testing.assert_allclose((op @ pw[2].t()).numpy(), (o @ wo.t()).numpy(), rtol=0,
                               atol=1e-5)

    q, kk, v, do = (_t(rng.normal(size=(B, T, D))) for _ in range(4))
    qp, dop = KT.pad_head_dim((q, do), nh, dkp)
    assert qp.shape == (B, T, Da)
    for t, tp in ((q, qp), (do, dop)):
        assert torch.equal(KT.cut_head_dim(tp, nh, dk), t)
    # the training attention at d_k 2 run at dkp 8, the kernels' scale (the
    # real d_k's) folded into q: a factor of 2, so the emulation is exact
    dk, D = 2, 2 * nh
    q, kk, v, do = (_t(rng.normal(size=(B, T, D))) for _ in range(4))
    qp, kp, vp, dop = KT.pad_head_dim((q, kk, v, do), nh, KT.padded_head_dim(dk))
    leaves = [t.clone().requires_grad_() for t in (q, kk, v, qp * 2, kp, vp)]
    o_real = KT.attention_train_plain(*leaves[:3], lens, 3, 0.2, nh)
    o_pad = KT.attention_train_plain(*leaves[3:], lens, 3, 0.2, nh)
    g_real = torch.autograd.grad(o_real, leaves[:3], do)
    g_pad = torch.autograd.grad(o_pad, leaves[3:], dop)
    for a, b_, mul in zip((o_real, *g_real), (o_pad, *g_pad), (1.0, 2.0, 1.0, 1.0)):
        np.testing.assert_allclose(KT.cut_head_dim(b_.detach() * mul, nh, dk).numpy(),
                                   a.detach().numpy(), rtol=0, atol=1e-6)


def test_plans_cover_the_new_widths_and_refuse_the_rest():
    """``ffn.plan`` has a tiling for every (D, H, k, O) of the new widths
    within the H100's 232,448 bytes of shared memory a block (computed at
    D rounded up to 32); ``attention_train.plan`` covers every d_k from 1 to
    2048; the checks refuse even k and d_k 2056 before anything is built."""
    for D in (1, 20, 36, 40, 72, 100, 130, 200, 260, 1000):
        for H in (72, 100, 1000, 1023):
            for k in (1, 3, 9):
                for O in (1, 30, D):
                    pl = KF.plan(D, H, k, O)
                    assert pl == KF.plan(KF.padded(D), KF.padded(H), k, O)
                    assert pl.smem1 <= KF.SMEM_MAX and pl.smem2 <= KF.SMEM_MAX
                    assert pl.smem1 == KF.padded(D) * ((pl.p + k - 1) | 1) * 2 + \
                        pl.st1 * pl.nh * 128 + KF.SLACK
    x = torch.zeros(1, 8, 40)
    w1, b1, w2, b2 = torch.zeros(64, 4 * 64), torch.zeros(64), torch.zeros(40, 64), \
        torch.zeros(40)
    with pytest.raises(ValueError, match="odd k"):
        KF._check("t", x, w1.bfloat16(), b1, w2.bfloat16(), b2,
                  torch.zeros(1, dtype=torch.int32), 4, 40, 40, torch.float32)
    for dk in (1, 7, 20, 130, 132, 1023, 1024):
        for mode in ("serve", "train", "f32"):
            p = KT.plan(dk, mode)
            assert 0 < max(p.smem.values()) <= KT.SMEM_LIMIT, (dk, mode, p)
            assert p.dkp >= max(dk, 128) and p.dkp % 64 == 0
        KA.check_head_dim("t", dk)
        heads = 2 if dk <= 512 else 1  # D = heads * dk within the projections' plan
        KA._check_heads("t", heads * dk, heads)
    for dk in (0, 2056):
        with pytest.raises(ValueError, match="head dim"):
            KT.plan(dk)
        with pytest.raises(ValueError, match="d_k"):
            KA._check_heads("t", 2 * dk, 2)


def _interpret(monkeypatch):
    """Every Pallas entry the JAX model's post-LN serving route reaches,
    called with interpret=True (the HLO interpreter) instead of on a TPU."""
    for mod, names in ((jattn, ("fused_attention_packed_qkv_res_ln",)),
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
        n = rng.normal(size=shape).astype(np.float32)
        if name == "w":
            n = n / np.sqrt(max(1, int(np.prod(shape[:-1]))))
        elif name in ("g", "alpha"):
            n = 1.0 + 0.1 * n * (name == "g")
        elif name == "var":
            n = 1.0 + 0.1 * np.abs(n)
        else:
            n = 0.1 * n
        return jnp.asarray(n.astype(np.float32), leaf.dtype)

    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return tuple(jax.tree_util.tree_map_with_path(fill, t) for t in shapes)


def test_odd_width_model_matches_jax(monkeypatch):
    """A bf16 post-LN model at adim 72, ddim 260 (two heads: d_k 36 and
    130), eunits 100, dunits 72, ``small_cfg``'s depth, loaded from the JAX
    parameters: kernel 1's plain version in the decoder (d_k 130; the
    encoder's d_k 36 takes plain attention in both packages), kernel 2's in
    both stacks, the JAX model through its Pallas kernels; the mel fed the
    JAX durations in the band."""
    cfg = Config(model=ModelConfig(
        adim=72, aheads=2, elayers=1, eunits=100, ddim=260, dlayers=1, dunits=72,
        postnet_layers=2, postnet_chans=16, positionwise_conv_kernel_size=3,
        duration_predictor_chans=16, fused_attention="on"))
    _interpret(monkeypatch)
    jm = JFS(cfg)
    params, state = _random_params(jm, np.random.default_rng(0))
    params["duration_predictor"]["out"]["b"] = params["duration_predictor"]["out"]["b"] + 1.5
    tm = TFS(config_from_dict(cfg.to_dict()), device="cpu")
    load_jax_params(tm, jax.device_get(params), jax.device_get(state))
    xs = np.random.default_rng(8).integers(1, 68, (3, 32)).astype(np.int32)
    ilens = np.asarray([32, 13, 1], np.int32)
    L = 64

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
    assert sorted(calls) == [("attention_block_plain", 260), ("ffn_block_plain", 72),
                             ("ffn_block_plain", 260)], calls
    d = np.abs(ht.float().numpy() - np.asarray(hj, np.float32))
    assert d.mean() < 0.02 and d.max() < 0.2, ("encoder", d.mean(), d.max())
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert int(lt.min()) > 0
    d = np.abs(mt.float().numpy() - np.asarray(mj, np.float32))
    assert d.mean() < 0.02 and d.max() < 0.2, ("mel", d.mean(), d.max())
