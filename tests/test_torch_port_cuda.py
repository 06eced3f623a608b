"""The port's CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU (sm_90a) and nvcc; skips without them. Imports no JAX,
so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Shapes are the serving path's widths at ragged lengths: token buffers that
are multiples of 32 but not of the kernels' 64-row tiles, rows of length 1,
full rows, and tiles wholly past the length. Tolerance (bf16 tier, both
sides round at the same points): mean abs < 2e-3, max abs < 0.1.
"""

import functools
import importlib.util
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fastspeech2_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _close(got, want):
    d = (got.float() - want.float()).abs()
    assert float(d.mean()) < 2e-3 and float(d.max()) < 0.1, (float(d.mean()), float(d.max()))


def _lengths(B, T, dev, g):
    ls = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
    ls[0], ls[-1] = T, 1
    return ls.to(dev)


@pytest.mark.parametrize("B,T,D", [(3, 96, 256), (2, 160, 384), (4, 32, 256)])
def test_attention_and_ffn_blocks(dev, B, T, D):
    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    g = torch.Generator().manual_seed(B * T)
    torch.manual_seed(D)
    blk = FFTBlock(EncoderConfig(idim=D, attention_dim=D, linear_units=1024), device=dev)
    x = torch.randn(B, T, D, generator=g).to(dev)
    lens = _lengths(B, T, dev, g)
    with torch.inference_mode():
        ap, fp = blk.attn_pack(torch.bfloat16), blk.ffn_pack(torch.bfloat16)
        n0 = KA.launches
        _close(KA.attention_block(x, *ap, lens, 2), KA.attention_block_plain(x, *ap, lens, 2))
        _close(KF.ffn_block(x, *fp, lens, 9), KF.ffn_block_plain(x, *fp, lens, 9))
        torch.cuda.synchronize()
    assert KA.launches == n0 + 1


def test_two_threads_launch_one_kernel_at_two_widths(dev):
    """A server's dispatch thread runs the encoder (D=256) while its delivery
    thread runs the decoder (D=384): kernel 1's q|k|v projection and out
    projection launches get other shared-memory sizes at each width. Two
    threads call the C entry back to back (nothing of Python between the
    calls, so they overlap inside it): no launch may be refused. With a
    per-launch opt-in that could shrink, about one launch in twenty at the
    wider size came back with cudaErrorInvalidValue."""
    import math
    import threading

    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.ops.kernels import attention as KA

    torch.manual_seed(5)
    jobs, keep = [], []
    for D in (256, 384):
        blk = FFTBlock(EncoderConfig(idim=D, attention_dim=D, linear_units=1024),
                       device=dev)
        x = torch.randn(1, 32, D, device=dev)
        lens = torch.tensor([32], dtype=torch.int32, device=dev)
        with torch.inference_mode():
            ap = blk.attn_pack(torch.bfloat16)
            want = KA.attention_block(x, *ap, lens, 2)  # binds KA._fn
        qkv = torch.empty((1, 32, 3 * D), dtype=torch.bfloat16, device=dev)
        o = torch.empty((1, 32, D), dtype=torch.bfloat16, device=dev)
        out = torch.empty_like(x)
        keep.append((blk, x, lens, ap, qkv, o, out, want))
        jobs.append((x.data_ptr(), *(t.data_ptr() for t in ap), lens.data_ptr(),
                     qkv.data_ptr(), o.data_ptr(), out.data_ptr(), 1, 32, D, 2,
                     1.0 / math.sqrt(D // 2), 1e-5,
                     torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    refused = {}

    def run(args):
        refused[args[13]] = sum(1 for _ in range(50000) if KA._fn(*args))

    threads = [threading.Thread(target=run, args=(job,)) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert refused == {256: 0, 384: 0}, f"refused launches of 50000 per width: {refused}"
    for *_, out, want in keep:
        assert torch.equal(out, want)


def test_adaptor_and_postnet(dev):
    from fastspeech2_tpu_torch.models.postnet import Postnet, PostnetConfig
    from fastspeech2_tpu_torch.models.predictors import Predictor, PredictorConfig
    from fastspeech2_tpu_torch.ops.kernels import adaptor as KAd
    from fastspeech2_tpu_torch.ops.kernels import postnet as KP
    from fastspeech2_tpu_torch.ops.length_regulator import expansion_indices
    from fastspeech2_tpu_torch.ops.quantize import linear_bins, log_bins

    g = torch.Generator().manual_seed(0)
    torch.manual_seed(0)
    B, T, L, D = 3, 40, 320, 256
    preds = [Predictor(PredictorConfig(idim=D), device=dev) for _ in range(2)]
    embs = [torch.nn.Linear(256, D, device=dev) for _ in range(2)]
    hs = torch.randn(B, T, D, generator=g).to(dev)
    tok = _lengths(B, T, dev, g)
    ds = torch.randint(0, 12, (B, T), generator=g, dtype=torch.int32).to(dev)
    net = Postnet(PostnetConfig(), device=dev)
    mel = torch.randn(B, L, 80, generator=g).to(dev)
    with torch.inference_mode():
        idx, _, out_lens = expansion_indices(
            ds, torch.arange(T, device=dev)[None] < tok[:, None], L, T)
        pack = KAd.pack_weights(*preds, *embs,
                                torch.from_numpy(log_bins(71.0, 676.0)).to(dev),
                                torch.from_numpy(linear_bins(0.0, 130.0)).to(dev),
                                torch.bfloat16)
        got, graw = KAd.variance_adaptor(hs, idx, out_lens, *pack)
        want, wraw = KAd.variance_adaptor_plain(hs, idx, out_lens, *pack)
        live = torch.arange(L, device=dev)[None] < out_lens[:, None]
        assert torch.all(got[~live] == 0) and torch.all(graw[:, 0][~live] == 0)
        assert float((graw - wraw).abs().max()) < 0.5
        w, bn, hidden = KP.pack_weights(net.layers, torch.bfloat16)
        _close(KP.postnet(mel, w, bn, out_lens, 5, hidden, 5),
               KP.postnet_plain(mel, w, bn, out_lens, 5, hidden, 5))
        torch.cuda.synchronize()


def _adaptor_case(D, lens, L, dev, g, T=40, nb=256):
    """Kernel 3's inputs at width D with nb bins: seeded predictors and
    embeddings (bf16 pack), encoder states, random expansion indices and the
    given out_lens."""
    from fastspeech2_tpu_torch.models.predictors import Predictor, PredictorConfig
    from fastspeech2_tpu_torch.ops.kernels import adaptor as KAd
    from fastspeech2_tpu_torch.ops.quantize import linear_bins, log_bins

    torch.manual_seed(D)
    preds = [Predictor(PredictorConfig(idim=D), device=dev) for _ in range(2)]
    embs = [torch.nn.Linear(nb, D, device=dev) for _ in range(2)]
    with torch.no_grad():
        for p in preds:  # spread the predictions over the bins
            p.out.weight.mul_(8.0)
        preds[0].out.bias.fill_(200.0)
        preds[1].out.bias.fill_(40.0)
    B = len(lens)
    hs = torch.randn(B, T, D, generator=g).to(dev)
    idx = torch.sort(torch.randint(0, T, (B, L), generator=g, dtype=torch.int32), -1)[0]
    out_lens = torch.tensor(lens, dtype=torch.int32)
    pack = KAd.pack_weights(*preds, *embs, torch.from_numpy(log_bins(71.0, 676.0, nb)).to(dev),
                            torch.from_numpy(linear_bins(0.0, 130.0, nb)).to(dev),
                            torch.bfloat16)
    return hs, idx.to(dev), out_lens.to(dev), pack


def _hold_adaptor(got, graw, want, wraw, out_lens, pack, hs, idx, share=0.01):
    """Kernel 3 against its plain version. Every row at or past out_len
    exactly zero, raw too; raw within mean 1e-2, max 0.5; every live row
    exactly the gathered state plus the embedding rows of the buckets of
    the kernel's own raw predictions (the residual's sum order), and where
    the buckets agree within mean 2e-3, max 0.1 of the plain row. Live
    frames one bucket off (a one-ulp change in the head moves a frame across
    an edge): at most 1% at the shapes the kernel took before its widths
    were opened (D a multiple of 8 in 64-1024, at most 4,096 bins), 5% at
    other widths (the band the CPU tests hold the port to against the JAX
    kernel in bf16; a larger conv1 K flips more head steps), and past 4,096
    bins the raw band alone: there the edges lie closer than
    one bf16 step of the head's sum, so every raw difference moves a bucket
    (two reference implementations differ so in up to 1.1% of frames at
    8,192 bins, scripts/adaptor_flip_band.py)."""
    bins, emb_w, emb_b = pack[10], pack[11], pack[12]
    L, D = got.shape[1:]
    live = torch.arange(L, device=got.device)[None] < out_lens[:, None]
    assert torch.all(got[~live] == 0) and torch.all(graw[:, 0][~live] == 0)
    assert torch.all(graw[:, 1][~live] == 0)
    bk = lambda r, i: (bins[i][None, None] < r[:, i][..., None]).sum(-1)  # noqa: E731
    flip = torch.stack([bk(graw, i) != bk(wraw, i) for i in (0, 1)], 1) & live[:, None]
    same = ~flip.any(1) & live
    assert int((~same & live).sum()) <= share * int(live.sum()), int((~same & live).sum())
    d = (graw - wraw).abs()
    assert float(d.mean()) < 1e-2 and float(d.max()) < 0.5, (float(d.mean()), float(d.max()))
    e = torch.gather(hs, 1, idx.long()[..., None].expand(-1, -1, D))
    rows = (e + (emb_w[0, :, :D].float()[bk(graw, 0)] + emb_b[0, :D])) + \
        (emb_w[1, :, :D].float()[bk(graw, 1)] + emb_b[1, :D])
    assert torch.equal(torch.where(live[..., None], rows, 0), got)
    keep = same[..., None]
    _close(torch.where(keep, got, 0), torch.where(keep, want, 0))


ADAPTOR_WIDTHS = [(200, 4, 256), (256, 4, 256), (384, 4, 256), (512, 4, 256), (1024, 4, 256),
                  (256, 48, 256), (36, 4, 256), (60, 4, 256), (100, 4, 256), (1100, 4, 256),
                  (1504, 4, 256), (2048, 4, 256), (256, 4, 8192), (256, 4, 65536)]


@pytest.mark.parametrize("D,B,nb", ADAPTOR_WIDTHS,
                         ids=[f"D{d}-B{b}-nb{nb}" for d, b, nb in ADAPTOR_WIDTHS])
def test_adaptor_at_every_width(dev, D, B, nb):
    """Kernel 3 at D = 200 (not a multiple of 32 or 64: each tap zero-padded
    to the K step), 256 and 384 (128-column ring tiles), 512 (64-column
    tiles) and 1024 (one ring stage), at D = 256 over 48 batch rows (more
    blocks than SMs); at D = 36 and 60 (below 64, not multiples of 8: the
    packed weights padded to 40 and 64, the rows read a value or four at a
    time), 100 and 1100 (multiples of 4, not 8), 1504 and 2048 (the x tile
    in chunks of 512 columns, conv1 accumulated over them); at 8,192 and
    65,536 bins (the edges counted 4,096 at a time); each at an L off the
    62-frame tiles, with lengths L, 1 and 0 (a wholly dead row) and one
    inside."""
    from fastspeech2_tpu_torch.ops.kernels import adaptor as KAd

    g = torch.Generator().manual_seed(D + nb)
    L = 331
    lens = [L, 1, 0, 200] + torch.randint(0, L + 1, (B - 4,), generator=g).tolist()
    hs, idx, out_lens, pack = _adaptor_case(D, lens, L, dev, g, nb=nb)
    with torch.inference_mode():
        n0 = KAd.launches
        got, graw = KAd.variance_adaptor(hs, idx, out_lens, *pack)
        want, wraw = KAd.variance_adaptor_plain(hs, idx, out_lens, *pack)
        torch.cuda.synchronize()
    assert KAd.launches == n0 + 1
    first_range = D % 8 == 0 and 64 <= D <= 1024
    _hold_adaptor(got, graw, want, wraw, out_lens, pack, hs, idx,
                  share=(0.01 if first_range else 0.05) if nb <= 4096 else 1.0)


def _postnet_case(C, C0, k, n, dev, g):
    """Kernel 4's weights at (C, C0, k, n): a seeded Postnet with random
    BatchNorm statistics, packed in bf16."""
    from fastspeech2_tpu_torch.models.postnet import Postnet, PostnetConfig
    from fastspeech2_tpu_torch.ops.kernels import postnet as KP

    torch.manual_seed(C + C0 + k)
    net = Postnet(PostnetConfig(odim=C0, n_layers=n, n_chans=C, n_filts=k), device=dev)
    with torch.no_grad():
        for layer in net.layers:
            c = layer.bn.running_mean.shape[0]
            layer.bn.running_mean.copy_(0.1 * torch.randn(c, generator=g))
            layer.bn.running_var.copy_(1.0 + torch.rand(c, generator=g))
            layer.bn.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=g))
            layer.bn.bias.copy_(0.1 * torch.randn(c, generator=g))
    return net, KP.pack_weights(net.layers, torch.bfloat16)


POSTNET_WIDTHS = [(256, 80, 5, 5), (512, 80, 5, 5), (200, 88, 7, 5), (256, 128, 9, 5),
                  (512, 80, 9, 8), (500, 100, 5, 5), (256, 100, 5, 1), (256, 80, 11, 5),
                  (256, 80, 31, 3), (256, 80, 5, 12), (300, 80, 11, 10), (20, 3, 7, 4),
                  (1024, 80, 5, 5), (768, 513, 11, 10), (1024, 1024, 5, 2), (600, 300, 31, 3)]


@pytest.mark.parametrize("C,C0,k,n", POSTNET_WIDTHS,
                         ids=[f"C{c}-C0{c0}-k{k}-n{n}" for c, c0, k, n in POSTNET_WIDTHS])
def test_postnet_at_every_width(dev, C, C0, k, n):
    """Kernel 4 at the default width, the Tacotron-2 / ESPnet2 width (C =
    512: 64-row stages, the warpgroups splitting the columns), C = 200 and
    C0 = 88 (not multiples of 32) at k = 7, k = 9 with C0 = 128, and 8
    layers of k = 9 at C = 512 (two launches through a bf16 plane); C = 500
    with 100 mels (not multiples of 8), one layer (C0 -> C0), k = 11 and 31
    in one launch, 12 layers, 10 layers of k = 11 at C = 300 (three launches:
    two planes in turn), C = 20 with 3 mels (a mel read and written a value
    at a time); the wide path, one launch a stage: C = 1024, (768, 513) at
    k = 11 over 10 layers, (1024, 1024), (600, 300) at k = 31; each at an L
    off every tile, with lengths L, 1 and 0 and one inside: within mean
    2e-3, max 0.1 of the plain version, and every row past len + halo the
    last stage's BatchNorm of zero, bit for bit."""
    from fastspeech2_tpu_torch.ops.kernels import postnet as KP

    g = torch.Generator().manual_seed(C + k)
    _, (w, bn, hidden) = _postnet_case(C, C0, k, n, dev, g)
    L = 301
    lens = torch.tensor([L, 1, 0, 150], dtype=torch.int32, device=dev)
    mel = torch.randn(4, L, C0, generator=g).to(dev)
    with torch.inference_mode():
        n0 = KP.launches
        got = KP.postnet(mel, w, bn, lens, n, hidden, k)
        want = KP.postnet_plain(mel, w, bn, lens, n, hidden, k)
        torch.cuda.synchronize()
    assert KP.launches == n0 + 1
    _close(got, want)
    s = bn[n - 1, :, :C0]
    dead = ((0.0 - s[0]) * s[1]) * s[2] + s[3]
    halo = n * (k - 1) // 2
    for b, m in enumerate(lens.tolist()):
        if m + halo < L:
            assert torch.equal(got[b, m + halo:], dead.expand(L - m - halo, C0)), b


def test_adaptor_and_postnet_plans_of_the_c_side_are_the_python_ones(dev):
    """csrc/adaptor.cu:ad_make_plan and csrc/postnet.cu:pn_make_plan pick
    the tilings of ops/kernels/{adaptor,postnet}.py:plan (the CPU tests
    hold the Python ones), and refuse the same shapes, over a grid that
    samples the ranges and their edges."""
    from fastspeech2_tpu_torch.ops.kernels import adaptor as KAd
    from fastspeech2_tpu_torch.ops.kernels import postnet as KP

    for D in list(range(0, 2064, 8)) + [1, 7, 36, 60, 100, 1100, 1148, 1150, 1153, 2047, 2049]:
        for NB in (0, 1, 16, 255, 256, 1024, 4096, 4097, 8192, 65536, 65537):
            try:
                want = KAd.plan(D, NB)
            except ValueError:
                with pytest.raises(ValueError):
                    KAd.c_plan(D, NB)
                continue
            assert KAd.c_plan(D, NB) == want, (D, NB)
    for C in (0, 1, 8, 20, 40, 128, 200, 256, 264, 300, 500, 512, 520, 768, 1024, 1025):
        for C0 in (0, 1, 3, 8, 80, 88, 100, 128, 136, 256, 264, 513, 1024, 1025):
            for k in (1, 3, 4, 5, 7, 9, 11, 21, 31, 33):
                for n in (0, 1, 2, 5, 8, 9, 10, 32, 33):
                    try:
                        want = KP.plan(C0, C, k, n)
                    except ValueError:
                        with pytest.raises(ValueError):
                            KP.c_plan(C0, C, k, n)
                        continue
                    assert KP.c_plan(C0, C, k, n) == want, (C0, C, k, n)


def test_adaptor_and_postnet_refuse_what_they_do_not_take(dev):
    """A CUDA shape outside the kernels' range raises ValueError that names
    the bound, and nothing falls back to the plain version: the adaptor at
    D = 2056 (past 2048) and at C = 128 (the predictors' width is 256), the
    postnet at C = 1032 (past 1024) and at k = 33 (past 31)."""
    from fastspeech2_tpu_torch.ops.kernels import adaptor as KAd
    from fastspeech2_tpu_torch.ops.kernels import postnet as KP

    n = (KAd.launches, KP.launches)
    B, T, L, NB = 2, 8, 16, 16
    bf = torch.bfloat16
    idx = torch.zeros(B, L, dtype=torch.int32, device=dev)
    lens = torch.full((B,), L, dtype=torch.int32, device=dev)
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device=dev)  # noqa: E731
    for d, c, bound in ((2056, 256, "D from 1 to 2048"), (64, 128, "C = 256")):
        with pytest.raises(ValueError, match=bound):
            KAd.variance_adaptor(z(B, T, d), idx, lens, z(2, c, 3 * d, dt=bf), z(2, c), z(2, c),
                                 z(2, c), z(2, c, 3 * c, dt=bf), z(2, c), z(2, c), z(2, c),
                                 z(2, c, dt=bf), z(2), z(2, NB), z(2, NB, d, dt=bf), z(2, d))
    for C0, C, k, bound in ((80, 1032, 5, "C and C0 from 1 to 1024"),
                            (80, 256, 33, "odd k up to 31")):
        with pytest.raises(ValueError, match=bound):
            KP.postnet(z(B, L, C0), z(64, dt=bf), z(3, 4, KP.bn_width(C0, C)), lens, 3, C, k)
    assert (KAd.launches, KP.launches) == n


def test_adaptor_and_postnet_use_wgmma_and_do_not_spill(dev):
    """adaptor's and postnet's libraries hold no mma.sync kernel: kernel 3
    at its three tilings (two ring-tile widths, and the x tile in chunks)
    and kernel 4 at its nine chain kernels (row tiling, hidden and last
    widths) and the wide path's stage kernel show HGMMA and no HMMA in their
    SASS, no ptxas spills, and no ptxas note that it serialized a wgmma."""
    import re
    import shutil
    import subprocess

    from fastspeech2_tpu_torch.ops.kernels import common

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib, kinds, want in (("adaptor", ("adaptor_kernel",), 3),
                             ("postnet", ("postnet_kernel", "postnet_wide_kernel"), 10)):
        common.load(lib)
        log = common.ptxas_report(lib)
        assert "serialized" not in log, lib
        funcs = dict((f[0], f[1:]) for f in re.findall(
            r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
            r"(\d+) bytes spill loads", log, re.S))
        sass = subprocess.run([cuobjdump, "-sass", str(common._lib_path(lib))],
                              check=True, capture_output=True, text=True).stdout
        seen = 0
        for part in sass.split("Function : ")[1:]:
            name = part.split()[0]
            assert "HMMA" not in part.replace("HGMMA", ""), name
            if any(k in name for k in kinds):
                seen += 1
                assert "HGMMA" in part and funcs.get(name) == ("0", "0"), name
        assert seen == want, (lib, seen)


def test_two_threads_launch_the_postnet_at_two_widths(dev):
    """The postnet kernel at C = 256 (128-row stages) and C = 512 (64-row
    stages) gets other shared-memory sizes: two threads call the C entry
    back to back, and no launch may be refused; each width's output stays
    what one thread alone gave."""
    import threading

    from fastspeech2_tpu_torch.ops.kernels import postnet as KP

    g = torch.Generator().manual_seed(8)
    jobs, keep = [], []
    for C in (256, 512):
        net, (w, bn, hidden) = _postnet_case(C, 80, 5, 5, dev, g)
        x = torch.randn(1, 96, 80, generator=g).to(dev)
        lens = torch.tensor([70], dtype=torch.int32, device=dev)
        with torch.inference_mode():
            want = KP.postnet(x, w, bn, lens, 5, hidden, 5)  # binds KP._fn
        out = torch.empty_like(x)
        keep.append((net, x, lens, w, bn, out, want))
        jobs.append((x.data_ptr(), w.data_ptr(), bn.data_ptr(), lens.data_ptr(), out.data_ptr(),
                     None, 1, 96, 80, C, 5, 5, bn.shape[2],
                     torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    refused = {}

    def run(args):
        refused[args[9]] = sum(1 for _ in range(5000) if KP._fn(*args))

    threads = [threading.Thread(target=run, args=(job,)) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert refused == {256: 0, 512: 0}, f"refused launches of 5000 per width: {refused}"
    for *_, out, want in keep:
        assert torch.equal(out, want)


def test_two_threads_launch_the_new_tilings_at_two_sizes(dev):
    """The wide postnet's stage kernel at k = 5 and k = 31 (x tiles of 133
    and 159 rows) and the adaptor's chunked-x kernel at 256 and 4,096 bins
    get other shared-memory sizes: two threads call each C entry back to
    back, and no launch may be refused; each size's output stays what one
    thread alone gave."""
    import threading

    from fastspeech2_tpu_torch.ops.kernels import adaptor as KAd
    from fastspeech2_tpu_torch.ops.kernels import postnet as KP

    g = torch.Generator().manual_seed(9)
    stream = torch.cuda.current_stream().cuda_stream
    jobs, keep = [], []
    for k in (5, 31):
        net, (w, bn, hidden) = _postnet_case(1024, 80, k, 2, dev, g)
        x = torch.randn(1, 160, 80, generator=g).to(dev)
        lens = torch.tensor([150], dtype=torch.int32, device=dev)
        with torch.inference_mode():
            want = KP.postnet(x, w, bn, lens, 2, hidden, k)  # binds KP._fn
        out, plane = torch.empty_like(x), torch.empty(160 * 1024, dtype=torch.bfloat16,
                                                      device=dev)
        keep.append((net, x, lens, w, bn, plane, out, want))
        jobs.append((KP._fn, (x.data_ptr(), w.data_ptr(), bn.data_ptr(), lens.data_ptr(),
                              out.data_ptr(), plane.data_ptr(), 1, 160, 80, 1024, 2, k,
                              bn.shape[2], stream)))
    for nb in (256, 4096):
        hs, idx, out_lens, pack = _adaptor_case(1504, [100], 100, dev, g, nb=nb)
        with torch.inference_mode():
            want = KAd.variance_adaptor(hs, idx, out_lens, *pack)[0]  # binds KAd._fn
        out, raw = torch.empty_like(want), torch.empty(1, 2, 100, device=dev)
        keep.append((hs, idx, out_lens, pack, raw, out, want))
        jobs.append((KAd._fn, tuple(t.data_ptr() for t in (hs, idx, out_lens, *pack, out, raw))
                     + (1, 40, 100, 1504, 256, nb, KAd.LN_EPS, stream)))
    torch.cuda.synchronize()
    refused = [0] * len(jobs)

    def run(i, fn, args):
        refused[i] = sum(1 for _ in range(1000) if fn(*args))

    for lo in (0, 2):
        threads = [threading.Thread(target=run, args=(i, *jobs[i])) for i in (lo, lo + 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    torch.cuda.synchronize()
    assert refused == [0] * len(jobs), f"refused launches of 1000 per size: {refused}"
    for *_, out, want in keep:
        assert torch.equal(out, want)


def test_wrapper_rejects_bad_inputs(dev):
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    x = torch.randn(2, 32, 256, device=dev)
    w1 = torch.zeros(1024, 9 * 256, device=dev)  # f32, the kernel takes bf16
    with pytest.raises(ValueError, match="dtype"):
        KF.ffn_block(x, w1, torch.zeros(1024, device=dev), w1[:256, :1024], x[0, 0],
                     x[0, 0], x[0, 0], torch.ones(2, dtype=torch.int32, device=dev), 9)


def _stage(C, dev, cd, g, scale=1.0):
    """Kernel-layout weights of one MelGAN stage at width C, from a seed."""
    from fastspeech2_tpu_torch.ops.precision import round_to

    bound = scale / (3 * C) ** 0.5
    w1 = ((torch.rand(3, C, 3 * C, generator=g) * 2 - 1) * bound).to(cd)
    w2 = ((torch.rand(3, C, C, generator=g) * 2 - 1) * scale / C ** 0.5).to(cd)
    b1, b2 = (round_to((torch.rand(3, C, generator=g) * 2 - 1) * bound, cd)
              for _ in range(2))
    return [t.to(dev).contiguous() for t in (w1, b1, w2, b2)]


@pytest.mark.parametrize("B,S,C", [(2, 2048, 256), (2, 4096, 128), (3, 2048, 64),
                                   (2, 6144, 32), (1, 128, 64), (2, 2048, 48),
                                   (2, 1024, 96), (1, 512, 160), (2, 640, 16),
                                   (1, 384, 256), (2, 256, 24), (1, 256, 200)])
def test_resstack_bf16(dev, B, S, C):
    """bf16 kernel vs its plain version: single-tile and multi-tile lengths,
    first and last tile (reflection) included; every kind of width: two
    hidden chunks (C > 128), one, and two row chunks a warpgroup (C <= 32);
    S = 384 and 640 are tileable but no multiple of the kernel's time tile
    (102 rows at C = 256, 230 at C = 16); C = 24 and 200 are zero-padded to
    32 and 224. Tolerance relative to the plain output's scale: both sides
    round at the same points, so they differ by accumulation order only:
    max < 2^-6 (two bf16 ulps of the largest values), mean < 1e-4."""
    from fastspeech2_tpu_torch.ops.kernels import resstack as KR

    g = torch.Generator().manual_seed(S + C)
    ws = _stage(C, dev, torch.bfloat16, g)
    x = torch.randn(B, S, C, generator=g).to(torch.bfloat16).to(dev)
    n0 = KR.launches
    got = KR.resstack(x, *ws)
    want = KR.resstack_plain(x, *ws)
    torch.cuda.synchronize()
    assert KR.launches == n0 + 1 and got.dtype == torch.bfloat16
    d = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    assert float(d.max()) < 2.0 ** -6 * scale and float(d.mean()) < 1e-4 * scale, (
        float(d.max()), float(d.mean()), scale)
    for sl in (slice(0, 16), slice(S - 16, S)):  # the reflected ends
        assert float(d[:, sl].max()) < 2.0 ** -6 * scale


@pytest.mark.parametrize("B,S,C", [(2, 1024, 64), (1, 256, 256), (2, 128, 32)])
def test_resstack_f32(dev, B, S, C):
    """f32 kernel vs its plain version: 1e-5 of the output's scale (f32
    sums in another order; no TF32, no fused multiply-add)."""
    from fastspeech2_tpu_torch.ops.kernels import resstack as KR

    g = torch.Generator().manual_seed(S + C)
    ws = _stage(C, dev, torch.float32, g)
    x = torch.randn(B, S, C, generator=g).to(dev)
    got = KR.resstack(x, *ws)
    want = KR.resstack_plain(x, *ws)
    torch.cuda.synchronize()
    d = (got - want).abs()
    assert float(d.max()) < 1e-5 * float(want.abs().max()), float(d.max())


@pytest.mark.parametrize("B,S,C,dil", [(2, 2048, 512, (1, 3, 9)), (1, 1024, 1024, (1, 3, 9)),
                                       (2, 640, 320, (1, 3, 9, 27)), (1, 256, 500, (1, 3, 9)),
                                       (1, 384, 768, (2, 5, 64))])
def test_resstack_bf16_wide(dev, B, S, C, dil):
    """The wide path (C above 256: two launches a dilated block, the hidden
    through device memory) vs the plain version: the first stage of a
    ``base_channels: 1024`` generator (512), 1024, 320 with four
    dilations, 500 (zero-padded to 504), and a dilation of 64 (its z tile in
    128-column chunks). Tolerance as for the narrow kernel."""
    from fastspeech2_tpu_torch.ops.kernels import resstack as KR

    g = torch.Generator().manual_seed(S + C)
    ws = _stage_n(C, dev, torch.bfloat16, g, len(dil))
    x = torch.randn(B, S, C, generator=g).to(torch.bfloat16).to(dev)
    n0 = KR.launches
    got = KR.resstack(x, *ws, dil)
    want = KR.resstack_plain(x, *ws, dil)
    torch.cuda.synchronize()
    assert KR.launches == n0 + 2 * len(dil) and got.dtype == torch.bfloat16
    d = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    assert float(d.max()) < 2.0 ** -6 * scale and float(d.mean()) < 1e-4 * scale, (
        float(d.max()), float(d.mean()), scale)
    for sl in (slice(0, 16), slice(S - 16, S)):  # the reflected ends
        assert float(d[:, sl].max()) < 2.0 ** -6 * scale


@pytest.mark.parametrize("B,S,C,dil", [(1, 512, 320, (1, 3, 9)), (1, 256, 1024, (1, 3, 9, 27)),
                                       (2, 256, 125, (1, 3, 9)), (1, 128, 250, (1, 3, 9))])
def test_resstack_f32_any_width(dev, B, S, C, dil):
    """f32 past the f32 kernel's first range: the wide path at 320 and 1024
    (two launches a block), and 125 and 250, zero-padded to 128 and 256.
    1e-5 of the output's scale, as for the f32 kernel."""
    from fastspeech2_tpu_torch.ops.kernels import resstack as KR

    g = torch.Generator().manual_seed(S + C)
    ws = _stage_n(C, dev, torch.float32, g, len(dil))
    x = torch.randn(B, S, C, generator=g).to(dev)
    n0 = KR.launches
    got = KR.resstack(x, *ws, dil)
    want = KR.resstack_plain(x, *ws, dil)
    torch.cuda.synchronize()
    assert KR.launches == n0 + (2 * len(dil) if C > 256 else 1)
    d = (got - want).abs()
    assert float(d.max()) < 1e-5 * float(want.abs().max()), float(d.max())


def _stage_n(C, dev, cd, g, n):
    """``_stage`` with n dilated blocks."""
    from fastspeech2_tpu_torch.ops.precision import round_to

    bound = 1.0 / (3 * C) ** 0.5
    w1 = ((torch.rand(n, C, 3 * C, generator=g) * 2 - 1) * bound).to(cd)
    w2 = ((torch.rand(n, C, C, generator=g) * 2 - 1) / C ** 0.5).to(cd)
    b1, b2 = (round_to((torch.rand(n, C, generator=g) * 2 - 1) * bound, cd)
              for _ in range(2))
    return [t.to(dev).contiguous() for t in (w1, b1, w2, b2)]


def test_resstack_rejects_bad_inputs(dev):
    from fastspeech2_tpu_torch.ops.kernels import resstack as KR

    g = torch.Generator().manual_seed(0)
    ws = _stage(64, dev, torch.bfloat16, g)
    x = torch.zeros(1, 2048, 64, device=dev)  # f32 activation, bf16 weights
    with pytest.raises(ValueError, match="dtype"):
        KR.resstack(x, *ws)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="halo"):
        KR.resstack(xb[:, :13], *ws)
    with pytest.raises(ValueError, match="multiple"):
        KR.resstack(xb[:, :2000].contiguous(), *ws)
    with pytest.raises(ValueError, match="C=1032"):
        KR.resstack(torch.zeros(1, 2048, 1032, dtype=torch.bfloat16, device=dev),
                    *_stage(1032, dev, torch.bfloat16, g))


@pytest.mark.parametrize("B,T,D", [(3, 96, 256), (2, 160, 384)])
def test_attention_res_ln(dev, B, T, D):
    """The q/k/v-given entry vs its plain version and vs the fused-QKV
    kernel, on separate q/k/v tensors and on column blocks of one buffer
    (those two bit for bit)."""
    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.ops import nn
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.precision import compute_dtype

    g = torch.Generator().manual_seed(B * T)
    torch.manual_seed(D)
    blk = FFTBlock(EncoderConfig(idim=D, attention_dim=D, linear_units=1024), device=dev)
    x = torch.randn(B, T, D, generator=g).to(dev)
    lens = _lengths(B, T, dev, g)
    with torch.inference_mode(), compute_dtype(torch.bfloat16):
        ap = blk.attn_pack(torch.bfloat16)
        q, k, v = (nn.linear(x, p.weight, p.bias, out_dtype=torch.bfloat16)
                   for p in (blk.attn.q, blk.attn.k, blk.attn.v))
        n0 = KA.res_ln_launches
        got = KA.attention_res_ln(q, k, v, x, *ap[2:], lens, 2)
        _close(got, KA.attention_res_ln_plain(q, k, v, x, *ap[2:], lens, 2))
        qkv = torch.cat([q, k, v], dim=-1)
        packed = KA.attention_res_ln(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:],
                                     x, *ap[2:], lens, 2)
        fused = KA.attention_block(x, *ap, lens, 2)
        torch.cuda.synchronize()
    assert KA.res_ln_launches == n0 + 2
    assert torch.equal(got, packed)
    # the projections are a cuBLAS f32 product here and a tensor-core product
    # in the fused kernel: q/k/v may differ by rare one-ulp flips, which reach
    # many outputs through the softmax and the LayerNorm, so the two kernels
    # are held to the band, not to the bits
    _close(got, fused)
    # (no-grad: the serving kernels refuse inputs that autograd would record,
    # and the packed LayerNorm weights are the parameters themselves)
    with torch.no_grad(), pytest.raises(ValueError, match="bfloat16"):
        KA.attention_res_ln(q.float(), k, v, x, *ap[2:], lens, 2)


# (B, T, D, heads): d_k 128, 192 and 256 (one head and two), T off the 64-
# and 128-row tiles; D = 768 takes the q|k|v projection's 64-row tiling and
# the out projection's two column passes with its LayerNorm launch
HALF_CASES = [(4, 100, 256, 2), (3, 200, 384, 2), (4, 130, 256, 1), (3, 72, 512, 2),
              (3, 96, 768, 3), (3, 100, 320, 2), (2, 150, 384, 1), (2, 70, 1024, 1),
              # any D, d_k no multiple of 8 (heads laid out dkp apart, zero-padded):
              # d_k 130 at D = 260 and 390, 100 at D = 200, 20 at D = 40, 132 at 264
              (2, 100, 260, 2), (2, 70, 390, 3), (3, 72, 200, 2), (3, 64, 40, 2),
              (2, 90, 264, 2)]


@pytest.mark.parametrize("B,T,D,H", HALF_CASES,
                         ids=[f"T{t}-D{d}-dk{d // h}" for _, t, d, h in HALF_CASES])
def test_attention_halves_at_every_head_dim(dev, B, T, D, H):
    """Kernels 1, 5 and 6 against their plain versions at d_k 128, 192,
    256, 160 (two heads: a column past d_k is the next head's), 384 and 1024
    (column parts) with lengths T, 1, 0 and random: 5 and 6 on q/k/v column blocks of
    one (B, T, 3D) buffer rounded as kernel 1 rounds them, kernel 1 against
    kernel 5 on the same x (the band: a cuBLAS f32 product and a tensor-core
    one flip rare q/k/v ulps). Rows at or past each length bit for bit: res
    + bo (6), and for 1 and 5 what kernel 5 gives at length 0 on the same
    residual, itself within 1e-5 of the plain LN(res + bo)."""
    from fastspeech2_tpu_torch.ops import nn
    from fastspeech2_tpu_torch.ops.kernels import attention as KA

    g = torch.Generator().manual_seed(B * T + D + H)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(dev)

    x = rnd(B, T, D, scale=2.0) + 0.5
    wqkv, wo = (rnd(3 * D, D) / D ** 0.5).to(bf), (rnd(D, D) / D ** 0.5).to(bf)
    bqkv, bo = rnd(3 * D, scale=0.1), rnd(D, scale=0.1)
    ln_g, ln_b = 1.0 + rnd(D, scale=0.2), rnd(D, scale=0.1)
    lens = _lengths_0_1(B, T, dev, g)
    with torch.inference_mode():
        n = (KA.launches, KA.res_ln_launches, KA.res_launches)
        got1 = KA.attention_block(x, wqkv, bqkv, wo, bo, ln_g, ln_b, lens, H)
        want1 = KA.attention_block_plain(x, wqkv, bqkv, wo, bo, ln_g, ln_b, lens, H)
        qkv = (x.to(bf).float() @ wqkv.float().t()).to(bf).float().add(bqkv).to(bf)
        q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        got5 = KA.attention_res_ln(q, k, v, x, wo, bo, ln_g, ln_b, lens, H)
        want5 = KA.attention_res_ln_plain(q, k, v, x, wo, bo, ln_g, ln_b, lens, H)
        got6 = KA.attention_res(q, k, v, x, wo, bo, lens, H)
        want6 = KA.attention_res_plain(q, k, v, x, wo, bo, lens, H)
        dead = KA.attention_res_ln(q, k, v, x, wo, bo, ln_g, ln_b, torch.zeros_like(lens), H)
        torch.cuda.synchronize()
    assert (KA.launches, KA.res_ln_launches, KA.res_launches) == (n[0] + 1, n[1] + 2, n[2] + 1)
    for got, want in ((got1, want1), (got5, want5), (got6, want6), (got1, got5)):
        _close(got, want)
    assert float((dead - nn.layer_norm(x + bo, ln_g, ln_b)).abs().max()) < 1e-5
    for b, m in enumerate(lens.tolist()):
        assert torch.equal(got6[b, m:], x[b, m:] + bo), b
        assert torch.equal(got1[b, m:], dead[b, m:]), b
        assert torch.equal(got5[b, m:], dead[b, m:]), b


def test_attention_half_kernels_use_wgmma_and_do_not_spill(dev):
    """attention's library holds no mma.sync kernel: beside the SERVE
    forward, the q|k|v projection (launch 1 of ffn_body.cuh at both
    tilings) and the out projection (its launch 2, with and without the
    LayerNorm, at four widths) show HGMMA and no HMMA in their SASS, and no
    ptxas spills; no ptxas note that it serialized a wgmma."""
    import re
    import shutil
    import subprocess

    from fastspeech2_tpu_torch.ops.kernels import common

    common.load("attention")
    log = common.ptxas_report("attention")
    assert "serialized" not in log
    funcs = dict((f[0], f[1:]) for f in re.findall(
        r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, (\d+) bytes spill loads",
        log, re.S))
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(common._lib_path("attention"))],
                          check=True, capture_output=True, text=True).stdout
    seen = {"ffn_conv_kernel": 0, "ffn_out_kernel": 0}
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        assert "HMMA" not in part.replace("HGMMA", ""), name
        kind = next((k for k in seen if k in name), None)
        if kind:
            seen[kind] += 1
            assert "HGMMA" in part and funcs.get(name) == ("0", "0"), name
    assert seen == {"ffn_conv_kernel": 2, "ffn_out_kernel": 8}, seen


@pytest.mark.parametrize("packed", [True, False], ids=["kernel11_packed", "kernel12"])
@pytest.mark.parametrize("B,T,D,rate", [(3, 96, 256, 0.2), (2, 160, 384, 0.2),
                                        (2, 200, 384, 0.0), (4, 40, 256, 0.5)])
def test_attention_train_forward_and_backward(dev, packed, B, T, D, rate):
    """Kernels 11 and 12 against the plain version's autograd: output and dQ,
    dK, dV for a random dO, at lengths that are no multiple of the 64-row
    tiles, with a full row, a row of length 1 and dead tiles; a seed past
    2^31; padded rows exactly zero. Band: both sides round at the same
    points, the summation order differs: max < 2^-6 (two bf16 steps at the
    peak), mean < 1e-4 of the plain result's peak. dO arrives non-contiguous and in f32, as autograd may hand
    it over."""
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT

    H, dk = 2, D // 2
    g = torch.Generator().manual_seed(B * T + D)
    lens = _lengths(B, T, dev, g)
    shape = (B, T, D) if packed else (B, H, T, dk)
    q, k, v = (torch.randn(shape, generator=g).bfloat16().to(dev).requires_grad_()
               for _ in range(3))
    do = torch.randn(shape[:-1] + (2 * shape[-1],), generator=g).to(dev)[..., ::2]
    assert not do.is_contiguous() and do.dtype == torch.float32
    seed = 2 ** 31 + 12345
    if packed:
        kern = KT.fused_attention_train_packed(q, k, v, lens, seed, H, rate)
        plain = KT.attention_train_plain(q, k, v, lens, seed, rate, H)
    else:
        kern = KT.fused_attention_train(q, k, v, lens, seed, rate)
        plain = KT.attention_train_plain(q, k, v, lens, seed, rate)
    n0 = KT.packed_bwd_launches + KT.bwd_launches
    got = (kern, *torch.autograd.grad(kern, (q, k, v), do))
    want = (plain, *torch.autograd.grad(plain, (q, k, v), do.bfloat16()))
    torch.cuda.synchronize()
    assert KT.packed_bwd_launches + KT.bwd_launches == n0 + 1
    pad = torch.arange(T, device=dev)[None] >= lens[:, None]
    pad = pad[:, :, None] if packed else pad[:, None, :, None]
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        assert float(torch.where(pad, a.detach().float().abs(), 0.0).max()) == 0.0, name
        d, peak = (a.float() - b.float()).abs(), float(b.float().abs().max())
        assert float(d.max()) < 2.0 ** -6 * peak and float(d.mean()) < 1e-4 * peak, (
            name, float(d.max()), float(d.mean()), peak)


@pytest.mark.parametrize("packed", [True, False], ids=["kernel11_packed", "kernel12"])
@pytest.mark.parametrize("B,T,D,rate", [(2, 100, 256, 0.2), (2, 70, 384, 0.0),
                                        (2, 90, 320, 0.2), (2, 60, 768, 0.2)])
def test_attention_train_f32(dev, packed, B, T, D, rate):
    """The f32 instantiation (plain multiply-adds, no TF32) against the plain
    version's autograd in full f32: 2e-5 of each result's peak (other
    summation order, expf against torch's exp); padded rows exactly zero."""
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT

    H, dk = 2, D // 2
    g = torch.Generator().manual_seed(T + D)
    lens = _lengths(B, T, dev, g)
    shape = (B, T, D) if packed else (B, H, T, dk)
    q, k, v = (torch.randn(shape, generator=g).to(dev).requires_grad_() for _ in range(3))
    do = torch.randn(shape, generator=g).to(dev)
    seed = 2 ** 32 - 3
    if packed:
        kern = KT.fused_attention_train_packed(q, k, v, lens, seed, H, rate)
        plain = KT.attention_train_plain(q, k, v, lens, seed, rate, H)
    else:
        kern = KT.fused_attention_train(q, k, v, lens, seed, rate)
        plain = KT.attention_train_plain(q, k, v, lens, seed, rate)
    got = (kern, *torch.autograd.grad(kern, (q, k, v), do))
    want = (plain, *torch.autograd.grad(plain, (q, k, v), do))
    torch.cuda.synchronize()
    pad = torch.arange(T, device=dev)[None] >= lens[:, None]
    pad = pad[:, :, None] if packed else pad[:, None, :, None]
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert float(torch.where(pad, a.detach().abs(), 0.0).max()) == 0.0, name
        d, peak = (a - b).detach().abs(), float(b.detach().abs().max())
        assert float(d.max()) < 2e-5 * peak, (name, float(d.max()), peak)


def test_attention_train_layouts_draw_the_same_mask(dev):
    """The packed and the (B, H, T, dk) entries agree bit for bit on the same
    values: one kernel body, the same (seed, b, h) mask."""
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT

    B, T, H, dk = 2, 130, 2, 128
    g = torch.Generator().manual_seed(7)
    lens = _lengths(B, T, dev, g)
    q4, k4, v4, do4 = (torch.randn(B, H, T, dk, generator=g).bfloat16().to(dev)
                       for _ in range(4))
    pack = lambda t: t.transpose(1, 2).reshape(B, T, H * dk).contiguous()  # noqa: E731
    a = [t.clone().requires_grad_() for t in (q4, k4, v4)]
    b = [pack(t).requires_grad_() for t in (q4, k4, v4)]
    oa = KT.fused_attention_train(*a, lens, 99, 0.3)
    ob = KT.fused_attention_train_packed(*b, lens, 99, H, 0.3)
    ga = torch.autograd.grad(oa, a, do4)
    gb = torch.autograd.grad(ob, b, pack(do4))
    for x, y in zip((oa, *ga), (ob, *gb)):
        assert torch.equal(pack(x), y)


def test_attention_train_rejects_what_it_does_not_cover(dev):
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT

    lens = torch.tensor([8, 3], dtype=torch.int32, device=dev)
    q = torch.randn(2, 8, 256, device=dev)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        KT.fused_attention_train_packed(q.half(), q.half(), q.half(), lens, 1, 2, 0.0)
    qb = q.bfloat16()
    q1032 = torch.randn(2, 8, 2064, device=dev).bfloat16()
    with pytest.raises(ValueError, match="head dim"):  # d_k 1032: past 1024
        KT.fused_attention_train_packed(q1032, q1032, q1032, lens, 1, 2, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        KT.fused_attention_train_packed(qb, qb.transpose(0, 1).contiguous().transpose(0, 1),
                                        qb, lens, 1, 2, 0.0)
    with pytest.raises(ValueError, match="lengths"):
        KT.fused_attention_train_packed(qb, qb, qb, lens.long(), 1, 2, 0.0)
    a, b, c = qb.clone().requires_grad_(), qb.clone().requires_grad_(), qb.clone()
    o = KT.fused_attention_train_packed(a, b, c, lens, 1, 2, 0.0)
    with pytest.raises(RuntimeError, match="all three"):
        o.sum().backward()


def _train_attention_pair(KT, packed, B, H, T, dk, rate, seed, g, dev):
    """Kernel and plain version of one entry on the same bf16 inputs: (o, dq,
    dk, dv) of each, and the padded-row mask of the layout."""
    lens = _lengths(B, T, dev, g)
    shape = (B, T, H * dk) if packed else (B, H, T, dk)
    q, k, v = (torch.randn(shape, generator=g).bfloat16().to(dev).requires_grad_()
               for _ in range(3))
    do = torch.randn(shape, generator=g).bfloat16().to(dev)
    if packed:
        kern = lambda: KT.fused_attention_train_packed(q, k, v, lens, seed, H, rate)  # noqa: E731
        plain = KT.attention_train_plain(q, k, v, lens, seed, rate, H)
    else:
        kern = lambda: KT.fused_attention_train(q, k, v, lens, seed, rate)  # noqa: E731
        plain = KT.attention_train_plain(q, k, v, lens, seed, rate)
    o = kern()
    got = (o, *torch.autograd.grad(o, (q, k, v), do))
    o2 = kern()
    again = (o2, *torch.autograd.grad(o2, (q, k, v), do))
    want = (plain, *torch.autograd.grad(plain, (q, k, v), do))
    torch.cuda.synchronize()
    pad = torch.arange(T, device=dev)[None] >= lens[:, None]
    return got, again, want, (pad[:, :, None] if packed else pad[:, None, :, None])


@pytest.mark.parametrize("packed,B,H,T,dk,rate", [
    (False, 2, 2, 1024, 128, 0.2),   # kernel 12 at MAX_T: 16 key tiles turn the ring over
    (True, 2, 2, 896, 192, 0.2),     # kernel 11 at PACKED_MAX_T
    (True, 4, 2, 128, 128, 0.2),     # B * H far below the SM count: the key split
    (False, 3, 2, 128, 192, 0.0),
    (True, 2, 1, 200, 256, 0.2),     # d_k 256, one head: (2, 200, 256)
    (False, 2, 1, 200, 256, 0.0),
    (True, 2, 2, 160, 256, 0.2),     # d_k 256, two heads: (2, 160, 512)
    (False, 2, 2, 160, 256, 0.2),
    (True, 16, 2, 640, 192, 0.2),    # B * H * ceil(T / 128) >= the SM count: the row split
    (False, 16, 2, 1024, 256, 0.2),  # the row split at d_k 256 (the dQ launch splits keys)
    (True, 3, 2, 150, 160, 0.2),     # d_k 160 padded to 192: two heads, columns past d_k
    (False, 3, 2, 150, 160, 0.2),
    (True, 2, 1, 200, 384, 0.2),     # d_k 384: two column parts of 192
    (False, 2, 2, 130, 384, 0.0),
    (True, 2, 2, 96, 64, 0.2),       # d_k 64 padded to 128
    (True, 2, 2, 96, 40, 0.2),       # d_k 40: a 64-column box wider than the map
    (False, 2, 2, 90, 40, 0.2),
    (True, 2, 1, 140, 1024, 0.2),    # d_k 1024: four parts of 256
    (True, 2, 2, 90, 136, 0.2),      # d_k 136 and 328: the chunk past d_k
    (False, 2, 2, 90, 328, 0.2),
    (True, 2, 2, 100, 130, 0.2),     # d_k 130 and 20: zero-padded to 136 and 24
    (False, 2, 2, 100, 130, 0.2),
    (True, 3, 2, 70, 20, 0.2),
    (False, 3, 2, 70, 20, 0.0),
], ids=["k12_T1024", "k11_T896", "k11_small_grid", "k12_small_grid_rate0", "k11_dk256_h1",
        "k12_dk256_h1_rate0", "k11_dk256_h2", "k12_dk256_h2", "k11_row_split",
        "k12_dk256_row_split", "k11_dk160_h2", "k12_dk160_h2", "k11_dk384_h1",
        "k12_dk384_h2_rate0", "k11_dk64_h2", "k11_dk40_h2", "k12_dk40_h2", "k11_dk1024_h1",
        "k11_dk136_h2", "k12_dk328_h2", "k11_dk130_h2", "k12_dk130_h2", "k11_dk20_h2",
        "k12_dk20_h2_rate0"])
def test_attention_train_ring_split_and_dk256(dev, packed, B, H, T, dk, rate):
    """Kernels 11 and 12 where the ring turns over many times, in both grid
    splits (128 query rows a block, or 64 rows whose keys the two warpgroups
    share where the grid would leave SMs idle), at d_k 256, and at the head
    dims padded with zero columns (40, 64, 136, 160) or cut into column
    parts (328, 384, 1024), against the
    plain version's autograd within the bands of
    test_attention_train_forward_and_backward (max < 2^-6, mean < 1e-4 of the
    peak); padded rows exactly zero; a second call gives the same bits (no
    atomics: every output tile has one writer)."""
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT

    g = torch.Generator().manual_seed(B * T + dk + H)
    got, again, want, pad = _train_attention_pair(KT, packed, B, H, T, dk, rate,
                                                  2 ** 31 + 77, g, dev)
    for name, a, a2, b in zip(("o", "dq", "dk", "dv"), got, again, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        assert torch.equal(a, a2), f"{name}: two calls differ"
        assert float(torch.where(pad, a.detach().float().abs(), 0.0).max()) == 0.0, name
        d, peak = (a.float() - b.float()).abs(), float(b.float().abs().max())
        assert float(d.max()) < 2.0 ** -6 * peak and float(d.mean()) < 1e-4 * peak, (
            name, float(d.max()), float(d.mean()), peak)


def test_mha_fused_train_apply_dk256_matches_the_cpu(dev):
    """Projections + kernel + out projection at adim 256, aheads 1 (d_k 256)
    in bf16, rate 0.2, on the card against the CPU port (plain version) with
    the same weights and seed: the route the JAX encoder takes for any
    d_k >= 128. Band: 2 bf16 steps of the output's peak (the projections
    sum in other orders)."""
    from fastspeech2_tpu_torch.models.encoder import MultiHeadAttention
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT
    from fastspeech2_tpu_torch.ops.precision import compute_dtype

    B, T, D = 3, 150, 256
    g = torch.Generator().manual_seed(3)
    x = torch.randn(B, T, D, generator=g)
    lens = torch.tensor([150, 97, 1], dtype=torch.int32)
    out = {}
    for d in ("cpu", dev):
        attn = MultiHeadAttention(D, device="cpu")
        with torch.no_grad():
            for p in attn.parameters():
                p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel()))
                        * 0.05)
        attn = attn.to(d)
        n0 = KT.packed_fwd_launches + KT.fwd_launches
        with compute_dtype(torch.bfloat16):
            out[str(d)] = KT.mha_fused_train_apply(attn, x.to(d), lens.to(d), 1, 1234,
                                                   0.2).float().cpu()
        out[str(d) + "_n"] = KT.packed_fwd_launches + KT.fwd_launches - n0
    assert out["cpu_n"] == 0 and out[str(dev) + "_n"] == 1
    want, got = out["cpu"], out[str(dev)]
    d = (got - want).abs()
    assert float(d.max()) < 2 * 2.0 ** -8 * float(want.abs().max()), float(d.max())


def test_attention_train_kernels_use_wgmma_and_do_not_spill(dev):
    """The bf16 training kernels are built from wgmma (HGMMA in the SASS, no
    mma.sync HMMA) and ptxas reports no spills for any instantiation."""
    import re
    import shutil
    import subprocess

    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT
    from fastspeech2_tpu_torch.ops.kernels import common

    KT._entry("fs2_attention_train_fwd", 7)  # builds the library
    log = common.ptxas_report("attention_train")
    funcs = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
                       r"(\d+) bytes spill loads", log, re.S)
    bf16 = [f for f in funcs if ("train_" in f[0] or "attn_fwd_kernel" in f[0])
            and "f32" not in f[0] and "rowdot" not in f[0]]
    assert len(bf16) >= 9, [f[0] for f in funcs]  # fwd x 2 splits, dq x 2, dkv; 3 head dims
    assert all(f[1] == "0" and f[2] == "0" for f in bf16), bf16
    assert "setmaxnreg ignored" not in log
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(common._lib_path("attention_train"))],
                          check=True, capture_output=True, text=True).stdout
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        if (("train_" in name or "attn_fwd_kernel" in name) and "f32" not in name
                and "rowdot" not in name):
            assert "HGMMA" in part and "HMMA" not in part.replace("HGMMA", ""), name


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One bf16 train step at d_k=128 (kernel route) on the card against the
    same step on the CPU (plain versions): same weights, batch and seeds.
    Loss within 1%, gradient norm within 5%."""
    import numpy as np

    from fastspeech2_tpu_torch.config import Config, ModelConfig
    from fastspeech2_tpu_torch.models.fastspeech2 import Batch, FastSpeech2
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT
    from fastspeech2_tpu_torch.train.optimizer import NoamAdam
    from fastspeech2_tpu_torch.train.seeds import SeedSchedule
    from fastspeech2_tpu_torch.train.step import TrainState, make_train_step, trainable

    cfg = Config(model=ModelConfig(adim=256, aheads=2, elayers=1, eunits=128, ddim=256,
                                   dlayers=1, dunits=128, postnet_layers=2,
                                   postnet_chans=32, fused_attention="on"))
    g = np.random.default_rng(0)
    B, T, L = 4, 16, 96
    ds = g.integers(1, 7, (B, T)).astype(np.int32)
    olens = ds.sum(1).astype(np.int32)
    m = (np.arange(L)[None] < olens[:, None])
    batch = Batch(xs=g.integers(1, 68, (B, T)).astype(np.int32),
                  ilens=np.full(B, T, np.int32),
                  ys=(g.normal(-5, 2, (B, L, 80)) * m[..., None]).astype(np.float32),
                  olens=olens, ds=ds,
                  es=(g.uniform(0.02, 100, (B, L)) * m).astype(np.float32),
                  ps=(g.uniform(71, 600, (B, L)) * m).astype(np.float32))
    out = {}
    for d in ("cpu", dev):
        model = FastSpeech2(cfg, device=d, generator=torch.Generator().manual_seed(1))
        opt = NoamAdam(trainable(model), cfg)
        seeds = [SeedSchedule(model.dropout_sites(), seed=5).draw() for _ in range(2)]
        n0 = KT.packed_fwd_launches
        _, rep = make_train_step(model, opt, 2, bf16=True)(
            TrainState(model, opt), Batch(*(torch.from_numpy(a).to(d) for a in batch)), seeds)
        out[str(d)] = (float(rep["loss"]), float(rep["grad_norm"]),
                       KT.packed_fwd_launches - n0)
    (lc, nc, kc), (lg, ng, kg) = out["cpu"], out[str(dev)]
    assert kc == 0 and kg == 4  # 2 blocks x 2 micro-batches
    assert abs(lg - lc) < 0.01 * abs(lc) and abs(ng - nc) < 0.05 * nc, out


def test_full_width_bf16_step_is_reproducible(dev):
    """The same full-width bf16 training step (``configs/default.yaml``, the
    seed-0 model, its dropout seeds, 16 rows of up to 96 tokens and 640
    frames) run twice from the same start gives the same gradients bit for
    bit: every backward on the step is deterministic (the length
    regulator's is ``ops/length_regulator.py:_Expand``, not the gather's
    scatter-add)."""
    import dataclasses

    import numpy as np

    from fastspeech2_tpu_torch.config import load_config
    from fastspeech2_tpu_torch.models.fastspeech2 import Batch, FastSpeech2
    from fastspeech2_tpu_torch.train.optimizer import NoamAdam
    from fastspeech2_tpu_torch.train.seeds import SeedSchedule
    from fastspeech2_tpu_torch.train.step import TrainState, make_train_step, trainable

    cfg = load_config(str(Path(__file__).resolve().parents[1] / "configs" / "default.yaml"))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, bf16=True))
    g = np.random.default_rng(4)
    B, T, L = 16, 96, 640
    ilens = g.integers(T // 2, T + 1, B).astype(np.int32)
    ds = g.integers(1, L // T + 1, (B, T)).astype(np.int32) * (np.arange(T)[None] < ilens[:, None])
    olens = ds.sum(1).astype(np.int32)
    m = np.arange(L)[None] < olens[:, None]
    batch = Batch(*(torch.from_numpy(a).to(dev) for a in (
        (g.integers(1, 68, (B, T)) * (ds > 0)).astype(np.int32), ilens,
        (g.normal(-5, 2, (B, L, 80)) * m[..., None]).astype(np.float32), olens, ds,
        (g.uniform(0.02, 100, (B, L)) * m).astype(np.float32),
        (g.uniform(71, 600, (B, L)) * m).astype(np.float32))))

    def gradients():
        model = FastSpeech2(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        opt = NoamAdam(trainable(model), cfg)
        kept = []
        opt.step = lambda grads: kept.extend(t.detach().clone() for t in grads) or \
            torch.zeros((), device=dev)
        seeds = SeedSchedule(model.dropout_sites(), seed=0)
        make_train_step(model, opt, 1, bf16=True)(TrainState(model, opt), batch,
                                                  [seeds.draw()])
        return [n for n, _ in model.named_parameters()], kept

    names, a = gradients()
    _, b = gradients()
    differ = [n for n, x, y in zip(names, a, b) if not torch.equal(x, y)]
    assert len(a) == len(names) and not differ, differ


def test_one_head_bf16_step_is_reproducible_at_dk384(dev):
    """``configs/default.yaml`` with ``aheads: 1`` (encoder d_k 256, decoder
    d_k 384: kernel 11's wide bodies, two column parts of 192): the same
    bf16 step of the seed-0 model run twice gives the same gradients bit for
    bit (every output tile of the backward has one writer)."""
    import dataclasses

    import numpy as np

    from fastspeech2_tpu_torch.config import load_config
    from fastspeech2_tpu_torch.models.fastspeech2 import Batch, FastSpeech2
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT
    from fastspeech2_tpu_torch.train.optimizer import NoamAdam
    from fastspeech2_tpu_torch.train.seeds import SeedSchedule
    from fastspeech2_tpu_torch.train.step import TrainState, make_train_step, trainable

    cfg = load_config(str(Path(__file__).resolve().parents[1] / "configs" / "default.yaml"))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, bf16=True),
                              model=dataclasses.replace(cfg.model, aheads=1))
    g = np.random.default_rng(5)
    B, T, L = 8, 80, 480
    ilens = g.integers(T // 2, T + 1, B).astype(np.int32)
    ds = g.integers(1, L // T + 1, (B, T)).astype(np.int32) * (np.arange(T)[None] < ilens[:, None])
    olens = ds.sum(1).astype(np.int32)
    m = np.arange(L)[None] < olens[:, None]
    batch = Batch(*(torch.from_numpy(a).to(dev) for a in (
        (g.integers(1, 68, (B, T)) * (ds > 0)).astype(np.int32), ilens,
        (g.normal(-5, 2, (B, L, 80)) * m[..., None]).astype(np.float32), olens, ds,
        (g.uniform(0.02, 100, (B, L)) * m).astype(np.float32),
        (g.uniform(71, 600, (B, L)) * m).astype(np.float32))))

    def gradients():
        model = FastSpeech2(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        opt = NoamAdam(trainable(model), cfg)
        kept = []
        opt.step = lambda grads: kept.extend(t.detach().clone() for t in grads) or \
            torch.zeros((), device=dev)
        seeds = SeedSchedule(model.dropout_sites(), seed=0)
        n = (KT.packed_fwd_launches, KT.packed_bwd_launches)
        make_train_step(model, opt, 1, bf16=True)(TrainState(model, opt), batch,
                                                  [seeds.draw()])
        assert (KT.packed_fwd_launches - n[0], KT.packed_bwd_launches - n[1]) == (8, 8)
        return [n for n, _ in model.named_parameters()], kept

    names, a = gradients()
    _, b = gradients()
    differ = [n for n, x, y in zip(names, a, b) if not torch.equal(x, y)]
    assert len(a) == len(names) and all(bool(torch.isfinite(x).all()) for x in a)
    assert not differ, differ


def test_attention_plan_of_the_c_side_is_the_python_one(dev):
    """``fs2_attention_plan`` (csrc/attention_fwd.cuh:attn_plan and the
    kernels' shared-memory sizes) gives ``attention_train.plan`` for every
    d_k in 1..1024 (132 too: not a multiple of 8, it runs zero-padded to
    136), and both refuse d_k 0 and 1032."""
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT

    for dk in range(1, 1025):
        serve, train, f32 = (KT.plan(dk, m) for m in ("serve", "train", "f32"))
        want = (serve.dkp, int(serve.wide), serve.part_width, serve.parts,
                serve.smem["serve_rows"], serve.smem["serve_keys"], train.smem["train_rows"],
                train.smem["train_keys"], train.smem["dq_rows"], train.smem["dq_keys"],
                train.smem["dkv"], f32.smem["f32_fwd"], f32.smem["f32_bwd"])
        assert KT.c_plan(dk) == want, (dk, KT.c_plan(dk), want)
    for dk in (0, 1032):
        with pytest.raises(ValueError):
            KT.plan(dk)
        with pytest.raises(ValueError):
            KT.c_plan(dk)


def test_attention_kernels_refuse_head_dims_they_do_not_take(dev):
    """On CUDA tensors every attention wrapper raises ValueError for d_k
    1032 and 2048 (past 1024; d_k 132, not a multiple of 8, runs
    zero-padded: ``test_attention_halves_at_every_head_dim``), and none
    falls back to its plain version: no launch counter moves."""
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT
    from fastspeech2_tpu_torch.ops.kernels import launch_counts

    before = launch_counts()
    bf, f32 = torch.bfloat16, torch.float32
    lens = torch.tensor([8], dtype=torch.int32, device=dev)
    for dk in (1032, 2048):
        z = lambda *s, dt=bf: torch.zeros(*s, dtype=dt, device=dev)  # noqa: E731
        D = dk
        with torch.no_grad():
            for call in (
                    lambda: KA.attention_block(z(1, 8, D, dt=f32), z(3 * D, D), z(3 * D, dt=f32),
                                               z(D, D), z(D, dt=f32), z(D, dt=f32),
                                               z(D, dt=f32), lens, 1),
                    lambda: KA.attention_res_ln(z(1, 8, D), z(1, 8, D), z(1, 8, D),
                                                z(1, 8, D, dt=f32), z(D, D), z(D, dt=f32),
                                                z(D, dt=f32), z(D, dt=f32), lens, 1),
                    lambda: KA.attention_res(z(1, 8, D), z(1, 8, D), z(1, 8, D),
                                             z(1, 8, D, dt=f32), z(D, D), z(D, dt=f32), lens, 1),
                    lambda: KA.fused_attention_packed(z(1, 8, D), z(1, 8, D), z(1, 8, D), lens,
                                                      1),
                    lambda: KA.fused_attention(z(1, 1, 8, D), z(1, 1, 8, D), z(1, 1, 8, D),
                                               lens)):
                with pytest.raises(ValueError, match="d_k"):
                    call()
        for dt in (bf, f32):
            q = z(1, 8, D, dt=dt)
            with pytest.raises(ValueError, match="head dim"):
                KT.fused_attention_train_packed(q, q, q, lens, 1, 1, 0.2)
            with pytest.raises(ValueError, match="head dim"):
                KT.fused_attention_train(q[:, None], q[:, None], q[:, None], lens, 1, 0.2)
    assert launch_counts() == before


def test_two_threads_launch_the_attention_at_dk192_and_dk384(dev):
    """The server's two threads run the encoder and the decoder at once; in
    a one-head model their bare attention is the tile body at d_k 192 and
    the wide body at d_k 384 (two column parts). Two threads call the C
    entry of kernel 7 back to back at the two head dims: no launch is
    refused, and every output equals the call made alone."""
    import math
    import threading

    from fastspeech2_tpu_torch.ops.kernels import attention as KA

    g = torch.Generator().manual_seed(19)
    jobs, keep = [], []
    for dk in (192, 384):
        q, k, v = (torch.randn(2, 96, dk, generator=g).to(torch.bfloat16).to(dev)
                   for _ in range(3))
        lens = torch.tensor([96, 41], dtype=torch.int32, device=dev)
        with torch.no_grad():
            want = KA.fused_attention_packed(q, k, v, lens, 1)  # binds KA._fn_bare
        out = torch.empty_like(q)
        keep.append((q, k, v, lens, out, want))
        jobs.append((q.data_ptr(), k.data_ptr(), v.data_ptr(), dk, lens.data_ptr(),
                     out.data_ptr(), 2, 96, 1, dk, 1, 1.0 / math.sqrt(dk),
                     torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    refused = {}

    def run(args):
        refused[args[3]] = sum(1 for _ in range(20000) if KA._fn_bare(*args))

    threads = [threading.Thread(target=run, args=(job,)) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert refused == {192: 0, 384: 0}, f"refused launches of 20000 per head dim: {refused}"
    for *_, out, want in keep:
        assert torch.equal(out, want)


def test_exported_one_head_artifact_launches_kernel_1(dev, tmp_path):
    """A one-head bf16 model (encoder d_k 256, decoder d_k 384) exported on
    the card (``infer/export.py``, at ``matmul_precision="highest"``, the
    eager call's) launches kernel 1 through its ``fs2::attention_block`` op
    in every block (the launch counter: 2 + 2) and returns the eager bf16
    call's mel and lengths bit for bit."""
    import numpy as np

    from fastspeech2_tpu_torch.config import Config, ModelConfig
    from fastspeech2_tpu_torch.infer.export import export_inference, load_exported
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
    from fastspeech2_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from fastspeech2_tpu_torch.ops.precision import compute_dtype
    from fastspeech2_tpu_torch.train.checkpoint import save_checkpoint

    cfg = Config(model=ModelConfig(adim=256, aheads=1, elayers=2, eunits=512, ddim=384,
                                   dlayers=2, dunits=512, fused_attention="on"))
    model = FastSpeech2(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.duration_predictor.out.bias.fill_(1.87)
    save_checkpoint(str(tmp_path / "m.npz"), model, None, 0, cfg)
    call = load_exported(export_inference(str(tmp_path / "m.npz"), str(tmp_path / "m.pt2"),
                                          batch=4, max_tokens=64, max_frames=512, bf16=True,
                                          matmul_precision="highest"))
    g = np.random.default_rng(2)
    ilens = np.asarray([64, 33, 9, 1], np.int32)
    xs = (g.integers(1, 68, (4, 64)) * (np.arange(64)[None] < ilens[:, None])).astype(np.int32)
    reset_launch_counts()
    mel, lens = call(xs, ilens)
    counts = launch_counts()
    assert counts["attention_block"] == 4 and counts["ffn_block"] == 4, counts
    with torch.inference_mode(), compute_dtype(torch.bfloat16):
        want, wlens, _ = model.inference(torch.from_numpy(xs).to(dev),
                                         torch.from_numpy(ilens).to(dev), out_maxlen=512)
    assert mel.is_cuda and torch.equal(lens, wlens) and int(lens.min()) > 0
    assert torch.isfinite(mel).all() and torch.equal(mel, want)


#: the serving kernels' custom ops (``ops/kernels/library.py``): op name ->
#: (wrapper module, its direct launch's name, leading arguments)
CUSTOM_OPS = {
    "attention_block": ("attention", "launch_block", ()),
    "attention_res_ln": ("attention", "launch_res_ln", ()),
    "attention_res": ("attention", "launch_res", ()),
    "fused_attention_packed": ("attention", "launch_packed", ()),
    "ffn_block": ("ffn", "launch_block", (False,)),
    "ffn_block_pre": ("ffn", "launch_block", (True,)),
    "variance_adaptor": ("adaptor", "launch", ()),
    "postnet": ("postnet", "launch", ()),
    "resstack": ("resstack", "launch", ()),
}


def _seeded_model(dev, **model_kw):
    from fastspeech2_tpu_torch.config import Config, ModelConfig
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2

    cfg = Config(model=ModelConfig(adim=256, aheads=2, elayers=2, eunits=512, ddim=256,
                                   dlayers=2, dunits=512, fused_attention="on", **model_kw))
    model = FastSpeech2(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.duration_predictor.out.bias.fill_(1.87)
    return cfg, model


def test_custom_ops_equal_their_direct_launches(dev, monkeypatch):
    """Each serving kernel's ``fs2::`` custom op against its direct ctypes
    launch on the inputs the model's routes give it (post-LN with MelGAN,
    ``FUSED_ATT_QKV`` off, pre-LN, ``concat_after``): the same bits, and one
    launch counted per op call."""
    import importlib

    import numpy as np
    from torch.utils._python_dispatch import TorchDispatchMode

    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.ops import flags
    from fastspeech2_tpu_torch.ops.kernels import launch_counts
    from fastspeech2_tpu_torch.vocoder import MelGANGenerator

    calls = {}

    class Record(TorchDispatchMode):
        """Keeps the first arguments each ``fs2::`` op is called with."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._schema.name.startswith("fs2::"):
                calls.setdefault(func._schema.name[len("fs2::"):], args)
            return func(*args, **(kwargs or {}))

    seqs = [np.arange(n) % 60 + 1 for n in (40, 17, 64)]
    _, model = _seeded_model(dev)
    synth = Synthesizer(model, bf16=True, device=dev)
    synth.attach_vocoder(MelGANGenerator(bf16=True, seed=0, device=dev))
    with Record():
        synth.wav_from_token_batch(seqs)
        monkeypatch.setattr(flags, "FUSED_ATT_QKV", False)
        synth.mel_from_token_batch(seqs)
        for kw in ({"encoder_normalize_before": True, "decoder_normalize_before": True},
                   {"encoder_concat_after": True, "decoder_concat_after": True}):
            Synthesizer(_seeded_model(dev, **kw)[1], bf16=True,
                        device=dev).mel_from_token_batch(seqs)
    assert set(calls) == set(CUSTOM_OPS), set(CUSTOM_OPS) - set(calls)
    for name, args in calls.items():
        mod, launch, lead = CUSTOM_OPS[name]
        before = launch_counts()[name]
        got = getattr(torch.ops.fs2, name)(*args)
        assert launch_counts()[name] == before + 1, name
        want = getattr(importlib.import_module(f"fastspeech2_tpu_torch.ops.kernels.{mod}"),
                       launch)(*lead, *args)
        for a, b in zip(*((t,) if isinstance(t, torch.Tensor) else t for t in (got, want))):
            assert a.is_cuda and torch.equal(a, b), name


def test_exported_bf16_artifact_launches_the_kernels(dev, tmp_path):
    """A bf16 artifact exported on the card (``infer/export.py``) launches
    kernels 1-4 through its custom ops (the launch counters: 2 + 2 blocks,
    one adaptor, one postnet) and returns the eager bf16 call's mel and
    lengths bit for bit."""
    import numpy as np

    from fastspeech2_tpu_torch.infer.export import export_inference, load_exported
    from fastspeech2_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from fastspeech2_tpu_torch.ops.precision import compute_dtype
    from fastspeech2_tpu_torch.train.checkpoint import save_checkpoint

    cfg, model = _seeded_model(dev)
    save_checkpoint(str(tmp_path / "m.npz"), model, None, 0, cfg)
    call = load_exported(export_inference(str(tmp_path / "m.npz"), str(tmp_path / "m.pt2"),
                                          batch=4, max_tokens=64, max_frames=512, bf16=True))
    g = np.random.default_rng(1)
    ilens = np.asarray([64, 40, 9, 1], np.int32)
    xs = (g.integers(1, 68, (4, 64)) * (np.arange(64)[None] < ilens[:, None])).astype(np.int32)
    reset_launch_counts()
    mel, lens = call(xs, ilens)
    counts = launch_counts()
    assert {k: counts[k] for k in ("attention_block", "ffn_block", "variance_adaptor",
                                   "postnet")} == {"attention_block": 4, "ffn_block": 4,
                                                   "variance_adaptor": 1, "postnet": 1}, counts
    with torch.inference_mode(), compute_dtype(torch.bfloat16):
        want, wlens, _ = model.inference(torch.from_numpy(xs).to(dev),
                                         torch.from_numpy(ilens).to(dev), out_maxlen=512)
    assert mel.is_cuda and torch.equal(lens, wlens) and int(lens.min()) > 0
    assert torch.equal(mel, want), float((mel - want).abs().max())


def _speechlike(B, N, g):
    """Harmonics on a gliding f0 plus noise; row 0 keeps sound only in its
    first tenth (a bucket's zero tail)."""
    t = torch.arange(N, dtype=torch.float64) / 22050
    f0 = 90 + 160 * torch.rand(B, 1, generator=g, dtype=torch.float64)
    ph = 2 * torch.pi * torch.cumsum(f0 * (1 + 0.1 * torch.sin(2 * torch.pi * t)), -1) / 22050
    y = sum(0.3 / k * torch.sin(k * ph) for k in range(1, 8))
    y = y + 0.01 * torch.randn(B, N, generator=g, dtype=torch.float64)
    y[0, N // 10:] = 0
    return y.float()


@functools.lru_cache(maxsize=1)
def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _f64_errors(y, fb, hop, win, mel, en):
    """chip_smoke.py's float64 comparison: the max abs log-mel error over the
    entries whose float64 mel exceeds 10 clip, and the max energy error over
    the energy's peak, against numpy's float64 rfft."""
    return _smoke().f64_errors(y, fb, hop, win, mel, en)


STFT_CASES = [(8, 229_376, 256, 80), (8, 16_384, 256, 80), (3, 700, 256, 80),
              (1, 300, 256, 80), (2, 5_000, 64, 80), (3, 9_000, 128, 80),
              (2, 12_000, 200, 80), (2, 12_000, 300, 80), (2, 24_000, 512, 80),
              (3, 6_000, 256, 128), (2, 24_000, 512, 160), (2, 250, 200, 128)]


@pytest.mark.parametrize("B,N,hop,n_mels", STFT_CASES)
def test_stft_mel_energy(dev, B, N, hop, n_mels):
    """Kernel 14 against its plain version (full f32 on both sides) at the
    preprocess path's bucket shapes, at short rows (one no longer than the
    reflect pad), at hop 64 to 512 (n_fft = 4 hop, win_length = n_fft) and
    128 and 160 mels. Tolerance 1e-4 (rtol and atol; the energy's atol 1e-4
    of its peak), the one the TPU kernel is held to. Against float64 truth
    the kernel's energy is no less accurate than the plain version's, and
    its log-mel within twice the plain version's max error: an FFT of 128
    points, or a row of 1-3 frames, may land a few f32 steps of the log
    past the direct DFT's; from n_fft 800 up it is more accurate."""
    from fastspeech2_tpu_torch.audio.stft import mel_filterbank
    from fastspeech2_tpu_torch.ops.kernels import stft as KS

    n_fft = 4 * hop
    g = torch.Generator().manual_seed(N + hop)
    y = _speechlike(B, N, g).to(dev)
    fb = torch.from_numpy(mel_filterbank(22050, n_fft, n_mels)).to(dev)
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=n_fft)
    n0 = KS.launches
    mel, en = KS.stft_mel_energy(y, fb, **kw)
    pm, pe = KS.stft_mel_energy_plain(y, fb, **kw)
    torch.cuda.synchronize()
    assert KS.launches == n0 + 1
    F = N // hop + 1
    assert mel.shape == pm.shape == (B, n_mels, F) and en.shape == pe.shape == (B, F)
    torch.testing.assert_close(mel, pm, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(en, pe, rtol=1e-4, atol=1e-4 * float(pe.abs().max()))
    k_mel, k_en = _f64_errors(y, fb, hop, n_fft, mel, en)
    p_mel, p_en = _f64_errors(y, fb, hop, n_fft, pm, pe)
    assert k_en <= p_en and k_mel <= 2 * p_mel, (k_mel, p_mel, k_en, p_en)


@pytest.mark.parametrize("hop", [200, 240, 300, 512])
def test_stft_mel_spectrogram_runs_the_kernel_at_other_hops(dev, hop):
    """MelSpectrogram.mel_and_energy with n_fft = 4 hop (the 16, 24 and 44.1
    kHz recipes' hops) launches kernel 14 on a CUDA tensor, and meets the
    matmul path."""
    from fastspeech2_tpu_torch.audio.stft import MelSpectrogram
    from fastspeech2_tpu_torch.ops.kernels import stft as KS

    y = _speechlike(2, 8_000, torch.Generator().manual_seed(hop)).to(dev)
    ms = MelSpectrogram(n_fft=4 * hop, hop_length=hop, win_length=4 * hop, device=dev)
    n0 = KS.launches
    mel, en = ms.mel_and_energy(y)
    assert KS.launches == n0 + 1
    pm, pe = KS.stft_mel_energy_plain(y, ms.mel_basis, 4 * hop, hop, 4 * hop)
    torch.testing.assert_close(mel, pm, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(en, pe, rtol=1e-4, atol=1e-4 * float(pe.abs().max()))


def test_stft_mel_energy_rejects_what_it_does_not_cover(dev):
    from fastspeech2_tpu_torch.audio.stft import MelSpectrogram, mel_filterbank
    from fastspeech2_tpu_torch.ops.kernels import stft as KS

    y = torch.randn(2, 4096, device=dev)
    fb = torch.from_numpy(mel_filterbank()).to(dev)
    with pytest.raises(ValueError, match="n_fft == 4"):
        KS.stft_mel_energy(y, fb, n_fft=1024, hop_length=128)
    with pytest.raises(ValueError, match="dtype"):
        KS.stft_mel_energy(y.double(), fb)
    # hops the kernel's FFT does not take raise; nothing falls back
    n0 = KS.launches
    for hop in (1025, 1100, 2048):
        fbh = torch.from_numpy(mel_filterbank(22050, 4 * hop, 80)).to(dev)
        with pytest.raises(ValueError, match="not supported"):
            KS.stft_mel_energy(y, fbh, n_fft=4 * hop, hop_length=hop, win_length=4 * hop)
        with pytest.raises(ValueError, match="not supported"):
            MelSpectrogram(n_fft=4 * hop, hop_length=hop, win_length=4 * hop,
                           device=dev).mel_and_energy(y)
    assert KS.launches == n0
    # another ratio takes the matmul path on the card, as in the JAX package
    mel, en = MelSpectrogram(hop_length=128, device=dev).mel_and_energy(y)
    assert KS.launches == n0 and mel.shape == (2, 80, 33)


STFT_NEW_CASES = [(2, 3_000, 1, 3), (2, 5_000, 7, 8), (2, 8_000, 28, 40),
                  (2, 22_050, 220, 80), (2, 22_050, 257, 80), (2, 22_050, 275, 80),
                  (2, 44_100, 441, 80), (2, 48_000, 600, 80), (2, 48_000, 1000, 80),
                  (2, 65_536, 1024, 80), (1, 20_000, 1021, 80), (2, 12_000, 13 * 17, 80)]


@pytest.mark.parametrize("B,N,hop,n_mels", STFT_NEW_CASES)
def test_stft_mel_energy_every_hop(dev, B, N, hop, n_mels):
    """Kernel 14 at hops past its first range: under 32 (hop 1: two points,
    three bins), n_fft / 2 with a factor 7, 11 or 13 (220, 275, 441, 221) or
    above 13 (257, 1021: direct DFT passes), past 512 (600, 1000, 1024: four
    frames a block past ~770). Against the plain version and float64 as
    ``test_stft_mel_energy`` holds the hops it took before."""
    from fastspeech2_tpu_torch.audio.stft import mel_filterbank
    from fastspeech2_tpu_torch.ops.kernels import stft as KS

    n_fft = 4 * hop
    g = torch.Generator().manual_seed(N + hop)
    y = _speechlike(B, N, g).to(dev)
    fb = torch.from_numpy(mel_filterbank(22050, n_fft, n_mels)).to(dev)
    kw = dict(n_fft=n_fft, hop_length=hop, win_length=n_fft)
    n0 = KS.launches
    mel, en = KS.stft_mel_energy(y, fb, **kw)
    pm, pe = KS.stft_mel_energy_plain(y, fb, **kw)
    torch.cuda.synchronize()
    assert KS.launches == n0 + 1
    F = N // hop + 1
    assert mel.shape == pm.shape == (B, n_mels, F) and en.shape == pe.shape == (B, F)
    torch.testing.assert_close(mel, pm, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(en, pe, rtol=1e-4, atol=1e-4 * float(pe.abs().max()))
    k_mel, k_en = _f64_errors(y, fb, hop, n_fft, mel, en)
    p_mel, p_en = _f64_errors(y, fb, hop, n_fft, pm, pe)
    assert k_en <= p_en and k_mel <= 2 * p_mel, (k_mel, p_mel, k_en, p_en)


def test_stft_c_plan_is_the_python_plan(dev):
    """One rule in two places: ``fs2_stft_plan`` gives ``plan``'s radices at
    every hop from 1 to 1024, eight frames a block where they fit and four
    above, within the card's shared memory; it refuses hop 0 and 1025."""
    from fastspeech2_tpu_torch.ops.kernels import stft as KS

    fts = set()
    for hop in range(1, 1025):
        radices, ft, smem = KS.c_plan(hop, min(80, 2 * hop + 1))
        assert radices == KS.plan(4 * hop), hop
        assert ft in (4, 8) and smem <= 232448 and (ft == 8 or hop > 512), (hop, ft, smem)
        fts.add(ft)
    assert fts == {4, 8}
    for hop in (0, 1025):
        with pytest.raises(ValueError):
            KS.c_plan(hop, 3)


def test_stft_library_does_not_spill(dev):
    """ptxas reports no spill in kernel 14's library."""
    import re

    from fastspeech2_tpu_torch.ops.kernels import common

    common.load("stft")  # builds the library
    report = common.ptxas_report("stft")
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)
    assert spills and all(s == ("0", "0") for s in spills), report


def _lengths_0_1(B, T, dev, g):
    """Random lengths with a full row, a length-1 row and a length-0 row."""
    ls = torch.randint(1, T + 1, (B,), generator=g, dtype=torch.int32)
    ls[0], ls[1], ls[-1] = T, 1, 0
    return ls.to(dev)


@pytest.mark.parametrize("B,T,D", [(4, 96, 256), (3, 160, 384), (4, 32, 256)])
def test_attention_res_and_bare(dev, B, T, D):
    """Kernel 6 (pre-LN attention half) and kernel 7 (bare, heads packed) at
    d_k 128 and 192 against their plain versions; dead tiles and lengths 0
    and 1: res + bo and zeros exactly; column blocks of one q|k|v buffer
    give the same bits as separate tensors."""
    from fastspeech2_tpu_torch.ops.kernels import attention as KA

    g = torch.Generator().manual_seed(B * T + D)
    bf = torch.bfloat16
    q, k, v = (torch.randn(B, T, D, generator=g).to(bf).to(dev) for _ in range(3))
    res = torch.randn(B, T, D, generator=g).to(dev)
    wo = (torch.randn(D, D, generator=g) / D ** 0.5).to(bf).to(dev)
    bo = (0.1 * torch.randn(D, generator=g)).to(dev)
    lens = _lengths_0_1(B, T, dev, g)
    n6, n7 = KA.res_launches, KA.packed_launches
    got = KA.attention_res(q, k, v, res, wo, bo, lens, 2)
    want = KA.attention_res_plain(q, k, v, res, wo, bo, lens, 2)
    bare = KA.fused_attention_packed(q, k, v, lens, 2)
    bare_want = KA.fused_attention_packed_plain(q, k, v, lens, 2)
    qkv = torch.cat([q, k, v], dim=-1)
    bare_cols = KA.fused_attention_packed(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:],
                                          lens, 2)
    torch.cuda.synchronize()
    assert (KA.res_launches, KA.packed_launches) == (n6 + 1, n7 + 2)
    _close(got, want)
    assert bare.dtype == bf
    _close(bare, bare_want)
    assert torch.equal(bare, bare_cols)
    for b, n in enumerate(lens.tolist()):
        assert torch.equal(got[b, n:], res[b, n:] + bo), b
        assert not bare[b, n:].any(), b


@pytest.mark.parametrize("B,H,T,dk", [(4, 2, 96, 128), (3, 2, 160, 192), (2, 4, 64, 128)])
def test_fused_attention_bhtd(dev, B, H, T, dk):
    """Kernel 8, (B, H, T, dk), against its plain version and against kernel
    7 on the same values packed along D (the same body: bit for bit)."""
    from fastspeech2_tpu_torch.ops.kernels import attention as KA

    g = torch.Generator().manual_seed(T * dk)
    q, k, v = (torch.randn(B, H, T, dk, generator=g).to(torch.bfloat16).to(dev)
               for _ in range(3))
    lens = _lengths_0_1(B, T, dev, g)
    n8 = KA.bhtd_launches
    got = KA.fused_attention(q, k, v, lens)
    want = KA.fused_attention_plain(q, k, v, lens)
    pack = lambda t: t.transpose(1, 2).reshape(B, T, H * dk).contiguous()  # noqa: E731
    packed = KA.fused_attention_packed(pack(q), pack(k), pack(v), lens, H)
    torch.cuda.synchronize()
    assert KA.bhtd_launches == n8 + 1 and got.shape == (B, H, T, dk)
    _close(got, want)
    assert torch.equal(pack(got), packed)
    for b, n in enumerate(lens.tolist()):
        assert not got[b, :, n:].any(), b


# (B, H, T, dk): every head dim in both grid splits (B * H * ceil(T / 128)
# below the card's 132 SMs: 64-row blocks whose key tiles the two warpgroups
# split; at or above: 128-row blocks), T from one key tile to 36
BARE_SHAPES = [(4, 2, 96, 128), (70, 2, 96, 128), (3, 2, 160, 192), (34, 2, 160, 192),
               (3, 1, 160, 256), (132, 1, 96, 256), (9, 2, 1024, 128), (3, 2, 1024, 192),
               (9, 2, 1024, 256), (3, 1, 2304, 128), (4, 2, 2304, 192), (3, 2, 2304, 256),
               (4, 2, 96, 64), (4, 2, 96, 40), (3, 2, 150, 136), (3, 2, 160, 160), (70, 2, 96, 160),
               (2, 1, 200, 384), (3, 2, 130, 384), (2, 2, 1024, 320), (2, 1, 100, 1024),
               (3, 2, 150, 130), (3, 2, 96, 20), (2, 3, 70, 3)]
BARE_IDS = ["dk128_T96_ksplit", "dk128_T96_rows", "dk192_T160_ksplit", "dk192_T160_rows",
            "dk256_T160_ksplit", "dk256_T96_rows", "dk128_T1024_rows", "dk192_T1024_ksplit",
            "dk256_T1024_rows", "dk128_T2304_ksplit", "dk192_T2304_rows",
            "dk256_T2304_ksplit", "dk64_T96", "dk40_T96", "dk136_T150", "dk160_T160_ksplit",
            "dk160_T96_rows", "dk384_h1_T200", "dk384_h2_T130", "dk320_T1024",
            "dk1024_T100", "dk130_T150", "dk20_T96", "dk3_h3_T70"]


@pytest.mark.parametrize("B,H,T,dk", BARE_SHAPES, ids=BARE_IDS)
def test_bare_attention_widths_and_splits(dev, B, H, T, dk):
    """Kernels 7 and 8 (the SERVE forward of csrc/attention_fwd.cuh) against
    their plain versions in the bf16 band, lengths T, 1 and 0: dead rows are
    zeros; kernel 8 equals kernel 7 and a second call the first, bit for bit;
    column blocks of one q|k|v buffer give the bits of separate tensors; and
    kernel 7 gives kernel 11's forward at rate 0 bit for bit (one body, the
    same arithmetic)."""
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.kernels import attention_train as KT

    g = torch.Generator().manual_seed(B * T + dk)
    D = H * dk
    q, k, v = (torch.randn(B, T, D, generator=g).to(torch.bfloat16).to(dev) for _ in range(3))
    lens = _lengths_0_1(B, T, dev, g)
    split = lambda t: t.view(B, T, H, dk).transpose(1, 2).contiguous()  # noqa: E731
    n7, n8 = KA.packed_launches, KA.bhtd_launches
    with torch.no_grad():
        got7 = KA.fused_attention_packed(q, k, v, lens, H)
        again = KA.fused_attention_packed(q, k, v, lens, H)
        got8 = KA.fused_attention(split(q), split(k), split(v), lens)
        qkv = torch.cat([q, k, v], dim=-1)
        cols = KA.fused_attention_packed(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:],
                                         lens, H)
        k11 = KT.fused_attention_train_packed(q, k, v, lens, 7, H, 0.0)
        want = KA.fused_attention_packed_plain(q, k, v, lens, H)
    torch.cuda.synchronize()
    assert (KA.packed_launches, KA.bhtd_launches) == (n7 + 3, n8 + 1)
    assert got7.dtype == torch.bfloat16 and got7.shape == (B, T, D)
    _close(got7, want)
    for b, n in enumerate(lens.tolist()):
        assert not got7[b, n:].any(), b
    assert torch.equal(got7, again)
    assert torch.equal(split(got7), got8)
    assert torch.equal(got7, cols)
    assert torch.equal(got7, k11)


@pytest.mark.parametrize("B,H,T,dk", [(4, 2, 96, 128), (3, 1, 160, 256), (3, 2, 200, 192),
                                      (3, 2, 100, 160), (2, 1, 90, 384), (2, 2, 70, 1024),
                                      (3, 2, 100, 130), (2, 2, 70, 20)])
def test_bare_attention_f32(dev, B, H, T, dk):
    """The f32 entry of kernels 7 and 8 (the training kernels' f32 forward at
    rate 0: plain multiply-adds, no TF32) against the plain version within
    2e-5 of the peak, the band of the f32 training forward; column blocks
    of one buffer are taken too."""
    from fastspeech2_tpu_torch.ops.kernels import attention as KA

    g = torch.Generator().manual_seed(T + dk)
    D = H * dk
    qkv = torch.randn(B, T, 3 * D, generator=g).to(dev)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    lens = _lengths_0_1(B, T, dev, g)
    split = lambda t: t.reshape(B, T, H, dk).transpose(1, 2).contiguous()  # noqa: E731
    n7, n8 = KA.packed_launches, KA.bhtd_launches
    got7 = KA.fused_attention_packed(q, k, v, lens, H)
    got8 = KA.fused_attention(split(q), split(k), split(v), lens)
    want = KA.fused_attention_packed_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                           lens, H)
    torch.cuda.synchronize()
    assert (KA.packed_launches, KA.bhtd_launches) == (n7 + 1, n8 + 1)
    assert got7.dtype == torch.float32 and got8.dtype == torch.float32
    peak = float(want.abs().max())
    for got in (got7, got8.transpose(1, 2).reshape(B, T, D)):
        assert float((got - want).abs().max()) < 2e-5 * peak
    for b, n in enumerate(lens.tolist()):
        assert not got7[b, n:].any(), b


def test_bare_attention_kernels_use_wgmma_and_do_not_spill(dev):
    """The SERVE instantiations of the forward in attention's library (the
    tile body at DK 128, 192, 256, both grid splits; the wide body at
    parts of 192 and 256) are wgmma kernels: HGMMA and no HMMA in
    their SASS, no ptxas spills, no stack frame (the two score arrays of the
    pipelined schedule stay in registers) and no ptxas note that it
    serialized the wgmma (the overlap would be gone)."""
    import re
    import shutil
    import subprocess

    from fastspeech2_tpu_torch.ops.kernels import common

    common.load("attention")
    log = common.ptxas_report("attention")
    funcs = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes stack frame, "
                       r"(\d+) bytes spill stores, (\d+) bytes spill loads", log, re.S)
    serve = [f for f in funcs if "attn_fwd_kernel" in f[0] or "attn_fwd_wide_kernel" in f[0]]
    assert len(serve) == 8, [f[0] for f in funcs]
    assert all(f[1:] == ("0", "0", "0") for f in serve), serve
    assert "serialized" not in log
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(common._lib_path("attention"))],
                          check=True, capture_output=True, text=True).stdout
    seen = 0
    for part in sass.split("Function : ")[1:]:
        name = part.split()[0]
        if "attn_fwd_kernel" in name or "attn_fwd_wide_kernel" in name:
            seen += 1
            assert "HGMMA" in part and "HMMA" not in part.replace("HGMMA", ""), name
    assert seen == 8


@pytest.mark.parametrize("B,T,D", [(4, 96, 256), (3, 160, 384)])
def test_ffn_block_pre(dev, B, T, D):
    """Kernel 9, x + FFN(mask(LN(x))), at k=9 and H=1024 against its plain
    version; lengths 0 and 1 and dead tiles give x + the bias row."""
    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    g = torch.Generator().manual_seed(B * T)
    torch.manual_seed(D)
    blk = FFTBlock(EncoderConfig(idim=D, attention_dim=D, linear_units=1024), device=dev)
    with torch.no_grad():
        blk.norm2.weight.add_(0.2 * torch.randn(D, generator=g).to(dev))
        blk.norm2.bias.add_(0.1 * torch.randn(D, generator=g).to(dev))
    x = (3.0 * torch.randn(B, T, D, generator=g) + 1.0).to(dev)  # LN has work to do
    lens = _lengths_0_1(B, T, dev, g)
    with torch.inference_mode():
        fp = blk.ffn_pack(torch.bfloat16)
        n9 = KF.pre_launches
        got = KF.ffn_block_pre(x, *fp, lens, 9)
        want = KF.ffn_block_pre_plain(x, *fp, lens, 9)
        c = _bias_row(KF, fp[:4], D, 9, dev)
        torch.cuda.synchronize()
    assert KF.pre_launches == n9 + 1
    _close(got, want)
    # every row from len + 4 on, of every batch row, holds x + the one bias
    # row (f32 rounding of the add only)
    _dead_rows(got, lens, 9, lambda b, t0: x[b, t0:] + c)


@pytest.mark.parametrize("O,out_dtype", [(384, torch.bfloat16), (384, torch.float32),
                                         (80, torch.float32), (200, torch.bfloat16),
                                         (30, torch.float32)])
def test_fused_ffn(dev, O, out_dtype):
    """Kernel 10, the bare conv-FFN of a bf16 input with O outputs (O != D
    and O not a multiple of the 384-column tile), in bf16 and in f32."""
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    g = torch.Generator().manual_seed(O)
    B, T, D, Hd, k = 3, 160, 384, 1024, 9
    x = torch.randn(B, T, D, generator=g).to(torch.bfloat16).to(dev)
    w1, b1, w2, b2 = _ffn_weights(D, Hd, O, k, g, dev)
    lens = _lengths_0_1(B, T, dev, g)
    n10 = KF.bare_launches
    got = KF.fused_ffn(x, w1, b1, w2, b2, lens, k, out_dtype)
    want = KF.fused_ffn_plain(x, w1, b1, w2, b2, lens, k, out_dtype)
    torch.cuda.synchronize()
    assert KF.bare_launches == n10 + 1
    assert got.dtype == out_dtype and got.shape == (B, T, O)
    _close(got, want)
    # every row from len + 4 on, of every batch row, is the one bias row,
    # bit for bit
    c = got[-1, -1]
    _dead_rows(got, lens, k, lambda b, t0: c, exact=True)


def _bias_row(KF, w, D, k, dev):
    """The bias-only row c = round(relu(round(b1)) W2) + b2 of kernel 10 on
    the FFN weights w = (w1, b1, w2, b2), in f32: row k - 1 of a length-0
    input (past its halo)."""
    x0 = torch.zeros(1, k, D, dtype=torch.bfloat16, device=dev)
    lens0 = torch.zeros(1, dtype=torch.int32, device=dev)
    return KF.fused_ffn(x0, *w, lens0, k, torch.float32)[0, -1]


def _dead_rows(got, lens, k, want_from, exact=False):
    """Every row t >= len + (k - 1) / 2 of every batch row against
    want_from(b, t0) (rows t0 on): bit for bit, or within 1e-5 (the f32
    rounding of the residual add and the LayerNorm's)."""
    T = got.shape[1]
    for b, n in enumerate(lens.tolist()):
        t0 = min(T, max(0, n) + (k - 1) // 2)
        if t0 == T:
            continue
        want = want_from(b, t0).expand_as(got[b, t0:])
        if exact:
            assert torch.equal(got[b, t0:], want), f"dead rows of batch row {b}"
        else:
            err = float((got[b, t0:].float() - want.float()).abs().max())
            assert err < 1e-5, f"dead rows of batch row {b}: {err}"


def _ffn_weights(D, H, O, k, g, dev):
    bf = torch.bfloat16
    w1 = (torch.randn(H, k * D, generator=g) / (k * D) ** 0.5).to(bf).to(dev)
    w2 = (torch.randn(O, H, generator=g) / H ** 0.5).to(bf).to(dev)
    b1, b2 = ((0.1 * torch.randn(n, generator=g)).to(dev) for n in (H, O))
    return w1, b1, w2, b2


# (B, T, D, H, k): T under one 64-row tile, T no multiple of the tiles, D=512
# (fewer ring stages), D=1024 with H=4096 (64-row conv tiles, two column
# passes and the row LayerNorm launch), a hidden width no multiple of 64, k=1
# and k=3 (ESPnet2's usual positionwise_conv_kernel_size)
FFN_EDGES = [(3, 40, 256, 1024, 9), (2, 200, 384, 1024, 9), (2, 160, 512, 1024, 9),
             (2, 100, 1024, 4096, 9), (3, 130, 256, 1056, 3), (3, 96, 384, 1024, 1),
             (2, 70, 384, 1024, 3),
             # any width: D and H padded to 32 (D = 260: 16-byte f32 rows, not
             # bf16; D = 36: the same; D = 30: neither, a value at a time)
             (2, 100, 260, 1000, 9), (3, 70, 200, 1000, 9), (3, 40, 36, 100, 3),
             (2, 64, 40, 72, 1), (2, 50, 30, 72, 3)]


@pytest.mark.parametrize("B,T,D,H,k", FFN_EDGES,
                         ids=[f"T{t}-D{d}-H{h}-k{k}" for _, t, d, h, k in FFN_EDGES])
def test_ffn_kernels_at_tiling_edges(dev, B, T, D, H, k):
    """Kernels 2, 9 and 10 against their plain versions at shapes the tiling
    makes risky, with lengths 0, 1 and T; every row t >= len + (k - 1) / 2
    is built from one bias-only row c for the call: c itself (10, bit for
    bit), x + c (9) and LN(x + c) (2), the last two within 1e-5."""
    from fastspeech2_tpu_torch.ops import nn
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    g = torch.Generator().manual_seed(B * T + D + k)
    w = _ffn_weights(D, H, D, k, g, dev)
    ln_g = (1.0 + 0.2 * torch.randn(D, generator=g)).to(dev)
    ln_b = (0.1 * torch.randn(D, generator=g)).to(dev)
    x = (2.0 * torch.randn(B, T, D, generator=g) + 0.5).to(dev)
    lens = _lengths_0_1(B, T, dev, g)
    with torch.inference_mode():
        c = _bias_row(KF, w, D, k, dev)
        got = KF.ffn_block(x, *w, ln_g, ln_b, lens, k)
        _close(got, KF.ffn_block_plain(x, *w, ln_g, ln_b, lens, k))
        _dead_rows(got, lens, k, lambda b, t0: nn.layer_norm(x[b, t0:] + c, ln_g, ln_b))
        got = KF.ffn_block_pre(x, *w, ln_g, ln_b, lens, k)
        _close(got, KF.ffn_block_pre_plain(x, *w, ln_g, ln_b, lens, k))
        _dead_rows(got, lens, k, lambda b, t0: x[b, t0:] + c)
        xb = x.to(torch.bfloat16)
        got = KF.fused_ffn(xb, *w, lens, k, torch.float32)
        _close(got, KF.fused_ffn_plain(xb, *w, lens, k, torch.float32))
        _dead_rows(got, lens, k, lambda b, t0: c, exact=True)
        torch.cuda.synchronize()


def test_ffn_plan_of_the_c_side_is_the_python_one(dev):
    """csrc/ffn.cu:make_plan and ops/kernels/ffn.py:plan pick the same
    tiling (the CPU tests hold the Python one)."""
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    for D in (32, 36, 200, 256, 260, 384, 512, 1000, 1024, 1472):
        for H in (32, 1000, 1024, 4096):
            for k in (1, 3, 9, 31):
                for O in (1, 80, 200, D, 1025):
                    try:
                        want = KF.plan(D, H, k, O)
                    except ValueError:
                        with pytest.raises(ValueError):
                            KF.c_plan(D, H, k, O)
                        continue
                    assert KF.c_plan(D, H, k, O) == want, (D, H, k, O)


def test_two_threads_launch_the_ffn_at_two_widths(dev):
    """The server's two threads run the FFN at D=256 (encoder) and D=384
    (decoder): both kernels of the entry get other shared-memory sizes. Two
    threads call the C entry back to back: no launch may be refused, and
    each width's output stays what one thread alone gave."""
    import threading

    from fastspeech2_tpu_torch.models.encoder import EncoderConfig, FFTBlock
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    torch.manual_seed(6)
    jobs, keep = [], []
    for D in (256, 384):
        blk = FFTBlock(EncoderConfig(idim=D, attention_dim=D, linear_units=1024),
                       device=dev)
        x = torch.randn(1, 32, D, device=dev)
        lens = torch.tensor([20], dtype=torch.int32, device=dev)
        with torch.inference_mode():
            fp = blk.ffn_pack(torch.bfloat16)
            want = KF.ffn_block(x, *fp, lens, 9)  # binds KF._fn
        hid = torch.empty(KF.scratch_elems(1, 32, 1024, D), dtype=torch.bfloat16, device=dev)
        out = torch.empty_like(x)
        keep.append((blk, x, lens, fp, hid, out, want))
        jobs.append((x.data_ptr(), *(t.data_ptr() for t in fp), lens.data_ptr(),
                     hid.data_ptr(), out.data_ptr(), 1, 32, D, 1024, 9, 1e-5,
                     torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    refused = {}

    def run(args):
        refused[args[12]] = sum(1 for _ in range(5000) if KF._fn(*args))

    threads = [threading.Thread(target=run, args=(job,)) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert refused == {256: 0, 384: 0}, f"refused launches of 5000 per width: {refused}"
    for *_, out, want in keep:
        assert torch.equal(out, want)


def test_new_kernels_refuse_the_wrong_dtype(dev):
    """A CUDA tensor the kernels do not take raises; nothing falls back to
    the plain version."""
    from fastspeech2_tpu_torch.ops.kernels import attention as KA
    from fastspeech2_tpu_torch.ops.kernels import ffn as KF

    B, T, D = 2, 64, 256
    q = torch.randn(B, T, D, device=dev)  # f32: kernel 6 takes bf16 only
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    n = (KA.res_launches, KA.packed_launches, KA.bhtd_launches, KF.pre_launches,
         KF.bare_launches)
    wo, bo = torch.zeros(D, D, dtype=torch.bfloat16, device=dev), torch.zeros(D, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        KA.attention_res(q, q, q, q, wo, bo, lens, 2)
    qh = q.half()  # kernels 7 and 8 take bf16 or f32
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        KA.fused_attention_packed(qh, qh, qh, lens, 2)
    q4 = qh.reshape(B, 2, T, D // 2)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        KA.fused_attention(q4, q4, q4, lens)
    with pytest.raises(ValueError, match="d_k"):  # d_k 1032: past 1024
        qb = torch.zeros(B, 1, T, 1032, dtype=torch.bfloat16, device=dev)
        KA.fused_attention(qb, qb, qb, lens)
    w1 = torch.zeros(1024, 9 * D, dtype=torch.bfloat16, device=dev)
    w2 = torch.zeros(D, 1024, dtype=torch.bfloat16, device=dev)
    b1, b2 = torch.zeros(1024, device=dev), torch.zeros(D, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        KF.ffn_block_pre(q.to(torch.bfloat16), w1, b1, w2, b2, b2, b2, lens, 9)
    with pytest.raises(ValueError, match="dtype"):
        KF.fused_ffn(q, w1, b1, w2, b2, lens, 9)
    with pytest.raises(ValueError, match="out_dtype"):
        KF.fused_ffn(q.to(torch.bfloat16), w1, b1, w2, b2, lens, 9, torch.float16)
    assert (KA.res_launches, KA.packed_launches, KA.bhtd_launches, KF.pre_launches,
            KF.bare_launches) == n


def test_pth_weights_serve_on_the_card_like_the_cpu(dev, tmp_path):
    """A default-width model written as a reference .pth by the port's saver
    loads onto the card with the same weights and serves a B=8 bf16 batch
    within chip_smoke.py's band of the CPU port (``hold_b8_vs_cpu``)."""
    from fastspeech2_tpu_torch.compat.torch_loader import load_torch_model
    from fastspeech2_tpu_torch.compat.torch_saver import save_torch_checkpoint
    from fastspeech2_tpu_torch.config import Config
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2

    cfg = Config()
    src = FastSpeech2(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        src.duration_predictor.out.bias.fill_(1.87)
    path = str(tmp_path / "model.pth")
    save_torch_checkpoint(path, src, cfg, step=3)
    cfg2, step, model = load_torch_model(path, device=dev)
    assert step == 3 and cfg2.to_dict() == cfg.to_dict()
    for (n, a), (_, b) in zip(src.state_dict().items(), model.state_dict().items()):
        assert torch.equal(a, b.cpu()), n
    _smoke().hold_b8_vs_cpu(torch, Synthesizer(model, bf16=True, device=dev), cfg2, ".pth model")


def test_bucketed_b32_matches_the_unbucketed_rows(dev):
    """``mel_from_token_batch_bucketed`` at B=32 (three buckets) through
    kernels 1-4 against the unbucketed call on the same batch: the same
    lengths, every row's live frames within ``hold_b8_vs_cpu``'s band."""
    import numpy as np

    from fastspeech2_tpu_torch.config import Config
    from fastspeech2_tpu_torch.infer.synthesize import Synthesizer
    from fastspeech2_tpu_torch.ops.kernels import adaptor, attention, ffn, postnet

    smoke = _smoke()
    synth = Synthesizer(smoke.seeded_model(torch, Config()), bf16=True, device=dev)
    b32 = smoke.batch(32)
    plan = synth._bucket_plan([len(s) for s in b32], 3, 1.0)
    assert len(plan) == 3 and sorted(i for g in plan for i in g) == list(range(32))
    n0 = [m.launches for m in (attention, ffn, adaptor, postnet)]
    mel_b, lens_b = synth.mel_from_token_batch_bucketed(b32, max_buckets=3)
    torch.cuda.synchronize()
    assert all(m.launches > n for m, n in zip((attention, ffn, adaptor, postnet), n0))
    mel_u, lens_u = synth.mel_from_token_batch(b32)
    np.testing.assert_array_equal(lens_b, lens_u)
    for i in range(32):  # hold_b8_vs_cpu's band: mean < 0.02, max < 0.2
        n = int(lens_b[i])
        smoke.compare(f"row {i}", torch.from_numpy(mel_b[i, :n]),
                      torch.from_numpy(mel_u[i, :n]), 0.02, 0.2)


@pytest.mark.parametrize("m,k,n", [(1, 37, 45), (16, 256, 768), (6144, 3456, 1024),
                                   (40, 9, 1)])
def test_int8_product_on_the_card(dev, m, k, n):
    """The int8 tier's product (``ops/quant8.py:int_mm``, ``torch._int_mm``
    on operands padded to its shapes) equals the exact integer product at
    widths it takes as they are and at widths it must pad."""
    from fastspeech2_tpu_torch.ops import quant8

    g = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    bt = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    got = quant8.int_mm(a.to(dev), bt.to(dev))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), quant8.int_mm(a, bt))


def test_int8_layers_on_the_card(dev):
    """W8A8 linear and conv (k = 9) on the card against the CPU, step by
    step: the same quantized weights, activations and scales, the same
    integer product, and so the same output bits."""
    from fastspeech2_tpu_torch.ops import quant8

    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 45, 384, generator=g)
    xq, sx = quant8.dynamic_quantize(x)
    xqd, sxd = quant8.dynamic_quantize(x.to(dev))
    assert float(sxd) == float(sx), (float(sxd), float(sx))
    assert torch.equal(xqd.cpu(), xq), int((xqd.cpu() != xq).sum())
    for w, k in ((torch.randn(1024, 384, 9, generator=g) * 0.05, 9),
                 (torch.randn(200, 384, generator=g) * 0.05, None)):
        dims = (1, 2) if k else (1,)
        q, qd = quant8.quantize_weight(w, dims), quant8.quantize_weight(w.to(dev), dims)
        assert torch.equal(qd.s.cpu(), q.s), float((qd.s.cpu() - q.s).abs().max())
        assert torch.equal(qd.q.cpu(), q.q), int((qd.q.cpu() != q.q).sum())
        b = torch.randn(w.shape[0], generator=g)
        fn = quant8.int8_conv1d if k else quant8.int8_linear
        got, want = fn(x.to(dev), qd, b.to(dev)).cpu(), fn(x, q, b)
        assert torch.equal(got, want), (k, float((got - want).abs().max()),
                                        int((got != want).sum()), got.numel())


# -- parallel/: collectives on the card ----------------------------------------

_RANK_SCRIPT = r'''
import json, sys
backend, rank, world, port, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
import torch
import torch.distributed as dist
from fastspeech2_tpu_torch.parallel import mesh as pm
from fastspeech2_tpu_torch.train.step import sum_over_group

dev = torch.device("cuda", 0)
if world == 1:  # a formed group of one (initialize_multihost forms none)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
else:
    assert pm.initialize_multihost(f"localhost:{port}", world, rank, backend=backend,
                                   device="cuda") == world
assert dist.get_backend() == backend
group = dist.group.WORLD
x = (torch.arange(6, dtype=torch.float32, device=dev) + 10 * rank).requires_grad_()
y = pm.all_reduce_sum(x * (rank + 1), group)
y.square().sum().backward()
grads = [torch.full((3,), float(rank + 1), device=dev), torch.ones(5, device=dev)]
sum_over_group(grads, group, bucket=4)
res = {"sum": y.tolist(), "grad": x.grad.tolist(),
       "gather": pm.all_gather(torch.full((2, 1), float(rank), device=dev), group).tolist(),
       "buckets": [g.tolist() for g in grads], "any": pm.any_rank(rank == world - 1, dev),
       "on_card": y.is_cuda and x.grad.is_cuda}
json.dump(res, open(f"{out}.{rank}.json", "w"))
dist.destroy_process_group()
'''


def _run_ranks(tmp_path, backend, world):
    import json
    import os
    import socket
    import subprocess
    import sys

    script = tmp_path / "rank.py"
    script.write_text(_RANK_SCRIPT)
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    root = str(Path(__file__).resolve().parents[1])
    procs = [subprocess.Popen([sys.executable, str(script), backend, str(r), str(world),
                               str(port), str(tmp_path / "out")],
                              env={**os.environ, "PYTHONPATH": root},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), [o[-2000:] for o in outs]
    return [json.load(open(f"{tmp_path / 'out'}.{r}.json")) for r in range(world)]


def test_two_rank_gloo_collectives_of_cuda_tensors(dev, tmp_path):
    """Two gloo ranks share the card (NCCL refuses two ranks on one device):
    the differentiable sum over the group and its gradient, the bucketed
    gradient sum of the training step, the all-gather and the flag
    agreement, all on CUDA tensors."""
    r0, r1 = _run_ranks(tmp_path, "gloo", 2)
    base = [float(i) for i in range(6)]
    want = [a * 1 + (a + 10) * 2 for a in base]  # rank 0 x*1 + rank 1 x*2
    for r, res in enumerate((r0, r1)):
        assert res["on_card"]
        assert res["sum"] == want
        # d/dx_r sum_ranks sum(y^2) = 2 y * (r + 1) * world
        assert res["grad"] == [2 * w * (r + 1) * 2 for w in want]
        assert res["gather"] == [[0.0], [0.0], [1.0], [1.0]]
        assert res["buckets"] == [[3.0] * 3, [2.0] * 5] and res["any"] is True


def test_world_of_one_nccl_group(dev, tmp_path):
    """A formed NCCL group of one on the card: every collective of
    ``parallel/`` runs through NCCL and leaves the values as they are."""
    (res,) = _run_ranks(tmp_path, "nccl", 1)
    assert res["on_card"]
    assert res["sum"] == [float(i) for i in range(6)]
    assert res["grad"] == [2.0 * i for i in range(6)]
    assert res["gather"] == [[0.0], [0.0]]
    assert res["buckets"] == [[1.0] * 3, [1.0] * 5] and res["any"] is True
