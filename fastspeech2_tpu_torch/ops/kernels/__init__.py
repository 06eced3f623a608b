"""Wrappers of the port's hand-written CUDA kernels (sources in ``csrc/``).

Each module holds its kernels' wrappers, their plain PyTorch versions and the
launch counters. Fourteen kernels, by the TPU kernel each replaces:

- ``attention.attention_block``: post-LN FFT-block attention half with the
  QKV projections (``ops/pallas/attention.py:fused_attention_packed_qkv_res_ln``)
- ``attention.attention_res_ln``: the same with q/k/v given
  (``ops/pallas/attention.py:fused_attention_packed_res_ln``)
- ``attention.attention_res``: pre-LN attention half, q/k/v given, no LN
  (``ops/pallas/attention.py:fused_attention_packed_res``)
- ``attention.fused_attention_packed``: bare masked attention, heads packed
  along D (``ops/pallas/attention.py:fused_attention_packed``)
- ``attention.fused_attention``: the same in (B, H, T, dk)
  (``ops/pallas/attention.py:fused_attention``)
- ``ffn.ffn_block``: post-LN FFT-block conv-FFN half
  (``ops/pallas/ffn.py:fused_ffn_block_post``)
- ``ffn.ffn_block_pre``: pre-LN FFT-block conv-FFN half
  (``ops/pallas/ffn.py:fused_ffn_block``)
- ``ffn.fused_ffn``: bare masked conv-FFN (``ops/pallas/ffn.py:fused_ffn``)
- ``adaptor.variance_adaptor``: variance adaptor
  (``ops/pallas/adaptor.py:fused_variance_adaptor``)
- ``postnet.postnet``: postnet chain (``ops/pallas/postnet.py:fused_postnet``)
- ``resstack.resstack``: MelGAN residual stack
  (``ops/pallas/resstack.py:resstack_fused``)
- ``attention_train.fused_attention_train_packed``: training attention with
  hash dropout, head-packed, forward and backward
  (``ops/pallas/attention_train.py:fused_attention_train_packed``)
- ``attention_train.fused_attention_train``: its (B, H, T, dk) twin
  (``ops/pallas/attention_train.py:fused_attention_train``)
- ``stft.stft_mel_energy``: STFT -> mel -> log plus energy, full f32
  (``ops/pallas/stft.py:stft_mel_energy``)

``launch_counts()`` reads every counter (the server's ``/healthz`` reports
them), ``reset_launch_counts()`` sets them to 0.
"""

import importlib

#: every wrapper's launch counter: name -> (module, attribute)
COUNTERS = {
    "attention_block": ("attention", "launches"),
    "attention_res_ln": ("attention", "res_ln_launches"),
    "attention_res": ("attention", "res_launches"),
    "fused_attention_packed": ("attention", "packed_launches"),
    "fused_attention": ("attention", "bhtd_launches"),
    "ffn_block": ("ffn", "launches"),
    "ffn_block_pre": ("ffn", "pre_launches"),
    "fused_ffn": ("ffn", "bare_launches"),
    "variance_adaptor": ("adaptor", "launches"),
    "postnet": ("postnet", "launches"),
    "resstack": ("resstack", "launches"),
    "attention_train_packed": ("attention_train", "packed_fwd_launches"),
    "attention_train_packed.bwd": ("attention_train", "packed_bwd_launches"),
    "attention_train": ("attention_train", "fwd_launches"),
    "attention_train.bwd": ("attention_train", "bwd_launches"),
    "stft_mel_energy": ("stft", "launches"),
}


def _counter(name):
    mod, attr = COUNTERS[name]
    return importlib.import_module(f"{__name__}.{mod}"), attr


def launch_counts():
    """{counter name: launches so far} of every kernel wrapper."""
    return {k: getattr(*_counter(k)) for k in COUNTERS}


def reset_launch_counts():
    from fastspeech2_tpu_torch.ops.kernels.common import count_lock

    with count_lock:
        for k in COUNTERS:
            setattr(*_counter(k), 0)
