"""Wrappers of the port's hand-written CUDA kernels (sources in ``csrc/``).

Each module holds its kernels' wrappers, their plain PyTorch versions and the
launch counters. Nine kernels, by the TPU kernel each replaces:

- ``attention.attention_block``: post-LN FFT-block attention half with the
  QKV projections (``ops/pallas/attention.py:fused_attention_packed_qkv_res_ln``)
- ``attention.attention_res_ln``: the same with q/k/v given
  (``ops/pallas/attention.py:fused_attention_packed_res_ln``)
- ``ffn.ffn_block``: post-LN FFT-block conv-FFN half
  (``ops/pallas/ffn.py:fused_ffn_block_post``)
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
"""
