"""Process-wide switches of the serving and training paths, read once at import.

Same names and environment variables as ``fastspeech2_tpu/ops/flags.py``, so
one environment configures both packages. Set the variable before the first
``fastspeech2_tpu_torch`` import; tests monkeypatch these attributes.
"""

import os

#: the fused variance-adaptor kernel (ops/kernels/adaptor.py) on the bf16
#: serving path. FS2_FUSED_ADAPTOR=off takes the module-by-module ops.
FUSED_ADAPTOR: bool = os.environ.get("FS2_FUSED_ADAPTOR", "on") != "off"

#: the fused [attention -> out-proj -> +residual] block half.
#: FS2_FUSED_ATT_RES=off selects the bare fused attention kernel
#: (ops/kernels/attention.py:mha_fused_apply) with plain projections around it.
FUSED_ATT_RES: bool = os.environ.get("FS2_FUSED_ATT_RES", "on") != "off"

#: QKV projections inside the post-LN attention block kernel
#: (ops/kernels/attention.py:attention_block). FS2_FUSED_ATT_QKV=off projects
#: q/k/v with plain ops and takes the split [attention+res+LN] kernel
#: (attention_res_ln).
FUSED_ATT_QKV: bool = os.environ.get("FS2_FUSED_ATT_QKV", "on") != "off"

#: size the decode frame buffer from the exact frame demand read after the
#: encode (infer/synthesize.py). FS2_DEMAND_SIZED=off uses the
#: frames-per-token heuristic buffer with saturation re-bucketing.
DEMAND_SIZED: bool = os.environ.get("FS2_DEMAND_SIZED", "on") != "off"

#: run the duration head in f32 inside the bf16 tier: its exp/round/clamp sits
#: on a rounding knife-edge, and a flipped integer duration shifts every later
#: frame. FS2_F32_DURATION=off runs the head in bf16.
F32_DURATION: bool = os.environ.get("FS2_F32_DURATION", "on") != "off"

#: head-packed (B, T, D) training attention kernel
#: (ops/kernels/attention_train.py:fused_attention_train_packed): no
#: (B,T,H,dk)<->(B,H,T,dk) transposes around the projections.
#: FS2_FUSED_ATT_TRAIN_PACKED=off takes the (B, H, T, dk) entry
#: (fused_attention_train) for every length.
FUSED_ATT_TRAIN_PACKED: bool = (
    os.environ.get("FS2_FUSED_ATT_TRAIN_PACKED", "on") != "off")
