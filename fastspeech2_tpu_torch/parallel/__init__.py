"""Data, tensor and sequence parallelism on ``torch.distributed``
(``fastspeech2_tpu/parallel/``): process groups, the mesh value, the
training window's rows and host gathers (``mesh.py``); the Megatron split of
the FFT blocks (``sharding.py``). The training step and loop
(``train/step.py``, ``train/loop.py``) and the ``Synthesizer``
(``infer/synthesize.py``, the sharded inference) consume it.
"""

from fastspeech2_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    gather_to_host,
    initialize_multihost,
    make_mesh,
)
from fastspeech2_tpu_torch.parallel.sharding import (  # noqa: F401
    check_tp_divisibility,
    make_mesh_2d,
    shard_model,
)
