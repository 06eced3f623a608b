"""Data pipeline: filelist parsing, feature store, bucketed batching,
per-host sharding, background prefetch to the device."""

from fastspeech2_tpu_torch.data.filelist import FilelistEntry, parse_filelist  # noqa: F401
from fastspeech2_tpu_torch.data.dataset import TTSDataset, remove_outlier  # noqa: F401
from fastspeech2_tpu_torch.data.batching import BucketBatcher, pad_batch  # noqa: F401
