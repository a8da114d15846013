"""Host data pipeline and device feed — counterpart of `tfde_tpu/data`:
`Dataset` and `AutoShardPolicy` (`pipeline`), `device_prefetch`
(`device`), and the `datasets` the ported paths use."""

from tfde_tpu_torch.data.device import device_prefetch  # noqa: F401
from tfde_tpu_torch.data.pipeline import AutoShardPolicy, Dataset  # noqa: F401
