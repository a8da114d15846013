"""In-process TensorBoard launcher — counterpart of
`tfde_tpu/observability/tb_server.py` (`start_tensorboard` :20), the
reference's worker-0 TensorBoard (mnist_keras_distributed.py:27-28,
192-197, 277-280).

On the chief only (rank 0 of the process group, or a process alone), on
the port from the argument, else ``$TB_PORT``, else 6006. Where the
`tensorboard` package is missing or fails to start, it logs the
equivalent command line instead: the event files the port writes
(`observability.tensorboard`) are standard, and any TensorBoard reads
them. This is host tooling; nothing on the device depends on it.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch.distributed as dist

log = logging.getLogger(__name__)


def start_tensorboard(logdir: str, port: Optional[int] = None
                      ) -> Optional[str]:
    """Launch TensorBoard on `logdir`; its URL, or None off the chief or
    when it cannot start (then the command line is logged)."""
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    if port is None:  # an explicit argument wins over the variable
        try:
            port = int(os.environ["TB_PORT"])
        except (KeyError, ValueError):
            port = 6006
    try:
        import tensorboard.program as tb_program

        tb = tb_program.TensorBoard()
        tb.configure(logdir=logdir, port=port)
        url = tb.launch()
    except Exception as e:  # not installed, or it failed to start
        log.info("in-process TensorBoard unavailable (%s); run externally: "
                 "tensorboard --logdir=%s --port=%d", e, logdir, port)
        return None
    log.info("TensorBoard started at %s --logdir=%s", url, logdir)
    return url
