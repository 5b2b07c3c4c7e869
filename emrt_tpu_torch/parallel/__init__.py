"""Data parallelism (counterpart of ``emrt_tpu/parallel``): the process
group and its rank helpers (``mesh``), BatchNorm over the global batch
(``sync_bn``) and a launcher of ranks from inside a program (``launch``)."""
from .mesh import (barrier, check_parallel, distributed, is_distributed, is_main, rank,
                   world_size)
from .sync_bn import SyncBatchNorm1d, SyncBatchNorm2d, convert_sync_batchnorm
