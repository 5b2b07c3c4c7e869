"""Data, tensor and spatial parallelism (counterpart of ``emrt_tpu/parallel``):
the process grid and its rank helpers (``mesh``), BatchNorm over the global
batch (``sync_bn``), the model split over a model group (``tensor``), the
image rows split over a spatial group (``spatial``) and a launcher of ranks
from inside a program (``launch``)."""
from .mesh import (barrier, check_parallel, distributed, is_distributed, is_main, rank,
                   world_size)
from .sync_bn import SyncBatchNorm1d, SyncBatchNorm2d, convert_sync_batchnorm
