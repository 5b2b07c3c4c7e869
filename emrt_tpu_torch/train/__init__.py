"""Training (counterpart of ``emrt_tpu/train``): the step, and the CLI's
``main`` (``python -m emrt_tpu_torch.train``).

The JAX package's ``TrainState`` has no counterpart: the ``nn.Module`` holds
the parameters and BatchNorm statistics, the optimizer its momentum buffers
and the step count, and both change in place.
"""
from .cli import main
from .step import make_train_step
