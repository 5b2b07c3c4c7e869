from .dataset import Dataset
from .datasets import (ADE20K, CocoStuff, Cityscapes, LoveDA, PascalContext,
                       Potsdam, SyntheticDataset, Trans10kV2, VaihingenISPRS,
                       get_dataset)
from .loader import DataLoader, IterationSampler, val_batches
from .transforms import get_transforms
