from .logger import get_logger, logger
from .metrics import (MetricAccumulator, accuracy, confusion_matrix, f1_scores,
                      kappa, mean_iou)
from .timer import TimeAverager, Timer, calculate_eta
