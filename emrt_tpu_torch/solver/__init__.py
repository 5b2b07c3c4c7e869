from .lr_scheduler import get_scheduler, polynomial_decay
from .optimizer import SGD, get_optimizer
