from .cross_entropy import (CrossEntropyLoss, MixSoftmaxCrossEntropyLoss,
                            get_loss_function)
