from .cross_entropy_loss import (BCELossWithLogits, CrossEntropyLoss,
                                 CrossEntropyLossTorch, NLLLoss,
                                 WeightedCrossEntropyLoss_torch,
                                 cross_entropy, soft_cross_entropy)

__all__ = ['CrossEntropyLoss', 'CrossEntropyLossTorch', 'BCELossWithLogits',
           'NLLLoss', 'WeightedCrossEntropyLoss_torch', 'cross_entropy',
           'soft_cross_entropy']
