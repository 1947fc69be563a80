from .circle_loss import (MultiPositiveCircleLoss, MultiPositiveSumLoss,
                          MultiPositiveUniLoss)
from .cross_entropy_loss import (BCELossWithLogits, CrossEntropyLoss,
                                 CrossEntropyLossTorch, NLLLoss, TripletLoss,
                                 WeightedCrossEntropyLoss_torch,
                                 cross_entropy, soft_cross_entropy)

__all__ = ['CrossEntropyLoss', 'CrossEntropyLossTorch', 'BCELossWithLogits',
           'NLLLoss', 'WeightedCrossEntropyLoss_torch', 'TripletLoss',
           'MultiPositiveSumLoss', 'MultiPositiveUniLoss',
           'MultiPositiveCircleLoss', 'cross_entropy', 'soft_cross_entropy']
