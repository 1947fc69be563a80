from .bmn_loss import (BinaryLogisticRegressionLoss, BMNLoss,
                       binary_logistic_regression_loss)
from .circle_loss import (MultiPositiveCircleLoss, MultiPositiveSumLoss,
                          MultiPositiveUniLoss)
from .cross_entropy_loss import (BCELossWithLogits, CrossEntropyLoss,
                                 CrossEntropyLossTorch, NLLLoss, TripletLoss,
                                 WeightedCrossEntropyLoss_torch,
                                 cross_entropy, soft_cross_entropy)
from .hvu_loss import HVULoss, OHEMHingeLoss, ohem_hinge_loss

__all__ = ['CrossEntropyLoss', 'CrossEntropyLossTorch', 'BCELossWithLogits',
           'NLLLoss', 'WeightedCrossEntropyLoss_torch', 'TripletLoss',
           'MultiPositiveSumLoss', 'MultiPositiveUniLoss',
           'MultiPositiveCircleLoss', 'cross_entropy', 'soft_cross_entropy', 'BMNLoss',
           'BinaryLogisticRegressionLoss', 'binary_logistic_regression_loss',
           'HVULoss', 'OHEMHingeLoss', 'ohem_hinge_loss']
