from .cross_entropy_loss import (CrossEntropyLoss, CrossEntropyLossTorch,
                                 cross_entropy, soft_cross_entropy)

__all__ = ['CrossEntropyLoss', 'CrossEntropyLossTorch', 'cross_entropy',
           'soft_cross_entropy']
