from .batch_norm import BatchNorm3d
from .decayed_infonce import (decay_weights, decayed_neg, dq, dq_plain,
                              l_neg, l_neg_plain)

__all__ = ['BatchNorm3d', 'decay_weights', 'decayed_neg', 'dq', 'dq_plain',
           'l_neg', 'l_neg_plain']
# the corr_lookup module is reached as mscl_torch.ops.corr_lookup: its
# function of the same name is not re-exported, so the two do not collide
