"""Two consecutive train steps of the ablation tool's arms moco (MoCoV2 on
its own with SyncMoCoAugmentV5), modist (MoDist) and mscl_nofra (MSCL with
MoDistv2PosHead, one flow pass) in mscl_torch against mscl_tpu, at the
tool's tiny scale on its own batches, each arm's config the JAX tool's
(tests/_torch_ablation_util.py); every loss, the queues, the EMA, the BN
statistics and the parameters after SGD."""
import pytest

from _torch_ablation_util import case_runs
from _torch_ablation_util import (  # noqa: F401  the checks, run here
    test_bn_running_stats_match, test_ema_key_params_match, test_losses_match,
    test_queue_state_matches, test_sgd_updated_params_match)
from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import xla3d_conv  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


@pytest.fixture(scope='module', params=['moco', 'modist', 'mscl_nofra'])
def runs(request, xla3d_conv):
    return case_runs(request.param)
