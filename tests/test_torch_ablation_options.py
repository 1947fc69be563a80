"""Two consecutive train steps of the ablation tool's mscl arm with each
option of MSCLWithAug, in mscl_torch against mscl_tpu: the base and
rotated flow passes as one forward at 2B (``batch_flow_passes``: joint BN
statistics) and the two passes under two flow keys (a list ``flow_key``),
as tests/test_torch_ablation_steps.py holds the arms
(tests/_torch_ablation_util.py)."""
import pytest

from _torch_ablation_util import case_runs
from _torch_ablation_util import (  # noqa: F401  the checks, run here
    test_bn_running_stats_match, test_ema_key_params_match, test_losses_match,
    test_queue_state_matches, test_sgd_updated_params_match)
from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import xla3d_conv  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


@pytest.fixture(scope='module', params=['batch_flow_passes', 'two_flow_keys'])
def runs(request, xla3d_conv):
    return case_runs(request.param)
