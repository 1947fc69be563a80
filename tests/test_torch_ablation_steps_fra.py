"""Two consecutive train steps of the ablation tool's FRA arms, mscl
(MSCLWithAug on MDS offsets) and mscl_nomds (on uniform offsets), in
mscl_torch against mscl_tpu, as tests/test_torch_ablation_steps.py holds
the other arms (tests/_torch_ablation_util.py)."""
import pytest

from _torch_ablation_util import case_runs
from _torch_ablation_util import (  # noqa: F401  the checks, run here
    test_bn_running_stats_match, test_ema_key_params_match, test_losses_match,
    test_queue_state_matches, test_sgd_updated_params_match)
from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import xla3d_conv  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


@pytest.fixture(scope='module', params=['mscl', 'mscl_nomds'])
def runs(request, xla3d_conv):
    return case_runs(request.param)
