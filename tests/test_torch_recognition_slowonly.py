"""The SlowOnly recipes through ``train_model`` against mscl_tpu's
(tests/_torch_recognition_util.py): ``slowonly_r50_8x8x1`` and
``slowonly_imagenet_pretrained_r50_8x4x1`` with validation, and
``slowonly_r50_4x16x1_..._flow`` (two-channel clips of grey x/y flow
frames; its val pipeline is NTHWC, so no validation)."""
import pytest

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import xla3d_conv  # noqa: F401
from _torch_recognition_util import check, sets  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread', 'xla3d_conv')
S = 'recognition/slowonly/'


@pytest.mark.parametrize('name', [
    S + 'slowonly_r50_8x8x1_256e_kinetics400_rgb.py',
    S + 'slowonly_imagenet_pretrained_r50_8x4x1_64e_kinetics400_rgb.py'])
def test_train_model_matches_jax(sets, tmp_path, name):
    check(name, *sets['rgb'], str(tmp_path), True, x64=True)


def test_flow_train_model_matches_jax(sets, tmp_path):
    check(S + 'slowonly_r50_4x16x1_256e_kinetics400_flow.py', *sets['flow'],
          str(tmp_path), False, x64=True)
