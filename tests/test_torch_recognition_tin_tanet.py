"""The frame-based recipes TIN (``tin_r50_1x1x8``: the TIN lr policy, its
warmup over the first epoch), TANet (``tanet_r50_1x1x8``), TSM on
MobileNetV2 (``tsm_mobilenetv2_1x1x8``) and C3D (``c3d_sports1m_16x1x1``,
its clips formatted NCTHW) through ``train_model`` against mscl_tpu's,
narrowed (tests/_torch_recognition_util.py). C3D has no BN, so JAX runs
it in float32. TIN and TANet also pass a change within two float32
spacings of the parameter (``check``'s ``spacing_floor``)."""
import pytest

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import xla3d_conv  # noqa: F401
from _torch_recognition_util import check, sets  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread', 'xla3d_conv')
R = 'recognition/'


@pytest.mark.parametrize('name,x64', [
    (R + 'tin/tin_r50_1x1x8_40e_sthv1_rgb.py', True),
    (R + 'tanet/tanet_r50_1x1x8_100e_kinetics400_rgb.py', True),
    (R + 'mobilenet_v2/tsm_mobilenetv2_1x1x8_50e_kinetics400_rgb.py', True),
    (R + 'c3d/c3d_sports1m_16x1x1_45e_ucf101_rgb.py', False),
])
def test_train_model_matches_jax(sets, tmp_path, name, x64):
    check(name, *sets['rgb'], str(tmp_path), False, x64=x64,
          ncthw='c3d' in name, spacing_floor='/tin/' in name or
          '/tanet/' in name)
