"""The frame-based recipes TSN (``tsn_r50_1x1x3``, with validation), TSM
(``tsm_r50_1x1x8``) and TRN (``trn_r50_1x1x8``, JAX's subset draws replayed)
through ``train_model`` against mscl_tpu's, narrowed to ResNet-18
(tests/_torch_recognition_util.py). TSM also passes a change within two
float32 spacings of the parameter (``check``'s ``spacing_floor``: a BN
scale near 1 in layer4 moves by about 1e-6 in two steps)."""
import pytest

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_recognition_util import check, sets  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')
R = 'recognition/'


@pytest.mark.parametrize('name,validate', [
    (R + 'tsn/tsn_r50_1x1x3_100e_kinetics400_rgb.py', True),
    (R + 'tsm/tsm_r50_1x1x8_50e_kinetics400_rgb.py', False),
    (R + 'trn/trn_r50_1x1x8_50e_sthv1_rgb.py', False),
])
def test_train_model_matches_jax(sets, tmp_path, name, validate):
    check(name, *sets['rgb'], str(tmp_path), validate, x64=True,
          spacing_floor='/tsm/' in name)
