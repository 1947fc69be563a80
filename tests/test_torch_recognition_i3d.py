"""The I3D recipes (``i3d_r50_dense_32x2x1``, with validation, and
``i3d_r50_lazy_32x2x1``, whose val pipeline is NTHWC) through
``train_model`` against mscl_tpu's (tests/_torch_recognition_util.py)."""
import pytest

from _torch_data_util import one_torch_thread  # noqa: F401
from _torch_port_util import xla3d_conv  # noqa: F401
from _torch_recognition_util import check, sets  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread', 'xla3d_conv')


@pytest.mark.parametrize('name,validate', [
    ('recognition/i3d/i3d_r50_dense_32x2x1_100e_kinetics400_rgb.py', True),
    ('recognition/i3d/i3d_r50_lazy_32x2x1_100e_kinetics400_rgb.py', False),
])
def test_train_model_matches_jax(sets, tmp_path, name, validate):
    check(name, *sets['rgb'], str(tmp_path), validate, x64=True)
