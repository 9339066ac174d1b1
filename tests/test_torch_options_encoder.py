"""The encoder with the options of the multi-view transformer and the
regressor that no configuration reaches, port vs the JAX package: window
splits 4 and 1, each view matched against its 3 nearest of 5, the
regressor's features projected to 32. The helpers and bounds of
test_torch_options.py."""

import pytest

from test_torch_options import check_option
from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_unimatch_encoder import vitt  # noqa: F401

OPTIONS = {
    # name: (num_scales, views, training, overrides); each holds several options
    "attn_split_4_knn_3_features_32": (
        1, 5, False, dict(multiview_trans_attn_split=4, local_mv_match=3, regressor_feature_channels=32),
    ),
    "attn_split_1": (1, 2, False, dict(multiview_trans_attn_split=1)),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_matches_jax(vitt, name):  # noqa: F811
    """The transformer's window splits at 4 (windows of 2 x 4 on the 8 x 16
    features) and at 1 (full attention), each view matched against its 3
    nearest of 5, the regressor's features projected to 32."""
    check_option(vitt, name, OPTIONS)
