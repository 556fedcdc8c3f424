"""The port's paged engine across the reference's serving flag cube at
bfloat16 activations, the reference cube's own dtype: the checks of
``test_torch_flag_cube.py`` (the dense oracle's tokens, the reference
engine's counters, each feature engaged), in a file of its own so that
the two dtypes run on separate workers.
"""
import pytest

from test_torch_flag_cube import CUBE, check_corner, check_point


@pytest.mark.parametrize("prefix_cache,fused,spec,adaptive,chunked", CUBE)
def test_flag_cube_matches_dense_oracle_and_reference(
        prefix_cache, fused, spec, adaptive, chunked):
    check_point((prefix_cache, fused, spec, adaptive, chunked), "bfloat16")


def test_flag_cube_corner_reproduces_the_reference_verdicts():
    check_corner("bfloat16")
