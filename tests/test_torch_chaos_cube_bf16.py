"""The chaos cube of ``test_torch_chaos_cube.py`` at bfloat16
activations, the reference cube's own dtype, in a file of its own so
that the two dtypes run on separate workers.
"""
import pytest

from test_torch_chaos_cube import CHAOS_CUBE, check_chaos_point


@pytest.mark.parametrize("prefix_cache,fused,spec,chunked", CHAOS_CUBE)
def test_chaos_cube_matches_dense_oracle_and_reference(prefix_cache, fused,
                                                       spec, chunked):
    check_chaos_point((prefix_cache, fused, spec, chunked), "bfloat16")
