"""The port's paged suffix prefill against the JAX reference on the CPU,
on the tiny grok config, whose MoE FFN runs in every suffix, chunk and
verify pass at the capacity that W tokens give: the checks of
``test_torch_suffix.py`` (same cases and tolerances), in a file of its
own so that the two run on separate workers.
"""
import pytest

from test_torch_suffix import (CASES, CHUNKS, FNS, check_chunks_compose,
                               check_page_copy, check_suffix_function)

ARCH = "grok-1-314b"


@pytest.mark.parametrize("start,n_valid,W", CASES)
@pytest.mark.parametrize("fn", FNS)
def test_suffix_functions_match_reference(fn, start, n_valid, W):
    check_suffix_function(fn, start, n_valid, W, ARCH)


def test_page_copy_matches_reference_exactly():
    check_page_copy(ARCH)


@pytest.mark.parametrize("start,chunk,end", CHUNKS)
def test_chunks_compose_to_one_suffix_pass(start, chunk, end):
    check_chunks_compose(ARCH, start, chunk, end)
