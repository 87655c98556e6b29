"""PyTorch port: dy2static's loops against the JAX package (its
``tests/test_dy2static.py``, the cases with a loop; the branches are in
``test_torch_dy2static.py``).  Each case's function is written once
against either package (``torch_dy2static_cases``); both trace it on
one input, the port's converted program has the JAX program's op types
block by block, and both programs reproduce eager dygraph on every
input: loops of 0, 1 and several trips, breaks and returns at each
site.  The values are float32 sums and products of powers of two and
small integers, exact in both packages (``rtol`` 0), except the two
cases the JAX test holds to 1e-5."""
import pytest

from torch_dy2static_run import run_case
from torch_dygraph_parity import _jax_eager_keys_kept  # noqa: F401

CASES = ["while_data_dependent_trip_count", "for_range_with_break",
         "python_control_flow_stays_python",
         "break_leaves_loop_var_at_breaking_index",
         "two_break_sites_nested_guards", "return_inside_while_loop",
         "return_inside_for_range_loop",
         "statements_after_returning_loop_are_guarded",
         "for_over_tensor_rows_with_list_append",
         "zero_trip_range_keeps_existing_var", "return_inside_loop_converts",
         "container_for_with_break_stays_python",
         "container_for_break_still_converts_tensor_ifs",
         "return_inside_nested_loop", "return_in_both_arms_inside_loop"]


@pytest.mark.parametrize("name", CASES)
def test_case_matches_jax_and_eager(name):
    types = run_case(name)
    if name == "while_data_dependent_trip_count":
        assert "while" in types[0]
    if name == "container_for_break_still_converts_tensor_ifs":
        assert "cond_pair" in types[0]
