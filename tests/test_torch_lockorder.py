"""The lock-order witness (``utils/lockorder.py``, a verbatim copy) on the
port: the fast negative controls of tests/test_lockorder_witness.py, read
onto the port's copy (tests/torch_ported.py). They prove the witness
records nesting and that ``assert_within`` fails on a stray edge."""
from tests.torch_ported import ported

from karpenter_core_tpu_torch.utils import lockorder

_ref = ported("test_lockorder_witness")
assert _ref.lockorder is lockorder

test_nested_acquisition_records_edge_and_fails_empty_graph = (
    _ref.test_nested_acquisition_records_edge_and_fails_empty_graph)
test_reentrant_reacquire_records_no_edge = (
    _ref.test_reentrant_reacquire_records_no_edge)
test_release_pops_lifo_and_tolerates_interleave = (
    _ref.test_release_pops_lifo_and_tolerates_interleave)
test_per_thread_stacks_do_not_cross = _ref.test_per_thread_stacks_do_not_cross
test_witness_proxy_passes_through = _ref.test_witness_proxy_passes_through
test_maybe_wrap_honors_env_flag = _ref.test_maybe_wrap_honors_env_flag
