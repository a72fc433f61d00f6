"""The data-parallel updates of Proto, APS, NEWAPS, UVF, GoalTD3 and GoalSM
at two gloo processes against JAX's ``make_dp_trainer`` on a 2-device mesh.

As ``tests/test_torch_parallel_agents.py`` (one spawn of
``tests/torch_dp_worker.py`` for the file, the cases of
``tests/torch_dp_agents.py``). The coupled terms here: Proto's
Sinkhorn-Knopp over the target scores of the global batch and its
candidates drawn from the global batch into the replicated queue (the same
on every process, its pointer advanced by the number of candidates); APS's
and NEWAPS's ``pbe``; NEWAPS's whitening by the pseudo-inverse of the
covariance of the global batch's φ̂ (``future_ratio`` > 0); the permutation
of the global batch's goals (UVF, GoalTD3, GoalSM). At one process, the
data-parallel update equals the plain one to the bit.
"""

import pytest
import torch

from test_torch_parallel import _spawn, one_process_group  # noqa: F401
from torch_dp_agents import CASES, check_one_process, check_two_processes, two_process_refs

NAMES = ["proto", "aps", "new_aps_future", "uvf", "goal_td3_replay", "goal_sm_permuted"]


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the suite runs in several processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    folder = tmp_path_factory.mktemp("dp2_more")
    refs = two_process_refs(folder, NAMES)
    return _spawn(folder), refs


@pytest.mark.parametrize("name", NAMES)
def test_dp_update_at_two_processes(two_processes, name) -> None:
    outs, refs = two_processes
    check_two_processes(outs, refs, name)


def test_proto_queue_takes_the_global_candidates(two_processes) -> None:
    """Every process pushes the same ``num_protos`` candidates, drawn over the
    global batch, into its queue: the queues and pointers are equal, the
    pointer advanced by the number of candidates, and the rows written are
    the single-process update's."""
    outs, refs = two_processes
    protos = CASES["proto"].cfg["num_protos"]
    queues = [out["agent_updates"]["proto"]["state"] for out in outs]
    assert int(queues[0]["queue_ptr"]) == int(queues[1]["queue_ptr"]) == protos
    assert torch.equal(queues[0]["queue"], queues[1]["queue"])
    single = refs["proto"]["single_state"]
    torch.testing.assert_close(queues[0]["queue"][:protos], single["queue"][:protos],
                               rtol=1e-4, atol=1e-5)
    assert not bool(queues[0]["queue"][protos:].any())


@pytest.mark.parametrize("name", NAMES)
def test_dp_update_at_one_process_is_the_plain_update(
        one_process_group, name) -> None:  # noqa: F811
    check_one_process(one_process_group, name)
