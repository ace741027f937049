"""`one_thread`, a module-scoped autouse fixture for the port's CPU test
files whose eager torch work is many small ops (the engines, the train
step, the MoE dispatches): the module's torch ops run on one intra-op
thread and the previous count comes back after it. Where the test workers
share the cores, a multi-threaded small op waits for its pool's threads
to be scheduled: an MLA engine case took 0.2 s alone and 8-75 s beside
five other workers, and 0.2-0.5 s there on one thread. Import it into a
test module to apply it:

    from torch_threads import one_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
