"""One torch intra-op thread while a test module of the port runs.

Import the fixture into a test module to use it:
``from torch_threads import one_torch_thread  # noqa: F401``.

Under ``pytest -n 6`` every worker's torch spins a pool of as many threads
as the host has cores, and a small CPU run of the port slows tens of times
beside the other workers (tests/test_torch_stencil_sht_layout.py's
stencil-weight cases beside five busy processes on eight cores: 219 s with
eight threads, 22 s with one). The checks are unchanged.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
