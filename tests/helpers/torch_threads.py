"""Cap torch's CPU threads for the port's test files (tests/test_torch_*.py).

Six pytest-xdist workers share the machine's cores, so each port test file
runs its tests with 2 torch threads. The cap is set and undone by a
module-scoped autouse fixture, not at import: every worker imports every
test file while it collects, and a cap set then would hold for the other
files' tests in that worker too. Import the fixture into a test module to
apply it there.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
