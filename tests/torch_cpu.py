"""One torch thread in every test worker process.

The suite runs in several worker processes at once, and each would give
torch (OpenMP) as many threads as the machine has cores; on 6 workers
their contention cost the port's CPU tests three times their wall time,
and the whole suite ran past its time limit.  Every tests/test_torch_*.py
module imports this module, so each worker sets torch to one thread while
it collects the tests, before any test runs.
"""

import torch

torch.set_num_threads(1)
