"""One intra-op thread for torch in a test process: every
``tests/test_torch_*.py`` imports this module first.

The tier-1 command runs the suite in six pytest workers on the machine's
cores. At torch's default, an OpenMP team of one thread per core in every
worker, the six teams oversubscribe the cores and spin waiting on each
other: the chip-smoke rehearsals took 2238 s of test time at the default
and 173 s at one thread, six workers on eight cores either way. A test that
wants more threads sets them itself.
"""

import torch

torch.set_num_threads(1)
