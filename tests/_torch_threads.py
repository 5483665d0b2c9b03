"""Shared helper of the torch port's tests: one intra-op thread per test
process. The tests run small tensors in several worker processes at
once; with torch's default of one thread per core, every reduction of
the plain step waits on a thread pool that the other workers keep busy.
The values do not depend on the thread count (the engine is integer
arithmetic). Imported for its effect."""

import torch

torch.set_num_threads(1)
