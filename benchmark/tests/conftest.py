"""Few threads a test process: the cells here are toy sizes, and several
workers with a thread per core each only contend."""

import os

import torch

os.environ.setdefault("OMP_NUM_THREADS", "2")
torch.set_num_threads(2)
