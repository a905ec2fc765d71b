import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
# one thread a test process: the tests run side by side in several workers
torch.set_num_threads(1)
