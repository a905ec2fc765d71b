from .mps import mps_parser, save_mps, to_sparse_lp
from .netlib import get_problem
