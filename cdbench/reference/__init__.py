"""The plain reference of copy detection: the paper's exact pair score
(Eqs. 2-8) and its decision, in PyTorch, independent of the program."""
from .exact import (
    CopyModel,
    decide,
    pair_scores_dense,
    square_scores,
    z_scores,
)

__all__ = ["CopyModel", "decide", "pair_scores_dense", "square_scores",
           "z_scores"]
