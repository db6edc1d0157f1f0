from .whitening import (
    mvnormal_negll, mvnormal_negll_grad,
    optimize_whitening, make_train_step, WhiteningResult,
)
from .vi import neg_elbo, neg_elbo_stl, optimize_elbo, VIResult

__all__ = [
    "mvnormal_negll", "mvnormal_negll_grad",
    "optimize_whitening",
    "make_train_step", "WhiteningResult",
    "neg_elbo", "neg_elbo_stl", "optimize_elbo", "VIResult",
]
