"""Multi-device / multi-host execution: mesh construction, row-sharded
fits with XLA collectives, and fold-sharded cross-validation.

The reference has no parallelism of any kind (single thread, no comm
backend — SURVEY.md §2 "Parallelism inventory"); this package is the
scaling layer the north star demands: rows of X/Y sharded
across a pod slice with psum/all-reduce for the cross-product and norm
reductions, CV folds and bootstrap replicates vmapped into scenario
batches sharded across chips.
"""

from pls_tpu.parallel.mesh import make_pls_mesh, initialize_distributed
from pls_tpu.parallel.sharded import (
    fit_sharded,
    fit_colsharded,
    cv_loo_sharded,
    fit_rowsharded_shardmap,
    cv_lso_sharded,
    cv_lso_rowsharded,
    train_step,
)

__all__ = [
    "make_pls_mesh",
    "initialize_distributed",
    "fit_sharded",
    "fit_colsharded",
    "fit_rowsharded_shardmap",
    "cv_lso_sharded",
    "cv_lso_rowsharded",
    "cv_loo_sharded",
    "train_step",
]
