"""pls-tpu: a TPU-native Partial Least Squares regression framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the reference
C++/Eigen library tjhladish/PLS (surveyed in SURVEY.md):

- Dayal–MacGregor "improved kernel" PLS algorithms 1 and 2
  (reference: /root/reference/src/pls.cpp:387-437), plus NIPALS and SIMPLS
  variants the reference does not have.
- Multi-response Y, scores/weights/loadings/coefficients extraction,
  prediction and explained-variance diagnostics
  (reference: /root/reference/src/pls.cpp:439-467).
- The full validation stack: leave-one-out, leave-some-out (Monte-Carlo) and
  new-data cross-validation with PRESS/MSE/RMSE summaries and Wilcoxon-based
  optimal-component selection (reference: /root/reference/src/pls.cpp:229-305,
  469-549).
- A CLI mirroring the reference executable's argv contract
  (reference: /root/reference/src/main.cpp:10-44).

The design is accelerator-idiomatic rather than a translation: fits are pure
functions compiled with `jax.jit`, the per-component deflation loop is a
`lax.scan` (with an optional fused Pallas kernel for the hot X-streaming
pass), cross-validation folds are a vmapped batch axis, and large designs
are row-sharded across a `jax.sharding.Mesh` with XLA collectives.
"""

from pls_tpu.types import (
    METHOD,
    KERNEL_TYPE1,
    KERNEL_TYPE2,
    NIPALS,
    SIMPLS,
    SPLS,
    VALIDATION_OUTPUT,
    RESS,
    MSE,
    PLSFit,
    Residual,
)
from pls_tpu.ops.stats import (
    sst,
    colwise_stdev,
    z_scores,
    colwise_z_scores,
)
from pls_tpu.ops.special import normalcdf
from pls_tpu.ops.wilcoxon import wilcoxon
from pls_tpu.models.kernel_pls import fit
from pls_tpu.models.predict import (
    scores,
    vip,
    loadings_x,
    loadings_y,
    coefficients,
    coefficients_all_components,
    fitted_values,
    residuals,
    sse,
    explained_variance,
    target_projection,
    selectivity_ratio,
)
from pls_tpu.cv.validation import (
    validation,
    optimal_num_components,
    print_validation,
    q_squared,
    rmsep,
    compare_models,
)
from pls_tpu.cv.bootstrap import (
    bootstrap_coefficients,
    bootstrap_coefficient_intervals,
)
from pls_tpu.cv.inference import (
    jackknife_coefficients,
    coefficient_significance,
    permutation_test,
)
from pls_tpu.cv.conformal import (
    cv_plus_intervals,
    jackknife_plus_intervals,
    split_conformal_intervals,
)
from pls_tpu.cv.loo import cv_loo, cv_loo_downdate, cv_loo_from_stats
from pls_tpu.cv.lso import cv_lso, cv_lso_downdate
from pls_tpu.cv.newdata import cv_new_data
from pls_tpu.cv.kfold import (
    cv_kfold,
    cv_kfold_downdate,
    cv_kfold_from_stats,
    cv_kfold_onepass,
    cv_group,
    fold_residual_chunk,
)
from pls_tpu.model import PLSModel
from pls_tpu.models.kernel_dd import fit_dd, fit_from_stats_dd
from pls_tpu.models.streaming import (
    FoldStatsAccumulator,
    StatsAccumulator,
    zscore_fold_stats,
    zscore_stats,
    collect_moments,
    fit_streaming,
    fit_streaming_csv,
)
from pls_tpu.models.npls import (
    NPLSFit,
    fit_npls,
    predict_npls,
    scores_npls,
)
from pls_tpu.models.recursive import RecursivePLS
from pls_tpu.models.robust import fit_robust
from pls_tpu.sampling import (
    kennard_stone,
    spxy,
    duplex,
    ks_train_test_split,
)
from pls_tpu.tune import (
    grid_search_cv,
    kfold_split,
    nested_cv_components,
    nested_grid_search_cv,
    NestedCVResult,
    tune_spls_keepx,
    tune_kpls,
)
from pls_tpu.select import (
    ipls,
    ipls_forward,
    ipls_backward,
    interval_masks,
    IPLSResult,
    IPLSSelection,
    uve_pls,
    UVEResult,
)
from pls_tpu.export import export_model_c, load_model_c
from pls_tpu.utils.checkpoint import (
    save_fit,
    load_fit,
    save_fit_orbax,
    load_fit_orbax,
    register_checkpointable,
)
from pls_tpu.utils.io import read_matrix_file, stream_matrix_file
from pls_tpu.utils.binio import (
    cv_kfold_npy,
    cv_repeated_kfold_npy,
    fit_streaming_npy,
    fold_stats_from_npy,
    npy_chunks,
    stats_from_npy,
    stream_npy,
    write_npy_chunked,
)
from pls_tpu.preprocess import ZScorer
from pls_tpu.transfer import (
    TransferModel,
    direct_standardization,
    piecewise_ds,
    apply_transfer,
    EPOModel,
    epo,
    epo_difference_matrix,
)
from pls_tpu.spectral import (
    snv,
    msc,
    MSCorrection,
    savgol,
    savgol_coeffs,
    detrend,
    normalize,
    SNV,
    SavitzkyGolay,
    Detrend,
)
from pls_tpu.estimator import (
    PLSRegressor,
    PLSGLMClassifier,
    RobustPLSRegressor,
    SPLSRegressor,
    OPLSRegressor,
    KPLSRegressor,
    PLSCanonical,
    CCA,
    PLSSVD,
)
from pls_tpu.models.crossdecomp import (
    CDFit,
    fit_plscanonical,
    fit_cca,
    fit_plssvd,
    cd_coefficients,
    cd_transform,
    cd_predict,
)
from pls_tpu.models.plsda import PLSDAClassifier
from pls_tpu.models.sparse import fit_spls, selected_variables
from pls_tpu.models.kpls import (
    KPLSFit,
    fit_kpls,
    predict_kpls,
    kernel_matrix,
)
from pls_tpu.models.opls import (
    OPLSFit,
    fit_opls,
    correct as opls_correct,
    predict as opls_predict,
)
from pls_tpu.models.oplsda import (
    OPLSDAClassifier,
    fit_oplsda,
    s_plot,
)
from pls_tpu.models.plsglm import PLSGLMFit, fit_plsglm, predict_plsglm
from pls_tpu.models.plscox import (
    PLSCoxFit,
    fit_plscox,
    predict_plscox,
    concordance_index,
)
from pls_tpu.models.plspm import (
    PLSPMFit,
    PLSPMBootstrap,
    fit_plspm,
    plspm_scores,
    bootstrap_plspm,
)
from pls_tpu.models.o2pls import (
    O2PLSFit,
    fit_o2pls,
    predict_y as o2pls_predict_y,
    predict_x as o2pls_predict_x,
    transform as o2pls_transform,
)
from pls_tpu.models.multiblock import (
    MBPLSFit,
    block_importance,
    block_scores,
    block_weights,
    fit_mbpls,
    predict_mbpls,
    super_scores,
)
from pls_tpu.models.missing import (
    fit_nipals_missing,
    impute_pls,
    nan_column_stats,
    predict_missing,
    scores_missing,
)
from pls_tpu.models.diagnostics import (
    MonitorModel,
    fit_monitor,
    hotelling_t2,
    leverage,
    spe,
    spe_limit,
    spe_contributions,
    t2_contributions,
    t2_limit,
    x_residuals,
)

__version__ = "0.5.0"

__all__ = [
    "METHOD",
    "KERNEL_TYPE1",
    "KERNEL_TYPE2",
    "NIPALS",
    "SIMPLS",
    "SPLS",
    "VALIDATION_OUTPUT",
    "RESS",
    "MSE",
    "PLSFit",
    "Residual",
    "sst",
    "colwise_stdev",
    "z_scores",
    "colwise_z_scores",
    "normalcdf",
    "wilcoxon",
    "fit",
    "scores",
    "loadings_x",
    "loadings_y",
    "coefficients",
    "coefficients_all_components",
    "fitted_values",
    "residuals",
    "sse",
    "explained_variance",
    "validation",
    "optimal_num_components",
    "print_validation",
    "q_squared",
    "rmsep",
    "compare_models",
    "bootstrap_coefficients",
    "bootstrap_coefficient_intervals",
    "jackknife_coefficients",
    "coefficient_significance",
    "permutation_test",
    "cv_plus_intervals",
    "jackknife_plus_intervals",
    "split_conformal_intervals",
    "cv_loo",
    "cv_loo_downdate",
    "cv_loo_from_stats",
    "cv_lso",
    "cv_lso_downdate",
    "cv_new_data",
    "cv_kfold",
    "cv_kfold_downdate",
    "cv_kfold_from_stats",
    "cv_kfold_npy",
    "cv_repeated_kfold_npy",
    "cv_kfold_onepass",
    "cv_group",
    "PLSModel",
    "read_matrix_file",
    "vip",
    "ZScorer",
    "TransferModel",
    "direct_standardization",
    "piecewise_ds",
    "apply_transfer",
    "EPOModel",
    "epo",
    "epo_difference_matrix",
    "target_projection",
    "selectivity_ratio",
    "PLSGLMFit",
    "PLSCoxFit",
    "fit_plscox",
    "predict_plscox",
    "concordance_index",
    "fit_plsglm",
    "predict_plsglm",
    "PLSPMFit",
    "PLSPMBootstrap",
    "fit_plspm",
    "plspm_scores",
    "bootstrap_plspm",
    "O2PLSFit",
    "fit_o2pls",
    "o2pls_predict_y",
    "o2pls_predict_x",
    "o2pls_transform",
    "ipls",
    "ipls_forward",
    "ipls_backward",
    "interval_masks",
    "IPLSResult",
    "IPLSSelection",
    "uve_pls",
    "UVEResult",
    "snv",
    "msc",
    "MSCorrection",
    "savgol",
    "savgol_coeffs",
    "detrend",
    "normalize",
    "SNV",
    "SavitzkyGolay",
    "Detrend",
    "PLSRegressor",
    "PLSGLMClassifier",
    "RobustPLSRegressor",
    "SPLSRegressor",
    "OPLSRegressor",
    "KPLSRegressor",
    "PLSCanonical",
    "CCA",
    "PLSSVD",
    "CDFit",
    "fit_plscanonical",
    "fit_cca",
    "fit_plssvd",
    "cd_coefficients",
    "cd_transform",
    "cd_predict",
    "PLSDAClassifier",
    "NPLSFit",
    "fit_npls",
    "predict_npls",
    "scores_npls",
    "RecursivePLS",
    "fit_robust",
    "FoldStatsAccumulator",
    "StatsAccumulator",
    "collect_moments",
    "zscore_fold_stats",
    "zscore_stats",
    "fit_streaming",
    "fit_streaming_csv",
    "fit_dd",
    "fit_from_stats_dd",
    "fit_streaming_npy",
    "npy_chunks",
    "fold_residual_chunk",
    "fold_stats_from_npy",
    "stats_from_npy",
    "stream_npy",
    "write_npy_chunked",
    "stream_matrix_file",
    "export_model_c",
    "load_model_c",
    "save_fit",
    "save_fit_orbax",
    "load_fit_orbax",
    "load_fit",
    "register_checkpointable",
    "kennard_stone",
    "spxy",
    "duplex",
    "ks_train_test_split",
    "grid_search_cv",
    "kfold_split",
    "nested_cv_components",
    "nested_grid_search_cv",
    "NestedCVResult",
    "tune_spls_keepx",
    "tune_kpls",
    "fit_spls",
    "selected_variables",
    "KPLSFit",
    "fit_kpls",
    "predict_kpls",
    "kernel_matrix",
    "OPLSFit",
    "fit_opls",
    "opls_correct",
    "opls_predict",
    "OPLSDAClassifier",
    "fit_oplsda",
    "s_plot",
    "MBPLSFit",
    "block_importance",
    "block_scores",
    "block_weights",
    "fit_mbpls",
    "predict_mbpls",
    "super_scores",
    "fit_nipals_missing",
    "impute_pls",
    "nan_column_stats",
    "predict_missing",
    "scores_missing",
    "MonitorModel",
    "fit_monitor",
    "hotelling_t2",
    "leverage",
    "spe",
    "spe_limit",
    "spe_contributions",
    "t2_contributions",
    "t2_limit",
    "x_residuals",
    "__version__",
]
