"""Geostatistics core: Matérn covariance, likelihoods, the TLR path,
cokriging and the MLOE/MMOM assessment.

Exports the names ``repro.core`` exports, where the port has them.
"""

from .assessment import mloe_mmom, mloe_mmom_univariate  # noqa: F401
from .covariance import (  # noqa: F401
    MaternParams,
    build_c0,
    build_correlation_matrix,
    build_sigma,
    cross_cov_at_zero,
    morton_order,
    pairwise_distances,
)
from .likelihood import exact_loglik, loglik_from_chol, profile_loglik  # noqa: F401
from .matern import (  # noqa: F401
    cross_covariance,
    effective_range,
    kv,
    matern_correlation,
    matern_correlation_halfint,
    parsimonious_rho,
)
from .mle import FitResult, MLEConfig, fit, make_objective  # noqa: F401
from .optimize import nelder_mead  # noqa: F401
from .prediction import (  # noqa: F401
    CokrigeFactor,
    cokrige,
    cokrige_and_score,
    dense_factor,
    mspe,
)
from .simulate import (  # noqa: F401
    grid_locations,
    simulate_mgrf,
    split_train_pred,
    uniform_locations,
)
