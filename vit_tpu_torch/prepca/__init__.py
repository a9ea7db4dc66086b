"""Offline preprocessing statistics of the port: covariance, PCA, KPCA, ZCA, PCP, CKA
(the names ``vit_tpu.prepca`` exports)."""

from vit_tpu_torch.prepca.pipeline import (  # noqa: F401
    KernelPCAState,
    PreprocessingPipeline,
    ZCAWhitening,
    compute_cka,
    compute_kernel_pca,
    compute_pca,
    compute_pcp,
)
from vit_tpu_torch.prepca.stats import (  # noqa: F401
    CovarianceStats,
    compute_covariance_stats,
    ensure_covariance,
    load_or_compute_covariance,
    zca_self_check,
)
