"""Decomposition estimators (``ganspace_tpu/estimators``).

Five interchangeable backends behind the duck-typed protocol the pipeline
expects (reference ``estimators.py:206-218``):

    fit(X)                      full-batch fit on centered samples
    fit_partial(X) -> bool      streaming update (ipca only)
    get_components() -> (components [c, D], stdev [c], var_ratio [c])
    batch_support : bool
    get_param_str() -> str      cache-filename fragment (exact reference format)
    mean_                       data mean seen by the estimator

``ipca`` streams (exact moments or the Nystrom sketch) on the device of its
first block; the full-batch four fit on ``device``, the card unless the
caller names another.
"""

from ganspace_tpu_torch.estimators.ica import ICAEstimator
from ganspace_tpu_torch.estimators.ipca import IPCAEstimator
from ganspace_tpu_torch.estimators.pca import PCAEstimator
from ganspace_tpu_torch.estimators.rsvd import FacebookPCAEstimator
from ganspace_tpu_torch.estimators.spca import SPCAEstimator


def get_estimator(name: str, n_components: int, alpha: float = 1.0,
                  refine=None, device="cuda", mesh=None, feature_sharding=None):
    """Name -> estimator factory (reference ``estimators.py:206-218``).
    ``refine`` pins the sketch tier's refine policy ("auto" / "always" /
    "never"); None reads GANSPACE_IPCA_REFINE once, at construction.
    ``mesh`` and ``feature_sharding`` (this rank's slice of D) make the
    streaming estimator's state per rank, merged once per pass and
    feature-sharded after the merge; the full-batch estimators ignore both
    (the pipeline fits them on rank 0)."""
    if name == "ipca":
        return IPCAEstimator(n_components, refine=refine, mesh=mesh,
                             feature_sharding=feature_sharding)
    if name == "pca":
        return PCAEstimator(n_components, device=device)
    if name == "fbpca":
        return FacebookPCAEstimator(n_components, device=device)
    if name == "ica":
        return ICAEstimator(n_components, device=device)
    if name == "spca":
        return SPCAEstimator(n_components, alpha, device=device)
    raise RuntimeError("Unknown estimator")


__all__ = [
    "get_estimator",
    "IPCAEstimator",
    "PCAEstimator",
    "FacebookPCAEstimator",
    "ICAEstimator",
    "SPCAEstimator",
]
