"""Decomposition estimators (``ganspace_tpu/estimators``): the IPCA
exact-moments tier only, for now."""

from ganspace_tpu_torch.estimators.ipca import IPCAEstimator


def get_estimator(name: str, n_components: int, alpha: float = 1.0):
    """Name -> estimator factory (reference ``estimators.py:206-218``)."""
    if name == "ipca":
        return IPCAEstimator(n_components)
    if name in ("pca", "fbpca", "ica", "spca"):
        raise NotImplementedError(f"estimator {name!r} is not ported yet "
                                  "(ROADMAP.md, queue 1: the other estimators)")
    raise RuntimeError("Unknown estimator")


__all__ = ["get_estimator", "IPCAEstimator"]
