"""Decomposition estimators (``ganspace_tpu/estimators``): IPCA only, for
now, with its three tiers (exact moments, Nystrom sketch, sklearn mirror)."""

from ganspace_tpu_torch.estimators.ipca import IPCAEstimator


def get_estimator(name: str, n_components: int, alpha: float = 1.0,
                  refine=None):
    """Name -> estimator factory (reference ``estimators.py:206-218``).
    ``refine`` pins the sketch tier's refine policy ("auto" / "always" /
    "never"); None reads GANSPACE_IPCA_REFINE once, at construction."""
    if name == "ipca":
        return IPCAEstimator(n_components, refine=refine)
    if name in ("pca", "fbpca", "ica", "spca"):
        raise NotImplementedError(f"estimator {name!r} is not ported yet "
                                  "(ROADMAP.md, queue 1: the other estimators)")
    raise RuntimeError("Unknown estimator")


__all__ = ["get_estimator", "IPCAEstimator"]
