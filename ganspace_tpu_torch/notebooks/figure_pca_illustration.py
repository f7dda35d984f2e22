"""PCA illustration on synthetic 2-D data
(``notebooks/figure_pca_illustration.py``, reference
``notebooks/figure_pca_illustration.ipynb``: a correlated Gaussian point
cloud with its principal axes, plus the same cloud in PCA coordinates).
It runs no generator: numpy, the port's PCA estimator and matplotlib.

    python -m ganspace_tpu_torch.notebooks.figure_pca_illustration --device cpu
"""

from pathlib import Path

import numpy as np

from ganspace_tpu_torch.notebooks.notebook_init import OUTDIR, parse_args


def point_cloud(seed: int) -> np.ndarray:
    """400 points of a correlated 2-D Gaussian, float64."""
    rs = np.random.RandomState(seed)
    cov = np.array([[2.5, 1.6], [1.6, 1.8]])
    return rs.multivariate_normal([0, 0], cov, size=400)


def principal_axes(pts: np.ndarray, device: str):
    """(comp [2, 2], stdev [2]) of the cloud by the pipeline's PCA estimator."""
    from ganspace_tpu_torch.estimators import get_estimator
    est = get_estimator("pca", 2, device=device)
    est.fit(pts.astype(np.float32))
    comp, stdev, _ = est.get_components()
    return np.asarray(comp), np.asarray(stdev)


def main(argv=None):
    args = parse_args(argv)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = point_cloud(args.seed)
    comp, stdev = principal_axes(pts, args.device)
    mean = pts.mean(0)

    fig, axes = plt.subplots(1, 2, figsize=(9, 4.2))
    axes[0].scatter(pts[:, 0], pts[:, 1], s=6, alpha=0.4, c="#4a90d9")
    for i, c in enumerate(comp):
        v = c * stdev[i] * 2
        axes[0].annotate("", xy=mean + v, xytext=mean,
                         arrowprops=dict(arrowstyle="->", lw=2, color="C3"))
        axes[0].text(*(mean + v * 1.15), f"PC{i}", color="C3")
    axes[0].set_title("data with principal axes")
    axes[0].set_aspect("equal")

    coords = (pts - mean) @ comp.T / stdev
    axes[1].scatter(coords[:, 0], coords[:, 1], s=6, alpha=0.4, c="#4a90d9")
    axes[1].set_title("PCA coordinates (whitened)")
    axes[1].set_aspect("equal")

    outdir = OUTDIR if args.outdir is None else Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    out = outdir / "pca_illustration.png"
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
