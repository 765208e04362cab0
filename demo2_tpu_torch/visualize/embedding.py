"""t-SNE embedding plot (demo2_tpu/visualize/embedding.py; reference:
utils/metrics.py:370-392, showPointMultiModal).  numpy in; scikit-learn and
matplotlib are imported inside the function."""

from __future__ import annotations

import numpy as np


def tsne_plot(features: np.ndarray, labels: np.ndarray, save_path: str = "tsne.pdf",
              max_ids: int = 25, seed: int = 0):
    """2-D t-SNE of the features of the first `max_ids` identities, coloured
    by identity, saved to `save_path`; returns the path, or None below four
    points (where t-SNE means nothing)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from sklearn import manifold
    except ImportError as e:  # the plotting packages are optional
        raise RuntimeError(f"t-SNE plotting requires sklearn+matplotlib: {e}")

    keep_ids = np.unique(labels)[:max_ids]
    mask = np.isin(labels, keep_ids)
    feats, labs = features[mask], labels[mask]
    if len(feats) < 4:
        return None
    # sklearn needs perplexity < n_samples; (n - 1) / 3 keeps it valid down to 4 points.
    perplexity = float(max(1.0, min(30.0, (len(feats) - 1) / 3.0)))
    emb = manifold.TSNE(n_components=2, random_state=seed, init="pca",
                        perplexity=perplexity).fit_transform(feats)
    emb = (emb - emb.min(0)) / (emb.max(0) - emb.min(0) + 1e-8)

    fig, ax = plt.subplots(figsize=(8, 8))
    for pid in keep_ids:
        pts = emb[labs == pid]
        ax.scatter(pts[:, 0], pts[:, 1], s=12, label=str(pid))
    ax.set_xticks([])
    ax.set_yticks([])
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return save_path
