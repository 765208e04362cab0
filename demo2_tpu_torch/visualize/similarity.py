"""Similarity distributions (demo2_tpu/visualize/similarity.py; reference:
utils/metrics.py:437-502).  numpy in; matplotlib is imported inside the
function."""

from __future__ import annotations

import numpy as np


def similarity_distributions(qf: np.ndarray, gf: np.ndarray, q_pids: np.ndarray,
                             g_pids: np.ndarray, save_path: str = "similarity_kde.png"):
    """Histograms of the cosine similarity of positive (same id) and negative
    query-gallery pairs, saved to `save_path`; returns {"pos_mean",
    "neg_mean", "path"}."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError(f"requires matplotlib: {e}")

    qn = qf / (np.linalg.norm(qf, axis=1, keepdims=True) + 1e-12)
    gn = gf / (np.linalg.norm(gf, axis=1, keepdims=True) + 1e-12)
    sims = qn @ gn.T
    same = q_pids[:, None] == g_pids[None, :]
    pos, neg = sims[same], sims[~same]

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(neg, bins=100, density=True, alpha=0.5, label="negative pairs")
    ax.hist(pos, bins=100, density=True, alpha=0.5, label="positive pairs")
    ax.set_xlabel("cosine similarity")
    ax.legend()
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)
    return {"pos_mean": float(pos.mean()), "neg_mean": float(neg.mean()), "path": save_path}
