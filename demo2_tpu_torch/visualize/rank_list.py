"""Rank-list outputs (demo2_tpu/visualize/rank_list.py): `save_rank_list`,
the per-query ranked gallery list that the reference writes during MSVR310
evaluation (`re.txt`), numpy only; `visualize_ranked_results`, the grid of
each query and its top-k gallery matches per modality, framed green or red
(reference: utils/metrics.py:262-339), matplotlib imported inside it."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def save_rank_list(
    distmat: np.ndarray,
    q_pids: np.ndarray,
    g_pids: np.ndarray,
    q_camids: np.ndarray,
    g_camids: np.ndarray,
    q_sceneids: Optional[np.ndarray] = None,
    g_sceneids: Optional[np.ndarray] = None,
    path: str = "re.txt",
    max_rank: int = 50,
):
    """Write the per-query ranked gallery list (MSVR310 `re.txt` format):
    entries `<pid>_s<scene>_v<camera>`, those with the query's id and scene
    (camera without scene ids) removed, the first `max_rank` kept."""
    indices = np.argsort(distmat, axis=1)
    with open(path, "w") as f:
        f.write("rank list file\n")
        for qi in range(distmat.shape[0]):
            order = indices[qi]
            if q_sceneids is not None:
                remove = (g_pids[order] == q_pids[qi]) & (g_sceneids[order] == q_sceneids[qi])
            else:
                remove = (g_pids[order] == q_pids[qi]) & (g_camids[order] == q_camids[qi])
            keep = ~remove
            sc = q_sceneids[qi] if q_sceneids is not None else 0
            f.write(f"{q_pids[qi]}_s{sc}_v{q_camids[qi]}:\n")
            ids = g_pids[order][keep][:max_rank]
            cams = g_camids[order][keep][:max_rank]
            scenes = (g_sceneids[order][keep][:max_rank] if g_sceneids is not None
                      else np.zeros_like(ids))
            f.write("  ".join(f"{i}_s{s}_v{c}" for i, s, c in zip(ids, scenes, cams)) + "  \n")
    return path


def visualize_ranked_results(distmat: np.ndarray, query_images: Sequence,
                             gallery_images: Sequence, q_pids: np.ndarray, g_pids: np.ndarray,
                             topk: int = 10, save_dir: str = "vis_results",
                             max_queries: int = 20):
    """For each of the first `max_queries` queries, a 3 x (topk + 1) grid (RGB,
    NIR, TIR rows; the query, then its `topk` nearest gallery samples, each
    framed green for the query's id and red otherwise) saved as
    `<save_dir>/query_<i>.png`.  `query_images` / `gallery_images` hold one
    (3, H, W, 3) array per sample.  Returns the paths."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.patches as patches
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError(f"requires matplotlib: {e}")

    os.makedirs(save_dir, exist_ok=True)
    order = np.argsort(distmat, axis=1)
    outs = []
    for qi in range(min(max_queries, distmat.shape[0])):
        ranked = order[qi][:topk]
        fig, axs = plt.subplots(3, topk + 1, figsize=(2 * (topk + 1), 6))
        for m, name in enumerate(("RGB", "NIR", "TIR")):
            axs[m, 0].imshow(np.asarray(query_images[qi][m]))
            axs[m, 0].set_title(f"Query {name}", fontsize=9)
            axs[m, 0].axis("off")
            for r, gi in enumerate(ranked):
                ax = axs[m, r + 1]
                img = np.asarray(gallery_images[gi][m])
                ax.imshow(img)
                ax.axis("off")
                color = "green" if g_pids[gi] == q_pids[qi] else "red"
                ax.add_patch(patches.Rectangle((0, 0), img.shape[1], img.shape[0], linewidth=4,
                                               edgecolor=color, facecolor="none"))
                ax.set_title(f"R{r + 1}", fontsize=8)
        path = os.path.join(save_dir, f"query_{qi}.png")
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        outs.append(path)
    return outs
