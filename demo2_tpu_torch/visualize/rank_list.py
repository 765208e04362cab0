"""Rank-list output (demo2_tpu/visualize/rank_list.py::save_rank_list): the
per-query ranked gallery list that the reference writes during MSVR310
evaluation (`re.txt`).  numpy only.  The ranked-grid image visualisation
needs matplotlib and is not ported (ROADMAP.md, port queue: the rest of the
modules)."""

from __future__ import annotations

from typing import Optional

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
