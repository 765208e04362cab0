"""Batch samplers (demo2_tpu/data/sampler.py): RandomIdentitySampler, the
PK sampler (P ids x K instances per batch, identities with fewer than K
images resampled with replacement), and SequentialSampler.  numpy only,
driven by (seed, epoch), so the port and the JAX package draw the same
batches."""

from __future__ import annotations

from collections import defaultdict
from typing import List, Sequence

import numpy as np


class RandomIdentitySampler:
    def __init__(self, data_source: Sequence, batch_size: int, num_instances: int, seed: int = 0):
        self.batch_size = batch_size
        self.num_instances = num_instances
        self.num_pids_per_batch = batch_size // num_instances
        self.seed = seed
        self.index_dic = defaultdict(list)
        for index, item in enumerate(data_source):
            self.index_dic[item[1]].append(index)
        self.pids = list(self.index_dic.keys())
        self.length = 0
        for pid in self.pids:
            num = max(len(self.index_dic[pid]), num_instances)
            self.length += num - num % num_instances

    def epoch_indices(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, epoch))
        batch_idxs_dict = defaultdict(list)
        for pid in self.pids:
            idxs = list(self.index_dic[pid])
            if len(idxs) < self.num_instances:
                idxs = list(rng.choice(idxs, size=self.num_instances, replace=True))
            rng.shuffle(idxs)
            chunk = []
            for idx in idxs:
                chunk.append(idx)
                if len(chunk) == self.num_instances:
                    batch_idxs_dict[pid].append(chunk)
                    chunk = []
        avai = list(self.pids)
        final: List[int] = []
        while len(avai) >= self.num_pids_per_batch:
            selected = list(rng.choice(len(avai), self.num_pids_per_batch, replace=False))
            for pid in [avai[i] for i in selected]:
                final.extend(batch_idxs_dict[pid].pop(0))
                if not batch_idxs_dict[pid]:
                    avai.remove(pid)
        return np.asarray(final, np.int64)

    def __len__(self):
        return self.length


class SequentialSampler:
    """DATALOADER.SAMPLER = 'softmax': the dataset in order every epoch, as
    the reference's plain DataLoader (make_dataloader.py:234-239), the short
    tail batch dropped, with RandomIdentitySampler's interface."""

    def __init__(self, data_source: Sequence, batch_size: int):
        self.batch_size = batch_size
        n = len(data_source)
        self.length = n - n % batch_size

    def epoch_indices(self, epoch: int) -> np.ndarray:
        del epoch  # the order does not change between epochs
        return np.arange(self.length, dtype=np.int64)

    def __len__(self):
        return self.length
