"""Dataset parsers (demo2_tpu/data/datasets.py): RGBNT201, RGBNT100,
MSVR310, the single-modal lineage parsers (market1501, dukemtmc, msmt17),
MSVWild863, and the procedural SyntheticTriModal stand-in.

Pure path parsing, no image is opened.  Each sample is (image_ref, pid,
camid, trackid): image_ref is a list of the 3 modality paths (RGBNT201,
MSVR310, MSVWild863), a single wide-image path cropped into 3 strips at load
time (RGBNT100) or one single-modal path (market1501 lineage); trackid
carries MSVR310's scene id.  SyntheticTriModal's refs are (tag, pid, j)
tuples that `render` draws from a seed, to the same uint8 images as the JAX
package.
"""

from __future__ import annotations

import functools
import glob
import os
import os.path as osp
import re
import zlib
from typing import List, Tuple

import numpy as np


class BaseDataset:
    train: List
    query: List
    gallery: List

    def _info(self, data):
        pids = {x[1] for x in data}
        cams = {x[2] for x in data}
        tracks = {x[3] for x in data}
        return len(pids), len(data), len(cams), len(tracks)

    def finalize(self):
        self.num_train_pids, self.num_train_imgs, self.num_train_cams, self.num_train_vids = self._info(
            self.train
        )
        (self.num_query_pids, self.num_query_imgs, self.num_query_cams, _) = self._info(
            self.query
        )
        (
            self.num_gallery_pids,
            self.num_gallery_imgs,
            self.num_gallery_cams,
            _,
        ) = self._info(self.gallery)


class RGBNT201(BaseDataset):
    """Tri-modal person Re-ID (reference: RGBNT201.py)."""

    def __init__(self, root: str):
        self.dataset_dir = osp.join(root, "RGBNT201")
        train_dir = osp.join(self.dataset_dir, "train_171")
        test_dir = osp.join(self.dataset_dir, "test")
        self.train = self._process(train_dir, relabel=True)
        self.query = self._process(test_dir, relabel=False)
        self.gallery = self._process(test_dir, relabel=False)
        self.finalize()

    def _process(self, dir_path: str, relabel: bool):
        rgb = sorted(glob.glob(osp.join(dir_path, "RGB", "*")))
        pid_container = set()
        for p in rgb:
            pid = int(osp.basename(p)[0:6])
            pid_container.add(pid)
        pid2label = {pid: i for i, pid in enumerate(sorted(pid_container))}
        data = []
        for p in rgb:
            name = osp.basename(p)
            pid = int(name[0:6])
            # camid digit follows '_cam' in the filename.
            m = re.search(r"cam(\d)", name)
            camid = int(m.group(1)) - 1 if m else 0
            if relabel:
                pid = pid2label[pid]
            paths = [
                p,
                osp.join(dir_path, "NI", name),
                osp.join(dir_path, "TI", name),
            ]
            data.append((paths, pid, camid, -1))
        return data


class RGBNT100(BaseDataset):
    """Tri-modal vehicle Re-ID, wide-strip layout (reference: RGBNT100.py)."""

    _pattern = re.compile(r"([-\d]+)_c(\d)")

    def __init__(self, root: str):
        self.dataset_dir = osp.join(root, "RGBNT100", "rgbir")
        self.train = self._process(osp.join(self.dataset_dir, "bounding_box_train"), True)
        self.query = self._process(osp.join(self.dataset_dir, "query"), False)
        self.gallery = self._process(
            osp.join(self.dataset_dir, "bounding_box_test"), False
        )
        self.finalize()

    def _process(self, dir_path: str, relabel: bool):
        imgs = sorted(glob.glob(osp.join(dir_path, "*.jpg")))
        pid_container = set()
        for p in imgs:
            pid, _ = map(int, self._pattern.search(osp.basename(p)).groups())
            if pid == -1 or pid > 600:
                continue
            pid_container.add(pid)
        pid2label = {pid: i for i, pid in enumerate(sorted(pid_container))}
        data = []
        for p in imgs:
            pid, camid = map(int, self._pattern.search(osp.basename(p)).groups())
            if pid == -1 or pid > 600:
                continue
            camid -= 1
            if relabel:
                pid = pid2label[pid]
            data.append((p, pid, camid, -1))  # single wide image path
        return data


class MSVR310(BaseDataset):
    """Tri-modal vehicle Re-ID with scene ids (reference: msvr310.py)."""

    def __init__(self, root: str):
        self.dataset_dir = osp.join(root, "MSVR310")
        self.train = self._process(osp.join(self.dataset_dir, "train"), relabel=True)
        self.query = self._process(osp.join(self.dataset_dir, "query3"), relabel=False)
        self.gallery = self._process(
            osp.join(self.dataset_dir, "gallery3"), relabel=False
        )
        self.finalize()

    def _process(self, dir_path: str, relabel: bool):
        vids = sorted(os.listdir(dir_path)) if osp.isdir(dir_path) else []
        pid_container = {int(v) for v in vids}
        pid2label = {pid: i for i, pid in enumerate(sorted(pid_container))}
        data = []
        for v in vids:
            vis = sorted(glob.glob(osp.join(dir_path, v, "vis", "*.jpg")))
            for p in vis:
                name = osp.basename(p)
                pid = int(v)
                camid = int(name[11])  # char 11 (reference: msvr310.py:80)
                sceneid = int(name[6:9])  # chars 6:9 (reference: :82)
                if relabel:
                    pid = pid2label[pid]
                paths = [
                    p,
                    osp.join(dir_path, v, "ni", name),
                    osp.join(dir_path, v, "th", name),
                ]
                data.append((paths, pid, camid, sceneid))
        return data


class Market1501(BaseDataset):
    """Single-modal lineage parser (reference: market1501.py:27-83).

    Kept from the TransReID lineage for registry parity
    (make_dataloader.py:15-22).  Samples carry ONE path, which the loader
    routes through the wide-strip reader exactly as the reference's
    `read_image` does for non-list paths (bases.py:28-43) — these datasets
    are not tri-modal and the reference never trains DeMo on them.

    Layout: ``market1501/{bounding_box_train,query,bounding_box_test}/*.jpg``
    with ``<pid>_c<camid>`` filenames; pid==-1 junk images dropped, camid
    1..6 -> 0..5, relabel on train.
    """

    dataset_name = "market1501"
    _pattern = re.compile(r"([-\d]+)_c(\d)")
    _max_cam = 6

    def __init__(self, root: str):
        self.dataset_dir = osp.join(root, self.dataset_name)
        self.train = self._process(
            osp.join(self.dataset_dir, "bounding_box_train"), relabel=True
        )
        self.query = self._process(osp.join(self.dataset_dir, "query"), relabel=False)
        self.gallery = self._process(
            osp.join(self.dataset_dir, "bounding_box_test"), relabel=False
        )
        self.finalize()

    def _process(self, dir_path: str, relabel: bool):
        imgs = sorted(glob.glob(osp.join(dir_path, "*.jpg")))
        pid_container = set()
        for p in imgs:
            pid, _ = map(int, self._pattern.search(osp.basename(p)).groups())
            if pid == -1:
                continue
            pid_container.add(pid)
        pid2label = {pid: i for i, pid in enumerate(sorted(pid_container))}
        data = []
        for p in imgs:
            pid, camid = map(int, self._pattern.search(osp.basename(p)).groups())
            if pid == -1:
                continue
            assert 1 <= camid <= self._max_cam
            if relabel:
                pid = pid2label[pid]
            data.append((p, pid, camid - 1, 1))
        return data


class DukeMTMCreID(Market1501):
    """Single-modal lineage parser (reference: dukemtmcreid.py:32-111, without
    its download helper): market1501's filename scheme, 8 cameras."""

    dataset_name = "dukemtmcreid"
    _max_cam = 8


class MSMT17(BaseDataset):
    """Single-modal lineage parser (reference: msmt17.py:21-75).

    List-file driven layout: ``MSMT17/{train,test}`` image roots plus
    ``list_{train,val,query,gallery}.txt`` with ``relpath pid`` lines; camid
    is the third ``_``-separated filename field, 1-based; train = train+val
    lists, pids pre-relabeled in the lists.
    """

    def __init__(self, root: str):
        self.dataset_dir = osp.join(root, "MSMT17")
        train_dir = osp.join(self.dataset_dir, "train")
        test_dir = osp.join(self.dataset_dir, "test")
        self.train = self._process(
            train_dir, osp.join(self.dataset_dir, "list_train.txt")
        ) + self._process(train_dir, osp.join(self.dataset_dir, "list_val.txt"))
        self.query = self._process(
            test_dir, osp.join(self.dataset_dir, "list_query.txt")
        )
        self.gallery = self._process(
            test_dir, osp.join(self.dataset_dir, "list_gallery.txt")
        )
        self.finalize()

    @staticmethod
    def _process(dir_path: str, list_path: str):
        data = []
        with open(list_path) as fh:
            for line in fh:
                relpath, pid = line.split(" ")
                camid = int(relpath.split("_")[2])
                data.append((osp.join(dir_path, relpath), int(pid), camid - 1, 1))
        return data


class MSVWild863(BaseDataset):
    """Tri-modal vehicle lineage parser (reference: MSVWild863.py:26-87).

    Flat ``{train,query,test}/{vis,ni,th}/*.jpg`` layout (RGBNT201-style but
    with the MSVR310 subdir names); pid = first 6 chars, camid = 4th char of
    the second ``_`` field, trackid fixed at -1.
    """

    def __init__(self, root: str):
        self.dataset_dir = osp.join(root, "MSVWild863")
        self.train = self._process(osp.join(self.dataset_dir, "train"), relabel=True)
        self.query = self._process(osp.join(self.dataset_dir, "query"), relabel=False)
        self.gallery = self._process(osp.join(self.dataset_dir, "test"), relabel=False)
        self.finalize()

    def _process(self, dir_path: str, relabel: bool):
        rgb = sorted(glob.glob(osp.join(dir_path, "vis", "*.jpg")))
        pid_container = {int(osp.basename(p).split("_")[0][0:6]) for p in rgb}
        pid2label = {pid: i for i, pid in enumerate(sorted(pid_container))}
        data = []
        for p in rgb:
            name = osp.basename(p)
            pid = int(name.split("_")[0][0:6])
            camid = int(name.split("_")[1][3]) - 1
            if relabel:
                pid = pid2label[pid]
            paths = [
                p,
                osp.join(dir_path, "ni", name),
                osp.join(dir_path, "th", name),
            ]
            data.append((paths, pid, camid, -1))
        return data


class SyntheticTriModal(BaseDataset):
    """Procedural tri-modal dataset with identity structure (CPU-testable).
    `render(ref)` gives the three (H, W, 3) uint8 modality images of a
    sample; `root` is taken as DATASET_REGISTRY passes it, and not read."""

    def __init__(self, root: str = "", num_pids: int = 8, num_cams: int = 4,
                 imgs_per_pid: int = 8, image_size: Tuple[int, int] = (64, 32), seed: int = 0,
                 hard: bool = False, id_weight: float = 0.35):
        self.image_size = image_size
        self.hard = hard
        # The hard recipe's identity weight: lower is harder to separate.
        self.id_weight = float(id_weight)
        rng = np.random.default_rng(seed)
        self._palettes = rng.uniform(0.1, 0.9, size=(num_pids, 3, 3))  # pid, modality, rgb
        if hard:
            base = rng.uniform(0.3, 0.7, size=(1, 3, 3))
            self._palettes = 0.55 * base + 0.45 * self._palettes

        def split(tag):  # trackid doubles as a synthetic scene id
            return [((tag, pid, j), pid, (pid + j) % num_cams, j % 3)
                    for pid in range(num_pids) for j in range(imgs_per_pid)]

        self.train = split("train")
        self.query = split("test")[: num_pids * 2]
        self.gallery = split("gallery")
        self.finalize()

    def render(self, ref) -> List[np.ndarray]:
        tag, pid, j = ref
        h, w = self.image_size
        # Stable across processes (builtin str hash is PYTHONHASHSEED-random).
        rng = np.random.default_rng(zlib.crc32(f"{tag}/{pid}/{j}".encode()))
        yy, _ = np.mgrid[0:h, 0:w]
        imgs = []
        for m in range(3):
            base = np.ones((h, w, 3), np.float32) * self._palettes[pid, m]
            if self.hard:
                # Identity lives only in a small palette offset; the stripes
                # are identity-independent, the jitter a camera nuisance.
                stripe = ((yy // 4) % 2).astype(np.float32)[..., None]
                jitter = rng.uniform(-0.18, 0.18)
                img = (self.id_weight * base + 0.15 * stripe
                       + 0.5 * rng.uniform(0, 1, (h, w, 3)) + jitter)
            else:
                stripe = ((yy // max(2, pid + 2)) % 2).astype(np.float32)[..., None]
                img = 0.7 * base + 0.2 * stripe + 0.1 * rng.uniform(0, 1, (h, w, 3))
            imgs.append((img * 255).clip(0, 255).astype(np.uint8))
        return imgs

    def render_all(self, samples) -> np.ndarray:
        """(N, 3, H, W, 3) uint8 of `samples`, in order."""
        return np.stack([np.stack(self.render(s[0])) for s in samples])


DATASET_REGISTRY = {
    "RGBNT201": RGBNT201,
    "RGBNT100": RGBNT100,
    "MSVR310": MSVR310,
    # The lineage's registry (reference make_dataloader.py:15-22).
    "market1501": Market1501,
    "dukemtmc": DukeMTMCreID,
    "msmt17": MSMT17,
    "MSVWild863": MSVWild863,
    "Synthetic": SyntheticTriModal,
    # Not separable by colour alone: eval metrics start below 100%.
    "SyntheticHard": functools.partial(SyntheticTriModal, hard=True, num_pids=12),
    # 48 queries among 288: mAP steadier from run to run.
    "SyntheticHardBig": functools.partial(SyntheticTriModal, hard=True, num_pids=24,
                                          imgs_per_pid=12),
}
