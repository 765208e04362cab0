"""Tri-modal batch pipeline from disk (demo2_tpu/data/loader.py).

Reference: data/datasets/make_dataloader.py (transforms :188-202, collate
:142-184, PK-sampled train loader and sequential query + gallery loader
:214-259) and bases.py:9-43 (three paths, or one wide strip image).

Batches collate to one (B, 3, H, W, 3) float32 array, the modality axis
explicit.  Decoding and augmentation run either in the native loader
(data/native.py; C++ threads, the ctypes call releases the interpreter lock)
or through PIL on a thread pool, in a producer thread that keeps `prefetch`
batches ahead of the consumer.  An eval pipe pads its last batch to the
batch size (`pad_last`) and says how many rows are real (`valid`).  PIL is
imported only on its own path.
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterator, List, Optional

import numpy as np
import torch

from ..config.defaults import Config
from .datasets import DATASET_REGISTRY, SyntheticTriModal
from .sampler import RandomIdentitySampler, SequentialSampler
from .transforms import EvalTransform, TrainTransform

logger = logging.getLogger("DeMo")

# The RGBNT100 wide strip: RGB, NIR and TIR side by side (bases.py:28-43).
STRIPS = ((0, 0, 256, 128), (256, 0, 512, 128), (512, 0, 768, 128))


def read_image(ref, dataset=None) -> list:
    """The 3 modality images of a sample as PIL images (reference: bases.py:9-43)."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True  # reference: bases.py:6
    if dataset is not None and isinstance(dataset, SyntheticTriModal) and isinstance(ref, tuple):
        return [Image.fromarray(a) for a in dataset.render(ref)]
    if isinstance(ref, str):  # RGBNT100 wide strip
        img = Image.open(ref).convert("RGB")
        return [img.crop(s) for s in STRIPS]
    return [Image.open(p).convert("RGB") for p in ref]


def pil_error() -> Optional[str]:
    """Why PIL cannot be used here, or None."""
    try:
        from PIL import Image  # noqa: F401
    except ImportError as e:
        return f"PIL does not import ({e})"
    return None


@dataclass
class Batch:
    images: np.ndarray  # (B, 3, H, W, 3) float32
    pids: np.ndarray  # (B,) int32
    camids: np.ndarray  # (B,) int32
    viewids: np.ndarray  # (B,) int32 (trackid / sceneid)
    paths: List[Any]
    valid: int  # number of non-padded samples


class TriModalDataPipe:
    def __init__(self, samples, dataset, transform, batch_size: int, num_workers: int = 4,
                 use_native: Optional[bool] = None):
        """`use_native`: None decides (on-disk JPEGs and a loader that
        builds), True requires the native loader and raises where it cannot
        be used, False takes PIL."""
        from .native import native_available, native_library

        self.samples = samples
        self.dataset = dataset
        self.transform = transform
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.pool = cf.ThreadPoolExecutor(max_workers=self.num_workers)
        if use_native is None:
            use_native = (isinstance(transform, (TrainTransform, EvalTransform))
                          and self._all_jpeg_paths() and native_available())
        elif use_native:
            if not native_available():
                raise RuntimeError(f"native decode forced but the native loader cannot be "
                                   f"built: {native_library().error}")
            if not samples:
                raise ValueError("native decode forced on an empty dataset")
            if not self._all_jpeg_paths(check_all=True):
                raise ValueError("native decode requires on-disk JPEG datasets "
                                 "(DATALOADER.NATIVE_DECODE=on with in-memory/non-JPEG samples)")
        self.use_native = bool(use_native)
        if self.use_native:
            mode = "train" if isinstance(transform, TrainTransform) else "eval"
            logger.info("data pipe (%s): native decode enabled (%s; DATALOADER.NATIVE_DECODE="
                        "off for the PIL path)", mode, native_library().decoder)

    def _all_jpeg_paths(self, check_all: bool = False) -> bool:
        if not self.samples:
            return False
        n = len(self.samples) if check_all else min(len(self.samples), 8)
        for s in self.samples[:n]:
            ref = s[0]
            paths = [ref] if isinstance(ref, str) else ref
            if not isinstance(paths, (list, tuple)):
                return False
            for p in paths:
                if not (isinstance(p, str) and p.lower().endswith((".jpg", ".jpeg"))):
                    return False
        return True

    def _native_batch_images(self, indices, seed, positions) -> np.ndarray:
        """Native path: (B, 3, H, W, 3) float32."""
        from .native import eval_params, load_batch_native, sample_train_params

        train = isinstance(self.transform, TrainTransform)
        h, w = self.transform.size
        paths, params = [], []
        for k, idx in zip(positions, indices):
            ref = self.samples[idx][0]
            items = [(ref, st) for st in STRIPS] if isinstance(ref, str) else [(p, None) for p in ref]
            for m, (path, st) in enumerate(items):
                paths.append(path)
                if train:
                    # The (sample, position, modality) stream of _load_one:
                    # the same geometry as the PIL path.
                    rng = np.random.default_rng((seed, int(idx), int(k), m))
                    params.append(sample_train_params(
                        rng, (h, w), self.transform.flip_prob, self.transform.padding,
                        self.transform.re_prob, st))
                else:
                    params.append(eval_params(st))
        flat = load_batch_native(paths, params, h, w, self.transform.mean, self.transform.std,
                                 num_threads=self.num_workers)
        return flat.reshape(len(indices), 3, h, w, 3)

    def _load_one(self, idx: int, key: tuple) -> np.ndarray:
        imgs = read_image(self.samples[idx][0], self.dataset)
        # Each modality from its own (seed, idx, pos, modality) stream, as
        # the native path draws them.
        return np.stack([self.transform(im, np.random.default_rng((*key, m)))
                         for m, im in enumerate(imgs)])  # (3, H, W, 3)

    def _make_batch(self, indices: np.ndarray, seed: int, pad_to: Optional[int],
                    positions: Optional[np.ndarray] = None) -> Batch:
        """`positions` are the rows' positions in the global batch (default
        0 .. B-1): they key each sample's augmentation, so that a rank's
        rows draw what the one-process batch draws for them
        (parallel/multihost.py)."""
        valid = len(indices)
        if pad_to is not None and valid < pad_to:
            indices = np.concatenate([indices, np.full(pad_to - valid, indices[-1])])
        if positions is None:
            positions = np.arange(len(indices))
        if self.use_native:
            images = self._native_batch_images(indices, seed, positions)
        else:
            keys = [(seed, int(i), int(k)) for k, i in zip(positions, indices)]
            images = np.stack(list(self.pool.map(self._load_one, indices, keys))).astype(
                np.float32)
        meta = [self.samples[i] for i in indices]
        return Batch(
            images=images,
            pids=np.asarray([m[1] for m in meta], np.int32),
            camids=np.asarray([m[2] for m in meta], np.int32),
            viewids=np.asarray([m[3] for m in meta], np.int32),
            paths=[m[0] for m in meta],
            valid=valid,
        )

    def iter_batches(self, order: np.ndarray, seed: int = 0, drop_last: bool = True,
                     pad_last: bool = False, prefetch: int = 2,
                     stage: Optional[Callable[[Batch], Any]] = None,
                     rows: Optional[np.ndarray] = None) -> Iterator[Any]:
        """Batches of `order`, made `prefetch` ahead in a producer thread
        (and passed through `stage` there, where given); a decode error is
        raised here, never swallowed (a truncated epoch would score a
        partial eval as complete).  Leaving the loop early stops the
        producer.  With `rows` (a rank's rows of the global batch) each
        batch, padded first with `pad_last`, is decoded at those rows only,
        its `valid` the global batch's."""
        bs = self.batch_size
        n_full = len(order) // bs
        chunks = [order[i * bs : (i + 1) * bs] for i in range(n_full)]
        rem = order[n_full * bs :]
        if len(rem) and not drop_last:
            chunks.append(rem)

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop, done = object(), threading.Event()
        err: List[BaseException] = []

        def put(item) -> None:
            while not done.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return
                except queue.Full:
                    continue

        def producer():
            try:
                for ch in chunks:
                    if done.is_set():
                        return
                    if rows is None:
                        batch = self._make_batch(np.asarray(ch), seed, bs if pad_last else None)
                    else:
                        valid = len(ch)
                        if valid < bs and not pad_last:
                            raise ValueError("a rank's rows split whole batches: pass pad_last")
                        ch = np.concatenate([ch, np.full(bs - valid, ch[-1])])
                        batch = self._make_batch(ch[rows], seed, None, positions=rows)
                        batch.valid = valid
                    put(batch if stage is None else stage(batch))
            except BaseException as e:  # re-raised in the consumer
                err.append(e)
            finally:
                put(stop)

        t = threading.Thread(target=producer, daemon=True, name="demo2-data-pipe")
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            done.set()
            t.join(timeout=60)


def device_batches(pipe: TriModalDataPipe, order: np.ndarray, device: torch.device,
                   seed: int = 0, **kw):
    """pipe.iter_batches(order, seed, **kw) on `device`: yields (batch,
    images f32, pids, camids, viewids int64).  On a card each batch is
    pinned in the producer thread and copied with non_blocking=True, so
    decoding the next batches overlaps the step on the card."""
    pin = device.type == "cuda"

    def stage(b: Batch):
        arrays = (b.images, b.pids, b.camids, b.viewids)
        return b, [torch.from_numpy(a).pin_memory() if pin else torch.from_numpy(a)
                   for a in arrays]

    for b, (images, *meta) in pipe.iter_batches(order, seed=seed, stage=stage, **kw):
        yield (b, images.to(device, non_blocking=True),
               *(t.to(device, non_blocking=True).long() for t in meta))


def make_dataloader(cfg: Config):
    """(train_pipe, sampler, val_pipe, num_query, num_classes, cam_num,
    view_num), as the reference's make_dataloader (:187-259).  A train
    epoch is `train_pipe.iter_batches(sampler.epoch_indices(epoch),
    seed=epoch)`.  Raises where a pipe can neither use the native loader nor
    PIL, naming why for each."""
    from .native import native_library

    name = cfg.DATASETS.NAMES
    if name not in DATASET_REGISTRY:
        raise ValueError(f"DATASETS.NAMES={name!r} is not one of {sorted(DATASET_REGISTRY)}")
    dataset = DATASET_REGISTRY[name](root=cfg.DATASETS.ROOT_DIR)

    native_mode = cfg.DATALOADER.NATIVE_DECODE
    if isinstance(native_mode, bool):
        # YAML 1.1 parses unquoted on/off as booleans: honour the intent.
        native_mode = "on" if native_mode else "off"
    if native_mode not in ("auto", "on", "off"):
        raise ValueError(f"DATALOADER.NATIVE_DECODE must be auto|on|off, got {native_mode!r}")
    use_native = {"on": True, "off": False, "auto": None}[native_mode]

    train_tf = TrainTransform(size=tuple(cfg.INPUT.SIZE_TRAIN), flip_prob=cfg.INPUT.PROB,
                              padding=cfg.INPUT.PADDING, re_prob=cfg.INPUT.RE_PROB,
                              mean=cfg.INPUT.PIXEL_MEAN, std=cfg.INPUT.PIXEL_STD)
    eval_tf = EvalTransform(size=tuple(cfg.INPUT.SIZE_TEST), mean=cfg.INPUT.PIXEL_MEAN,
                            std=cfg.INPUT.PIXEL_STD)
    train_pipe = TriModalDataPipe(dataset.train, dataset, train_tf, cfg.SOLVER.IMS_PER_BATCH,
                                  cfg.DATALOADER.NUM_WORKERS, use_native=use_native)
    sampler_mode = cfg.DATALOADER.SAMPLER
    if "triplet" in sampler_mode:  # reference make_dataloader.py:213: PK for any *triplet*
        sampler = RandomIdentitySampler(dataset.train, cfg.SOLVER.IMS_PER_BATCH,
                                        cfg.DATALOADER.NUM_INSTANCE, seed=cfg.SOLVER.SEED)
    elif sampler_mode == "softmax":
        sampler = SequentialSampler(dataset.train, cfg.SOLVER.IMS_PER_BATCH)
    else:
        raise ValueError(f"DATALOADER.SAMPLER must be softmax or *triplet*, got {sampler_mode!r}")
    val_samples = list(dataset.query) + list(dataset.gallery)
    val_pipe = TriModalDataPipe(val_samples, dataset, eval_tf, cfg.TEST.IMS_PER_BATCH,
                                cfg.DATALOADER.NUM_WORKERS, use_native=use_native)
    for label, pipe in (("train", train_pipe), ("val", val_pipe)):
        if pipe.use_native or not pipe.samples:
            continue
        pil = pil_error()
        if pil is not None:
            if native_mode == "off":
                why = "DATALOADER.NATIVE_DECODE is off"
            elif not pipe._all_jpeg_paths():
                why = "its samples are not on-disk JPEGs"
            else:
                why = f"the native loader is unavailable: {native_library().error}"
            raise RuntimeError(f"the {label} pipe of {name} has no decoder: {pil}, and the "
                               f"native loader cannot serve it ({why})")
    return (train_pipe, sampler, val_pipe, len(dataset.query), dataset.num_train_pids,
            dataset.num_train_cams, dataset.num_train_vids)
