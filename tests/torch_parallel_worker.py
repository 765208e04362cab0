"""Data-parallel cases of tests/test_torch_parallel.py (not a test module).

    RANK=r WORLD_SIZE=w MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python tests/torch_parallel_worker.py OUT_DIR [SETUP.pt]

joins the gloo group of W ranks on the CPU through
parallel/mesh.py::join_process_group, runs every case below on its rows of
the global batch and saves what each returns to OUT_DIR/rank<r>.pt.  The
test runs the same case functions in one process (the default world of one)
for the one-process reference.  SETUP.pt, written by the test, holds the
JAX case's weights and batch.  Imports torch and the port only.
"""

from __future__ import annotations

import contextlib
import os
import sys
from unittest import mock

import numpy as np
import torch

from demo2_tpu_torch.config import get_cfg_defaults
from demo2_tpu_torch.config.presets import apply_flagship, apply_tiny
from demo2_tpu_torch.data.datasets import SyntheticTriModal
from demo2_tpu_torch.data.device_cache import DeviceCache
from demo2_tpu_torch.data.loader import TriModalDataPipe
from demo2_tpu_torch.data.sampler import RandomIdentitySampler
from demo2_tpu_torch.data.transforms import EvalTransform, TrainTransform
from demo2_tpu_torch.engine import train as engine_train
from demo2_tpu_torch.engine.eval import run_eval
from demo2_tpu_torch.engine.state import create_train_state, replica_tensors
from demo2_tpu_torch.engine.train import build_train_step, do_train, loss_and_grads
from demo2_tpu_torch.losses.losses import make_loss_fn
from demo2_tpu_torch.models import make_model
from demo2_tpu_torch.models.sdtps import dropout
from demo2_tpu_torch.models.vit import drop_path
from demo2_tpu_torch.ops import norm
from demo2_tpu_torch.parallel import collectives as col
from demo2_tpu_torch.parallel.mesh import World, join_process_group, make_world
from demo2_tpu_torch.parallel.multihost import HostShardedBatches, iter_index_batches
from demo2_tpu_torch.utils.checkpoint import restore_checkpoint
from demo2_tpu_torch.utils.logger import setup_logger
from demo2_tpu_torch.utils.metrics_log import MetricsLogger

CPU = torch.device("cpu")
NUM_PIDS, CAMERA_NUM, IMGS_PER_PID = 8, 4, 4
NUM_QUERY = 2 * NUM_PIDS  # SyntheticTriModal's query split
STEPS = 2


def train_cfg(center: bool = False, **solver):
    """The tiny flagship in f32 on the CPU with SGD (updates linear in the
    gradient, so a gradient off by a factor shows in the parameters; Adam
    would hide it), global batch 16, eval batches of 10 (the last of the 48
    val samples padded); with `center` the center loss too."""
    cfg = get_cfg_defaults()
    apply_flagship(cfg, on_tpu=False)
    apply_tiny(cfg)
    cfg.MODEL.DEVICE = "cpu"
    cfg.DATALOADER.NUM_INSTANCE = 4
    cfg.SOLVER.OPTIMIZER_NAME = "SGD"
    cfg.SOLVER.BASE_LR = 0.005
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.TEST.IMS_PER_BATCH = 10
    if center:
        cfg.MODEL.METRIC_LOSS_TYPE = "triplet_center"
    for k, v in solver.items():
        setattr(cfg.SOLVER, k, v)
    return cfg.freeze()


def data(cfg):
    ds = SyntheticTriModal(num_pids=NUM_PIDS, num_cams=CAMERA_NUM, imgs_per_pid=IMGS_PER_PID,
                           image_size=tuple(cfg.INPUT.SIZE_TRAIN))
    train = DeviceCache.from_arrays(ds.render_all(ds.train), ds.train, train=True, cfg=cfg,
                                    device=CPU)
    val_samples = ds.query + ds.gallery
    val = DeviceCache.from_arrays(ds.render_all(val_samples), val_samples, train=False,
                                  cfg=cfg, device=CPU)
    sampler = RandomIdentitySampler(ds.train, cfg.SOLVER.IMS_PER_BATCH,
                                    cfg.DATALOADER.NUM_INSTANCE, seed=cfg.SOLVER.SEED)
    return ds, train, val, sampler


def model_for(cfg):
    return make_model(cfg, NUM_PIDS, CAMERA_NUM, device=CPU,
                      generator=torch.Generator().manual_seed(0))


def snapshot(tensors: dict) -> dict:
    return {k: v.detach().clone() for k, v in tensors.items()}


def averaged(world, grads):
    """The averaged-gradient control: the sum over the ranks divided by W."""
    col.all_reduce_sum_(list(grads.values()))
    for g in grads.values():
        g.div_(world.size)


def steps(world: World, control: str = "") -> dict:
    """STEPS SGD steps through build_train_step on the device cache (this
    rank's rows of each PK batch): the losses and the train state after.
    `control` "center" adds the center loss; the controls "averaged"
    average the gradients over the ranks, "per_rank_bn" leave the BatchNorm
    statistics per rank."""
    cfg = train_cfg(center=control == "center")
    _, train, _, sampler = data(cfg)
    model = model_for(cfg)
    init = snapshot(model.state_dict())
    state = create_train_state(cfg, model, STEPS)
    patches = {"averaged": mock.patch.object(engine_train, "reduce_gradients", averaged),
               "per_rank_bn": mock.patch.object(norm, "active_shard", lambda: None)}
    with patches.get(control, contextlib.nullcontext()):
        step = build_train_step(cfg, model, state, train, world)
        order = sampler.epoch_indices(1)[: STEPS * cfg.SOLVER.IMS_PER_BATCH]
        losses = [step(torch.from_numpy(rows))["loss"].item()
                  for rows, _ in iter_index_batches(world, order, cfg.SOLVER.IMS_PER_BATCH)]
    return {"losses": losses, "init": init, "replicas": snapshot(replica_tensors(state))}


def jax_step(world: World, setup: dict) -> dict:
    """One SGD step of loss_and_grads on the JAX case's fixed batch and
    weights (setup: cfg overrides, the port's state dict, images, pids,
    cams), SDTPS's dropout off as the JAX side runs it."""
    cfg = train_cfg(**setup["solver"])
    model = model_for(cfg)
    model.load_state_dict(setup["state_dict"])
    for mlp in model.sdtps.modal_weight_mlp:
        mlp.dropout = 0.0
    state = create_train_state(cfg, model, 4)
    b = len(setup["pids"])
    shard = col.Shard(world, b)
    rows = slice(shard.lo, shard.hi) if world.size > 1 else slice(0, b)
    with col.data_parallel(shard):
        loss, _, grads = loss_and_grads(cfg, model, make_loss_fn(cfg, NUM_PIDS),
                                        setup["images"][rows], setup["pids"][rows],
                                        setup["cams"][rows], None)
    engine_train.reduce_gradients(world, grads)
    state.optimizer.step(grads)
    return {"loss": loss.item(), "state": snapshot(model.state_dict())}


def draws(world: World) -> dict:
    """This rank's draws over the batch under the step's shard: the
    augmented cache rows, a drop-path mask over modality-major 3B rows, a
    dropout mask over B rows, a Gumbel draw over (3, B, N) and the same
    generator's next draw (the generator advanced as in one process)."""
    cfg = train_cfg()
    _, train, _, sampler = data(cfg)
    bs = cfg.SOLVER.IMS_PER_BATCH
    rows, _ = next(iter_index_batches(world, sampler.epoch_indices(1), bs))
    b = len(rows)
    g = torch.Generator().manual_seed(5)
    with col.data_parallel(col.Shard(world, bs)):
        images = train.batch(torch.from_numpy(rows), g)[0]
        path = drop_path(torch.ones(3 * b, 2), 0.5, train=True, generator=g)
        drop = dropout(torch.ones(b, 4), 0.5, g)
        gumbel = col.batch_rand((3, b, 5), generator=g, device=CPU, batch_axis=1)
    return {"images": images, "drop_path": path, "dropout": drop, "gumbel": gumbel,
            "after": torch.rand(4, generator=g)}


def host_rows(world: World) -> dict:
    """The host pipe's first train batch (PIL decode, per-sample keys) and
    its padded last eval batch, each at this rank's rows."""
    cfg = train_cfg()
    ds, _, _, sampler = data(cfg)
    size = tuple(cfg.INPUT.SIZE_TRAIN)
    train = TriModalDataPipe(ds.train, ds, TrainTransform(size=size), cfg.SOLVER.IMS_PER_BATCH,
                             num_workers=1, use_native=False)
    val = TriModalDataPipe(ds.query + ds.gallery, ds, EvalTransform(size=size),
                           cfg.TEST.IMS_PER_BATCH, num_workers=1, use_native=False)
    val_order = np.arange(len(val.samples))
    if world.size > 1:
        train, val = HostShardedBatches(train, world), HostShardedBatches(val, world)
    order = sampler.epoch_indices(1)[: cfg.SOLVER.IMS_PER_BATCH]
    first = next(iter(train.iter_batches(order, seed=1)))
    tail = list(val.iter_batches(val_order[40:], drop_last=False, pad_last=True))
    return {"train": torch.from_numpy(first.images), "train_pids": torch.from_numpy(first.pids),
            "tail": torch.from_numpy(tail[0].images), "tail_valid": tail[0].valid}


def evaluate(world: World, out: str) -> dict:
    """run_eval of the initial model over the val cache (48 samples in
    batches of 10) and over the val pipe, the rank list to this rank's file
    under `out`; and the gather of each rank's row numbers."""
    cfg = train_cfg()
    ds, _, val, _ = data(cfg)
    model = model_for(cfg)
    cmc, m_ap = run_eval(cfg, model, val, NUM_QUERY, world=world,
                         rank_list_path=os.path.join(out, f"re_rank{world.rank}.txt"))
    pipe = TriModalDataPipe(ds.query + ds.gallery, ds,
                            EvalTransform(size=tuple(cfg.INPUT.SIZE_TEST)),
                            cfg.TEST.IMS_PER_BATCH, num_workers=1, use_native=False)
    pipe_cmc, pipe_map = run_eval(cfg, model, pipe, NUM_QUERY, world=world)
    shard = col.Shard(world, 16)
    with col.data_parallel(shard):
        gathered = col.gather_rows(torch.arange(shard.lo, shard.hi) if world.size > 1
                                   else torch.arange(16))
    return {"cmc": torch.from_numpy(np.asarray(cmc)), "mAP": m_ap,
            "pipe_cmc": torch.from_numpy(np.asarray(pipe_cmc)), "pipe_mAP": pipe_map,
            "gathered": gathered}


def writes(world: World, out: str) -> dict:
    """do_train for one epoch with eval and checkpoints, the log, the
    metrics file and the checkpoints each to this rank's path under `out`;
    then every rank resumes from the primary's checkpoint."""
    cfg = train_cfg(MAX_EPOCHS=1, EVAL_PERIOD=1, CHECKPOINT_PERIOD=1, LOG_PERIOD=1)
    _, train, val, sampler = data(cfg)
    r = world.rank
    setup_logger("DeMo", os.path.join(out, f"log_rank{r}"))
    writer = MetricsLogger(os.path.join(out, f"metrics_rank{r}.jsonl"))
    state = create_train_state(cfg, model_for(cfg), STEPS)
    try:
        state, best = do_train(cfg, state, train, sampler, val, NUM_QUERY,
                               checkpoint_dir=os.path.join(out, f"ckpt_rank{r}"),
                               writer=writer, world=world)
    finally:
        writer.close()
    if world.size > 1:
        torch.distributed.barrier()
    resumed = restore_checkpoint(os.path.join(out, "ckpt_rank0"),
                                 create_train_state(cfg, model_for(cfg), STEPS))
    col.check_replicas_equal(world, replica_tensors(resumed), "the resumed states")
    return {"best": best, "replicas": snapshot(replica_tensors(state)),
            "resumed": snapshot(replica_tensors(resumed))}


def world_checks(world: World) -> dict:
    """make_world under the group for TPU.NUM_DEVICES -1, W and 2 W, the
    replica check on states that differ on rank 1 only, and batch_mean of
    rows r + 1 on rank r with its gradient."""
    got = {}
    for n in (-1, world.size, 2 * world.size):
        try:
            got[n] = make_world(n).size
        except ValueError as e:
            got[n] = str(e)
    tensors = {"a": torch.zeros(3), "b": torch.full((2,), float(world.rank == 1))}
    try:
        col.check_replicas_equal(world, tensors, "the probe tensors")
        got["replicas"] = "equal"
    except RuntimeError as e:
        got["replicas"] = str(e)
    x = torch.full((2, 3), float(world.rank + 1), requires_grad=True)
    with col.data_parallel(col.Shard(world, 2 * world.size)):
        mean = col.batch_mean(x)
    mean.backward()
    got["batch_mean"], got["batch_mean_grad"] = mean.item(), x.grad
    return got


def main(out: str, setup_path: str) -> None:
    world = join_process_group("cpu", timeout_s=120)
    setup = torch.load(setup_path, weights_only=False)
    results = {"world": (world.size, world.rank, world.backend),
               "steps": steps(world), "center": steps(world, "center"),
               "averaged": steps(world, "averaged"),
               "per_rank_bn": steps(world, "per_rank_bn"), "jax_step": jax_step(world, setup),
               "draws": draws(world), "host_rows": host_rows(world),
               "evaluate": evaluate(world, out), "writes": writes(world, out),
               "world_checks": world_checks(world)}
    torch.save(results, os.path.join(out, f"rank{world.rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(2)
    main(sys.argv[1], sys.argv[2])
