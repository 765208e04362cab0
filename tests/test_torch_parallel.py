"""Data-parallel training of the port (demo2_tpu_torch/parallel/) on the CPU.

Two ranks over gloo (tests/torch_parallel_worker.py, spawned once for the
module with a join timeout of its own) run the tiny flagship in f32 with SGD
on their rows of each global batch; the same case functions run here in one
process.  Held: the two-rank steps against the one-process steps (losses,
parameters, BatchNorm statistics) and the ranks bitwise equal to each
other; one two-rank step against JAX's one-device build_train_step on the
same global batch and weights; the averaged-gradient and per-rank-BatchNorm
controls failing the same bounds; each rank's draws and host-pipe rows equal
to the one-process rows; eval gathered in row order with the padded tail
dropped; only the primary rank writing; the world's checks (D12).
"""

import functools
import os
import pathlib
import socket
import subprocess
import sys
import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.config import get_cfg_defaults as j_get_cfg_defaults
from demo2_tpu.config.presets import apply_flagship as j_apply_flagship
from demo2_tpu.config.presets import apply_tiny as j_apply_tiny
from demo2_tpu.engine.train import build_train_step as j_build_train_step
from demo2_tpu.models import make_model as j_make_model
from demo2_tpu.parallel import mesh as jmesh
from demo2_tpu.parallel import multihost as jmh
from demo2_tpu_torch.parallel import collectives as col
from demo2_tpu_torch.parallel.mesh import World, make_world
from demo2_tpu_torch.parallel.multihost import host_batch_rows, iter_index_batches
from demo2_tpu_torch.utils.converters import convert_flax_variables
from torch_port_helpers import jax_state_from, n, random_variables

import torch_parallel_worker as wk

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_parallel_worker.py"
WORLD = 2
JOIN_TIMEOUT_S = 150
# f32 on both sides, only the summation order differs (tests/test_torch_train.py).
TOL = dict(rtol=1e-5, atol=1e-6)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_cfg():
    """JAX's config of torch_parallel_worker.train_cfg()."""
    cfg = j_get_cfg_defaults()
    j_apply_flagship(cfg, on_tpu=False)
    j_apply_tiny(cfg)
    cfg.DATALOADER.NUM_INSTANCE = 4
    cfg.SOLVER.OPTIMIZER_NAME = "SGD"
    cfg.SOLVER.BASE_LR = 0.005
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.TEST.IMS_PER_BATCH = 10
    cfg.freeze()
    return cfg


def _jax_setup():
    """The JAX case's batch and random weights, and the port's state dict of
    those weights."""
    cfg = _jax_cfg()
    h, w = cfg.INPUT.SIZE_TRAIN
    rng = np.random.default_rng(8)
    images = rng.standard_normal((16, 3, h, w, 3)).astype(np.float32)
    pids = np.repeat(np.arange(8), 2).astype(np.int32)
    cams = rng.integers(0, wk.CAMERA_NUM, 16).astype(np.int32)
    jmodel = j_make_model(cfg, wk.NUM_PIDS, wk.CAMERA_NUM)
    variables = random_variables(jmodel, images[:2], cams[:2], train=False, seed=8)
    port = wk.model_for(wk.train_cfg())
    setup = {"solver": {}, "state_dict": convert_flax_variables(variables, port),
             "images": torch.from_numpy(images), "pids": torch.from_numpy(pids).long(),
             "cams": torch.from_numpy(cams).long()}
    return cfg, jmodel, variables, (images, pids, cams), setup


def _jax_step(cfg, jmodel, variables, batch):
    """JAX's one-device train step on the global batch, flax's dropout off
    (its draws are not the port's; the port runs SDTPS's dropout at 0)."""
    images, pids, cams = batch
    sample = types.SimpleNamespace(images=images[:2], camids=cams[:2], viewids=cams[:2] * 0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        jstate, tx, ctx, _ = jax_state_from(cfg, jmodel, variables, sample)
        jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                                opt_state=tx.init(variables["params"]))
        new, metrics = j_build_train_step(cfg, jmodel, tx, ctx, donate=False)(
            jstate, jnp.asarray(images), jnp.asarray(pids), jnp.asarray(cams),
            jnp.asarray(cams * 0), jax.random.PRNGKey(1))
        return {"params": new.params, "batch_stats": new.batch_stats}, float(metrics["loss"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the two ranks, compute JAX's step and the one-process cases
    here meanwhile, then join the ranks (killed on a failure or after
    JOIN_TIMEOUT_S)."""
    out = tmp_path_factory.mktemp("ranks")
    jcfg, jmodel, variables, batch, setup = _jax_setup()
    setup_path = out / "setup.pt"
    torch.save(setup, setup_path)
    port = _free_port()
    procs, logs = [], []
    for r in range(WORLD):
        env = dict(os.environ, PYTHONPATH=str(REPO), RANK=str(r), WORLD_SIZE=str(WORLD),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        log = open(out / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, str(WORKER), str(out), str(setup_path)],
                                      env=env, cwd=str(REPO), stdout=log,
                                      stderr=subprocess.STDOUT))
    try:
        one_out = out / "one"
        one_out.mkdir()
        one = World()
        single = {"steps": wk.steps(one), "center": wk.steps(one, "center"),
                  "jax_step": wk.jax_step(one, setup), "draws": wk.draws(one),
                  "host_rows": wk.host_rows(one), "evaluate": wk.evaluate(one, str(one_out))}
        jax_state, jax_loss = _jax_step(jcfg, jmodel, variables, batch)
        for p in procs:
            p.wait(timeout=JOIN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (out / f"rank{r}.log").read_text()[-4000:]
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return types.SimpleNamespace(out=out, ranks=ranks, one=single, setup=setup,
                                 jax_state=jax_state, jax_loss=jax_loss)


def _rows(r, b=16):
    return slice(r * b // WORLD, (r + 1) * b // WORLD)


def _close(a: dict, b: dict, **tol) -> list:
    """The keys of two tensor dicts that are not within `tol`."""
    return [k for k in b if not np.allclose(n(a[k]), n(b[k]), **tol)]


def _within(got: dict, want: dict) -> list:
    """What of a two-rank run is not within bounds of the one-process run:
    'losses' (rtol 1e-5), then the names of the train state's tensors: the
    parameters, BatchNorm statistics and centers within TOL, the SGD traces
    (the last step's gradients) at the gradient tolerance of
    tests/test_torch_train.py's one-step test."""
    bad = [] if np.allclose(got["losses"], want["losses"], rtol=1e-5, atol=0) else ["losses"]
    a, b = got["replicas"], want["replicas"]
    traces = [k for k in b if k.startswith("optimizer.")]
    top = max(np.abs(n(b[k])).max() for k in traces)
    bad += [k for k in traces if not np.allclose(
        n(a[k]), n(b[k]), rtol=1e-3, atol=1e-4 * np.abs(n(b[k])).max() + 1e-6 * top)]
    return bad + _close({k: a[k] for k in b if k not in traces},
                        {k: b[k] for k in b if k not in traces}, **TOL)


@pytest.mark.parametrize("case", ["steps", "center"])
def test_two_ranks_take_the_one_process_steps(run, case):
    """Losses, parameters, BatchNorm statistics and SGD traces after two
    steps (with `center` also the centers), within TOL of one process."""
    for r in range(WORLD):
        got = run.ranks[r][case]
        assert got["replicas"].keys() == run.one[case]["replicas"].keys()
        assert _within(got, run.one[case]) == [], r
    stats = [k for k in run.one["steps"]["replicas"] if k.endswith("running_mean")]
    assert stats and all(not torch.equal(run.one["steps"]["replicas"][k],
                                         run.one["steps"]["init"][k[len("model."):]])
                         for k in stats)
    assert "centers" in run.one["center"]["replicas"]


@pytest.mark.parametrize("case", ["steps", "center"])
def test_ranks_stay_bitwise_equal(run, case):
    a, b = (run.ranks[r][case]["replicas"] for r in range(WORLD))
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    assert run.ranks[0][case]["losses"] == run.ranks[1][case]["losses"]


@pytest.mark.parametrize("control", ["averaged", "per_rank_bn"])
def test_controls_fail_the_bounds(run, control):
    """The same run with the gradients averaged, or the BatchNorm statistics
    left per rank, must not pass the bounds the honest run passes."""
    assert _within(run.ranks[0][control], run.one["steps"]) != []


def test_two_ranks_match_jax_one_device_step(run):
    """One SGD step of two ranks on the JAX case's global batch against
    JAX's one-device step: the loss, each parameter's update at the
    gradient tolerance of tests/test_torch_train.py's one-step test, the
    BatchNorm statistics within TOL."""
    got = run.ranks[0]["jax_step"]
    np.testing.assert_allclose(got["loss"], run.jax_loss, rtol=1e-5)
    init = run.setup["state_dict"]
    want = convert_flax_variables(run.jax_state, wk.model_for(wk.train_cfg()))
    deltas = {k: n(want[k]) - n(init[k]) for k in want}
    top = max(np.abs(d).max() for d in deltas.values())
    for k, d in deltas.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(n(got["state"][k]), n(want[k]), err_msg=k, **TOL)
            continue
        np.testing.assert_allclose(n(got["state"][k]) - n(init[k]), d, rtol=1e-3,
                                   atol=1e-4 * np.abs(d).max() + 1e-6 * top, err_msg=k)
    assert top > 0
    for k, v in run.ranks[1]["jax_step"]["state"].items():
        assert torch.equal(v, got["state"][k]), k
    # and against the port's one-process step on the same batch
    assert _close(got["state"], run.one["jax_step"]["state"], **TOL) == []


@pytest.mark.parametrize("world", [1, 2, 4])
def test_rows_and_index_batches_match_jax(world):
    """host_batch_rows and iter_index_batches of rank r against the rows
    JAX's P('data') sharding gives device r, full batches and a padded
    remainder."""
    mesh = jmesh.make_mesh(world)
    devices = list(mesh.devices.flat)
    bs = 8
    order = np.random.default_rng(3).permutation(29)
    jax_batches = list(jmh.iter_index_batches(mesh, order, bs, drop_last=False, pad_last=True))
    for r in range(world):
        w = World(world, r)
        sl = jmesh.batch_sharding(mesh).devices_indices_map((bs,))[devices[r]][0]
        np.testing.assert_array_equal(host_batch_rows(w, bs), np.arange(bs)[sl])
        ours = list(iter_index_batches(w, order, bs, drop_last=False, pad_last=True))
        assert [v for _, v in ours] == [v for _, v in jax_batches] == [8, 8, 8, 5]
        for (rows, _), (garr, _) in zip(ours, jax_batches):
            shard = next(s for s in garr.addressable_shards if s.device == devices[r])
            np.testing.assert_array_equal(rows, np.asarray(shard.data))


@pytest.mark.parametrize("what", ["images", "drop_path", "dropout", "gumbel", "after"])
def test_each_rank_draws_the_one_process_rows(run, what):
    want = run.one["draws"][what]
    for r in range(WORLD):
        got = run.ranks[r]["draws"][what]
        if what == "drop_path":  # the backbone's modality-major 3B rows
            want_r = want.reshape(3, 16, -1)[:, _rows(r)].reshape(got.shape)
        elif what == "gumbel":
            want_r = want[:, _rows(r)]
        elif what == "after":  # the generator's next draw: it advanced alike
            want_r = want
        else:
            want_r = want[_rows(r)]
        assert torch.equal(got, want_r), r


@pytest.mark.parametrize("what", ["train", "tail"])
def test_host_pipe_rows_are_the_one_process_rows(run, what):
    """A rank's decoded rows (augmentation keyed on the global positions)
    are the one-process batch's, the padded eval tail's too."""
    want = run.one["host_rows"][what]
    for r in range(WORLD):
        got = run.ranks[r]["host_rows"]
        assert torch.equal(got[what], want[_rows(r, 10 if what == "tail" else 16)]), r
    assert run.ranks[0]["host_rows"]["tail_valid"] == run.one["host_rows"]["tail_valid"] == 8
    assert torch.equal(run.ranks[1]["host_rows"]["train_pids"],
                       run.one["host_rows"]["train_pids"][_rows(1)])


@pytest.mark.parametrize("source", ["", "pipe_"])
def test_eval_gathers_rows_in_order_and_drops_the_padding(run, source):
    """Every rank's CMC and mAP (the cache, or the pipe) equal, and equal to
    one process's over the same 48 samples (5 batches of 10, the last
    padded); rank r's rows gathered in rank order."""
    want = run.one["evaluate"]
    for r in range(WORLD):
        got = run.ranks[r]["evaluate"]
        np.testing.assert_allclose(n(got[f"{source}cmc"]), n(want[f"{source}cmc"]), atol=1e-6)
        np.testing.assert_allclose(got[f"{source}mAP"], want[f"{source}mAP"], atol=1e-6)
        assert torch.equal(got["gathered"], torch.arange(16))
    a, b = (run.ranks[r]["evaluate"] for r in range(WORLD))
    assert torch.equal(a[f"{source}cmc"], b[f"{source}cmc"])
    assert a[f"{source}mAP"] == b[f"{source}mAP"]


def test_only_the_primary_rank_writes(run):
    """do_train's checkpoints, the log file, the metrics file and the rank
    list exist for rank 0 only; both ranks end the epoch, and resume from
    the primary's checkpoint, bitwise alike."""
    out = run.out
    assert any((out / "ckpt_rank0").iterdir()) and any((out / "ckpt_rank0_best").iterdir())
    assert list((out / "log_rank0").glob("train_log_*.txt"))
    assert (out / "metrics_rank0.jsonl").stat().st_size > 0
    assert (out / "re_rank0.txt").exists()
    for p in ("ckpt_rank1", "ckpt_rank1_best", "log_rank1", "metrics_rank1.jsonl",
              "re_rank1.txt"):
        assert not (out / p).exists(), p
    a, b = (run.ranks[r]["writes"] for r in range(WORLD))
    assert a["best"] == b["best"] and a["best"]["mAP"] > 0
    for key in ("replicas", "resumed"):
        assert [k for k in a[key] if not torch.equal(a[key][k], b[key][k])] == []
    assert [k for k in a["replicas"] if not torch.equal(a["replicas"][k], a["resumed"][k])] == []


def test_world_checks_under_the_group(run):
    got = run.ranks[1]["world_checks"]
    assert got[-1] == got[WORLD] == WORLD
    assert "TPU.NUM_DEVICES=4 under a process group of 2 ranks" in got[2 * WORLD]
    assert "differ between the ranks" in got["replicas"]
    assert run.ranks[0]["world"] == (WORLD, 0, "gloo")
    # rows of 1 on rank 0 and 2 on rank 1: the global mean, each row's
    # gradient 1 / (global count)
    assert got["batch_mean"] == 1.5
    assert torch.equal(got["batch_mean_grad"], torch.full((2, 3), 1.0 / 12))


@pytest.mark.parametrize("num_devices", [2, 8])
def test_num_devices_above_one_without_a_group_raises(num_devices):
    """D12: one PyTorch process drives one device; the error names the
    launch."""
    with pytest.raises(ValueError, match=f"torchrun --nproc_per_node {num_devices} "):
        make_world(num_devices)
    assert make_world(1).size == make_world(-1).size == 1


@pytest.mark.parametrize("draw", ["rand", "randn", "randint"])
def test_batch_draws_outside_a_shard_are_torch_draws(draw):
    """Outside the step's shard (and in a world of one) a batch draw is the
    plain torch draw, bit for bit."""
    fns = {"rand": (col.batch_rand, torch.rand), "randn": (col.batch_randn, torch.randn),
           "randint": (functools.partial(col.batch_randint, 0, 7),
                       functools.partial(torch.randint, 0, 7))}
    ours, plain = fns[draw]
    for shard in (None, col.Shard(World(), 6)):
        with col.data_parallel(shard):
            got = ours((6, 3), generator=torch.Generator().manual_seed(2),
                       device=torch.device("cpu"))
        assert torch.equal(got, plain((6, 3), generator=torch.Generator().manual_seed(2)))
