"""DeMo's branches other than the flagship's, against the JAX package on the
CPU: the HDM + ATMoE model of configs/*/DeMo.yml at return_pattern 1, 2 and
3, the Baseline, SDTPS alone, DGAF alone (v3, and v1 over GlobalLocalFuse),
SDTPS + DGAF v1 and the shared SDTPS projections.  Each configuration is its
YAML file's keys (f32, apply_tiny's backbone); every flax leaf is set to a
seeded random value and the port loads the same values through the
converter.  Then one whole f32 train step of DeMo.yml's model against JAX's
build_train_step, the evaluation entry points at each pattern, do_train's
pattern loop, and the auxiliary losses of the train step.
"""

import functools
import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import demo2_tpu.models.demo as jdemo
from demo2_tpu.config import get_cfg_defaults
from demo2_tpu.config.presets import apply_tiny
from demo2_tpu.engine.train import build_train_step as j_build_train_step
from demo2_tpu.losses import losses as jl
from demo2_tpu.models import make_model as j_make_model
from demo2_tpu.models.hdm_atmoe import GeneralFusion as JGeneralFusion
from demo2_tpu.serving import FeatureExtractor as JFeatureExtractor
from demo2_tpu_torch.data import device_cache as dc
from demo2_tpu_torch.data.datasets import SyntheticTriModal
from demo2_tpu_torch.data.sampler import RandomIdentitySampler
from demo2_tpu_torch.engine.eval import do_inference, eval_step, miss_mask, run_eval
from demo2_tpu_torch.engine.state import create_train_state
from demo2_tpu_torch.engine.train import do_train, loss_and_grads
from demo2_tpu_torch.losses import losses as tl
from demo2_tpu_torch.models import make_model
from demo2_tpu_torch.serving import FeatureExtractor
from demo2_tpu_torch.utils.converters import convert_flax_variables
from torch_port_helpers import CPU, generator, jax_state_from, load_port, n, random_variables, t

NUM_CLASSES, CAMERA_NUM = 8, 4
TOL = dict(rtol=1e-5, atol=1e-5)
C = 512  # CLIP ViT-B-16's projected width, whatever the tiny backbone's
CASES = {  # id: (YAML file under configs/, MODEL overrides)
    "DeMo": ("RGBNT201/DeMo.yml", {}),
    "DeMo-direct0": ("RGBNT201/DeMo.yml", {"DIRECT": 0}),
    "DeMo-hdm_only": ("RGBNT201/DeMo.yml", {"ATM": False}),
    "Baseline-direct1": ("RGBNT201/Baseline.yml", {}),
    "Baseline-direct0": ("RGBNT201/Baseline.yml", {"DIRECT": 0}),
    "SDTPS": ("RGBNT201/DeMo_SDTPS.yml", {}),
    "SDTPS-global_local": ("RGBNT201/DeMo_SDTPS.yml", {"GLOBAL_LOCAL": True}),
    "SDTPS-direct0": ("RGBNT201/DeMo_SDTPS.yml", {"DIRECT": 0}),
    "DGAF-v3": ("RGBNT201/DeMo_DGAF.yml", {}),
    "DGAF-v1": ("RGBNT201/DeMo_DGAF.yml", {"DGAF_VERSION": "v1"}),
    "DGAF-v1-global_local": ("RGBNT201/DeMo_DGAF.yml", {"DGAF_VERSION": "v1",
                                                         "GLOBAL_LOCAL": True}),
    "SDTPS_DGAF-v1-global_local": ("RGBNT201/DeMo_SDTPS_DGAF.yml", {"DGAF_VERSION": "v1",
                                                                    "GLOBAL_LOCAL": True}),
    "SDTPS_shared": ("RGBNT201/DeMo_SDTPS_shared.yml", {}),
    "optimized": ("RGBNT201/DeMo_optimized.yml", {}),
}
# The branch names in the JAX package's order (the first branch carries the
# SDTPS loss weight and the train step's accuracy).
BRANCHES = {
    "DeMo": ["ori", "moe"],
    "DeMo-direct0": ["ori_r", "ori_n", "ori_t", "moe"],
    "Baseline-direct0": ["ori_r", "ori_n", "ori_t"],
    "SDTPS-direct0": ["sdtps", "ori_r", "ori_n", "ori_t"],
}


def _cfg(case, **tpu):
    path, model = CASES[case]
    cfg = get_cfg_defaults()
    cfg.merge_from_file(f"configs/{path}")
    apply_tiny(cfg)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.DATA_CACHE = "device"
    for k, v in {**model, **tpu}.items():
        setattr(cfg.TPU if k in tpu else cfg.MODEL, k, v)
    return cfg.freeze()


class _Pair:
    """One configuration's JAX model with random variables, a jitted apply
    of all three return patterns, and the port model with the same weights."""

    def __init__(self, case):
        self.cfg = cfg = _cfg(case)
        h, w = cfg.INPUT.SIZE_TEST
        self.jmodel = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
        self.variables = random_variables(self.jmodel, np.zeros((2, 3, h, w, 3), np.float32),
                                          np.zeros((2,), np.int32), train=False, seed=3)
        self.port = load_port(make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU,
                                         generator=generator()), self.variables)
        self.order = []

        def apply(v, x, c, m):
            outs = [self.jmodel.apply(v, x, c, None, m, train=False, return_pattern=p)
                    for p in (1, 2, 3)]
            # At trace time the branch dict is the model's own, in its order
            # (a jitted output comes back with its keys sorted).
            self.order.append(list(outs[0]["branches"]))
            return outs

        self.japply = jax.jit(apply)


@functools.cache
def _pair(case):
    return _Pair(case)


def _images(n_img, cfg, seed):
    h, w = cfg.INPUT.SIZE_TEST
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_img, 3, h, w, 3)).astype(np.float32),
            rng.integers(0, CAMERA_NUM, n_img).astype(np.int32))


@pytest.mark.parametrize("case", list(CASES))
def test_branches_match_jax_at_every_return_pattern(case):
    pair = _pair(case)
    images, cams = _images(3, pair.cfg, seed=1)
    mask = np.ones(3, np.float32)
    wants = pair.japply(pair.variables, images, cams, mask)
    moe = pair.cfg.MODEL.HDM or pair.cfg.MODEL.ATM
    for pattern, want in zip((1, 2, 3), wants):
        with torch.no_grad():
            got = pair.port(t(images), t(cams).long(), None, t(mask), return_pattern=pattern)
        assert list(got["branches"]) == pair.order[0] == BRANCHES.get(case, pair.order[0])
        width = {1: 3 * C, 2: 7 * C, 3: 10 * C}[pattern] if moe else 3 * C
        assert got["embedding"].dtype == torch.float32
        assert got["embedding"].shape == (3, width) == want["embedding"].shape
        np.testing.assert_allclose(n(got["embedding"]), np.asarray(want["embedding"]), **TOL)
        for name, (logits, feat) in want["branches"].items():
            np.testing.assert_allclose(n(got["branches"][name][0]), np.asarray(logits),
                                       err_msg=name, **TOL)
            np.testing.assert_allclose(n(got["branches"][name][1]), np.asarray(feat),
                                       err_msg=name, **TOL)
    assert pair.port.embed_dim == (10 if moe else 3) * C


def test_branch_order_is_the_jax_packages():
    """The main branch first: the loss weights and the reported accuracy
    read it (losses.py::branch_weights)."""
    assert [c for c in CASES if c not in BRANCHES]  # the rest are single-head
    for case, names in BRANCHES.items():
        pair = _pair(case)
        assert list(tl.branch_weights(pair.cfg, names)) == names
    assert tl.branch_weights(_pair("SDTPS-direct0").cfg, BRANCHES["SDTPS-direct0"]) == {
        "sdtps": 2.0, "ori_r": 1.0, "ori_n": 1.0, "ori_t": 1.0}


def test_converter_fills_the_new_trees():
    """GeneralFusion, GlobalLocalFuse, DGAF v1 and the shared SDTPS
    projections: every leaf lands where it belongs, and strictly both ways."""
    demo = _pair("DeMo")
    sd = convert_flax_variables(demo.variables, demo.port)
    p, bs = demo.variables["params"], demo.variables["batch_stats"]
    gf = p["general_fusion"]
    np.testing.assert_array_equal(n(sd["general_fusion.hdm.in_proj_kernel"]),
                                  gf["hdm"]["in_proj_kernel"])
    np.testing.assert_array_equal(n(sd["general_fusion.moe.gate_k.weight"]),
                                  gf["moe"]["gate_k"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(n(sd["general_fusion.moe.expert_bn.running_var"]),
                                  bs["general_fusion"]["moe"]["expert_bn"]["var"])
    assert {k.split(".")[0] for k in sd} == {"backbone", "general_fusion", "head_ori",
                                             "head_moe"}
    v1 = _pair("DGAF-v1-global_local")
    sd = convert_flax_variables(v1.variables, v1.port)
    np.testing.assert_array_equal(n(sd["gl_fuse.kernel"]),
                                  v1.variables["params"]["gl_fuse"]["kernel"])
    np.testing.assert_array_equal(n(sd["dgaf.core.gate_fc1.weight"]),
                                  v1.variables["params"]["dgaf"]["core"]["gate_fc1"]["Dense_0"]
                                  ["kernel"].T)
    shared = _pair("SDTPS_shared")
    assert shared.port.sdtps.q_proj_kernel.shape == (3, 1, C, C)
    flat = dict(flax.traverse_util.flatten_dict(demo.variables))
    del flat[("params", "general_fusion", "hdm", "set_tokens")]
    with pytest.raises(ValueError, match="no leaf filled"):
        convert_flax_variables(flax.traverse_util.unflatten_dict(flat), demo.port)


def test_feature_extractor_serves_pattern_3_as_jax_does():
    pair = _pair("DeMo")
    jfx = JFeatureExtractor(pair.cfg, pair.jmodel, jax.tree.map(jnp.asarray, pair.variables),
                            batch_size=4)
    fx = FeatureExtractor(pair.cfg, pair.port, device=CPU, batch_size=4)
    images, cams = _images(5, pair.cfg, seed=2)
    for n_req in (0, 1, 5):
        for miss in ("None", "nt"):
            got = fx.extract(images[:n_req], cams[:n_req], miss=miss)
            want = jfx.extract(images[:n_req], cams[:n_req], miss=miss)
            assert got.shape == want.shape == (n_req, 10 * C)
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout off on the JAX side, whose draws are not the port's: flax's
    Dropout, and HDM's rate through the GeneralFusion that DeMo builds.
    Nothing of demo2_tpu/ changes."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    monkeypatch.setattr(jdemo, "GeneralFusion", functools.partial(JGeneralFusion, dropout=0.0))


def test_one_train_step_of_demo_yml_matches_jax(no_dropout):
    cfg = _cfg("DeMo")
    h, w = cfg.INPUT.SIZE_TRAIN
    rng = np.random.default_rng(8)
    images = rng.standard_normal((16, 3, h, w, 3)).astype(np.float32)
    pids = np.repeat(np.arange(8), 2).astype(np.int32)
    cams = rng.integers(0, CAMERA_NUM, 16).astype(np.int32)
    jmodel = j_make_model(cfg, NUM_CLASSES, CAMERA_NUM)
    variables = random_variables(jmodel, images[:2], cams[:2], train=False, seed=8)
    batch = types.SimpleNamespace(images=images[:2], camids=cams[:2], viewids=cams[:2] * 0)
    jstate, tx, ctx, _ = jax_state_from(cfg, jmodel, variables, batch)
    jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                            opt_state=tx.init(variables["params"]))
    jargs = (jnp.asarray(images), jnp.asarray(pids), jnp.asarray(cams), jnp.asarray(cams * 0))
    loss_fn = jl.make_loss_fn(cfg, NUM_CLASSES)

    def j_loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jargs[0], jargs[2], jargs[3], None, train=True,
                              rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
        wts = jl.branch_weights(cfg, out["branches"].keys())
        return sum(wts[k] * loss_fn(lg, f, jargs[1]) for k, (lg, f) in out["branches"].items())

    j_loss_value, j_grads = jax.jit(jax.value_and_grad(j_loss))(variables["params"])
    new_jstate, metrics = j_build_train_step(cfg, jmodel, tx, ctx, donate=False)(
        jstate, *jargs, jax.random.PRNGKey(1))
    np.testing.assert_allclose(float(metrics["loss"]), float(j_loss_value), rtol=1e-6)

    port = load_port(make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=CPU, generator=generator()),
                     variables)
    port.general_fusion.hdm.dropout = 0.0
    loss, acc, grads = loss_and_grads(cfg, port, tl.make_loss_fn(cfg, NUM_CLASSES), t(images),
                                      t(pids).long(), t(cams).long(), None)
    np.testing.assert_allclose(n(loss), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(n(acc), float(metrics["acc"]))
    want = convert_flax_variables({"params": j_grads, "batch_stats": variables["batch_stats"]},
                                  port)
    assert set(grads) == {k for k, _ in port.named_parameters()}
    top = max(np.abs(n(want[k])).max() for k in grads)
    for k, g in grads.items():
        wk = n(want[k])
        np.testing.assert_allclose(n(g), wk, rtol=1e-3, atol=1e-4 * np.abs(wk).max() + 1e-6 * top,
                                   err_msg=k)
    assert np.abs(n(grads["general_fusion.hdm.set_tokens"])).max() > 0
    # The BatchNorm statistics the step's forward updated, ATMoE's two among them.
    stats = convert_flax_variables({"params": new_jstate.params,
                                    "batch_stats": new_jstate.batch_stats}, port)
    before = convert_flax_variables(variables, port)
    for k, v in port.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert not np.array_equal(n(v), n(before[k])), k
            np.testing.assert_allclose(n(v), n(stats[k]), err_msg=k, **TOL)


def _train_setup(cfg):
    ds = SyntheticTriModal(num_pids=8, imgs_per_pid=4, image_size=tuple(cfg.INPUT.SIZE_TRAIN))
    train = dc.DeviceCache.from_arrays(ds.render_all(ds.train), ds.train, train=True, cfg=cfg,
                                       device=CPU)
    val_samples = ds.query + ds.gallery
    val = dc.DeviceCache.from_arrays(ds.render_all(val_samples), val_samples, train=False,
                                     cfg=cfg, device=CPU)
    sampler = RandomIdentitySampler(ds.train, cfg.SOLVER.IMS_PER_BATCH,
                                    cfg.DATALOADER.NUM_INSTANCE, seed=cfg.SOLVER.SEED)
    model = make_model(cfg, ds.num_train_pids, ds.num_train_cams, device=CPU,
                       generator=generator(0))
    return ds, train, val, sampler, model


def test_eval_entry_points_take_the_return_pattern(tmp_path):
    cfg = _cfg("DeMo")
    ds, _, val, _, model = _train_setup(cfg)
    images, pids, camids = val.batch(torch.arange(4))
    mask = miss_mask("None", device=CPU)
    feats = {p: eval_step(model, images, camids, mask, return_pattern=p) for p in (1, 2, 3)}
    assert [f.shape[1] for f in feats.values()] == [3 * C, 7 * C, 10 * C]
    torch.testing.assert_close(feats[3], torch.cat([feats[2], feats[1]], dim=1))
    results = {p: run_eval(cfg, model, val, len(ds.query), p) for p in (1, 2, 3)}
    for cmc, m_ap in results.values():
        assert cmc.shape == (len(ds.gallery),) and 0.0 < m_ap <= 1.0
    cmc, m_ap = do_inference(cfg, model, val, len(ds.query), 2)
    np.testing.assert_array_equal(cmc, results[2][0])
    assert m_ap == results[2][1]


def test_do_train_evaluates_patterns_1_2_and_3(tmp_path):
    cfg = _cfg("DeMo").defrost()
    for k, v in dict(MAX_EPOCHS=1, EVAL_PERIOD=1, CHECKPOINT_PERIOD=0, LOG_PERIOD=1,
                     BASE_LR=3.5e-3, WARMUP_ITERS=0).items():
        setattr(cfg.SOLVER, k, v)
    cfg.TEST.IMS_PER_BATCH = 24
    cfg.freeze()
    ds, train, val, sampler, model = _train_setup(cfg)
    state = create_train_state(cfg, model, len(sampler) // cfg.SOLVER.IMS_PER_BATCH)
    state, best = do_train(cfg, state, train, sampler, val, len(ds.query))
    entry = state.history[-1]
    assert all(0.0 < entry[k] <= 1.0 for k in ("mAP@1", "mAP@2", "mAP"))
    assert best["mAP"] == entry["mAP"]  # pattern 3 decides the best
    assert entry["mAP"] == run_eval(cfg, model, val, len(ds.query))[1]


class _AuxModel(torch.nn.Module):
    """One branch and two auxiliary losses that depend on the parameters."""

    dtype = torch.float32

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.linspace(-1.0, 1.0, 12).reshape(3, 4))
        self.a = torch.nn.Parameter(torch.tensor(0.7))

    def forward(self, images, camids, viewids, mask, train, generator):
        feat = images.reshape(images.shape[0], -1)[:, :3] @ self.w
        return {"branches": {"ori": (feat, feat)}, "embedding": feat,
                "aux_loss": {"lif": self.a.square(), "x": 3.0 * self.a}}


def test_aux_losses_are_added_to_the_train_loss():
    """The JAX train step (engine/train.py:85-87) adds each aux loss, the
    one named 'lif' at MODEL.LIF_LOSS_WEIGHT and any other at 1."""
    cfg = _cfg("Baseline-direct1").defrost()
    cfg.MODEL.LIF_LOSS_WEIGHT = 0.25
    cfg.freeze()
    model = _AuxModel()
    images = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 3, 2, 1, 1))
                              .astype(np.float32))
    pids = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3])
    loss_fn = tl.make_loss_fn(cfg, 4)
    loss, _, grads = loss_and_grads(cfg, model, loss_fn, images, pids, pids, None)
    feat = images.reshape(8, -1)[:, :3] @ model.w
    branch = loss_fn(feat, feat, pids)
    a = model.a.detach()
    torch.testing.assert_close(loss, branch.detach() + 0.25 * a ** 2 + 3.0 * a)
    torch.testing.assert_close(grads["a"], 0.25 * 2 * a + 3.0)
