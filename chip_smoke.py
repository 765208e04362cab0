#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (demo2_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

builds the hand-written CUDA kernels from demo2_tpu_torch/csrc, checks each
against its plain PyTorch version at the flagship shapes, drives the
flagship (DeMo SDTPS + DGAF v3 on CLIP ViT-B/16, 256x128, bf16, random
weights from a seed) as a server through FeatureExtractor and match() and as
a trainer through build_train_step and do_train, and times kernels, requests
and train steps against the plain path.  Phases:

  1. device: card name and power limit, torch / CUDA / triton / nvcc
     versions, kernel build time and ptxas register / smem / spill lines;
  2. eval kernels (1, 2) vs their plain versions, at x (192, 129, 768) and
     at batch 1 (3, 129, 768), tolerance asserted;
  5. training kernels at the same shapes: the training forward (3) with its
     residuals and probs, the saved-probs backward with db (4) and without
     (7, bitwise equal to 4's dqkv), and the autograd Function's 7 grads, each
     no further from an f32 run than the plain bf16 path;
  3. serving: requests of N = 0, 1, 64, 100 images with miss "None" and "nt";
     shape, finiteness, unit norm, 12 launches of kernels 1 and 2 per
     forward, cosine >= 0.999 to the plain path, match() and CMC / mAP;
  4. serving timing (printed): kernels 1 and 2 vs plain with TFLOP/s,
     extractor batch-1 latency and batch-64 throughput on both paths, peak
     memory, a profile of one batch-64 request;
  6. training: a device cache of synthetic 256x128 images, 171 ids x 8; the
     step-1 gradients of both paths (cosine >= 0.999 whole, >= 0.99 per
     block's ln_1 / in_proj / out_proj); 20 Adam (bf16 moments) steps of PK
     batches of 64 = 8 ids x 8 through build_train_step, each launching
     kernels 3 and 4 12 times and kernels 1 and 2 never; finite losses,
     every parameter and the BatchNorm statistics changed, the loss falling
     (mean of the last 5 steps below the first 5's), per-step loss within
     2% of the plain path's over 10 steps; then an input gradient with the
     weights frozen (as a saliency map takes it), which runs kernel 7;
  7. do_train: one epoch with eval over a small synthetic val cache (kernels
     1 and 2 at eval, 3 and 4 in training), mAP in (0, 1], the best
     checkpoint saved and reloaded;
  8. training timing (printed): kernels 3, 4 and 7 vs plain with TFLOP/s,
     the train step in ms and img/s on both paths in turns, peak memory, a
     profile of one train step on each path.

Any failed check raises, so the exit code is non-zero; without a CUDA device
the script exits non-zero before printing any result.  The last three lines
are the kernels (JSON), the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

FLAGSHIP = (192, 129, 768)  # (3B, tokens, width) at batch 64
BATCH1 = (3, 129, 768)
HEADS = 12
NUM_CLASSES, CAMERA_NUM = 171, 6  # RGBNT201, as bench.py sizes the flagship
# Kernel vs plain bf16 version.  Both round to bf16 at different points
# (the plain version rounds each matmul output, then the bias add, then the
# residual add), so single elements may differ by a couple of bf16 ulps:
# 2 ulps at |v| < 8 is 2^-4.  A mean above 5e-3, over half a bf16 ulp at
# unit scale, would be a systematic error.  And against an f32 run of the
# plain version the kernel must be about as accurate as the plain bf16 path.
MAX_ABS_TOL = 6.25e-2
MEAN_ABS_TOL = 5e-3
F32_MEAN_RATIO = 1.5
COSINE_MIN = 0.999
BF16_PEAK_TFLOPS = 989.0  # H100 SXM data sheet, dense, at the 700 W limit
# A rehearsal on the CPU (import this module, set REHEARSAL = True and call the
# phases with torch.device("cpu")) runs the tiny config; the wrappers then take
# their plain versions, which count no launches, so the launch checks only log.
REHEARSAL = False


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def require_launches(got: dict, want: dict, what: str) -> None:
    if REHEARSAL:
        log(f"[rehearsal] {what}: launches {got}, on the card {want}")
        return
    require(got == want, f"{what}: launches {got}, expected {want}")


def sync() -> None:
    """Wait for the card (a no-op when a phase is rehearsed on the CPU)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 1


def phase_device() -> str:
    from demo2_tpu_torch.ops.kernel_lib import find_nvcc, kernel_library

    card = card_line()
    log(card)
    try:
        import triton  # noqa: F401  (recorded only: the port's kernels are CUDA C++)

        triton_state = f"triton {triton.__version__} imports"
    except ImportError:
        triton_state = "triton does not import"
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}, {triton_state}")
    nvcc = find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[-1]
    log(f"[device] nvcc {nvcc}: {version}")
    lib = kernel_library()
    log(f"[build] {lib.path} built in {lib.build_seconds:.1f} s")
    for line in lib.build_log.splitlines():
        if "ptxas" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    require("sm_90a" in lib.build_log, "the kernels were not compiled for sm_90a")
    return card


# ---------------------------------------------------------------- phase 2


def block_inputs(shape, device, seed):
    """Unit-scale activations and init-scale weights (as the flax initialisers
    draw them) for both blocks; weights bf16, vectors f32."""
    b, s, c = shape
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *sh, std=1.0: torch.randn(*sh, generator=g) * std
    bf = lambda t: t.to(device, torch.bfloat16).contiguous()
    f32 = lambda t: t.to(device, torch.float32).contiguous()
    x = bf(rnd(b, s, c))
    attn = dict(ln_weight=f32(1 + rnd(c, std=0.1)), ln_bias=f32(rnd(c, std=0.1)),
                wqkv=bf(rnd(3 * c, c, std=c ** -0.5)), bqkv=f32(rnd(3 * c, std=0.02)),
                wout=bf(rnd(c, c, std=c ** -0.5)), bout=f32(rnd(c, std=0.02)))
    mlp = dict(ln_weight=f32(1 + rnd(c, std=0.1)), ln_bias=f32(rnd(c, std=0.1)),
               w1=bf(rnd(4 * c, c, std=c ** -0.5)), b1=f32(rnd(4 * c, std=0.02)),
               w2=bf(rnd(c, 4 * c, std=(4 * c) ** -0.5)), b2=f32(rnd(c, std=0.02)))
    return x, attn, mlp


def kernel_cases(x, attn, mlp):
    from demo2_tpu_torch.ops import fused_block as fb

    attn_kw = dict(num_heads=HEADS, scale=(x.shape[-1] // HEADS) ** -0.5)
    return {
        "fused_attention_block": (
            lambda: fb.fused_attention_block(x, **attn, **attn_kw),
            lambda xx, w: fb.attention_block_plain(xx, **w, **attn_kw),
            attn,
        ),
        "fused_mlp_block": (
            lambda: fb.fused_mlp_block(x, **mlp),
            lambda xx, w: fb.mlp_block_plain(xx, **w),
            mlp,
        ),
    }


def phase_kernels(device) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    errors = {}
    for shape in (FLAGSHIP, BATCH1):
        x, attn, mlp = block_inputs(shape, device, seed=1)
        for name, (kernel, plain, weights) in kernel_cases(x, attn, mlp).items():
            yk = kernel().float()
            yp = plain(x, weights).float()
            y32 = plain(x.float(), {k: v.float() for k, v in weights.items()})
            torch.cuda.synchronize()
            d = (yk - yp).abs()
            max_abs, mean_abs = d.max().item(), d.mean().item()
            k32 = (yk - y32).abs()
            p32 = (yp - y32).abs()
            log(f"[kernel] {name} {tuple(shape)}: vs plain bf16 max {max_abs:.3e} "
                f"mean {mean_abs:.3e}; vs plain f32: kernel max {k32.max().item():.3e} "
                f"mean {k32.mean().item():.3e}, plain bf16 max {p32.max().item():.3e} "
                f"mean {p32.mean().item():.3e}")
            require(bool(torch.isfinite(yk).all()), f"{name} {shape}: non-finite output")
            require(max_abs <= MAX_ABS_TOL, f"{name} {shape}: max abs {max_abs} > {MAX_ABS_TOL}")
            require(mean_abs <= MEAN_ABS_TOL,
                    f"{name} {shape}: mean abs {mean_abs} > {MEAN_ABS_TOL}")
            require(k32.mean().item() <= F32_MEAN_RATIO * p32.mean().item(),
                    f"{name} {shape}: less accurate against f32 than the plain bf16 path")
            if shape == FLAGSHIP:
                errors[name] = max_abs
    log(f"[kernel] tolerance: max abs <= {MAX_ABS_TOL}, mean abs <= {MEAN_ABS_TOL}, "
        f"mean error vs f32 <= {F32_MEAN_RATIO} x the plain bf16 path's: ok")
    return errors


# ---------------------------------------------------------------- phase 3


def flagship_cfg(fused: bool, **overrides):
    """The flagship config; `overrides` as SECTION__KEY=value."""
    from demo2_tpu_torch.config import get_cfg_defaults
    from demo2_tpu_torch.config.presets import apply_flagship, apply_tiny

    cfg = get_cfg_defaults()
    apply_flagship(cfg, on_tpu=True)
    if REHEARSAL:
        apply_tiny(cfg)
    # configs/RGBNT201/DeMo_SDTPS_DGAF.yml
    cfg.MODEL.SDTPS_CROSS_ATTN_TYPE = "attention"
    cfg.MODEL.SDTPS_SPARSE_RATIO = 0.7
    cfg.MODEL.SIE_COE = 1.0
    cfg.TPU.USE_FLASH_ATTENTION = fused
    for key, value in overrides.items():
        section, name = key.split("__")
        setattr(getattr(cfg, section), name, value)
    return cfg.freeze()


def build_models(device):
    from demo2_tpu_torch.models import make_model

    cfg = flagship_cfg(fused=True)
    model = make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=device,
                       generator=torch.Generator().manual_seed(0))
    plain_cfg = flagship_cfg(fused=False)
    plain = make_model(plain_cfg, NUM_CLASSES, CAMERA_NUM, device=device,
                       generator=torch.Generator().manual_seed(0))
    plain.load_state_dict(model.state_dict())
    return cfg, model, plain_cfg, plain


def request_images(n, cfg, seed):
    """Transform-normalised images ((x/255 - 0.5) / 0.5) of random pixels."""
    h, w = cfg.INPUT.SIZE_TEST
    rng = np.random.default_rng(seed)
    pixels = rng.integers(0, 256, size=(n, 3, h, w, 3), dtype=np.uint8)
    return (pixels.astype(np.float32) / 255.0 - 0.5) / 0.5, rng.integers(0, CAMERA_NUM, n)


def phase_slice(device, cfg, model, plain_cfg, plain) -> dict:
    from demo2_tpu_torch.ops.fused_block import fused_attention_block, fused_mlp_block
    from demo2_tpu_torch.serving import FeatureExtractor, match
    from demo2_tpu_torch.utils.metrics import R1mAPEvaluator

    kernels = (fused_attention_block, fused_mlp_block)
    layers = len(model.backbone.base.resblocks)
    images, cams = request_images(100, cfg, seed=2)
    fx = FeatureExtractor(cfg, model, device=device, batch_size=64)
    requests = [(n, miss) for miss in ("None", "nt") for n in (0, 1, 64, 100)]

    for k in kernels:
        k.launches = 0
    embeddings = {}
    for n, miss in requests:
        before = [k.launches for k in kernels]
        emb = fx.extract(images[:n], cams[:n], miss=miss)
        torch.cuda.synchronize()
        rose = [k.launches - b for k, b in zip(kernels, before)]
        forwards = math.ceil(n / fx.batch_size)
        require(rose == [layers * forwards] * 2,
                f"N={n} miss={miss}: kernel launches rose by {rose}, expected "
                f"{layers} per forward x {forwards}")
        embeddings[(n, miss)] = emb
    launches = {k.__name__: k.launches for k in kernels}
    log(f"[slice] main path: {len(requests)} requests, launches {launches}")

    fx_plain = FeatureExtractor(plain_cfg, plain, device=device, batch_size=64)
    for (n, miss), emb in embeddings.items():
        require(emb.shape == (n, model.embed_dim), f"N={n}: shape {emb.shape}")
        require(bool(np.isfinite(emb).all()), f"N={n} miss={miss}: non-finite embedding")
        ref = fx_plain.extract(images[:n], cams[:n], miss=miss)
        if n:
            norms = np.linalg.norm(emb, axis=1)
            cos = np.sum(emb * ref, axis=1) / (norms * np.linalg.norm(ref, axis=1))
            require(bool(np.all(np.abs(norms - 1.0) < 1e-4)), f"N={n}: not unit norm")
            require(float(cos.min()) >= COSINE_MIN,
                    f"N={n} miss={miss}: cosine to the plain path {cos.min()} < {COSINE_MIN}")
            log(f"[slice] N={n:3d} miss={miss:4s}: shape {emb.shape}, cosine to plain path "
                f"min {cos.min():.6f} mean {cos.mean():.6f}")
        else:
            log(f"[slice] N=0 miss={miss}: shape {emb.shape}")
    require(not np.allclose(embeddings[(64, "None")], embeddings[(64, "nt")]),
            "the miss mask changed nothing")

    # Retrieval: the 64 queries are images 0..63, the gallery holds all 100.
    query, gallery = embeddings[(64, "None")], embeddings[(100, "None")]
    idx, dist = match(query, gallery, topk=10, device=device)
    require(idx.shape == (64, 10) and bool(np.all(idx[:, 0] == np.arange(64))),
            "match(): a query's nearest gallery entry is not its own image")
    require(bool(np.all(np.diff(dist, axis=1) >= -1e-5)), "match(): distances not ascending")
    pids = np.arange(100) // 4
    ev = R1mAPEvaluator(num_query=64, device=device)
    ev.update(query, pids[:64], np.zeros(64, np.int64))
    ev.update(gallery, pids, np.ones(100, np.int64))
    cmc, m_ap = ev.compute()
    require(cmc[0] == 1.0 and 0.0 < m_ap <= 1.0, f"CMC/mAP: rank-1 {cmc[0]}, mAP {m_ap}")
    log(f"[slice] match top-10 ok; CMC rank-1 {cmc[0]:.3f}, mAP {m_ap:.4f} on the card")
    return launches


# ---------------------------------------------------------------- phase 4


def cuda_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate(plain_fn, kernel_fn):
    """plain, kernel, kernel, plain; the mean of each pair."""
    p1, k1, k2, p2 = plain_fn(), kernel_fn(), kernel_fn(), plain_fn()
    return (k1 + k2) / 2, (p1 + p2) / 2


def block_flops(name: str, shape) -> int:
    """Matrix-product FLOPs of one sub-block call on x of `shape`."""
    b, s, c = shape
    m = b * s
    if name == "fused_attention_block":  # qkv + out-proj GEMMs, QK^T + PV
        return 2 * m * c * 3 * c + 2 * m * c * c + 4 * b * s * s * c
    return 2 * 2 * m * c * 4 * c  # fc1 + fc2


def phase_timing(device, card, cfg, model, plain_cfg, plain) -> dict:
    from demo2_tpu_torch.serving import FeatureExtractor

    times = {}
    x, attn, mlp = block_inputs(FLAGSHIP, device, seed=1)
    for name, (kernel, plain_fn, weights) in kernel_cases(x, attn, mlp).items():
        k_ms, p_ms = alternate(lambda: cuda_ms(lambda: plain_fn(x, weights)),
                               lambda: cuda_ms(kernel))
        times[name] = (k_ms, p_ms)
        tflops = lambda ms: block_flops(name, FLAGSHIP) / ms / 1e9
        log(f"[time] {name} x{FLAGSHIP}: kernel {k_ms:.4f} ms ({tflops(k_ms):.1f} TFLOP/s, "
            f"{100 * tflops(k_ms) / BF16_PEAK_TFLOPS:.1f}% of the bf16 peak), plain "
            f"{p_ms:.4f} ms ({tflops(p_ms):.1f} TFLOP/s) ({card})")

    images, cams = request_images(64, cfg, seed=3)

    def latency_ms(m, c):
        fx = FeatureExtractor(c, m, device=device, batch_size=1)
        for _ in range(3):
            fx.extract(images[:1], cams[:1])
        samples = []
        for _ in range(20):
            t0 = time.perf_counter()
            fx.extract(images[:1], cams[:1])
            samples.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(samples))

    def throughput(m, c, reps=10):
        fx = FeatureExtractor(c, m, device=device, batch_size=64)
        for _ in range(2):
            fx.extract(images, cams)
        t0 = time.perf_counter()
        for _ in range(reps):
            fx.extract(images, cams)
        return 64 * reps / (time.perf_counter() - t0)

    k_lat, p_lat = alternate(lambda: latency_ms(plain, plain_cfg), lambda: latency_ms(model, cfg))
    log(f"[time] extractor batch-1 latency (median of 20): kernel path {k_lat:.3f} ms, "
        f"plain path {p_lat:.3f} ms ({card})")
    k_tp, p_tp = alternate(lambda: throughput(plain, plain_cfg), lambda: throughput(model, cfg))
    log(f"[time] extractor batch-64: kernel path {k_tp:.1f} img/s, plain path {p_tp:.1f} "
        f"img/s, host arrays in and out included ({card})")
    torch.cuda.reset_peak_memory_stats()
    throughput(model, cfg, reps=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[time] peak device memory, kernel path at batch 64: {peak:.2f} GiB ({card})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    log(f"[time] after timing: clocks.sm, power.draw, power.limit, temp = {smi}")
    for label, m, c in (("kernel path", model, cfg), ("plain path", plain, plain_cfg)):
        fx = FeatureExtractor(c, m, device=device, batch_size=64)
        profile(f"{label}, one batch-64 request", lambda: fx.extract(images, cams), card)
    return times


def profile(label, fn, card, top=10) -> None:
    """Where one call of `fn` spends its time: device time by kernel
    (torch.profiler / CUPTI) against the host clock around the call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"[profile] {label}: host wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {len(rows)} device ops ({card})")
    for e in rows[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:110]}")


# ---------------------------------------------------------------- phase 5


PROBS_MAX_ABS = 7.8e-3   # 2 bf16 ulps just below 1 (2^-8 each)
PROBS_ROW_SUM = 1e-2     # rows of bf16 probabilities sum to 1 within this
DB_REL = 1e-3            # db vs the f32 column sums of the kernel's own dqkv


def mean_err(a, ref) -> float:
    return (a.float() - ref.float()).abs().mean().item()


def train_kernel_inputs(shape, device, seed):
    """x and f32 attention parameters (leaves), and a unit cotangent."""
    x, attn, _ = block_inputs(shape, device, seed)
    params = {k: v.float() for k, v in attn.items()}
    g = torch.Generator().manual_seed(seed + 100)
    grad_out = torch.randn(shape, generator=g).to(device, torch.bfloat16)
    return x, params, grad_out


def check_train_forward(x, p, shape, kw) -> dict:
    from demo2_tpu_torch.ops import fused_block as fb

    w = {k: (v.to(torch.bfloat16) if k in ("wqkv", "wout") else v) for k, v in p.items()}
    got = fb.fused_attention_block_train(x, **w, **kw)
    plain = fb.attention_block_train_plain(x, **w, **kw)
    f32 = fb.attention_block_train_plain(x.float(), **p, **kw)
    sync()
    for name, yk, yp, y32 in zip(("out", "qkv", "attn"), got[:3], plain[:3], f32[:3]):
        d = (yk.float() - yp.float()).abs()
        k32, p32 = mean_err(yk, y32), mean_err(yp, y32)
        log(f"[train-kernel] kernel 3 {name} {tuple(shape)}: vs plain bf16 max "
            f"{d.max().item():.3e} mean {d.mean().item():.3e}; vs f32 kernel {k32:.3e}, "
            f"plain bf16 {p32:.3e}")
        require(bool(torch.isfinite(yk).all()), f"kernel 3 {name} {shape}: non-finite")
        require(d.max().item() <= MAX_ABS_TOL, f"kernel 3 {name} {shape}: max abs {d.max()}")
        require(d.mean().item() <= MEAN_ABS_TOL, f"kernel 3 {name} {shape}: mean abs {d.mean()}")
        require(k32 <= F32_MEAN_RATIO * p32, f"kernel 3 {name} {shape}: less accurate than plain")
    probs, s = got[3], shape[1]
    dp = (probs.float() - plain[3].float()).abs().max().item()
    row = (probs.float().sum(-1) - 1.0).abs().max().item()
    pad = probs[..., s:].abs().max().item() if probs.shape[-1] > s else 0.0
    log(f"[train-kernel] kernel 3 probs {tuple(probs.shape)}: vs plain max {dp:.3e}, "
        f"row sums within {row:.3e} of 1, columns >= S max {pad}")
    require(dp <= PROBS_MAX_ABS, f"kernel 3 probs {shape}: max abs {dp} > {PROBS_MAX_ABS}")
    require(row <= PROBS_ROW_SUM, f"kernel 3 probs {shape}: a row sums {row} away from 1")
    require(pad == 0.0, f"kernel 3 probs {shape}: non-zero columns past S")
    return {"max_abs": max((yk.float() - yp.float()).abs().max().item()
                           for yk, yp in zip(got[:3], plain[:3])),
            "residuals": got}


def check_train_backward(res, grad_out, shape, kw) -> dict:
    from demo2_tpu_torch.ops import packed_attention as pa

    _, qkv, _, probs = res
    do = grad_out
    dqkv, db = pa.attention_bwd_saved_db(qkv, probs, do, **kw)
    dqkv7 = pa.attention_bwd_saved(qkv, probs, do, **kw)
    plain, _ = pa.attention_bwd_saved_plain(qkv, probs, do, with_db=True, **kw)
    f32, _ = pa.attention_bwd_saved_plain(qkv.float(), probs.float(), do.float(), with_db=True,
                                          **kw)
    sync()
    d = (dqkv.float() - plain.float()).abs()
    k32, p32 = mean_err(dqkv, f32), mean_err(plain, f32)
    ref_db = dqkv.float().sum((0, 1))
    db_err = (db - ref_db).abs().max().item()
    db_scale = ref_db.abs().max().item()
    log(f"[train-kernel] kernel 4 dqkv {tuple(shape)}: vs plain bf16 max {d.max().item():.3e} "
        f"mean {d.mean().item():.3e}; vs f32 kernel {k32:.3e}, plain bf16 {p32:.3e}; db vs "
        f"the f32 column sums of its dqkv: max {db_err:.3e} (max |sum| {db_scale:.3e})")
    require(bool(torch.isfinite(dqkv).all()) and bool(torch.isfinite(db).all()),
            f"kernel 4 {shape}: non-finite")
    require(k32 <= F32_MEAN_RATIO * p32, f"kernel 4 {shape}: less accurate than plain")
    require(db_err <= DB_REL * db_scale, f"kernel 4 {shape}: db off by {db_err}")
    require(torch.equal(dqkv7, dqkv), f"kernel 7 {shape}: dqkv not bitwise equal to kernel 4's")
    log(f"[train-kernel] kernel 7 dqkv {tuple(shape)}: bitwise equal to kernel 4's")
    return {"max_abs": d.max().item()}


def check_train_function(x, p, grad_out, shape, kw) -> None:
    """FusedAttentionBlockFn vs autograd of attention_block_plain: each of
    the 7 grads no further from the f32 grads than the plain bf16 path's."""
    from demo2_tpu_torch.ops import fused_block as fb

    def grads(fn, xx):
        xx = xx.detach().requires_grad_(True)
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
        out = fn(xx, leaves)
        out.backward(grad_out.to(out.dtype))
        return [xx.grad] + [leaves[k].grad for k in ("ln_weight", "ln_bias", "wqkv", "bqkv",
                                                     "wout", "bout")]

    names = ("x", "ln_weight", "ln_bias", "wqkv", "bqkv", "wout", "bout")
    kern = grads(lambda xx, w: fb.FusedAttentionBlockFn.apply(
        xx, w["ln_weight"], w["ln_bias"], w["wqkv"], w["bqkv"], w["wout"], w["bout"],
        kw["num_heads"], kw["scale"]), x)
    plain = grads(lambda xx, w: fb.attention_block_plain(xx, **w, **kw), x)
    f32 = grads(lambda xx, w: fb.attention_block_plain(xx, **w, **kw), x.float())
    sync()
    for name, gk, gp, g32 in zip(names, kern, plain, f32):
        k32, p32 = mean_err(gk, g32), mean_err(gp, g32)
        log(f"[train-kernel] Function grad {name} {tuple(shape)}: mean error vs f32 kernel "
            f"path {k32:.3e}, plain bf16 {p32:.3e} (mean |f32 grad| {g32.abs().mean().item():.3e})")
        require(bool(torch.isfinite(gk).all()), f"Function grad {name} {shape}: non-finite")
        require(k32 <= F32_MEAN_RATIO * p32,
                f"Function grad {name} {shape}: {k32} > {F32_MEAN_RATIO} x {p32}")


def phase_train_kernels(device, shapes=(FLAGSHIP, BATCH1)) -> dict:
    """Kernels 3, 4 and 7 against their plain versions, and the training
    Function against autograd of the plain block."""
    errors = {}
    for shape in shapes:
        x, p, grad_out = train_kernel_inputs(shape, device, seed=5)
        kw = dict(num_heads=shape[-1] // 64, scale=64 ** -0.5)
        fwd = check_train_forward(x, p, shape, kw)
        bwd = check_train_backward(fwd["residuals"], grad_out, shape, kw)
        check_train_function(x, p, grad_out, shape, kw)
        if shape == shapes[0]:
            errors["fused_attention_block_train"] = fwd["max_abs"]
            errors["attention_bwd_saved_db"] = bwd["max_abs"]
            errors["attention_bwd_saved"] = bwd["max_abs"]
    log(f"[train-kernel] tolerances: forward as phase 2; probs max abs <= {PROBS_MAX_ABS}, "
        f"row sums within {PROBS_ROW_SUM}, zero past S; dqkv and the 7 Function grads no "
        f"further from f32 than {F32_MEAN_RATIO} x the plain bf16 path; db within {DB_REL} "
        f"of max |column sum|; kernel 7 bitwise kernel 4: ok")
    return errors


# ---------------------------------------------------------------- phase 6


TRAIN_IMGS_PER_PID = 8   # RGBNT201-sized cache: 171 ids x 8 = 1,368 samples
TRAIN_STEPS = 20         # an epoch of that cache is 21 PK batches of 64
PLAIN_STEPS = 10
GRAD_COS_MODEL = 0.999
GRAD_COS_BLOCK = 0.99
LOSS_REL = 0.02


def training_kernels():
    from demo2_tpu_torch.ops import fused_block as fb, packed_attention as pa

    return {"fused_attention_block": fb.fused_attention_block,
            "fused_mlp_block": fb.fused_mlp_block,
            "fused_attention_block_train": fb.fused_attention_block_train,
            "attention_bwd_saved_db": pa.attention_bwd_saved_db,
            "attention_bwd_saved": pa.attention_bwd_saved}


def reset_counts() -> None:
    for k in training_kernels().values():
        k.launches = 0


def counts() -> dict:
    return {name: k.launches for name, k in training_kernels().items()}


def build_train_data(cfg, device):
    """A DeviceCache of SyntheticTriModal at the flagship's 256x128, RGBNT201's
    171 train ids, and its PK sampler."""
    from demo2_tpu_torch.data.datasets import SyntheticTriModal
    from demo2_tpu_torch.data.device_cache import DeviceCache
    from demo2_tpu_torch.data.sampler import RandomIdentitySampler

    t0 = time.perf_counter()
    ds = SyntheticTriModal(num_pids=NUM_CLASSES, num_cams=CAMERA_NUM,
                           imgs_per_pid=TRAIN_IMGS_PER_PID,
                           image_size=tuple(cfg.INPUT.SIZE_TRAIN), seed=0)
    cache = DeviceCache.from_arrays(ds.render_all(ds.train), ds.train, train=True, cfg=cfg,
                                    device=device)
    sampler = RandomIdentitySampler(ds.train, cfg.SOLVER.IMS_PER_BATCH,
                                    cfg.DATALOADER.NUM_INSTANCE, seed=cfg.SOLVER.SEED)
    sync()
    log(f"[train] device cache: {tuple(cache.images.shape)} uint8, "
        f"{cache.images.numel() / 2**20:.0f} MiB on the card, rendered and copied in "
        f"{time.perf_counter() - t0:.1f} s")
    return cache, sampler


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm()).clamp(min=1e-300)).item()


def check_step1_grads(cfg, model, plain_cfg, plain, cache, idx) -> None:
    """Gradients of the first step on the kernel and the plain path: the
    same weights, batch and draws."""
    from demo2_tpu_torch.engine.train import loss_and_grads
    from demo2_tpu_torch.losses.losses import make_loss_fn

    grads = []
    for c, m in ((cfg, model), (plain_cfg, plain)):
        gen = torch.Generator(device=cache.images.device).manual_seed(cfg.SOLVER.SEED)
        images, pids, camids = cache.batch(idx, gen)
        loss, _, g = loss_and_grads(c, m, make_loss_fn(c, NUM_CLASSES), images, pids, camids,
                                    gen)
        grads.append(g)
        log(f"[train] step-1 loss, {'kernel' if c is cfg else 'plain'} path: {loss.item():.6f}")
    gk, gp = grads
    whole = cosine(torch.cat([gk[k].flatten() for k in gk]), torch.cat([gp[k].flatten() for k in gk]))
    worst = (1.0, "")
    for i in range(len(model.backbone.base.resblocks)):
        pre = f"backbone.base.resblocks.{i}."
        for group in ("ln_1.", "attn.in_proj_", "attn.out_proj."):
            keys = [k for k in gk if k.startswith(pre + group)]
            c = cosine(torch.cat([gk[k].flatten() for k in keys]),
                       torch.cat([gp[k].flatten() for k in keys]))
            worst = min(worst, (c, pre + group))
    log(f"[train] step-1 gradient cosine, kernel vs plain path: whole model {whole:.6f}; "
        f"lowest block ln_1 / in_proj / out_proj {worst[0]:.6f} ({worst[1]})")
    require(whole >= GRAD_COS_MODEL, f"step-1 gradient cosine {whole} < {GRAD_COS_MODEL}")
    require(worst[0] >= GRAD_COS_BLOCK, f"{worst[1]} gradient cosine {worst[0]} < {GRAD_COS_BLOCK}")


def train_steps(cfg, model, cache, order, steps, per_step=None):
    """`steps` optimizer steps through build_train_step; per_step(i, rose)
    checks the kernel launches of each step.  Returns the losses."""
    from demo2_tpu_torch.engine.state import create_train_state
    from demo2_tpu_torch.engine.train import build_train_step

    bs = cfg.SOLVER.IMS_PER_BATCH
    state = create_train_state(cfg, model, len(order) // bs)
    step = build_train_step(cfg, model, state, cache)
    idx = torch.from_numpy(order[: steps * bs].reshape(steps, bs)).to(cache.images.device)
    losses = []
    for i in range(steps):
        before = counts()
        losses.append(step(idx[i])["loss"])
        if per_step is not None:
            per_step(i, {k: v - before[k] for k, v in counts().items()})
    return [x.item() for x in losses]


def phase_train(device, cfg, model, plain_cfg, plain, cache, sampler) -> dict:
    layers = len(model.backbone.base.resblocks)
    order = sampler.epoch_indices(1)
    bs = cfg.SOLVER.IMS_PER_BATCH
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    plain.load_state_dict(init)
    check_step1_grads(cfg, model, plain_cfg, plain, cache,
                      torch.from_numpy(order[:bs]).to(device))
    model.load_state_dict(init)  # undo the BatchNorm updates of the check
    plain.load_state_dict(init)

    want = {"fused_attention_block": 0, "fused_mlp_block": 0,
            "fused_attention_block_train": layers, "attention_bwd_saved_db": layers,
            "attention_bwd_saved": 0}

    def per_step(i, rose):
        if i == 0 or not REHEARSAL:
            require_launches(rose, want, f"train step {i}")

    reset_counts()
    t0 = time.perf_counter()
    losses = train_steps(cfg, model, cache, order, TRAIN_STEPS, per_step)
    wall = time.perf_counter() - t0
    launches = counts()
    log(f"[train] main path: {TRAIN_STEPS} steps of {bs} through build_train_step in "
        f"{wall:.1f} s, launches {launches}")
    log(f"[train] kernel path losses: {' '.join(f'{x:.4f}' for x in losses)}")
    require(all(math.isfinite(x) for x in losses), "a non-finite loss")
    after = model.state_dict()
    stale = [k for k, _ in model.named_parameters() if torch.equal(after[k], init[k])]
    require(not stale, f"parameters the steps did not change: {stale}")
    bn = [k for k in after if k.endswith(("running_mean", "running_var"))]
    require(bn and all(not torch.equal(after[k], init[k]) for k in bn),
            "BatchNorm running statistics did not change")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"[train] loss falls: mean of the first 5 steps {first:.4f}, of the last 5 {last:.4f}")
    require(last < first, "the loss did not fall")

    plain_losses = train_steps(plain_cfg, plain, cache, order, PLAIN_STEPS)
    rel = [abs(k - p) / abs(p) for k, p in zip(losses, plain_losses)]
    log(f"[train] plain path losses: {' '.join(f'{x:.4f}' for x in plain_losses)}; "
        f"largest relative difference {max(rel):.4%}")
    require(max(rel) <= LOSS_REL, f"kernel vs plain loss differ by {max(rel):.4%}")
    return {"fused_attention_block_train": launches["fused_attention_block_train"],
            "attention_bwd_saved_db": launches["attention_bwd_saved_db"],
            "attention_bwd_saved": phase_input_grad(device, cfg, model, plain)}


def phase_input_grad(device, cfg, model, plain) -> int:
    """The input gradient of the summed embedding norms with the weights
    frozen, as demo2_tpu/visualize/saliency.py::gradcam_heatmaps takes it:
    the attention backward needs no db, so it runs kernel 7.  Held, as the
    kernels are, to be no further from an f32 run of the plain path than the
    plain bf16 path is."""
    from demo2_tpu_torch.models import make_model

    layers = len(model.backbone.base.resblocks)
    images, cams = request_images(64, cfg, seed=4)
    f32 = make_model(flagship_cfg(False, TPU__COMPUTE_DTYPE="float32"), NUM_CLASSES,
                     CAMERA_NUM, device=device, generator=torch.Generator().manual_seed(0))
    plain.load_state_dict(model.state_dict())
    f32.load_state_dict(model.state_dict())
    grads = []
    for m in (model, plain, f32):
        m.requires_grad_(False)
        x = torch.from_numpy(images).to(device).requires_grad_(True)
        if m is model:
            reset_counts()
        emb = m(x, torch.from_numpy(cams).to(device), train=False)["embedding"]
        emb.norm(dim=-1).sum().backward()
        sync()
        if m is model:
            launches = counts()
        grads.append(x.grad.float())
        m.requires_grad_(True)
    del f32
    want = {"fused_attention_block": 0, "fused_mlp_block": 0,
            "fused_attention_block_train": layers, "attention_bwd_saved_db": 0,
            "attention_bwd_saved": layers}
    ref = grads[2]
    err = [((g - ref).norm() / ref.norm()).item() for g in grads[:2]]
    log(f"[train] input-gradient pass (weights frozen, batch 64): launches {launches}; "
        f"relative error vs the f32 plain path: kernel path {err[0]:.4e}, plain bf16 path "
        f"{err[1]:.4e}; cosine kernel vs plain bf16 {cosine(grads[0], grads[1]):.6f}")
    require_launches(launches, want, "input-gradient pass")
    require(bool(torch.isfinite(grads[0]).all()) and grads[0].abs().max().item() > 0,
            "input gradient is zero or non-finite")
    require(err[0] <= F32_MEAN_RATIO * err[1],
            f"input gradient: error {err[0]} > {F32_MEAN_RATIO} x the plain bf16 path's {err[1]}")
    return launches["attention_bwd_saved"]


# ---------------------------------------------------------------- phase 7


def phase_do_train(device, model, cache, sampler) -> None:
    """One epoch of do_train with eval over a small synthetic val cache, and
    the best checkpoint saved and reloaded."""
    import tempfile

    from demo2_tpu_torch.data.datasets import SyntheticTriModal
    from demo2_tpu_torch.data.device_cache import DeviceCache
    from demo2_tpu_torch.engine.state import create_train_state
    from demo2_tpu_torch.engine.train import do_train
    from demo2_tpu_torch.models import make_model
    from demo2_tpu_torch.utils.checkpoint import restore_checkpoint

    cfg = flagship_cfg(True, SOLVER__MAX_EPOCHS=1, SOLVER__EVAL_PERIOD=1,
                       SOLVER__CHECKPOINT_PERIOD=0, SOLVER__LOG_PERIOD=7,
                       TEST__IMS_PER_BATCH=64)
    val_ds = SyntheticTriModal(num_pids=16, num_cams=CAMERA_NUM, imgs_per_pid=4,
                               image_size=tuple(cfg.INPUT.SIZE_TEST), seed=1)
    val_samples = val_ds.query + val_ds.gallery
    val = DeviceCache.from_arrays(val_ds.render_all(val_samples), val_samples, train=False,
                                  cfg=cfg, device=device)
    layers = len(model.backbone.base.resblocks)
    bs = cfg.SOLVER.IMS_PER_BATCH
    steps = len(sampler.epoch_indices(1)) // bs
    evals = math.ceil(len(val_samples) / cfg.TEST.IMS_PER_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = f"{tmp}/ckpt"
        state = create_train_state(cfg, model, len(sampler) // bs)
        reset_counts()
        t0 = time.perf_counter()
        state, best = do_train(cfg, state, cache, sampler, val, len(val_ds.query),
                               checkpoint_dir=ckpt)
        wall = time.perf_counter() - t0
        launches = counts()
        entry = state.history[-1]
        log(f"[do_train] 1 epoch, {entry['steps']} steps + eval of {len(val_samples)} samples "
            f"in {wall:.1f} s: loss {entry['loss']:.4f}, acc {entry['acc']:.3f}, mAP "
            f"{entry['mAP']:.4f}, Rank-1 {entry['Rank-1']:.3f}; launches {launches}")
        want = {"fused_attention_block": layers * evals, "fused_mlp_block": layers * evals,
                "fused_attention_block_train": layers * steps,
                "attention_bwd_saved_db": layers * steps, "attention_bwd_saved": 0}
        require_launches(launches, want, "do_train")
        require(0.0 < entry["mAP"] <= 1.0 and best["mAP"] == entry["mAP"], f"mAP {best}")
        fresh = make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=device,
                           generator=torch.Generator().manual_seed(1))
        restored = restore_checkpoint(f"{ckpt}_best", create_train_state(cfg, fresh, steps))
        mine = state.model.state_dict()
        require(restored.step == state.step and all(
            torch.equal(v, mine[k]) for k, v in fresh.state_dict().items()),
            "the best checkpoint did not reload the trained state")
        log(f"[do_train] best checkpoint at step {restored.step} saved and reloaded: ok")


# ---------------------------------------------------------------- phase 8


def train_kernel_flops(name: str, shape) -> int:
    b, s, c = shape
    if name == "fused_attention_block_train":
        return block_flops("fused_attention_block", shape)
    return 8 * b * s * s * c  # dV, dP, dQ, dK


def phase_train_timing(device, card, cfg, model, plain_cfg, plain, cache, sampler) -> dict:
    from demo2_tpu_torch.engine.state import create_train_state
    from demo2_tpu_torch.engine.train import build_train_step
    from demo2_tpu_torch.ops import fused_block as fb, packed_attention as pa

    times = {}
    x, p, grad_out = train_kernel_inputs(FLAGSHIP, device, seed=5)
    w = {k: (v.to(torch.bfloat16) if k in ("wqkv", "wout") else v) for k, v in p.items()}
    kw = dict(num_heads=HEADS, scale=(FLAGSHIP[-1] // HEADS) ** -0.5)
    _, qkv, _, probs = fb.fused_attention_block_train(x, **w, **kw)
    cases = {
        "fused_attention_block_train": (lambda: fb.fused_attention_block_train(x, **w, **kw),
                                        lambda: fb.attention_block_train_plain(x, **w, **kw)),
        "attention_bwd_saved_db": (
            lambda: pa.attention_bwd_saved_db(qkv, probs, grad_out, **kw),
            lambda: pa.attention_bwd_saved_plain(qkv, probs, grad_out, with_db=True, **kw)),
        "attention_bwd_saved": (
            lambda: pa.attention_bwd_saved(qkv, probs, grad_out, **kw),
            lambda: pa.attention_bwd_saved_plain(qkv, probs, grad_out, with_db=False, **kw)),
    }
    for name, (kern, plain_fn) in cases.items():
        k_ms, p_ms = alternate(lambda: cuda_ms(plain_fn), lambda: cuda_ms(kern))
        times[name] = (k_ms, p_ms)
        tf = lambda ms: train_kernel_flops(name, FLAGSHIP) / ms / 1e9
        log(f"[time] {name} x{FLAGSHIP}: kernel {k_ms:.4f} ms ({tf(k_ms):.1f} TFLOP/s), plain "
            f"{p_ms:.4f} ms ({tf(p_ms):.1f} TFLOP/s) ({card})")

    bs = cfg.SOLVER.IMS_PER_BATCH
    order = sampler.epoch_indices(2)
    idx = torch.from_numpy(order[: 8 * bs].reshape(8, bs)).to(device)

    def stepper(c, m):
        step = build_train_step(c, m, create_train_state(c, m, len(order) // bs), cache)
        return lambda i: step(idx[i % len(idx)])

    steppers = {"kernel": stepper(cfg, model), "plain": stepper(plain_cfg, plain)}

    def step_ms(which, reps=5):
        run = steppers[which]
        for i in range(2):
            run(i)
        sync()
        t0 = time.perf_counter()
        for i in range(reps):
            run(i)
        sync()
        return (time.perf_counter() - t0) * 1e3 / reps

    k_ms, p_ms = alternate(lambda: step_ms("plain"), lambda: step_ms("kernel"))
    log(f"[time] train step, batch {bs}: kernel path {k_ms:.2f} ms ({1e3 * bs / k_ms:.1f} img/s), "
        f"plain path {p_ms:.2f} ms ({1e3 * bs / p_ms:.1f} img/s) ({card})")
    for which in ("kernel", "plain"):
        torch.cuda.reset_peak_memory_stats()
        steppers[which](0)
        sync()
        log(f"[time] peak device memory of a {which}-path train step: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    for which in ("kernel", "plain"):
        profile(f"{which} path, one train step of {bs}", lambda: steppers[which](1), card,
                top=14)
    return times


KERNEL_SOURCES = {  # name: (source, the Pallas kernel it replaces)
    "fused_attention_block": ("demo2_tpu_torch/csrc/fused_attention_block.cu",
                              "demo2_tpu/ops/fused_block.py:128"),
    "fused_mlp_block": ("demo2_tpu_torch/csrc/fused_mlp_block.cu",
                        "demo2_tpu/ops/fused_block.py:369"),
    "fused_attention_block_train": ("demo2_tpu_torch/csrc/fused_attention_block.cu",
                                    "demo2_tpu/ops/fused_block.py:118"),
    "attention_bwd_saved_db": ("demo2_tpu_torch/csrc/attention_bwd.cu",
                               "demo2_tpu/ops/packed_attention.py:264"),
    "attention_bwd_saved": ("demo2_tpu_torch/csrc/attention_bwd.cu",
                            "demo2_tpu/ops/packed_attention.py:231"),
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    card = phase_device()
    errors = phase_kernels(device)
    errors.update(phase_train_kernels(device))
    cfg, model, plain_cfg, plain = build_models(device)
    launches = phase_slice(device, cfg, model, plain_cfg, plain)
    times = phase_timing(device, card, cfg, model, plain_cfg, plain)
    cache, sampler = build_train_data(cfg, device)
    launches.update(phase_train(device, cfg, model, plain_cfg, plain, cache, sampler))
    phase_do_train(device, model, cache, sampler)
    times.update(phase_train_timing(device, card, cfg, model, plain_cfg, plain, cache, sampler))
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errors[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in KERNEL_SOURCES.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
