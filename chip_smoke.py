#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (demo2_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

builds the hand-written CUDA kernels from demo2_tpu_torch/csrc, checks each
against its plain PyTorch version at the flagship shapes, drives the
flagship embedding server (DeMo SDTPS + DGAF v3 on CLIP ViT-B/16, 256x128,
bf16, random weights from a seed) through FeatureExtractor and match(), and
times the kernels and the extractor against the plain path.  Phases:

  1. device: card name and power limit, torch / CUDA / triton / nvcc
     versions, kernel build time and ptxas register / smem / spill lines;
  2. kernels: each kernel vs its plain version, at x (192, 129, 768) and at
     batch 1 (3, 129, 768), tolerance asserted;
  3. slice: requests of N = 0, 1, 64, 100 images with miss "None" and "nt";
     shape, finiteness, unit norm, 12 launches of each kernel per forward,
     cosine >= 0.999 against the same model on the plain path, match() and
     CMC / mAP on the card;
  4. timing (printed, not asserted): kernels vs plain versions with their
     achieved TFLOP/s, extractor batch-1 latency and batch-64 throughput on
     both paths, peak memory, and a profile of one batch-64 request.

Any failed check raises, so the exit code is non-zero; without a CUDA device
the script exits non-zero before printing any result.  The last line is
{"ok": true, "device": {...}}; the line before it lists the kernels.
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


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


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


def flagship_cfg(fused: bool):
    from demo2_tpu_torch.config import get_cfg_defaults
    from demo2_tpu_torch.config.presets import apply_flagship

    cfg = get_cfg_defaults()
    apply_flagship(cfg, on_tpu=True)
    # configs/RGBNT201/DeMo_SDTPS_DGAF.yml
    cfg.MODEL.SDTPS_CROSS_ATTN_TYPE = "attention"
    cfg.MODEL.SDTPS_SPARSE_RATIO = 0.7
    cfg.MODEL.SIE_COE = 1.0
    cfg.TPU.USE_FLASH_ATTENTION = fused
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
        profile_request(label, FeatureExtractor(c, m, device=device, batch_size=64),
                        images, cams, card)
    return times


def profile_request(label, fx, images, cams, card, top=10) -> None:
    """Where one batch-64 request's time goes: device time by kernel
    (torch.profiler / CUPTI) against the host clock around the request."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fx.extract(images, cams)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fx.extract(images, cams)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"[profile] {label}, one batch-64 request: host wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), {len(rows)} device ops ({card})")
    for e in rows[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:110]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    card = phase_device()
    errors = phase_kernels(device)
    cfg, model, plain_cfg, plain = build_models(device)
    launches = phase_slice(device, cfg, model, plain_cfg, plain)
    times = phase_timing(device, card, cfg, model, plain_cfg, plain)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    sources = {
        "fused_attention_block": ("demo2_tpu_torch/csrc/fused_attention_block.cu",
                                  "demo2_tpu/ops/fused_block.py:128"),
        "fused_mlp_block": ("demo2_tpu_torch/csrc/fused_mlp_block.cu",
                            "demo2_tpu/ops/fused_block.py:369"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errors[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in sources.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
