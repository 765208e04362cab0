#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (demo2_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

builds the hand-written CUDA kernels from demo2_tpu_torch/csrc, checks each
against its plain PyTorch version at the shapes of the paths below, drives
the flagship (DeMo SDTPS + DGAF v3 on CLIP ViT-B/16, 256x128, bf16, random
weights from a seed) as a server through FeatureExtractor and match() and as
a trainer through build_train_step and do_train, drives the same DeMo on
the ImageNet ViT (vit_base_patch16_224, full width and depth) as a server
and a trainer, the head-major attention route, the flagship's training with
the one-pass LayerNorm backward (TPU.PALLAS_LN_BWD) and its re-ranked
evaluation (TEST.RE_RANKING, the MSVR310 scene protocol), the block backward
with the fused-dW kernel in its middle, the flagship's training with the fused
MLP (TPU.FUSED_MLP_TRAIN) and the attention ablation tool, drives DeMo's own
model (configs/RGBNT201/DeMo.yml: HDM + ATMoE beside the globals' head, at
full width) as a server, an evaluator at each return_pattern and a trainer,
eleven more DeMo branches of configs/ at two blocks, and three more
assemblies at full width (the DeMoBeiyong cascade of
configs/RGBNT201/DeMo_SACR_SDTPS_LIF.yml, DeMo_Parallel.yml and
DeMo_FRCA_DGAF.yml), drives DeMo on the other backbones (T2T-ViT-24,
vit_small at stride 12, ResNet-50-IBN-a, OSNet-AIN) as a server and a
trainer, serves and trains the flagship past 144 tokens (at stride 12 and
at 384x128) and past 256 (on TransReID's stride-12 crops, 256x256 and
384x128), trains and evaluates the flagship from a JPEG tree on
disk through the port's CLIs (tools/train.py, tools/test.py), trains and
serves the flagship with the int8 MLP (TPU.INT8_MLP), takes its saliency
maps and runs the missing-modality sweep (tools/miss_sweep.py), trains and
evaluates the flagship data-parallel (two ranks sharing the card over gloo;
tools/train --distributed in a one-rank NCCL world), and times kernels,
requests, the loader and train steps against the plain path.
Phases:

  1. device: card name and power limit, torch / CUDA / triton / nvcc
     versions, kernel build time and ptxas register / smem / spill lines;
  2. the block kernels (1, 2, 2's training form, 3; their GEMMs on wgmma,
     gemm_sm90.cuh) at the edges of the GEMM's tiling, x (3, 129, 768),
     (5, 77, 768), (1, 1, 768), (8, 129, 384), (8, 129, 512) and the flagship's
     (192, 129, 768): 1 and 2 against their plain bf16 versions, 3 and 2-train
     as phases 5 and 18 hold them, 3 and 2-train within a mean of 1.5e-4 of the
     output's mean size of the plain versions that round alike, a bound that
     misrounded controls on the same inputs fail (the out-projection's residual
     in f32, fc2's in bf16, p rounded after PV, h rounded before the bias), 1
     and 2 bitwise equal to 3's and 2-train's outputs;
  5. training kernels at the same shapes: the training forward (3) with its
     residuals and probs, the saved-probs backward with db (4) and without
     (7, bitwise equal to 4's dqkv), and the autograd Function's 7 grads, each
     no further from an f32 run than the plain bf16 path; kernel 4's dqkv also
     within phase 2's bounds and a mean of 1e-5 of the plain version, a bound
     that the same arithmetic with dS left in f32 (a control on the same
     inputs) fails, its dqkv and db bit-identical over two runs; kernels 4 and
     7 also at the edges of their tiling, packed qkv (48, 144, 2304),
     (192, 16, 2304), (192, 1, 2304), (64, 40, 1152) and (5, 77, 576) with the
     probabilities the plain forward saves, within the same bounds (the
     control wherever there is more than one key);
  9. attention kernels: the packed self-attention (5) and its recomputing
     backward (6) at qkv (192, 129, 2304) and (3, 129, 2304), the head-major
     attention (9) and its backward (10) at (192, 129, 12, 64) and
     (3, 129, 12, 64), each output within phase 2's bounds of the plain
     version and no further from f32 than the plain bf16 version, and within
     a mean of 1e-5 of the plain version, a bound that the same arithmetic
     rounded at the wrong point (controls run on the same inputs) fails;
     all four also at the edges of their tiling, (48, 144, 12, 64),
     (192, 16, 12, 64), (192, 1, 12, 64), (64, 40, 6, 64) and (5, 77, 3, 64)
     and the packed qkv of the same sizes, (48, 144, 2304) to (5, 77, 576),
     within the same bounds; the outputs of kernels 6 and 10 bit-identical
     over two runs at every shape.  The wide pair of kernels 5 and 6
     (csrc/packed_attention_wide.cu: heads of 64 or 96 over up to 256
     tokens) within the same bounds at qkv (192, 211, 2304) with 12 heads of
     64 and with 8 of 96, and (192, 129, 2304) with 8 of 96 (vit_small's
     scale 768^-0.5), kernels 5's and 6's misrounded controls failing the
     mean bound there, and at WIDE_EDGE_SHAPES (S = 1, 16, 145, 256; many
     (sample, head) items; at S = 256 and batch 192, 11-18 items to each
     block of the persistent grid); its backward bit-identical over two runs;
     packed_attention_fwd / _bwd at S = 211 launching it and not the
     register pair;
  3. serving: requests of N = 0, 1, 64, 100 images with miss "None" and "nt";
     shape, finiteness, unit norm, 12 launches of kernels 1 and 2 per
     forward (and of no other kernel), cosine >= 0.999 to the plain path,
     match() and CMC / mAP;
  4. serving timing (printed): kernels 1 and 2 vs plain with TFLOP/s, their
     four GEMMs alone (profiler device time inside the kernels' own launches)
     beside torch.addmm at the same shapes, extractor batch-1 latency and
     batch-64 throughput on both paths, peak memory, a profile of one batch-64
     request;
  6. training: a device cache of synthetic 256x128 images, 171 ids x 8; the
     step-1 gradients of both paths (cosine >= 0.999 whole, >= 0.99 per
     block's ln_1 / in_proj / out_proj); 20 Adam (bf16 moments) steps of PK
     batches of 64 = 8 ids x 8 through build_train_step, each launching
     kernels 3 and 4 12 times and no other kernel; finite losses, every
     parameter and the BatchNorm statistics changed, the loss falling (mean
     of the last 5 steps below the first 5's), per-step loss within 2% of
     the plain path's over 10 steps; then an input gradient with the
     weights frozen (as a saliency map takes it), which runs kernel 7;
  7. do_train: one epoch with eval over a small synthetic val cache (kernels
     1 and 2 at eval, 3 and 4 in training), mAP in (0, 1], the best
     checkpoint saved and reloaded;
  8. training timing (printed): kernels 3, 4 and 7 vs plain with TFLOP/s;
     the GEMMs of 3 and 2's training form alone beside torch.addmm; the train
     step in ms and img/s on both paths in turns, peak memory, a profile of one
     train step on each path;
  10. the head-major route: attention_core(implementation="pallas") and a
     MultiHeadAttention cross-attention of equal lengths, forward and
     backward, each launching kernels 9 and 10 once, cosine >= 0.999 to the
     plain route for the output and every gradient;
  11. ViT serving: phase 3 on DeMo over vit_base_patch16_224, 12 launches of
     kernel 5 per forward and of no other kernel;
  12. ViT training: phase 6 with drop path 0.1 (both paths' generators
     seeded alike, so their masks agree; step-1 cosine per block's qkv /
     proj), each step launching kernels 5 and 6 12 times and no other;
  13. ViT timing (printed): kernels 5, 6, 9 and 10 vs plain with TFLOP/s and
     beside scaled_dot_product_attention (forward, and its autograd
     backward); the extractor at batch 1 and 64 and the train step on
     both paths in turns, peak memory, profiles of one request and one step;
  14. the LayerNorm backward (11) vs its plain version at (24768, 768) and
     (387, 768) bf16 and at (387, 768) f32: dx within phase 2's bounds,
     dweight / dbias within 1e-3 of their largest, each no further from an
     f64 computation than 1.5 x the plain version, all three outputs
     bit-identical over two runs; the Jaccard min-sum (12) on the re-ranking
     weights of 1,600 queries among 4,800 clustered features, at phase 16's
     80 among 320 and at a ragged 70 x 333, each at k2 = 15, at k2 = 1 and on
     uniform weights, and at JACCARD_EDGES: bitwise equal to the ascending-k
     sum (jaccard_min_sum_ordered), which a descending-k control fails, max
     abs <= 1e-6 from its plain version (1e-5 where rows are full),
     bit-identical runs; negative inputs computed with the same bits;
  15. training with PALLAS_LN_BWD: phase 6 on the flagship kernel path with
     the flag on, each step launching kernels 3, 4 and 11 12 times and no
     other; step-1 gradient cosine to the plain model >= 0.999 whole and per
     block, ln_2's weight and bias among the groups;
  16. re-ranked eval: do_inference and run_eval with TEST.RE_RANKING over an
     eval cache cut from the training images on the card, the second with
     DATASETS.NAMES = MSVR310 (scene protocol, rank list file); each eval
     launches kernel 12 once beside kernels 1 and 2; distances within 1e-5
     of, and CMC / mAP equal to, the same calls with the kernel swapped for
     its plain version;
  17. timing (printed): kernels 11 (beside aten's native_layer_norm_backward)
     and 12 vs plain (12 on V at k2 = 15, k2 = 1 and uniform, beside the
     min-sum through torch.cdist(p=1), with its byte bound and the dense
     sum's operations), re_ranking as a whole at 1,600 / 3,200, the train step
     with and without PALLAS_LN_BWD in turns, a profile of one step of each;
  18. the fused-dW backward (8: kernel 4's backward into a bf16 dqkv, then dt
     and dW on the block GEMM, gemm_sm90.cuh, with MN-major operands) vs its
     plain version at qkv (192, 129, 2304) and (3, 129, 2304), at kernel 4's
     edge shapes of phase 5, at (8, 129, 1536) (width 512) and at
     (24, 129, 2304) (two slices of dW's K): dt within phase 2's bounds and
     within a mean of 1e-4 of its mean size of the plain version, a bound that
     the same contraction of the unrounded dq, dk, dv (a control on the same
     inputs, wherever there is more than one key) fails; dW and db within 1e-3
     of their largest; each output no further from an f64
     computation than 1.5 x the plain version; all three bit-identical over
     two runs.  The MLP's training form (2) vs its plain version: out as
     phase 2, the hidden h within one bf16 ulp, at most 0.2% of it
     differing, which h rounded before the bias (a control) exceeds.  The
     ablation kernel's (13) five cases vs their plain versions at (192, 136,
     2304) and (8, 136, 2304), within two bf16 ulps and a mean of 1e-5 of
     their mean size;
  19. the block backward through the kernel-8 route at x (192, 129, 768): the
     seven grads against the kernel-4 route's (cosine >= 0.9999, dx within
     phase 2's bounds, bqkv bitwise equal: kernel 8's db is kernel 4's),
     launching kernel 3 once, kernel 8 once, kernel 4 never;
  20. training with FUSED_MLP_TRAIN: phase 6 on the flagship kernel path with
     the flag on, each step launching kernels 3, 4 and the training form of 2
     12 times and no other; step-1 gradient cosine to the plain model >= 0.999
     whole and per block (ln_2, mlp.c_fc and mlp.c_proj among the groups);
     then one do_train epoch with eval (kernels 1 and 2 at eval);
  21. timing (printed): kernel 8 beside kernel 4 + the two torch.mm it fuses,
     and each of its launches by the profiler beside that stage's bound,
     2's training form beside the unfused MLP's forward, the ablation tool's
     five cases (full h=12 beside scaled_dot_product_attention, and no
     slower than it), the train
     step with and without FUSED_MLP_TRAIN in turns with the peak memory of
     each, a profile of one step of each;
  22. DeMo.yml (at CUT_DEPTH = 6 of its 12 blocks, as phases 25 and 30:
     the script's time limit; its keys from YAML_KEYS,
     apply_flagship's production flags,
     171 ids, 6 cameras, PK 8 x 8; HDM 8 heads of 64, ATMoE HEAD 4): phase 3
     on it (kernels 1 and 2 once a block a forward, cosine >= 0.999 to the
     plain path at N = 1, 64, 100 under miss "None" and "nt"); run_eval at
     return_pattern 1, 2, 3 with widths 1,536 / 3,584 / 5,120 (3C / 7C /
     10C at C = 512), pattern 3 = [2, 1], mAP in (0, 1]; phase 6 on it
     (kernels 3 and 4 once a block a step; HDM's parameters, ATMoE's
     expert_kernel and its two BatchNorms' running statistics changed); a
     do_train epoch logging patterns 1, 2 and 3;
  23. timing (printed): the DeMo.yml train step and batch-64 request beside
     the flagship's in turns, with a profile of each (device busy), and
     HDM + ATMoE alone at batch 64, eval forward and forward + backward;
  24. the Baseline, DeMo_SDTPS, DeMo_DGAF (v3, and v1 with GLOBAL_LOCAL),
     DeMo_SDTPS_shared, DeMo_optimized and MSVR310's DeMo.yml (128x256, the
     scene protocol with its rank list) at two blocks, and
     DeMo_SACR_SDTPS, DeMo_LIF, the two MultiModalSACR files and
     SDTPSComplete (SDTPS_VARIANT "complete" on DeMo_SDTPS_DGAF.yml): one
     train step (2 launches of kernels 3 and 4) and one run_eval (2 of
     kernels 1 and 2 a forward) each;
  25. DeMo_SACR_SDTPS_LIF.yml (DeMoLegacy: SACR, LIF, SDTPS, GLOBAL_LOCAL),
     DeMo_Parallel.yml (nine heads, 9C) and DeMo_FRCA_DGAF.yml (FRCA, its six
     directed cross-attentions, DGAF V3Multi, 6C) at full width and CUT_DEPTH
     blocks as phase 22 builds DeMo.yml: phase 3 on each, run_eval at its width, the LIF loss
     finite and in the step's loss, phase 6 on each (every tensor of its own
     modules changed, BatchNorm statistics included), and FRCA's channel
     spectrum on the card against numpy's f64 FFT, its phase at the real bins
     0 or pi by the sign of the real part;
  26. timing (printed): each of the three beside the flagship, train step and
     batch-64 request in turns with a profile of each, and its own modules
     alone at batch 64 (SACR's core, LIF's predictors and targets, FRCA with
     its cross-attention, the nine heads), eval and forward + backward;
  27. the input path from disk and the CLIs: the native loader built (its
     decoder printed: libjpeg, or nvJPEG where libjpeg's header is missing,
     as on the card's machine), an RGBNT201 tree of 960 JPEGs (32 train ids
     and 8 test ids x 8, SyntheticTriModal's hard recipe at 288x144, quality
     95) written by the port's JPEG writer; the train and eval caches that
     build_device_cache decodes held against the sources resized by
     F.interpolate (bicubic / bilinear, antialiased) within DECODE_MAX_U8 /
     DECODE_MEAN_U8, which the sources shifted by one pixel fail;
     tools/train.main on the flagship's keys (DeMo_SDTPS_DGAF.yml and
     apply_flagship's flags), 2 epochs with an eval each, once with
     TPU.DATA_CACHE host and once with device: 12 launches of kernels 3 and
     4 a step and of 1 and 2 an eval forward, no other; finite losses; the
     metrics file's six tags, the log, the best checkpoint; tools/test.main
     on the latest and the best checkpoint reproducing the run's mAP and
     Rank-1 exactly;
  28. timing (printed): the native loader's images/s at 1, 2, 4 and 8
     threads, and the batch-64 flagship train step fed by the host pipe
     against the device cache in turns, each with the device busy share of a
     profiled window of 4 steps;
  29. the training knobs (run after phase 8, on its model and cache): one
     step of the flagship with TPU.REMAT_BACKBONE and one without, from the
     same weights, batch and draws: the loss and every gradient bit-equal
     (a gradient that is not is named and held to a cosine of 0.99999),
     kernel 3 launched 24 times and kernel 4 12 times (the wrappers' counts
     and the profiler's), remat's peak memory below the other's, both steps
     timed in turns; phase 6 on the flagship with METRIC_LOSS_TYPE
     triplet_center and the timm cosine schedule (TPU.ENABLE_COSINE_SCHEDULE,
     SOLVER.LR_SCHEDULER cosine), the centers moved for exactly the ids seen,
     the lr the cosine recipe's; tools/quality_gate.main --report-only over 2
     epochs of a tree of 16 ids x 8 at full width: its report with two evals,
     kernels 3 and 4 12 times a step, 1 and 2 12 times an eval forward;
  30. the CLIP tower's tuning paths at full width, CUT_DEPTH blocks (after
     phase 29, on
     its cache), six configurations of the flagship: MODEL.FROZEN with LoRA
     of rank 4 on q, k and v, on q and v (the merged form), with ConvLoRA on
     the patch embed, FROZEN with the FFN adapter and no LoRA, the adapter
     alone, and the modality prompts (PROMPT: x (192, 141, 768) in the
     block kernels); LoRA's B, ConvLoRA's B and the prompts drawn at random
     (their zero init hides the delta).  Each: a batch-64 request through
     FeatureExtractor against the plain path (cosine >= 0.999), kernel 1
     once a block a forward and kernel 2 too, 0 under the adapter, by the
     wrappers' counts and the profiler's; the step-1 gradient of the
     trainable parameters against the plain path (phase 6's cosines), 10
     steps on both paths (phase 6's loss bound), the frozen parameters bit
     for bit unchanged and every trainable one moved; kernel 3 once a block
     a step and kernel 4 too, or kernel 7 where MODEL.FROZEN leaves
     the qkv bias without a gradient (wrappers and profiler); the step timed
     beside the flagship's, with its device busy share; kernels 1, 3, 4 and
     7 timed at S = 141 beside their bounds;
  32. the other backbones (after phase 21, on the flagship's cache), DeMo
     with the flagship fusion (SDTPS + DGAF v3) and only TRANSFORMER_TYPE
     and STRIDE_SIZE changed: t2t_vit_t_24 (512 wide, 24 blocks of 8 heads
     of 64, 129 tokens) and vit_small_patch16_224 at stride 12 (768 wide, 8
     blocks of 8 heads of 96, 211 tokens), each through phase 3 (24 / 8
     launches a forward of kernel 5 / of the wide pair's forward, and no
     other kernel) and phase 6 with BACKBONE_STEPS steps (24 launches a step
     of kernels 5 and 6 / 8 of the wide pair), the backbone's step-1
     gradient held from one upstream gradient, the losses within LOSS_REL of
     the plain path's; resnet50_ibn_a and osnet_ain_x1_0 (no kernel of the
     port: cuDNN convolutions): 20 steps, each finite and launching no
     kernel, the loss falling, every BatchNorm's running statistics moved,
     run_eval's mAP in (0, 1], and the f32 trunk on the card (cuDNN with
     TF32 off) within CUDNN_F32_REL of the same trunk on the CPU;
  33. timing (printed): the wide pair at WIDE_SHAPES beside its bound and
     scaled_dot_product_attention's forward / backward; each of the four
     backbones' train step and batch-64 request beside the flagship's in
     turns, with the profiler's device busy share of one of each;
  31. migration from the reference (after phase 28, on its JPEG tree): a
     reference-layout DeMo (SDTPS + DGAF v3) on vit_base_patch16_224 written
     with torch.save from random tensors under the reference's key names,
     tools/test.main with it as TEST.WEIGHT (kernel 5 12 times an eval
     forward), its embedding through load_reference_checkpoint against the
     plain path's (cosine >= 0.999), tools/train.main --init_pth over one
     epoch (kernels 5 and 6 12 times a step); the kernel-path checks of
     phases 2 and 5 also run at the prompts' S = 141;
  34. TPU.INT8_MLP and the analysis stack (parts 1 and 2 after phase 30, on
     its cache; part 3 after phase 27, on its tree): torch._int_mm bit-equal
     to the exact f64 product at the flagship's MLP shapes, (24768, 768) x
     (768, 3072) and (24768, 3072) x (3072, 768); int8_dense on x (24768,
     768) bf16 bit-equal to a reference (host scales and half-to-even
     rounding, the product in f64) in both modes, which a control rounding
     toward zero fails; the flagship with INT8_MLP dynamic and static at
     full width against the plain path with the same INT8_MLP: a batch-64
     request (cosine >= 0.999; kernel 1 12 times, kernel 2 never), the
     step-1 gradient (phase 6's cosines, ln_2 and the MLP among the groups),
     INT8_STEPS steps on each path (kernels 3 and 4 12 times a step, losses
     within 2%), the step and the request timed beside the bf16 flagship's,
     a profile of one step of each; gradcam (class_idx pinned; kernels 1
     and 2 12 times: the probe lies after the backbone) and gradcam_heatmaps
     (kernels 3, 7 and 2's training form 12 times) on the flagship at batch
     8, the probed patch activations held (cosine >= 0.999), the maps'
     agreement printed (SDTPS's input gradient is ill-conditioned); the maps
     held within CAM_MAP_TOL of the plain path's on DGAF v3 alone (gradcam)
     and on the Baseline (gradcam_heatmaps), other images' maps further;
     tools.miss_sweep's seven conditions on phase 27's tree and best
     checkpoint (kernels 1 and 2 12 times an eval forward), "None" equal to
     tools/test.main's mAP and Rank-1; the phase's seconds against its
     45 s budget.
  35. data parallel: (a) after phase 13, two ranks (spawned processes,
     the kernels built in phase 1 reused) sharing cuda:0 over gloo
     (parallel/mesh.py::join_process_group with the device pinned) train
     the flagship at full width, 256x128, bf16, kernels on, global batch 64
     (32 a rank) on a synthetic cache of 24 ids x 8, DP_STEPS steps from
     seed 0, each step against the one-process step from the same state on
     the same global batch (rank 0): the backbone's step-1 gradient cosine
     >= 0.9999 whole and >= 0.999 per block, the step-1 gradient norm within
     1e-3, every step's loss within 1e-3, the BatchNorm running statistics
     after every step within 1e-2 of their largest, and the ranks' train
     states bitwise equal after the steps (the free one-process trajectory's
     losses printed beside: SDTPS's selection turns summation-order noise
     into loss jumps of ~1e-3 within three steps); the same run with the
     gradients averaged, and with the BatchNorm statistics per rank, must
     each fail one of these; kernels 3 and 4 12 times a step on each rank;
     one eval of 96 samples in a batch of 128 padded (64 rows a rank):
     kernels 1 and 2 12 times on each rank, both ranks' CMC and mAP equal;
     each rank's step wall time and one step's device-busy ms beside the
     one process's (two ranks on one card measure correctness, not
     scaling); (b) after phase 31, on phase 27's tree: `python -m
     torch.distributed.run --nproc_per_node 1 -m demo2_tpu_torch.tools.train
     --distributed` (a one-rank NCCL world, its log naming the backend), one
     epoch and an eval, against tools/train without --distributed, each a
     fresh process: the checkpoint (parameters, buffers, moments) and the
     mAP bit for bit.
  36. the block kernels past the register tiles' 144 tokens (heads of 64,
     up to 256: csrc/attention_wide_block.cuh): (a) after phase 18, kernels
     1, 3, 4, 7 and 8 at x (192, 211, 768), (192, 145, 768), (64, 193, 768)
     and (48, 256, 768) within phases 2, 5 and 18's bounds of their plain
     versions (kernel 3's control, p rounded before it is normalised, and
     kernel 4's, dS left in f32, failing them), kernel 1 bitwise kernel 3's
     out, kernel 7 bitwise kernel 4's dqkv, reruns bit-identical, the
     training Function's grads at the first shape, kernels 4 and 7 also at
     qkv (192, 256, 2304), (16, 150, 1536) and (3, 211, 2304), every launch
     on the wide forms and none on the register forms; the four wide forms
     timed at (192, 211, 768) beside their bounds (kernel 8 there too); (b)
     after phase 34 (parts 1 and 2), the flagship at MODEL.STRIDE_SIZE
     (12, 12) (211 tokens) on both paths: phase 3's requests (kernels 1 and
     2 12 times a forward, 1 in its wide form), phase 6 over BACKBONE_STEPS
     steps (3 and 4 wide, 12 times a step; the backbone's step-1 gradient
     held from one upstream gradient), the input-gradient pass (3 and 7
     wide), its step and request beside the flagship's; (c) the flagship at
     384x128, stride 16 (193 tokens): one batch-64 request against the plain
     path and one step; (d) after phase 27, on its tree: tools/train.main at
     stride 12 (one epoch, the wide forms' launches) and tools/test.main on
     its checkpoint (the run's mAP and Rank-1 exactly).  (c) runs at
     CUT_DEPTH blocks.
  37. the block kernels past 256 tokens (heads of 64, up to 512:
     csrc/attention_long_block.cuh): (a) after phase 36 (a), phase 36
     (a)'s checks of the long forms of kernels 1, 3, 4, 7 (and 8's first
     stage) at x (192, 442, 768), (192, 257, 768), (64, 311, 768), (48,
     512, 768), (8, 300, 768) and (8, 340, 768), kernels 4 and 7 also at
     qkv (3, 442, 2304), (256, 272, 2304), (16, 384, 2304) and (4, 449,
     2304) (the edges of the forward's 64-row tiling and of its four
     builds), every launch on the long forms; the four timed at (192, 442,
     768) beside their bounds (kernel 8 there too); (b) after phase 36 (b,
     c), the flagship at 256x256, MODEL.STRIDE_SIZE (12, 12) (442 tokens),
     full width and all 12 blocks, on both paths: requests of 1 and 64
     images (kernel 1 long, 12 times a forward), phase 6 over BACKBONE_STEPS
     steps (3 and 4 long; the backbone's step-1 gradient held from one
     upstream gradient, each step's loss held to the plain path's, their
     fall printed only), the input-gradient pass (3 and 7
     long), the peak memory over phase 6, its step and request (device
     busy, peak memory) beside the 129-token flagship's; (c) 384x128 at
     stride 12 (311 tokens): one batch-64 request against the plain path and
     one step.

Every timed kernel is printed beside its bound: the larger of its bytes
(each input read and each output written once) over the card's 3.35 TB/s and
its operations over the peak for their type.

Any failed check raises, so the exit code is non-zero; without a CUDA device
the script exits non-zero before printing any result.  The last three lines
are the twenty-four kernels (JSON: the thirteen Pallas kernels'
counterparts, the fused MLP in both forms, the wide pair of kernels 5 and 6,
the wide and the long forms of kernels 1, 3, 4 and 7), the card's name and
power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

FLAGSHIP = (192, 129, 768)  # (3B, tokens, width) at batch 64
BATCH1 = (3, 129, 768)
# MODEL.PROMPT appends 3 x 4 prompt tokens to each block's sequence: S = 141,
# which pads to the kernels' kMaxSeq of 144.
PROMPT_SHAPE = (192, 141, 768)
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
# Kernels 5, 6, 9 and 10 round at the very points their plain versions round,
# so the two differ only where an f32 sum taken in another order lands on the
# other side of a bf16 rounding: a mean of ~3e-7 on an H100.  A kernel that
# rounds at another point (p to bf16 before PV, say) moves most outputs by a
# fraction of a bf16 ulp, a mean of ~1e-4, yet passes the three bounds above.
# Phase 9 holds these kernels to this bound and shows, on the same inputs,
# that plain versions rounding at the wrong point fail it.
ROUNDING_MEAN_TOL = 1e-5
COSINE_MIN = 0.999
BF16_PEAK_TFLOPS = 989.0  # H100 SXM data sheet, dense, at the 700 W limit
F32_PEAK_TFLOPS = 67.0    # the same sheet: f32 outside the tensor cores
HBM_PEAK_TBS = 3.35       # device memory rate
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


def all_kernels() -> dict:
    """The wrappers of the twenty-four kernels, each counting its launches."""
    from demo2_tpu_torch.ops import fused_block as fb, flash_attention as fa
    from demo2_tpu_torch.ops import norm, packed_attention as pa
    from demo2_tpu_torch.tools import bench_kernel_ablate as ab
    from demo2_tpu_torch.utils import reranking

    return {"fused_attention_block": fb.fused_attention_block,
            "fused_mlp_block": fb.fused_mlp_block,
            "fused_attention_block_train": fb.fused_attention_block_train,
            "attention_bwd_saved_db": pa.attention_bwd_saved_db,
            "attention_bwd_saved": pa.attention_bwd_saved,
            "packed_attention_fwd": pa.packed_attention_fwd,
            "packed_attention_bwd": pa.packed_attention_bwd,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "layernorm_bwd": norm.layernorm_bwd,
            "jaccard_min_sum": reranking.jaccard_min_sum,
            "fused_mlp_block_train": fb.fused_mlp_block_train,
            "attention_bwd_fused_dw": pa.attention_bwd_fused_dw,
            "attention_ablate": ab.ablate_attention,
            "packed_attention_wide_fwd": pa.packed_attention_wide_fwd,
            "packed_attention_wide_bwd": pa.packed_attention_wide_bwd,
            "fused_attention_block_wide": fb.fused_attention_block_wide,
            "fused_attention_block_train_wide": fb.fused_attention_block_train_wide,
            "attention_bwd_saved_db_wide": pa.attention_bwd_saved_db_wide,
            "attention_bwd_saved_wide": pa.attention_bwd_saved_wide,
            "fused_attention_block_long": fb.fused_attention_block_long,
            "fused_attention_block_train_long": fb.fused_attention_block_train_long,
            "attention_bwd_saved_db_long": pa.attention_bwd_saved_db_long,
            "attention_bwd_saved_long": pa.attention_bwd_saved_long}


def reset_counts() -> None:
    for k in all_kernels().values():
        k.launches = 0


def counts() -> dict:
    return {name: k.launches for name, k in all_kernels().items()}


def launch_dict(**nonzero) -> dict:
    """Launch counts of all twenty-four kernels: `nonzero`, the rest 0."""
    return {name: nonzero.get(name, 0) for name in all_kernels()}


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

    attn_kw = dict(num_heads=x.shape[-1] // 64, scale=64 ** -0.5)  # heads of 64
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


def exact_products() -> None:
    """The plain versions' products as the references they are: no TF32, no
    reduced-precision sums inside a bf16 product."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


# The shapes of the block kernels' checks: M = B x S not a multiple of the
# GEMM's 128-row tile ((3, 129), (5, 77), one row), the widths 384 and 512 of
# heads of 64 (T2T's), whose qkv, fc1 and out-proj widths are not multiples of
# 256 (and at 512 not of the 192-column tile either), and the flagship shape,
# which gives each block of the persistent GEMM many tiles.
BLOCK_EDGE_SHAPES = ((3, 129, 768), (5, 77, 768), (1, 1, 768), (8, 129, 384), (8, 129, 512),
                     FLAGSHIP, PROMPT_SHAPE)
# Kernels 3 and 2 (training form) round where attention_block_train_plain and
# mlp_block_train_plain round, so the two differ only where an f32 sum taken in
# another order lands on the other side of a bf16 rounding: on an H100 a mean
# of 1e-8 to 8e-5 of the output's mean size (the most at kernel 3's out, whose
# residual sum reads every such move of attn).  Rounding at a neighbouring
# point (the out-projection's residual added in f32, fc2's in bf16, p rounded
# after PV, h rounded before the bias) moves 4e-4 to 2e-3 of it.  The bound
# sits between; kernels 1 and 2 equal the training forms' outputs bit for bit.
BLOCK_ROUNDING_REL = 1.5e-4


def check_rounding(what, got, same, control=None) -> None:
    """`got` within a mean of BLOCK_ROUNDING_REL of mean |same| of `same`, the
    plain version that rounds where the kernel does; `control` (a plain
    version rounding at another point, on the same inputs) beyond it."""
    size = same.float().abs().mean().item()
    d = mean_err(got, same)
    line = (f"[kernel] {what}: vs the plain version rounding alike mean {d:.3e} ({d / size:.2e} "
            f"of mean |plain| {size:.3e})")
    require(d <= BLOCK_ROUNDING_REL * size,
            f"{what}: mean abs {d} > {BLOCK_ROUNDING_REL} of {size}: the kernel rounds where "
            f"its plain version does not")
    if control is not None:
        dc = mean_err(control, same)
        line += f"; misrounded control {dc:.3e} ({dc / size:.2e})"
        require(dc > BLOCK_ROUNDING_REL * size,
                f"{what}: the misrounded control is within {BLOCK_ROUNDING_REL} of the plain "
                f"version ({dc}), so the bound cannot tell where a kernel rounds")
    log(line)


def check_eval_kernel(name, kernel, plain, weights, x, shape):
    """Kernel 1 or 2 against its plain bf16 version and an f32 run of it;
    returns (the kernel's output, max abs error)."""
    got = kernel()
    yk = got.float()
    yp = plain(x, weights).float()
    y32 = plain(x.float(), {k: v.float() for k, v in weights.items()})
    sync()
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
    require(mean_abs <= MEAN_ABS_TOL, f"{name} {shape}: mean abs {mean_abs} > {MEAN_ABS_TOL}")
    require(k32.mean().item() <= F32_MEAN_RATIO * p32.mean().item(),
            f"{name} {shape}: less accurate against f32 than the plain bf16 path")
    return got, max_abs


def phase_kernels(device, shapes=BLOCK_EDGE_SHAPES) -> dict:
    """The block kernels at `shapes`: 1 and 2 against their plain bf16
    versions (phase 2's bounds), 3 with its residuals and probs (phase 5's
    bounds) and 2's training form with h (phase 18's), 3 and 2-train also
    within BLOCK_ROUNDING_REL of the plain versions that round alike, each
    beside misrounded controls that fail that bound, and 1 and 2 bitwise
    equal to 3's and 2-train's outputs.  Returns name -> max abs error at the
    flagship shape."""
    exact_products()
    errors = {}
    for shape in shapes:
        x, attn, mlp = block_inputs(shape, device, seed=1)
        eval_out = {}
        for name, (kernel, plain, weights) in kernel_cases(x, attn, mlp).items():
            eval_out[name], max_abs = check_eval_kernel(name, kernel, plain, weights, x, shape)
            if shape == FLAGSHIP:
                errors[name] = max_abs
        kw = dict(num_heads=shape[-1] // 64, scale=64 ** -0.5)
        train = check_train_forward(x, {k: v.float() for k, v in attn.items()}, shape, kw)
        mlp_out = check_mlp_train(device, shape)["out"]
        pairs = (("kernel 1", "kernel 3", eval_out["fused_attention_block"], train["residuals"][0]),
                 ("kernel 2", "kernel 2 (training form)", eval_out["fused_mlp_block"], mlp_out))
        for a, b, ya, yb in pairs:
            if REHEARSAL:  # the plain versions of 1 and 2 round as the plain path does
                log(f"[rehearsal] {a} {tuple(shape)}: bitwise equality to {b} on the card only")
            else:
                require(torch.equal(ya, yb), f"{a} {shape}: output not bitwise equal to {b}'s")
                log(f"[kernel] {a} {tuple(shape)}: output bitwise equal to {b}'s")
    log(f"[kernel] tolerance: max abs <= {MAX_ABS_TOL}, mean abs <= {MEAN_ABS_TOL}, "
        f"mean error vs f32 <= {F32_MEAN_RATIO} x the plain bf16 path's; 3 and 2-train within "
        f"a mean of {BLOCK_ROUNDING_REL} of mean |plain| of the plain version rounding alike "
        f"(every misrounded control beyond it), 1 and 2 bitwise 3 and 2-train, at {len(shapes)} "
        f"shapes: ok")
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


def vit_cfg(fused: bool, **overrides):
    """DeMo (SDTPS + DGAF v3) on vit_base_patch16_224: the flagship recipe
    with the ImageNet ViT backbone at its full width, drop path 0.1."""
    return flagship_cfg(fused, MODEL__TRANSFORMER_TYPE="vit_base_patch16_224",
                        MODEL__DROP_PATH=0.1, TPU__BACKBONE_WIDTH=-1, TPU__BACKBONE_HEADS=-1,
                        **overrides)


# The configs/ files of the DeMo branches and assemblies that phases 22-26
# drive, as merge_from_list opts: the card's machine has no PyYAML.
# tests/test_torch_package.py pins each equal to Config.merge_from_file of its
# file.
_YAML_MODEL = ["MODEL.TRANSFORMER_TYPE", "ViT-B-16", "MODEL.STRIDE_SIZE", [16, 16],
               "MODEL.SIE_CAMERA", True, "MODEL.SIE_COE", 1.0, "MODEL.DIRECT", 1,
               "MODEL.ID_LOSS_WEIGHT", 0.25, "MODEL.TRIPLET_LOSS_WEIGHT", 1.0]
_YAML_REST = ["INPUT.SIZE_TRAIN", [256, 128], "INPUT.SIZE_TEST", [256, 128], "INPUT.PROB", 0.5,
              "INPUT.RE_PROB", 0.5, "INPUT.PADDING", 10, "DATALOADER.SAMPLER", "softmax_triplet",
              "DATALOADER.NUM_INSTANCE", 8, "DATALOADER.NUM_WORKERS", 4,
              "DATASETS.NAMES", "RGBNT201", "DATASETS.ROOT_DIR", "./data",
              "SOLVER.BASE_LR", 0.00035, "SOLVER.WARMUP_ITERS", 10, "SOLVER.MAX_EPOCHS", 50,
              "SOLVER.STEPS", [30, 40], "SOLVER.GAMMA", 0.1, "SOLVER.OPTIMIZER_NAME", "Adam",
              "SOLVER.IMS_PER_BATCH", 64, "SOLVER.EVAL_PERIOD", 1, "TEST.IMS_PER_BATCH", 128,
              "TEST.RE_RANKING", "no", "TEST.NECK_FEAT", "before", "TEST.FEAT_NORM", "yes",
              "TEST.MISS", "None", "OUTPUT_DIR", "./output"]
_YAML_SDTPS = ["MODEL.USE_SDTPS", True, "MODEL.SDTPS_SPARSE_RATIO", 0.7,
               "MODEL.SDTPS_CROSS_ATTN_TYPE", "attention"]
_YAML_DGAF = ["MODEL.USE_DGAF", True, "MODEL.DGAF_VERSION", "v3"]
_YAML_LEGACY = _YAML_MODEL + ["MODEL.ARCH", "DeMoBeiyong", "MODEL.GLOBAL_LOCAL", True]
_YAML_SACR = ["MODEL.USE_SACR", True, "MODEL.SACR_DILATION_RATES", [2, 3, 4]]
_YAML_LIF = ["MODEL.USE_LIF", True, "MODEL.LIF_BETA", 0.4, "MODEL.LIF_LOSS_WEIGHT", 0.1]
_YAML_DEMO = _YAML_MODEL + ["MODEL.GLOBAL_LOCAL", True, "MODEL.HDM", True, "MODEL.ATM", True,
                            "MODEL.HEAD", 4]
YAML_KEYS = {
    "RGBNT201/DeMo.yml": _YAML_DEMO + _YAML_REST,
    "MSVR310/DeMo.yml": _YAML_DEMO + _YAML_REST + [
        "INPUT.SIZE_TRAIN", [128, 256], "INPUT.SIZE_TEST", [128, 256], "DATASETS.NAMES",
        "MSVR310"],
    "RGBNT201/Baseline.yml": _YAML_MODEL + ["MODEL.GLOBAL_LOCAL", False] + _YAML_REST,
    "RGBNT201/DeMo_SDTPS.yml": _YAML_MODEL + ["MODEL.GLOBAL_LOCAL", False] + _YAML_SDTPS + [
        "MODEL.SDTPS_CROSS_ATTN_HEADS", 4, "MODEL.SDTPS_LOSS_WEIGHT", 2.0] + _YAML_REST,
    "RGBNT201/DeMo_DGAF.yml": _YAML_MODEL + ["MODEL.GLOBAL_LOCAL", False] + _YAML_DGAF + [
        "MODEL.DGAF_NUM_HEADS", 8] + _YAML_REST,
    "RGBNT201/DeMo_SDTPS_shared.yml": _YAML_MODEL + ["MODEL.GLOBAL_LOCAL", False] + _YAML_SDTPS
    + ["MODEL.SDTPS_SHARE_CROSS_ATTN", True] + _YAML_DGAF + _YAML_REST,
    "RGBNT201/DeMo_optimized.yml": _YAML_MODEL + ["MODEL.GLOBAL_LOCAL", True] + _YAML_SDTPS + [
        "MODEL.SDTPS_LOSS_WEIGHT", 2.0] + _YAML_DGAF + ["MODEL.DGAF_NUM_HEADS", 8] + _YAML_REST,
    "RGBNT201/DeMo_SDTPS_DGAF.yml": _YAML_MODEL + ["MODEL.GLOBAL_LOCAL", False] + _YAML_SDTPS + [
        "MODEL.SDTPS_CROSS_ATTN_HEADS", 4, "MODEL.SDTPS_LOSS_WEIGHT", 2.0] + _YAML_DGAF + [
        "MODEL.DGAF_TAU", 1.0, "MODEL.DGAF_INIT_ALPHA", 0.5, "MODEL.DGAF_NUM_HEADS", 8]
    + _YAML_REST,
    "RGBNT201/DeMo_SACR_SDTPS.yml": _YAML_LEGACY + _YAML_SACR + _YAML_SDTPS + [
        "MODEL.SDTPS_LOSS_WEIGHT", 2.0] + _YAML_REST,
    "RGBNT201/DeMo_SACR_SDTPS_LIF.yml": _YAML_LEGACY + _YAML_SACR + _YAML_LIF + _YAML_SDTPS
    + _YAML_REST,
    "RGBNT201/DeMo_LIF.yml": _YAML_LEGACY + _YAML_LIF + _YAML_SDTPS + _YAML_REST,
    "RGBNT201/DeMo_MultiModalSACR_SDTPS_DGAF.yml": _YAML_MODEL + [
        "MODEL.ARCH", "DeMoBeiyong", "MODEL.GLOBAL_LOCAL", False, "MODEL.USE_MULTIMODAL_SACR",
        True, "MODEL.MULTIMODAL_SACR_VERSION", "v1"] + _YAML_SDTPS + _YAML_DGAF + _YAML_REST,
    "RGBNT201/DeMo_MultiModalSACR_SDTPS_DGAF_v2.yml": _YAML_MODEL + [
        "MODEL.ARCH", "DeMoBeiyong", "MODEL.GLOBAL_LOCAL", False, "MODEL.USE_MULTIMODAL_SACR",
        True, "MODEL.MULTIMODAL_SACR_VERSION", "v2"] + _YAML_SDTPS + _YAML_DGAF + _YAML_REST,
    "RGBNT201/DeMo_Parallel.yml": _YAML_MODEL + [
        "MODEL.ARCH", "DeMo_Parallel", "MODEL.GLOBAL_LOCAL", True, "MODEL.USE_SDTPS", True,
        "MODEL.SDTPS_SPARSE_RATIO", 0.6, "MODEL.SDTPS_CROSS_ATTN_TYPE", "attention",
        "MODEL.SDTPS_CROSS_ATTN_HEADS", 4, "MODEL.SDTPS_LOSS_WEIGHT", 1.0] + _YAML_DGAF + [
        "MODEL.DGAF_LOSS_WEIGHT", 1.0, "MODEL.FUSED_LOSS_WEIGHT", 0.5] + _YAML_REST,
    "RGBNT201/DeMo_FRCA_DGAF.yml": _YAML_MODEL + [
        "MODEL.GLOBAL_LOCAL", False, "MODEL.USE_FRCA", True, "MODEL.FRCA_NEGATIVE_SLOPE", 0.1,
        "MODEL.FRCA_USE_CROSS_ATTN", True, "MODEL.FRCA_CROSS_ATTN_HEADS", 8] + _YAML_DGAF
    + _YAML_REST,
}


def yaml_cfg(path: str, fused: bool, **overrides):
    """The keys of configs/`path` (YAML_KEYS) with apply_flagship's production
    flags (bf16 compute, the block kernels when `fused`, bf16 Adam moments,
    the device cache) and none of its MODEL keys; `overrides` as
    SECTION__KEY=value."""
    from demo2_tpu_torch.config import get_cfg_defaults
    from demo2_tpu_torch.config.presets import apply_tiny

    cfg = get_cfg_defaults().merge_from_list(YAML_KEYS[path])
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.USE_FLASH_ATTENTION = fused
    cfg.TPU.BF16_MOMENTS = cfg.TPU.BF16_SECOND_MOMENT = True
    cfg.TPU.DATA_CACHE = "device"
    if REHEARSAL:
        apply_tiny(cfg)
    for key, value in overrides.items():
        section, name = key.split("__")
        setattr(getattr(cfg, section), name, value)
    return cfg.freeze()


# Blocks of the models of phases 22-23 (DeMo.yml), 25-26 (the three
# assemblies) and 30 (the six tuning configurations) on the card, of the
# backbone's 12: their paths are the flagship's block kernels at full width,
# which phases 2-8 check at full depth, and the whole script has to end well
# inside its time limit beside phase 36.
CUT_DEPTH = 6


def cut_depth(make_cfg):
    """`make_cfg` with the backbone cut to CUT_DEPTH blocks on the card (a
    rehearsal keeps apply_tiny's two)."""
    if REHEARSAL:
        return make_cfg
    return lambda fused, **overrides: make_cfg(fused, TPU__BACKBONE_DEPTH=CUT_DEPTH, **overrides)


def demo_cfg(fused: bool, **overrides):
    """configs/RGBNT201/DeMo.yml: HDM + ATMoE beside the three globals' head."""
    return yaml_cfg("RGBNT201/DeMo.yml", fused, **overrides)


def build_models(device, make_cfg=flagship_cfg):
    """The kernel-path model (random weights from seed 0) and the plain-path
    model with the same weights."""
    from demo2_tpu_torch.models import make_model

    cfg = make_cfg(fused=True)
    model = make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=device,
                       generator=torch.Generator().manual_seed(0))
    plain_cfg = make_cfg(fused=False)
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


def num_blocks(model) -> int:
    base = model.backbone.base
    return len(base.resblocks if hasattr(base, "resblocks") else base.blocks)


def phase_slice(device, cfg, model, plain_cfg, plain, per_forward: dict,
                label: str = "slice") -> dict:
    """Serving: requests through FeatureExtractor, each forward launching
    `per_forward` (all twenty kernels' counts), embeddings against the plain
    path, match() and CMC / mAP.  Returns the launches of the requests."""
    from demo2_tpu_torch.serving import FeatureExtractor, match
    from demo2_tpu_torch.utils.metrics import R1mAPEvaluator

    images, cams = request_images(100, cfg, seed=2)
    fx = FeatureExtractor(cfg, model, device=device, batch_size=64)
    requests = [(n, miss) for miss in ("None", "nt") for n in (0, 1, 64, 100)]

    reset_counts()
    embeddings = {}
    for n, miss in requests:
        before = counts()
        emb = fx.extract(images[:n], cams[:n], miss=miss)
        sync()
        forwards = math.ceil(n / fx.batch_size)
        require_launches({k: v - before[k] for k, v in counts().items()},
                         {k: v * forwards for k, v in per_forward.items()},
                         f"[{label}] N={n} miss={miss}")
        embeddings[(n, miss)] = emb
    launches = counts()
    log(f"[{label}] main path: {len(requests)} requests, launches {launches}")

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
            log(f"[{label}] N={n:3d} miss={miss:4s}: shape {emb.shape}, cosine to plain path "
                f"min {cos.min():.6f} mean {cos.mean():.6f}")
        else:
            log(f"[{label}] N=0 miss={miss}: shape {emb.shape}")
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
    log(f"[{label}] match top-10 ok; CMC rank-1 {cmc[0]:.3f}, mAP {m_ap:.4f} on the card")
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


def host_ms(fn, iters=50, warmup=3) -> float:
    """Host time to enqueue one call of `fn` (no synchronize inside the loop):
    above the device time, the host sets a call's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * seconds / iters


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


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def roofline(flops: int, peak_tflops: float, moved_bytes: int):
    """(bound_ms, bound_by): the least time the card could take for the work,
    the larger of its operations over their peak rate and its bytes (each
    input read once, each output written once) over the memory rate."""
    ops_ms = flops / (peak_tflops * 1e9)
    bytes_ms = moved_bytes / (HBM_PEAK_TBS * 1e9)
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def timed(kernel, plain, flops, shape, inputs, library=None, peak=BF16_PEAK_TFLOPS, iters=20,
          plain_iters=20, moved=None) -> dict:
    """One entry of time_kernels: the kernel's call, its plain version's, the
    operations of one call (at `peak` TFLOP/s) and its input tensors, and the
    one PyTorch call that computes the same function where there is one.
    `moved` gives the bytes where they are not those of the inputs and of the
    output tensors (an output written in part)."""
    return dict(kernel=kernel, plain=plain, flops=flops, shape=shape, inputs=inputs,
                library=library, peak=peak, iters=iters, plain_iters=plain_iters, moved=moved)


def time_kernels(cases: dict, card) -> dict:
    """name -> timed(...): CUDA-event times of the kernel and its plain
    version in turns, the library call's where there is one, the achieved
    TFLOP/s and the bound from this run's tensors.  Returns name -> {ms,
    plain_ms, bound_ms, bound_by, library_ms}."""
    times = {}
    for name, c in cases.items():
        k_ms, p_ms = alternate(lambda: cuda_ms(c["plain"], c["plain_iters"]),
                               lambda: cuda_ms(c["kernel"], c["iters"]))
        lib_ms = None
        if c["library"] is not None:
            lib_ms = (cuda_ms(c["library"], c["iters"]) + cuda_ms(c["library"], c["iters"])) / 2
        moved = c["moved"]
        if moved is None:
            moved = tensor_bytes(c["inputs"]) + tensor_bytes(as_tuple(c["kernel"]()))
        bound_ms, bound_by = roofline(c["flops"], c["peak"], moved)
        times[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": lib_ms}
        tflops = lambda ms: c["flops"] / ms / 1e9
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"[time] {name} x{c['shape']}: kernel {k_ms:.4f} ms ({tflops(k_ms):.1f} TFLOP/s, "
            f"{100 * tflops(k_ms) / c['peak']:.1f}% of the {c['peak']:.0f} TFLOP/s peak), plain "
            f"{p_ms:.4f} ms ({tflops(p_ms):.1f} TFLOP/s), library call {lib}; bound "
            f"{bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.1f} MB moved, "
            f"{c['flops'] / 1e9:.1f} GFLOP; {100 * bound_ms / k_ms:.1f}% of it reached) ({card})")
    return times


# The products of the block kernels (gemm_sm90.cuh), each under its epilogue's
# name in the kernel's symbol: (its rows of x, the block kernel that launches
# it, the epilogue, N and K in units of the width).
BLOCK_GEMMS = {"fused_attention_block": (("qkv", "BiasEpilogue", 3, 1),
                                         ("out-proj", "BiasResidualBf16Epilogue", 1, 1)),
               "fused_attention_block_train": (("qkv", "BiasEpilogue", 3, 1),
                                               ("out-proj", "BiasResidualBf16Epilogue", 1, 1)),
               "fused_mlp_block": (("fc1", "BiasQuickGeluEpilogue", 4, 1),
                                   ("fc2", "BiasResidualF32Epilogue", 1, 4)),
               "fused_mlp_block_train": (("fc1 with h", "BiasQuickGeluHiddenEpilogue", 4, 1),
                                         ("fc2", "BiasResidualF32Epilogue", 1, 4))}


def device_ms(fn, iters=10, expect=()) -> dict:
    """Device time of each kernel that `iters` calls of `fn` launch, by name
    (torch.profiler / CUPTI), in ms per call.  Profiles again (up to four
    times) while no event, or no event matching each regex of `expect`, has
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    sync()
    for attempt in range(4):  # CUPTI now and then hands back no (or not every) device event
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            sync()
        got = {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
        missing = [x for x in expect
                   if not sum(t for key, t in got.items() if re.search(x, key)) > 0]
        if sum(got.values()) > 0 and not missing:
            return got
        log(f"[profile] no device time recorded for {missing or 'any kernel'} (attempt "
            f"{attempt + 1}): profiling again")
    return got


def time_block_gemms(device, card, names, shape=FLAGSHIP) -> dict:
    """Each GEMM of the block kernels `names` alone, read off the profiler
    inside the kernel's own launches at x of `shape`, beside one torch.addmm
    (cuBLAS) on bf16 operands of the same shape, bias included, by CUDA
    events (the profiler has handed back no device event for it in some
    calls); the port never calls the latter.  Returns (kernel, product) ->
    (ms, addmm ms)."""
    from demo2_tpu_torch.ops import fused_block as fb

    x, attn, mlp = block_inputs(shape, device, seed=1)
    kw = dict(num_heads=shape[-1] // 64, scale=64 ** -0.5)
    calls = {"fused_attention_block": lambda: fb.fused_attention_block(x, **attn, **kw),
             "fused_attention_block_train": lambda: fb.fused_attention_block_train(x, **attn, **kw),
             "fused_mlp_block": lambda: fb.fused_mlp_block(x, **mlp),
             "fused_mlp_block_train": lambda: fb.fused_mlp_block_train(x, **mlp)}
    b, s, c = shape
    m = b * s
    g = torch.Generator().manual_seed(3)
    got = {}
    for name in names:
        kernels = device_ms(calls[name], expect=[f"::{epilogue}[,>]"
                                                 for _, epilogue, _, _ in BLOCK_GEMMS[name]])
        for product, epilogue, n_mult, k_mult in BLOCK_GEMMS[name]:
            n, k = n_mult * c, k_mult * c
            ms = sum(t for key, t in kernels.items() if re.search(f"::{epilogue}[,>]", key))
            require(ms > 0, f"{name}: no device time under gemm_sm90_kernel<{epilogue}, ...>")
            a = torch.randn(m, k, generator=g).to(device, torch.bfloat16)
            w = (torch.randn(n, k, generator=g) * k ** -0.5).to(device, torch.bfloat16)
            bias = torch.randn(n, generator=g).to(device, torch.bfloat16)
            lib_ms = cuda_ms(lambda: torch.addmm(bias, a, w.t()))  # one kernel a call
            rate = lambda t: 2 * m * n * k / t / 1e9
            log(f"[gemm] {name} {product} ({m} x {k}) @ ({k} x {n}): {ms:.4f} ms "
                f"({rate(ms):.1f} TFLOP/s); torch.addmm {lib_ms:.4f} ms ({rate(lib_ms):.1f} "
                f"TFLOP/s) ({card})")
            got[(name, product)] = (ms, lib_ms)
    return got


def phase_timing(device, card, cfg, model, plain_cfg, plain) -> dict:
    x, attn, mlp = block_inputs(FLAGSHIP, device, seed=1)
    times = time_kernels({
        name: timed(kernel, lambda plain_fn=plain_fn, weights=weights: plain_fn(x, weights),
                    block_flops(name, FLAGSHIP), FLAGSHIP, [x, *weights.values()])
        for name, (kernel, plain_fn, weights) in kernel_cases(x, attn, mlp).items()}, card)
    time_block_gemms(device, card, ("fused_attention_block", "fused_mlp_block"))
    time_extractor(device, card, cfg, model, plain_cfg, plain)
    return times


def time_extractor(device, card, cfg, model, plain_cfg, plain, label: str = "",
                   names=("kernel path", "plain path")) -> None:
    """Extractor batch-1 latency and batch-64 throughput on both paths
    (`names`), peak memory of the first, a profile of one batch-64 request
    on each."""
    from demo2_tpu_torch.serving import FeatureExtractor

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
    log(f"[time] {label}extractor batch-1 latency (median of 20): {names[0]} {k_lat:.3f} ms, "
        f"{names[1]} {p_lat:.3f} ms ({card})")
    k_tp, p_tp = alternate(lambda: throughput(plain, plain_cfg), lambda: throughput(model, cfg))
    log(f"[time] {label}extractor batch-64: {names[0]} {k_tp:.1f} img/s "
        f"({64e3 / k_tp:.2f} ms a request), {names[1]} {p_tp:.1f} img/s ({64e3 / p_tp:.2f} ms), "
        f"host arrays in and out included ({card})")
    torch.cuda.reset_peak_memory_stats()
    throughput(model, cfg, reps=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[time] {label}peak device memory, {names[0]} at batch 64: {peak:.2f} GiB ({card})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    log(f"[time] after timing: clocks.sm, power.draw, power.limit, temp = {smi}")
    for path, m, c in ((names[0], model, cfg), (names[1], plain, plain_cfg)):
        fx = FeatureExtractor(c, m, device=device, batch_size=64)
        profile(f"{label}{path}, one batch-64 request", lambda: fx.extract(images, cams), card)


def profile(label, fn, card, top=10) -> tuple:
    """Where one call of `fn` spends its time: device time by kernel
    (torch.profiler / CUPTI) against the host clock around the call.
    Returns (host wall ms, device busy ms)."""
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
    return wall_ms, busy_ms


# ---------------------------------------------------------------- phase 5


PROBS_MAX_ABS = 7.8e-3   # 2 bf16 ulps just below 1 (2^-8 each)
PROBS_ROW_SUM = 1e-2     # rows of bf16 probabilities sum to 1 within this
DB_REL = 1e-3            # db vs the f32 column sums of the kernel's own dqkv
# The edges of the tiling of kernels 4 and 7, the packed qkv of phase 9's
# FLASH_EDGE_SHAPES: no padded row, one tile, one key, other head counts; the
# short ones give a block many (sample, head) items.
SAVED_EDGE_SHAPES = ((48, 144, 2304), (192, 16, 2304), (192, 1, 2304), (64, 40, 1152),
                     (5, 77, 576))


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
    out_control, attn_control = _misrounded_attention_block(x, w, plain, kw)
    check_rounding(f"kernel 3 out {tuple(shape)}", got[0], plain[0], out_control)
    check_rounding(f"kernel 3 qkv {tuple(shape)}", got[1], plain[1])
    check_rounding(f"kernel 3 attn {tuple(shape)}", got[2], plain[2],
                   attn_control if s > 1 else None)  # over one key nothing is rounded
    return {"max_abs": max((yk.float() - yp.float()).abs().max().item()
                           for yk, yp in zip(got[:3], plain[:3])),
            "residuals": got}


def _misrounded_attention_block(x, w, plain, kw):
    """Kernel 3's out with the out-projection's residual added in f32 (fc2's
    rounding), and its attn with p rounded after PV (kernel 5's), from the
    plain version's own qkv and attn."""
    from demo2_tpu_torch.ops import fused_block as fb, packed_attention as pa

    _, qkv, attn, _ = plain
    c = x.shape[-1]
    y = fb._mm_f32(attn.reshape(-1, c), w["wout"].t()) + w["bout"].float()
    out = (x.float() + y.reshape(x.shape)).to(x.dtype)
    return out, pa.packed_self_attention_plain(qkv, kw["num_heads"], kw["scale"])


def saved_probs_inputs(shape, device, seed):
    """Kernel 4's inputs at a packed shape (B, S, 3C) without a block around
    them: unit-scale bf16 qkv, the probabilities the plain forward saves for
    it (softmax of the f32 scores, rounded to bf16, zero columns up to S16)
    and a unit cotangent of the attention output."""
    import torch.nn.functional as F

    from demo2_tpu_torch.ops import packed_attention as pa

    b, s, c3 = shape
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *sh: torch.randn(*sh, generator=g).to(device, torch.bfloat16)
    qkv, do = rnd(b, s, c3), rnd(b, s, c3 // 3)
    q, k, _ = _packed_heads(qkv, c3 // 3 // 64)
    p = _softmax_f32(q, k, 64 ** -0.5).to(torch.bfloat16)
    return qkv, F.pad(p, (0, pa.probs_cols(s) - s)).contiguous(), do


def _misrounded_saved_bwd(qkv, probs, do, *, num_heads, scale):
    """Kernel 4 with dS left in f32 for the dQ and dK products (the Pallas
    kernel rounds it to bf16 once, before both): what a kernel that feeds
    its dS registers straight into the next product as hi + lo would compute."""
    s = qkv.shape[1]
    q, k, v = _packed_heads(qkv, num_heads)
    dof = do.reshape(*do.shape[:2], num_heads, -1).transpose(1, 2).float()
    p = probs[..., :s].float()
    dp = dof @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dqkv = (ds @ k * scale, ds.transpose(-1, -2) @ q * scale, p.transpose(-1, -2) @ dof)
    return torch.cat([_merge(_bf16(x)) for x in dqkv], -1).to(qkv.dtype)


def check_train_backward(qkv, probs, do, kw, control: bool = True) -> dict:
    """Kernels 4 and 7 on one set of inputs, as phase 9 holds 5 and 6: dqkv
    within phase 2's bounds and a mean of ROUNDING_MEAN_TOL of the plain
    version, no further from an f32 run than the plain bf16 version; with
    `control`, the misrounded control on the same inputs fails that bound; dqkv
    and db bit-identical over two runs; db within DB_REL of the f32 column
    sums of its own dqkv; kernel 7's dqkv bitwise equal to kernel 4's."""
    from demo2_tpu_torch.ops import packed_attention as pa

    dqkv, db = pa.attention_bwd_saved_db(qkv, probs, do, **kw)
    dqkv_again, db_again = pa.attention_bwd_saved_db(qkv, probs, do, **kw)
    dqkv7 = pa.attention_bwd_saved(qkv, probs, do, **kw)
    plain, _ = pa.attention_bwd_saved_plain(qkv, probs, do, with_db=True, **kw)
    f32, _ = pa.attention_bwd_saved_plain(qkv.float(), probs.float(), do.float(), with_db=True,
                                          **kw)
    wrong = _misrounded_saved_bwd(qkv, probs, do, **kw) if control else None
    sync()
    shape = tuple(qkv.shape)
    d = (dqkv.float() - plain.float()).abs()
    max_abs, mean_abs = d.max().item(), d.mean().item()
    k32, p32 = mean_err(dqkv, f32), mean_err(plain, f32)
    ref_db = dqkv.float().sum((0, 1))
    db_err = (db - ref_db).abs().max().item()
    db_scale = ref_db.abs().max().item()
    log(f"[train-kernel] kernel 4 dqkv {shape}: vs plain bf16 max {max_abs:.3e} "
        f"mean {mean_abs:.3e}; vs f32 kernel {k32:.3e}, plain bf16 {p32:.3e}; db vs "
        f"the f32 column sums of its dqkv: max {db_err:.3e} (max |sum| {db_scale:.3e})")
    require(dqkv.shape == plain.shape and dqkv.dtype == plain.dtype and db.dtype == torch.float32,
            f"kernel 4 {shape}: shape or dtype")
    require(bool(torch.isfinite(dqkv).all()) and bool(torch.isfinite(db).all()),
            f"kernel 4 {shape}: non-finite")
    require(max_abs <= MAX_ABS_TOL, f"kernel 4 {shape}: max abs {max_abs}")
    require(mean_abs <= MEAN_ABS_TOL, f"kernel 4 {shape}: mean abs {mean_abs}")
    require(k32 <= F32_MEAN_RATIO * p32, f"kernel 4 {shape}: less accurate than plain")
    require(mean_abs <= ROUNDING_MEAN_TOL,
            f"kernel 4 {shape}: mean abs {mean_abs} > {ROUNDING_MEAN_TOL}: the kernel rounds "
            f"where its plain version does not")
    if wrong is not None:
        w32, dw = mean_err(wrong, f32), mean_err(wrong, plain)
        log(f"[train-kernel] kernel 4 dqkv {shape}: control with dS left in f32: vs plain bf16 "
            f"mean {dw:.3e}, mean error vs f32 {w32:.3e}")
        require(dw > ROUNDING_MEAN_TOL,
                f"kernel 4 {shape}: the misrounded control is within {ROUNDING_MEAN_TOL} of the "
                f"plain version ({dw}), so the bound cannot tell where a kernel rounds")
    require(db_err <= DB_REL * db_scale, f"kernel 4 {shape}: db off by {db_err}")
    require(torch.equal(dqkv_again, dqkv) and torch.equal(db_again, db),
            f"kernel 4 {shape}: two runs differ in their bits")
    require(torch.equal(dqkv7, dqkv), f"kernel 7 {shape}: dqkv not bitwise equal to kernel 4's")
    log(f"[train-kernel] kernel 4 {shape}: dqkv and db bit-identical over two runs; kernel 7's "
        f"dqkv bitwise equal to kernel 4's")
    return {"max_abs": max_abs}


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


def phase_train_kernels(device, shapes=(FLAGSHIP, BATCH1, PROMPT_SHAPE),
                        edges=SAVED_EDGE_SHAPES) -> dict:
    """Kernels 3, 4 and 7 against their plain versions, and the training
    Function against autograd of the plain block; then kernels 4 and 7 at
    `edges`, the edges of their tiling, on packed qkv with the probabilities
    the plain forward saves (no control over one key: dS is exactly zero there
    and nothing is rounded)."""
    exact_products()
    errors = {}
    for shape in shapes:
        x, p, grad_out = train_kernel_inputs(shape, device, seed=5)
        kw = dict(num_heads=shape[-1] // 64, scale=64 ** -0.5)
        fwd = check_train_forward(x, p, shape, kw)
        _, qkv, _, probs = fwd["residuals"]
        bwd = check_train_backward(qkv, probs, grad_out, kw)
        check_train_function(x, p, grad_out, shape, kw)
        if shape == shapes[0]:
            errors["fused_attention_block_train"] = fwd["max_abs"]
            errors["attention_bwd_saved_db"] = bwd["max_abs"]
            errors["attention_bwd_saved"] = bwd["max_abs"]
    for shape in edges:
        kw = dict(num_heads=shape[-1] // 3 // 64, scale=64 ** -0.5)
        check_train_backward(*saved_probs_inputs(shape, device, seed=9), kw,
                             control=shape[1] > 1)
    log(f"[train-kernel] tolerances: forward as phase 2; probs max abs <= {PROBS_MAX_ABS}, "
        f"row sums within {PROBS_ROW_SUM}, zero past S; dqkv as phase 2 and within a mean of "
        f"{ROUNDING_MEAN_TOL} of the plain version (the misrounded control above it); dqkv and "
        f"the 7 Function grads no further from f32 than {F32_MEAN_RATIO} x the plain bf16 path; "
        f"db within {DB_REL} of max |column sum|; dqkv and db bit-identical over two runs; "
        f"kernel 7 bitwise kernel 4: ok")
    return errors


# ---------------------------------------------------------------- phase 6


TRAIN_IMGS_PER_PID = 8   # RGBNT201-sized cache: 171 ids x 8 = 1,368 samples
TRAIN_STEPS = 20         # an epoch of that cache is 21 PK batches of 64
PLAIN_STEPS = 10
GRAD_COS_MODEL = 0.999
GRAD_COS_BLOCK = 0.99
LOSS_REL = 0.02


def build_train_data(cfg, device, num_pids=NUM_CLASSES):
    """A DeviceCache of SyntheticTriModal at the config's size (the flagship's
    256x128), RGBNT201's 171 train ids (or `num_pids`), and its PK sampler."""
    from demo2_tpu_torch.data.datasets import SyntheticTriModal
    from demo2_tpu_torch.data.device_cache import DeviceCache
    from demo2_tpu_torch.data.sampler import RandomIdentitySampler

    t0 = time.perf_counter()
    ds = SyntheticTriModal(num_pids=num_pids, num_cams=CAMERA_NUM,
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


def block_groups(model):
    """(key prefix of block i, the parameter groups whose step-1 gradient
    cosine is held per block) for the model's backbone."""
    if hasattr(model.backbone.base, "resblocks"):  # CLIP
        return "backbone.base.resblocks.{}.", ("ln_1.", "attn.in_proj_", "attn.out_proj.")
    return "backbone.base.blocks.{}.", ("attn.qkv.", "attn.proj.")


def grads_cosine(gk: dict, gp: dict, prefix: str = "") -> float:
    """The cosine of two gradient dicts over the tensors whose name starts
    with `prefix`."""
    keys = [k for k in gk if k.startswith(prefix)]
    return cosine(torch.cat([gk[k].flatten() for k in keys]),
                  torch.cat([gp[k].flatten() for k in keys]))


def check_step1_grads(cfg, model, plain_cfg, plain, cache, idx, label="train",
                      extra_groups=(), block_min=None, required=True) -> None:
    """Gradients of the first step on the kernel and the plain path, whole
    and per block.  `extra_groups` are further per-block parameter groups to
    hold, `block_min` their cosine bound; with `required` False the cosines
    are printed only (check_backbone_grads holds the kernels then).  Both
    paths take the same weights, batch and draws (the generator seeded
    alike, so that augmentation, dropout and drop path agree)."""
    block_min = GRAD_COS_BLOCK if block_min is None else block_min
    from demo2_tpu_torch.engine.train import loss_and_grads
    from demo2_tpu_torch.losses.losses import make_loss_fn

    from demo2_tpu_torch.engine.state import create_train_state

    grads = []
    for c, m in ((cfg, model), (plain_cfg, plain)):
        gen = torch.Generator(device=cache.images.device).manual_seed(cfg.SOLVER.SEED)
        images, pids, camids = cache.batch(idx, gen)
        # with center loss, the centers a train state starts from (seeded alike)
        centers = (create_train_state(c, m, 1).centers
                   if "center" in c.MODEL.METRIC_LOSS_TYPE else None)
        loss, _, g = loss_and_grads(c, m, make_loss_fn(c, NUM_CLASSES), images, pids, camids,
                                    gen, centers=centers)
        grads.append(g)
        log(f"[{label}] step-1 loss, {'kernel' if c is cfg else 'plain'} path: "
            f"{loss.item():.6f}")
    gk, gp = grads
    whole = grads_cosine(gk, gp)
    prefix, groups = block_groups(model)
    groups = groups + tuple(extra_groups)
    worst = min((grads_cosine(gk, gp, prefix.format(i) + group), prefix.format(i) + group)
                for i in range(num_blocks(model)) for group in groups)
    log(f"[{label}] step-1 gradient cosine, kernel vs plain path: whole model {whole:.6f}; "
        f"lowest block {' / '.join(groups)} {worst[0]:.6f} ({worst[1]})"
        + ("" if required else " (printed, not held)"))
    if required:
        require(whole >= GRAD_COS_MODEL, f"step-1 gradient cosine {whole} < {GRAD_COS_MODEL}")
        require(worst[0] >= block_min, f"{worst[1]} gradient cosine {worst[0]} < {block_min}")


def check_backbone_grads(cfg, model, plain_cfg, plain, cache, idx, label) -> None:
    """The backbone's step-1 parameter gradients on the kernel and the plain
    path from one upstream gradient: the kernel path's gradient of the whole
    step's loss at the backbone's output (patches and globals), run back
    through each path's backbone on the same batch and draws.  Held whole
    (GRAD_COS_MODEL) and per block (GRAD_COS_BLOCK): this isolates the
    kernels from a head whose input gradient is ill-conditioned."""
    from demo2_tpu_torch.engine.train import loss_and_grads
    from demo2_tpu_torch.losses.losses import make_loss_fn

    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    upstream = {}

    def keep(module, args, out):
        for i, t in enumerate(out):
            t.register_hook(lambda g, i=i: upstream.__setitem__(i, g))

    gen = torch.Generator(device=cache.images.device).manual_seed(cfg.SOLVER.SEED)
    images, pids, camids = cache.batch(idx, gen)
    handle = model.backbone.register_forward_hook(keep)
    try:
        loss_and_grads(cfg, model, make_loss_fn(cfg, NUM_CLASSES), images, pids, camids, gen)
    finally:
        handle.remove()
    model.load_state_dict(init)  # undo the heads' BatchNorm updates
    grads = []
    for m in (model, plain):
        gen = torch.Generator(device=cache.images.device).manual_seed(cfg.SOLVER.SEED)
        images, pids, camids = cache.batch(idx, gen)
        out = m.backbone(images.to(m.dtype), camids, None, None, True, gen)
        names, params = zip(*[(k, p) for k, p in m.named_parameters()
                              if k.startswith("backbone.")])
        g = torch.autograd.grad(out, params, grad_outputs=(upstream[0], upstream[1]),
                                allow_unused=True)
        grads.append({k: torch.zeros_like(p) if x is None else x
                      for k, p, x in zip(names, params, g)})
    gk, gp = grads
    whole = grads_cosine(gk, gp)
    prefix, groups = block_groups(model)
    worst = min((grads_cosine(gk, gp, prefix.format(i) + grp), prefix.format(i) + grp)
                for i in range(num_blocks(model)) for grp in groups)
    log(f"[{label}] backbone step-1 gradient cosine from one upstream gradient, kernel vs "
        f"plain path: whole backbone {whole:.6f}; lowest block {' / '.join(groups)} "
        f"{worst[0]:.6f} ({worst[1]})")
    require(whole >= GRAD_COS_MODEL, f"backbone gradient cosine {whole} < {GRAD_COS_MODEL}")
    require(worst[0] >= GRAD_COS_BLOCK, f"{worst[1]} gradient cosine {worst[0]} < "
            f"{GRAD_COS_BLOCK}")


def train_steps(cfg, model, cache, order, steps, per_step=None, states=None):
    """`steps` optimizer steps through build_train_step; per_step(i, rose)
    checks the kernel launches of each step; the train state is appended to
    `states` where that is a list.  Returns the losses."""
    from demo2_tpu_torch.engine.state import create_train_state
    from demo2_tpu_torch.engine.train import build_train_step

    bs = cfg.SOLVER.IMS_PER_BATCH
    state = create_train_state(cfg, model, len(order) // bs)
    if states is not None:
        states.append(state)
    step = build_train_step(cfg, model, state, cache)
    idx = torch.from_numpy(order[: steps * bs].reshape(steps, bs)).to(cache.images.device)
    losses = []
    for i in range(steps):
        before = counts()
        losses.append(step(idx[i])["loss"])
        if per_step is not None:
            per_step(i, {k: v - before[k] for k, v in counts().items()})
    return [x.item() for x in losses]


def phase_train(device, cfg, model, plain_cfg, plain, cache, sampler, per_step_want: dict,
                label: str = "train", extra_groups=(), block_min=None,
                whole_model: bool = True, states=None, steps: int = TRAIN_STEPS,
                hold_losses=None, hold_fall: bool = True) -> dict:
    """`steps` steps through build_train_step, each launching
    `per_step_want` (all twenty kernels' counts), against the plain path.
    Without `whole_model` the step-1 gradient of the two paths is printed
    only, and the backbone's gradient from one upstream gradient is held
    (check_backbone_grads); so are the losses of the two paths, unless
    `hold_losses` holds them all the same.  Without `hold_fall` the fall of
    the loss over the steps is printed only (on both paths).  The kernel
    path's train state is appended to `states` where that is a list.
    Returns the launches of the steps."""
    hold_losses = whole_model if hold_losses is None else hold_losses
    order = sampler.epoch_indices(1)
    bs = cfg.SOLVER.IMS_PER_BATCH
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    plain.load_state_dict(init)
    idx = torch.from_numpy(order[:bs]).to(device)
    check_step1_grads(cfg, model, plain_cfg, plain, cache, idx, label, extra_groups, block_min,
                      required=whole_model)
    if not whole_model:
        model.load_state_dict(init)
        plain.load_state_dict(init)
        check_backbone_grads(cfg, model, plain_cfg, plain, cache, idx, label)
    model.load_state_dict(init)  # undo the BatchNorm updates of the check
    plain.load_state_dict(init)

    def per_step(i, rose):
        if i == 0 or not REHEARSAL:
            require_launches(rose, per_step_want, f"[{label}] train step {i}")

    reset_counts()
    t0 = time.perf_counter()
    losses = train_steps(cfg, model, cache, order, steps, per_step, states)
    wall = time.perf_counter() - t0
    launches = counts()
    log(f"[{label}] main path: {steps} steps of {bs} through build_train_step in "
        f"{wall:.1f} s, launches {launches}")
    log(f"[{label}] kernel path losses: {' '.join(f'{x:.4f}' for x in losses)}")
    require(all(math.isfinite(x) for x in losses), "a non-finite loss")
    after = model.state_dict()
    stale = [k for k, _ in model.named_parameters() if torch.equal(after[k], init[k])]
    require(not stale, f"parameters the steps did not change: {stale}")
    bn = [k for k in after if k.endswith(("running_mean", "running_var"))]
    require(bn and all(not torch.equal(after[k], init[k]) for k in bn),
            "BatchNorm running statistics did not change")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"[{label}] loss falls: mean of the first 5 steps {first:.4f}, of the last 5 "
        f"{last:.4f}" + ("" if hold_fall else " (printed, not held)"))
    if hold_fall:
        require(last < first, "the loss did not fall")

    plain_losses = train_steps(plain_cfg, plain, cache, order, PLAIN_STEPS)
    if not hold_fall:
        log(f"[{label}] plain path: mean of the first 5 steps "
            f"{float(np.mean(plain_losses[:5])):.4f}, of the last 5 "
            f"{float(np.mean(plain_losses[-5:])):.4f} (printed, not held)")
    rel = [abs(k - p) / abs(p) for k, p in zip(losses, plain_losses)]
    log(f"[{label}] plain path losses: {' '.join(f'{x:.4f}' for x in plain_losses)}; "
        f"largest relative difference {max(rel):.4%}"
        + ("" if hold_losses else " (printed, not held)"))
    if hold_losses:
        require(max(rel) <= LOSS_REL, f"kernel vs plain loss differ by {max(rel):.4%}")
    return launches


def phase_input_grad(device, cfg, model, plain, make_cfg=flagship_cfg, form="",
                     ref_chunk=None) -> dict:
    """The input gradient of the summed embedding norms with the weights
    frozen, as demo2_tpu/visualize/saliency.py::gradcam_heatmaps takes it:
    the attention backward needs no db, so it runs kernel 7, and the MLP,
    fused outside training, runs its training form for its backward.  Held,
    as the kernels are, to be no further from an f32 run of the plain path than the
    plain bf16 path is.  `make_cfg` builds the model's config (the f32 run's
    too); `form`: kernels 3 and 7 in that form ("_wide" at 145-256 tokens,
    "_long" past 256).  With `ref_chunk` the two references take the batch
    `ref_chunk` images at a time (an eval forward is per sample, so the
    gradient is the same sum; the f32 run's activations past 256 tokens do
    not fit the card at 64), the kernel path the whole batch in one pass.
    Returns the launches of the pass."""
    from demo2_tpu_torch.models import make_model

    layers = num_blocks(model)
    images, cams = request_images(64, cfg, seed=4)
    f32 = make_model(make_cfg(False, TPU__COMPUTE_DTYPE="float32"), NUM_CLASSES,
                     CAMERA_NUM, device=device, generator=torch.Generator().manual_seed(0))
    plain.load_state_dict(model.state_dict())
    f32.load_state_dict(model.state_dict())
    grads = []
    camids = torch.from_numpy(cams).to(device)
    for m in (model, plain, f32):
        m.requires_grad_(False)
        x = torch.from_numpy(images).to(device).requires_grad_(True)
        if m is model:
            reset_counts()
        chunk = len(x) if m is model or ref_chunk is None else ref_chunk
        for i in range(0, len(x), chunk):
            emb = m(x[i:i + chunk], camids[i:i + chunk], train=False)["embedding"]
            emb.norm(dim=-1).sum().backward()
        del emb
        sync()
        if m is model:
            launches = counts()
        grads.append(x.grad.float())
        m.requires_grad_(True)
    del f32
    want = launch_dict(**{f"fused_attention_block_train{form}": layers,
                          f"attention_bwd_saved{form}": layers},
                       fused_mlp_block_train=layers)
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
    return launches


# ---------------------------------------------------------------- phase 7


def phase_do_train(device, model, cache, sampler, make_cfg=flagship_cfg, per_step=()) -> None:
    """One epoch of do_train with eval over a small synthetic val cache, and
    the best checkpoint saved and reloaded.  `per_step` names the kernels a
    train step launches once per block beside kernels 3 and 4."""
    import tempfile

    from demo2_tpu_torch.data.datasets import SyntheticTriModal
    from demo2_tpu_torch.data.device_cache import DeviceCache
    from demo2_tpu_torch.engine.state import create_train_state
    from demo2_tpu_torch.engine.train import do_train
    from demo2_tpu_torch.models import make_model
    from demo2_tpu_torch.utils.checkpoint import restore_checkpoint

    cfg = make_cfg(True, SOLVER__MAX_EPOCHS=1, SOLVER__EVAL_PERIOD=1, SOLVER__CHECKPOINT_PERIOD=0,
                   SOLVER__LOG_PERIOD=7, TEST__IMS_PER_BATCH=64)
    val_ds = SyntheticTriModal(num_pids=16, num_cams=CAMERA_NUM, imgs_per_pid=4,
                               image_size=tuple(cfg.INPUT.SIZE_TEST), seed=1)
    val_samples = val_ds.query + val_ds.gallery
    val = DeviceCache.from_arrays(val_ds.render_all(val_samples), val_samples, train=False,
                                  cfg=cfg, device=device)
    layers = num_blocks(model)
    bs = cfg.SOLVER.IMS_PER_BATCH
    steps = len(sampler.epoch_indices(1)) // bs
    # With HDM / ATMoE each eval runs return_pattern 1, 2 and 3.
    patterns = 3 if cfg.MODEL.HDM or cfg.MODEL.ATM else 1
    evals = patterns * math.ceil(len(val_samples) / cfg.TEST.IMS_PER_BATCH)
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
        if patterns > 1:
            log(f"[do_train] mAP by return_pattern: 1 (ori) {entry['mAP@1']:.4f}, 2 (moe) "
                f"{entry['mAP@2']:.4f}, 3 (both, decides the best) {entry['mAP']:.4f}")
            require(all(0.0 < entry[k] <= 1.0 for k in ("mAP@1", "mAP@2")),
                    f"mAP of patterns 1 and 2: {entry}")
        want = launch_dict(fused_attention_block=layers * evals,
                           fused_mlp_block=layers * evals,
                           fused_attention_block_train=layers * steps,
                           attention_bwd_saved_db=layers * steps,
                           **{name: layers * steps for name in per_step})
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


QKV_SHAPE = (192, 129, 2304)  # the flagship's packed qkv (3B, S, 3C) at batch 64


def spread(xs) -> str:
    """median [min .. max] of a list of readings."""
    return f"{float(np.median(xs)):.4f} [{min(xs):.4f} .. {max(xs):.4f}]"


def phase_train_timing(device, card, cfg, model, plain_cfg, plain, cache, sampler) -> dict:
    from demo2_tpu_torch.ops import fused_block as fb, packed_attention as pa

    x, p, grad_out = train_kernel_inputs(FLAGSHIP, device, seed=5)
    w = {k: (v.to(torch.bfloat16) if k in ("wqkv", "wout") else v) for k, v in p.items()}
    kw = dict(num_heads=HEADS, scale=(FLAGSHIP[-1] // HEADS) ** -0.5)
    _, qkv, _, probs = fb.fused_attention_block_train(x, **w, **kw)
    saved = [qkv, probs, grad_out]
    cases = {
        "fused_attention_block_train": (lambda: fb.fused_attention_block_train(x, **w, **kw),
                                        lambda: fb.attention_block_train_plain(x, **w, **kw),
                                        [x, *w.values()]),
        "attention_bwd_saved_db": (
            lambda: pa.attention_bwd_saved_db(qkv, probs, grad_out, **kw),
            lambda: pa.attention_bwd_saved_plain(qkv, probs, grad_out, with_db=True, **kw),
            saved),
        "attention_bwd_saved": (
            lambda: pa.attention_bwd_saved(qkv, probs, grad_out, **kw),
            lambda: pa.attention_bwd_saved_plain(qkv, probs, grad_out, with_db=False, **kw),
            saved),
    }
    times = time_kernels({name: timed(kern, plain_fn, train_kernel_flops(name, FLAGSHIP),
                                      FLAGSHIP, inputs)
                          for name, (kern, plain_fn, inputs) in cases.items()}, card)
    time_block_gemms(device, card, ("fused_attention_block_train", "fused_mlp_block_train"))
    time_train_step(device, card, cfg, model, plain_cfg, plain, cache, sampler)
    return times


def time_train_step(device, card, cfg, model, plain_cfg, plain, cache, sampler,
                    label: str = "", names=("kernel path", "plain path"),
                    profiles: bool = True, reps: int = 5) -> None:
    """The train step in ms and img/s on both paths (`names`) in turns (each
    turn the mean of `reps` steps after 2), the peak memory of a step and,
    with `profiles`, a profile of one step on each path."""
    from demo2_tpu_torch.engine.state import create_train_state
    from demo2_tpu_torch.engine.train import build_train_step

    bs = cfg.SOLVER.IMS_PER_BATCH
    order = sampler.epoch_indices(2)
    idx = torch.from_numpy(order[: 8 * bs].reshape(8, bs)).to(device)

    def stepper(c, m):
        step = build_train_step(c, m, create_train_state(c, m, len(order) // bs), cache)
        return lambda i: step(idx[i % len(idx)])

    steppers = {names[0]: stepper(cfg, model), names[1]: stepper(plain_cfg, plain)}

    def step_ms(which):
        run = steppers[which]
        for i in range(2):
            run(i)
        sync()
        t0 = time.perf_counter()
        for i in range(reps):
            run(i)
        sync()
        return (time.perf_counter() - t0) * 1e3 / reps

    # In turns; the four readings are printed, since the host sets the step
    # and two readings of one path differ by more than some pairs of paths.
    p1, k1, k2, p2 = step_ms(names[1]), step_ms(names[0]), step_ms(names[0]), step_ms(names[1])
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    log(f"[time] {label}train step, batch {bs}: {names[0]} {k_ms:.2f} ms "
        f"({1e3 * bs / k_ms:.1f} img/s), {names[1]} {p_ms:.2f} ms ({1e3 * bs / p_ms:.1f} img/s); "
        f"turns {names[1]} {p1:.2f}, {names[0]} {k1:.2f}, {names[0]} {k2:.2f}, {names[1]} "
        f"{p2:.2f} ms ({card})")
    for which in names:
        torch.cuda.reset_peak_memory_stats()
        steppers[which](0)
        sync()
        log(f"[time] {label}peak device memory of a train step, {which}: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    for which in names if profiles else ():
        profile(f"{label}{which}, one train step of {bs}", lambda: steppers[which](1),
                card, top=14)


# ---------------------------------------------------------------- phase 9


PACKED_SHAPES = ((192, 129, 2304), (3, 129, 2304))       # qkv (3B, S, 3C)
FLASH_SHAPES = ((192, 129, 12, 64), (3, 129, 12, 64))     # q, k, v (3B, S, H, D)
# The edges of the tiling of kernels 5, 6, 9 and 10 (one warp per 16 rows of
# one (sample, head), nine at most): no padded row, one tile, one key, other
# head counts.  All but the last give a block several (sample, head) items,
# and the short ones put a warp's consecutive tasks many items apart.  Kernels
# 5 and 6 take the packed qkv of the same sizes, (B, S, 3 * H * D).
FLASH_EDGE_SHAPES = ((48, 144, 12, 64), (192, 16, 12, 64), (192, 1, 12, 64), (64, 40, 6, 64),
                     (5, 77, 3, 64))


# The recomputing backwards sum in a fixed order, without atomics.
BITWISE_RERUN = ("packed_attention_bwd", "flash_attention_bwd", "packed_attention_wide_bwd")


def as_tuple(y):
    return y if isinstance(y, tuple) else (y,)


def attention_kernel_cases(device, packed_shape, flash_shape, seed):
    """Kernels 5, 6, 9 and 10 with their plain versions: name -> (kernel
    call, plain version, its inputs, FLOPs, the library call).  Unit-scale
    bf16 inputs (what the qkv Linear of a LayerNormed x gives at init) and
    unit cotangents.  The library call is scaled_dot_product_attention on
    (B, H, S, D) views of the same inputs, and for the backward kernels the
    autograd backward of its output; it is a yardstick for the timing phase
    and runs nowhere in the port."""
    import torch.nn.functional as F

    from demo2_tpu_torch.ops import flash_attention as fa, packed_attention as pa

    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g).to(device, torch.bfloat16)
    b, s, c3 = packed_shape
    h, scale = c3 // 3 // 64, 64 ** -0.5
    qkv, do = rnd(b, s, c3), rnd(b, s, c3 // 3)
    q, k, v, dof = (rnd(*flash_shape) for _ in range(4))
    fb_, fs, fh, fd = flash_shape
    pk = dict(num_heads=h, scale=scale)

    def sdpa(heads, cotangent):
        """(forward call, backward call) of the library's attention on
        head-major views; the backward differentiates one kept forward."""
        qh, kh, vh = (x.detach().requires_grad_(True) for x in heads)
        fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        if not qh.is_cuda:
            return fwd, None
        out = fwd()
        return fwd, lambda: torch.autograd.grad(out, (qh, kh, vh), cotangent, retain_graph=True)

    packed_heads = [x.reshape(b, s, h, 64).transpose(1, 2) for x in qkv.split(c3 // 3, -1)]
    packed_lib = sdpa(packed_heads, do.reshape(b, s, h, 64).transpose(1, 2))
    flash_lib = sdpa([x.transpose(1, 2) for x in (q, k, v)], dof.transpose(1, 2))
    return {
        "packed_attention_fwd": (lambda: pa.packed_attention_fwd(qkv, **pk),
                                 lambda *x: pa.packed_self_attention_plain(*x, h, scale),
                                 (qkv,), 4 * b * s * s * c3 // 3, packed_lib[0]),
        "packed_attention_bwd": (lambda: pa.packed_attention_bwd(qkv, do, **pk),
                                 lambda *x: pa.packed_attention_bwd_plain(*x, h, scale),
                                 (qkv, do), 10 * b * s * s * c3 // 3, packed_lib[1]),
        "flash_attention_fwd": (lambda: fa.flash_attention_fwd(q, k, v, scale=scale),
                                lambda *x: fa.flash_attention_plain(*x, scale=scale),
                                (q, k, v), 4 * fb_ * fs * fs * fh * fd, flash_lib[0]),
        "flash_attention_bwd": (lambda: fa.flash_attention_bwd(q, k, v, dof, scale=scale),
                                lambda *x: fa.flash_attention_bwd_plain(*x, scale=scale),
                                (q, k, v, dof), 10 * fb_ * fs * fs * fh * fd, flash_lib[1]),
    }


def compare_cases(device, block_shape=FLAGSHIP, packed_shape=PACKED_SHAPES[0],
                  flash_shape=FLASH_SHAPES[0], jaccard_size=None, qkv_shape=None,
                  wide_shapes=None, long_shape=None, seed=7) -> dict:
    """Kernels 1, 2, 2-train, 3, 5, 6, 9, 10, 12 (at JACCARD_SIZES[0] on the
    clustered weights), 8, 4 and 7 (at QKV_SHAPES[0]), the wide pair of 5
    and 6 (by default at WIDE_SHAPES and WIDE_LONG_SHAPES, named by S and
    the head width) and kernels 1, 3, 4 and 7 past the register tiles (by
    default at LONG_SHAPE, named "block S": their wide forms) on fixed
    inputs, as tools/compare_trees.py times them: name -> one call of the
    kernel's wrapper.  Only the wrappers' public signatures are used, so the
    same cases run against the package of any checkout of the port."""
    from demo2_tpu_torch.ops import fused_block as fb, packed_attention as pa
    from demo2_tpu_torch.utils import reranking as rr

    x, attn, mlp = block_inputs(block_shape, device, seed)
    kw = dict(num_heads=block_shape[-1] // 64, scale=64 ** -0.5)
    cases = {"fused_attention_block": lambda: fb.fused_attention_block(x, **attn, **kw),
             "fused_mlp_block": lambda: fb.fused_mlp_block(x, **mlp),
             "fused_attention_block_train": lambda: fb.fused_attention_block_train(x, **attn, **kw),
             "fused_mlp_block_train": lambda: fb.fused_mlp_block_train(x, **mlp)}
    attention = attention_kernel_cases(device, packed_shape, flash_shape, seed)
    cases.update({name: case[0] for name, case in attention.items()})
    vq, v = rerank_weights(*(jaccard_size or JACCARD_SIZES[0]), device)
    cases["jaccard_min_sum"] = lambda: rr.jaccard_min_sum(vq, v)
    dw_inputs, dw_kw = fused_dw_inputs(qkv_shape or QKV_SHAPES[0], device, seed)
    cases["attention_bwd_fused_dw"] = lambda: pa.attention_bwd_fused_dw(*dw_inputs, **dw_kw)
    cases["attention_bwd_saved_db"] = lambda: pa.attention_bwd_saved_db(*dw_inputs[:3], **dw_kw)
    cases["attention_bwd_saved"] = lambda: pa.attention_bwd_saved(*dw_inputs[:3], **dw_kw)
    for shape in wide_shapes or WIDE_SHAPES + WIDE_LONG_SHAPES:
        for name, case in wide_attention_cases(device, shape, seed).items():
            cases[f"{name} {shape[1]}x{shape[2] // 3 // shape[3]}"] = case[0]
    cases.update(block_cases(device, long_shape or LONG_SHAPE, seed))
    return cases


def block_cases(device, shape, seed=7) -> dict:
    """Kernels 1, 3, 4 and 7 at x `shape` (B, S, C), each named "block S",
    through the wrappers that route by S."""
    from demo2_tpu_torch.ops import fused_block as fb, packed_attention as pa

    b, s, c = shape
    x, attn, _ = block_inputs(shape, device, seed)
    saved = saved_probs_inputs((b, s, 3 * c), device, seed)
    kw = dict(num_heads=c // 64, scale=64 ** -0.5)
    return {f"fused_attention_block block {s}": lambda: fb.fused_attention_block(x, **attn, **kw),
            f"fused_attention_block_train block {s}":
                lambda: fb.fused_attention_block_train(x, **attn, **kw),
            f"attention_bwd_saved_db block {s}": lambda: pa.attention_bwd_saved_db(*saved, **kw),
            f"attention_bwd_saved block {s}": lambda: pa.attention_bwd_saved(*saved, **kw)}


# The block kernels' long forms in tools/compare_trees.py: the 256x256 and
# 384x128 crops at stride 12, batch 64 ("block 442", "block 311").
LONGER_COMPARE_SHAPES = ((192, 442, 768), (64, 311, 768))


def longer_compare_cases(device, shapes=LONGER_COMPARE_SHAPES, seed=7) -> dict:
    """block_cases at `shapes`: kernels 1, 3, 4 and 7 past 256 tokens, which
    tools/compare_trees.py times beside compare_cases (a checkout whose
    kernels stop at 256 tokens refuses them)."""
    cases = {}
    for shape in shapes:
        cases.update(block_cases(device, shape, seed))
    return cases


def long_yardstick(device, card, shape=LONGER_COMPARE_SHAPES[0], calls=10, seed=7) -> str:
    """The yardstick of a well-made attention at the long forms' shape, as
    tools/compare_trees.py --yardstick reads it in each checkout:
    scaled_dot_product_attention's forward on q, k, v (B, H, S, 64) bf16 and
    the autograd backward of one kept forward (CUDA events; the port never
    calls it), and the profiler's rows of `calls` calls each of kernels 1, 3,
    4 and 7 at x `shape`, whose attention launch (launch 3 of kernels 1 and
    3) stands beside it.  Returns the summary line."""
    import torch.nn.functional as F

    b, s, c = shape
    h = c // 64
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, s, 64, generator=g).to(device, torch.bfloat16)
                   for _ in range(4))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    fwd = lambda: F.scaled_dot_product_attention(q, k, v, scale=64 ** -0.5)
    out = fwd()
    bwd = lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True)
    fwd_ms = [cuda_ms(fwd), cuda_ms(fwd)]
    bwd_ms = [cuda_ms(bwd), cuda_ms(bwd)]
    flops = 4 * b * h * s * s * 64
    line = (f"sdpa at q, k, v {(b, h, s, 64)}: forward {spread(fwd_ms)} ms "
            f"({flops / min(fwd_ms) / 1e9:.1f} TFLOP/s), backward {spread(bwd_ms)} ms "
            f"({2.5 * flops / min(bwd_ms) / 1e9:.1f} TFLOP/s)")
    for name, call in block_cases(device, shape, seed).items():
        call()
        profile(f"{name}, {calls} calls", lambda: [call() for _ in range(calls)], card, top=6)
    return f"{line} ({card})"


def digest(y) -> str:
    """The first 12 hex digits of the SHA-1 of a call's output tensors'
    bytes: two checkouts whose digests agree gave the same bits."""
    import hashlib

    h = hashlib.sha1()
    for t in as_tuple(y):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _softmax_f32(q, k, scale):
    s = (q @ k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / (e.sum(-1, keepdim=True) + 1e-30)


def _packed_heads(qkv, h):
    """(B, S, 3C) -> q, k, v (B, H, S, D) in f32."""
    b, s, c3 = qkv.shape
    return (x.reshape(b, s, h, -1).transpose(1, 2).float() for x in qkv.split(c3 // 3, -1))


def _merge(t):
    """(B, H, S, D) -> (B, S, H*D)."""
    return t.transpose(1, 2).flatten(2)


def _misrounded_packed_fwd(qkv, h, scale):
    """Kernel 5 with kernel 1's rounding point: p normalised, then rounded
    to bf16 for PV (the Pallas kernel rounds the unnormalised exp)."""
    q, k, v = _packed_heads(qkv, h)
    return _merge(_bf16(_softmax_f32(q, k, scale)) @ v).to(qkv.dtype)


def _misrounded_packed_bwd(qkv, do, h, scale):
    """Kernel 6 with dS from the bf16 p, as kernel 4 takes it from the saved
    probs (the Pallas kernel takes dS from the f32 p)."""
    q, k, v = _packed_heads(qkv, h)
    dof = do.reshape(*do.shape[:2], h, -1).transpose(1, 2).float()
    pb = _bf16(_softmax_f32(q, k, scale))
    dp = dof @ v.transpose(-1, -2)
    ds = _bf16(pb * (dp - (dp * pb).sum(-1, keepdim=True)))
    dqkv = (ds @ k * scale, ds.transpose(-1, -2) @ q * scale, pb.transpose(-1, -2) @ dof)
    return torch.cat([_merge(_bf16(x)) for x in dqkv], -1).to(qkv.dtype)


def _misrounded_flash_fwd(q, k, v, *, scale):
    """Kernel 9 with p rounded to bf16 for PV, as JAX's off-TPU fallback
    rounds it (the Pallas kernel keeps p in f32)."""
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    return (_bf16(_softmax_f32(qf, kf, scale)) @ vf).transpose(1, 2).to(q.dtype)


def _misrounded_flash_bwd(q, k, v, do, *, scale):
    """Kernel 10 with p rounded to bf16 for dV and dS (the Pallas kernel
    keeps it in f32)."""
    qf, kf, vf, dof = (x.float().transpose(1, 2) for x in (q, k, v, do))
    pb = _bf16(_softmax_f32(qf, kf, scale))
    dp = dof @ vf.transpose(-1, -2)
    ds = pb * (dp - (dp * pb).sum(-1, keepdim=True))
    grads = (ds @ kf * scale, ds.transpose(-1, -2) @ qf * scale, pb.transpose(-1, -2) @ dof)
    return tuple(x.transpose(1, 2).to(q.dtype) for x in grads)


def misrounded_controls(num_heads, scale) -> dict:
    """For each of kernels 5, 6, 9 and 10, its plain version rounding at a
    point where the Pallas kernel does not: what a kernel copied from the
    wrong tile would compute."""
    return {"packed_attention_fwd": lambda qkv: _misrounded_packed_fwd(qkv, num_heads, scale),
            "packed_attention_bwd": lambda qkv, do: _misrounded_packed_bwd(qkv, do, num_heads,
                                                                           scale),
            "flash_attention_fwd": lambda *x: _misrounded_flash_fwd(*x, scale=scale),
            "flash_attention_bwd": lambda *x: _misrounded_flash_bwd(*x, scale=scale)}


def check_attention_case(name, case, control, errors=None) -> None:
    """One kernel of phase 9 at one shape against its plain version, the f32
    run of it and (where `control` is given) the misrounded control."""
    kernel, plain, inputs, _, _ = case
    got = as_tuple(kernel())
    ref = as_tuple(plain(*inputs))
    f32 = as_tuple(plain(*(x.float() for x in inputs)))
    wrong = as_tuple(control(*inputs)) if control is not None else (None,) * len(got)
    again = as_tuple(kernel()) if name in BITWISE_RERUN else ()
    sync()
    shape = tuple(inputs[0].shape)
    worst = 0.0
    for i, (yk, yp, y32, yw) in enumerate(zip(got, ref, f32, wrong)):
        what = f"{name} output {i} {shape}"
        d = (yk.float() - yp.float()).abs()
        k32, p32 = mean_err(yk, y32), mean_err(yp, y32)
        log(f"[attn-kernel] {what}: vs plain bf16 max {d.max().item():.3e} mean "
            f"{d.mean().item():.3e}; mean error vs f32 kernel {k32:.3e}, plain bf16 "
            f"{p32:.3e} (mean |f32| {y32.abs().mean().item():.3e})")
        require(yk.shape == yp.shape and yk.dtype == yp.dtype, f"{what}: shape or dtype")
        require(bool(torch.isfinite(yk).all()), f"{what}: non-finite")
        require(d.max().item() <= MAX_ABS_TOL, f"{what}: max abs {d.max().item()}")
        require(d.mean().item() <= MEAN_ABS_TOL, f"{what}: mean abs {d.mean().item()}")
        require(k32 <= F32_MEAN_RATIO * p32,
                f"{what}: {k32} > {F32_MEAN_RATIO} x the plain bf16 path's {p32}")
        require(d.mean().item() <= ROUNDING_MEAN_TOL,
                f"{what}: mean abs {d.mean().item()} > {ROUNDING_MEAN_TOL}: the kernel "
                f"rounds where its plain version does not")
        if yw is not None:
            w32, dw = mean_err(yw, y32), mean_err(yw, yp)
            log(f"[attn-kernel] {what}: control rounding at the wrong point: vs plain "
                f"bf16 mean {dw:.3e}, mean error vs f32 {w32:.3e} ({w32 / p32:.3f} x the "
                f"plain's)")
            require(dw > ROUNDING_MEAN_TOL,
                    f"{what}: the misrounded control is within {ROUNDING_MEAN_TOL} of the "
                    f"plain version ({dw}), so the bound cannot tell where a kernel rounds")
        worst = max(worst, d.max().item())
    for i, (a, b) in enumerate(zip(got, again)):
        require(torch.equal(a, b), f"{name} output {i} {shape}: two runs differ")
    if again:
        log(f"[attn-kernel] {name} {shape}: every output bit-identical over two runs")
    if errors is not None:
        errors[name] = worst


def phase_attention_kernels(device, shapes=tuple(zip(PACKED_SHAPES, FLASH_SHAPES)),
                            flash_edges=FLASH_EDGE_SHAPES) -> dict:
    """Kernels 5, 6, 9 and 10 against their plain versions: every output
    within the bounds of phase 2 of the plain bf16 version, no further from
    an f32 run of the plain version than the plain bf16 version is, and
    within a mean of ROUNDING_MEAN_TOL of the plain version.  The controls,
    plain versions rounding at the wrong point, must fail that last bound on
    the same inputs.  The outputs of kernels 6 and 10 are bit-identical over
    two runs.  Then all four at `flash_edges`, the edges of their tiling
    (kernels 5 and 6 on the packed qkv of the same sizes), within the same
    bounds (the controls at the main shapes only: over one key every
    probability is exactly 1 and nothing is rounded).  Returns name -> the
    kernel's max abs error at the first shape."""
    errors = {}
    for packed_shape, flash_shape in shapes:
        cases = attention_kernel_cases(device, packed_shape, flash_shape, seed=7)
        controls = misrounded_controls(packed_shape[2] // 3 // 64, 64 ** -0.5)
        for name, case in cases.items():
            check_attention_case(name, case, controls[name],
                                 errors if packed_shape == shapes[0][0] else None)
    for flash_shape in flash_edges:
        b, s, h, d = flash_shape
        cases = attention_kernel_cases(device, (b, s, 3 * h * d), flash_shape, seed=9)
        for name, case in cases.items():
            check_attention_case(name, case, None)
    log(f"[attn-kernel] tolerances: max abs <= {MAX_ABS_TOL}, mean abs <= {MEAN_ABS_TOL}, "
        f"mean error vs f32 <= {F32_MEAN_RATIO} x the plain bf16 path's, mean abs <= "
        f"{ROUNDING_MEAN_TOL} (every misrounded control above it): ok")
    return errors


# The wide pair of kernels 5 and 6 (csrc/packed_attention_wide.cu): qkv
# (3B, S, 3C) and the head count.  Stride 12 at 256x128 gives 211 tokens, in
# vit_base's 12 heads of 64 and vit_small's 8 of 96; vit_small at stride 16
# has 129.  The edges: one key, one 16-row tile, the first S past the
# register tiles' 144, the longest S (256), each with many (sample, head)
# items, and heads of 64 at a length the register pair also takes.
# WIDE_LONG_SHAPES, the longest S at batch 192, give each block of the
# persistent grid 11-12 (8 heads of 96) or 17-18 (12 heads of 64) items, so
# that every slot of the operand ring and of the statistics is reused many
# times over.
WIDE_SHAPES = ((192, 211, 2304, 12), (192, 211, 2304, 8), (192, 129, 2304, 8))
WIDE_LONG_SHAPES = ((192, 256, 2304, 8), (192, 256, 2304, 12))
WIDE_EDGE_SHAPES = ((192, 1, 2304, 8), (192, 16, 2304, 8), (48, 145, 2304, 12),
                    (24, 256, 2304, 8), (16, 256, 2304, 12), (64, 40, 1152, 6),
                    *WIDE_LONG_SHAPES)


def wide_scale(c: int, num_heads: int) -> float:
    """The softmax scale the shape's backbone uses: vit_small's qk_scale
    768^-0.5 for heads of 96 (not a power of two), 1 / sqrt(64) else."""
    return c ** -0.5 if c // num_heads == 96 else (c // num_heads) ** -0.5


def wide_attention_cases(device, shape, seed):
    """The wide pair with its plain versions, as attention_kernel_cases gives
    kernels 5 and 6 (the library call: scaled_dot_product_attention on
    head-major views, and the autograd backward of its output)."""
    import torch.nn.functional as F

    from demo2_tpu_torch.ops import packed_attention as pa

    b, s, c3, h = shape
    c = c3 // 3
    scale = wide_scale(c, h)
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *sh: torch.randn(*sh, generator=g).to(device, torch.bfloat16)
    qkv, do = rnd(b, s, c3), rnd(b, s, c)
    heads = [x.reshape(b, s, h, c // h).transpose(1, 2).detach().requires_grad_(True)
             for x in qkv.split(c, -1)]
    library_fwd = lambda: F.scaled_dot_product_attention(*heads, scale=scale)
    library_bwd = None
    if qkv.is_cuda:
        out = library_fwd()
        cot = do.reshape(b, s, h, c // h).transpose(1, 2)
        library_bwd = lambda: torch.autograd.grad(out, heads, cot, retain_graph=True)
    pk = dict(num_heads=h, scale=scale)
    return {
        "packed_attention_wide_fwd": (lambda: pa.packed_attention_wide_fwd(qkv, **pk),
                                      lambda *x: pa.packed_self_attention_plain(*x, h, scale),
                                      (qkv,), 4 * b * s * s * c, library_fwd),
        "packed_attention_wide_bwd": (lambda: pa.packed_attention_wide_bwd(qkv, do, **pk),
                                      lambda *x: pa.packed_attention_bwd_plain(*x, h, scale),
                                      (qkv, do), 10 * b * s * s * c, library_bwd),
    }


def phase_wide_attention_kernels(device, shapes=WIDE_SHAPES, edges=WIDE_EDGE_SHAPES) -> dict:
    """The wide pair of kernels 5 and 6 within phase 9's bounds of their
    plain versions (ROUNDING_MEAN_TOL, which kernel 5's and 6's misrounded
    controls fail on the same inputs), the backward bit-identical over two
    runs, at WIDE_SHAPES and at the edges; then packed_attention_fwd / _bwd
    at a wide shape, which must launch the wide pair and not the register
    pair.  Returns name -> the max abs error at the first shape."""
    from demo2_tpu_torch.ops import packed_attention as pa

    errors = {}
    for shape in shapes:
        b, s, c3, h = shape
        controls = misrounded_controls(h, wide_scale(c3 // 3, h))
        for name, case in wide_attention_cases(device, shape, seed=7).items():
            check_attention_case(name, case, controls[name.replace("_wide", "")],
                                 errors if shape == shapes[0] else None)
    for shape in edges:
        for name, case in wide_attention_cases(device, shape, seed=9).items():
            check_attention_case(name, case, None)
    b, s, c3, h = shapes[0]
    qkv = torch.randn(4, s, c3, generator=torch.Generator().manual_seed(3)).to(device,
                                                                              torch.bfloat16)
    kw = dict(num_heads=h, scale=wide_scale(c3 // 3, h))
    reset_counts()
    pa.packed_attention_bwd(qkv, pa.packed_attention_fwd(qkv, **kw), **kw)
    sync()
    require_launches(counts(), launch_dict(packed_attention_wide_fwd=1,
                                           packed_attention_wide_bwd=1),
                     f"[attn-wide] packed_attention_fwd / _bwd at qkv {(4, s, c3)}, {h} heads")
    log(f"[attn-wide] the wide pair at {len(shapes)} shapes and {len(edges)} edges within "
        f"the bounds, its backward bit-identical over two runs; the dispatch at S = {s}: ok")
    return errors


# ---------------------------------------------------------------- phase 10


def phase_head_major(device, shape=FLASH_SHAPES[0]) -> dict:
    """The head-major route: attention_core(..., implementation="pallas") and
    MultiHeadAttention's cross-attention of equal lengths, forward and
    backward, each launching kernels 9 and 10 once, against the plain route
    (implementation="xla") on the same inputs and weights.  Returns the
    launches of both."""
    from demo2_tpu_torch.ops.attention import MultiHeadAttention, attention_core

    b, s, h, d = shape
    c = h * d
    g = torch.Generator().manual_seed(11)
    rnd = lambda *sh: torch.randn(*sh, generator=g).to(device, torch.bfloat16)
    q, k, v, dout = (rnd(b, s, h, d) for _ in range(4))
    query, kv, gy = rnd(b, s, c), rnd(b, s, c), rnd(b, s, c)

    def core(impl):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        y = attention_core(*leaves, scale=d ** -0.5, implementation=impl)
        y.backward(dout)
        return [y] + [x.grad for x in leaves]

    def mha(impl):
        m = MultiHeadAttention(c, h, dtype=torch.bfloat16, device=device,
                               generator=torch.Generator().manual_seed(12), implementation=impl)
        x, y_kv = query.clone().requires_grad_(True), kv.clone().requires_grad_(True)
        y = m(x, y_kv)
        y.backward(gy)
        return [y, x.grad, y_kv.grad, m.in_proj_weight.grad]

    total = launch_dict()
    for name, fn in (("attention_core", core), ("MultiHeadAttention cross", mha)):
        reset_counts()
        got = fn("pallas")
        sync()
        launches = counts()
        ref = fn("xla")
        sync()
        require_launches(launches, launch_dict(flash_attention_fwd=1, flash_attention_bwd=1),
                         f"[head-major] {name}")
        total = {k: total[k] + launches[k] for k in total}
        for what, a, r in zip(("output", "grad 1", "grad 2", "grad 3"), got, ref):
            cos = cosine(a.float(), r.float())
            log(f"[head-major] {name} {what} {tuple(a.shape)}: cosine to the plain route "
                f"{cos:.6f}")
            require(bool(torch.isfinite(a).all()), f"[head-major] {name} {what}: non-finite")
            require(cos >= COSINE_MIN, f"[head-major] {name} {what}: cosine {cos} < {COSINE_MIN}")
    log(f"[head-major] main path: launches {total}")
    return total


# ---------------------------------------------------------------- phases 11-13


def phase_vit_timing(device, card, cfg, model, plain_cfg, plain, cache, sampler) -> dict:
    """Kernels 5, 6, 9 and 10 against their plain versions with TFLOP/s and
    beside the library's call, the extractor at batch 1 and 64, and the ViT
    train step, each on both paths in turns."""
    cases = attention_kernel_cases(device, PACKED_SHAPES[0], FLASH_SHAPES[0], seed=7)
    times = time_kernels({
        name: timed(kernel, lambda plain_fn=plain_fn, inputs=inputs: plain_fn(*inputs), flops,
                    tuple(inputs[0].shape), inputs, library)
        for name, (kernel, plain_fn, inputs, flops, library) in cases.items()}, card)
    time_extractor(device, card, cfg, model, plain_cfg, plain, label="ViT ")
    time_train_step(device, card, cfg, model, plain_cfg, plain, cache, sampler, label="ViT ")
    return times


# ---------------------------------------------------------------- phase 14


LN_BWD_SHAPES = ((24768, 768), (387, 768))  # the rows of x (192, 129, 768) and (3, 129, 768)
LN_EPS = 1e-5
LN_SUM_REL = 1e-3      # dweight / dbias vs the plain version's, of their largest
# Kernel and plain version both sum in f32, in different orders; where both sit
# at f32 rounding of the f64 result, their ratio is noise.  An error within
# 1e-6 of the output's largest value passes whatever the plain version's is.
F32_ROUNDING_FLOOR = 1e-6
# (queries, gallery): n = 4,800 at dataset scale, phase 16's eval, a ragged 333
JACCARD_SIZES = ((1600, 3200), (80, 240), (70, 263))
JACCARD_TOL = 1e-6     # values lie in [0, 1]; the two sum 4,800 f32 terms in different orders
# Where every one of the 4,800 terms is non-zero (uniform weights, full edge
# rows), the ascending sum of ~0.67 takes 4,800 roundings against the plain
# version's tree: 3.9e-6 apart on uniform weights at 1,600 x 4,800 (phase 14
# on an H100).
JACCARD_DENSE_TOL = 1e-5
# (queries, gallery, depth) of kernel 12's edges: one query row over four
# gallery tiles (512 rows each) and an odd depth, one gallery row, depth 7,
# depth that is no multiple of 4 over three tiles (edge_weights' rows).
JACCARD_EDGES = ((1, 1, 7), (1, 1537, 4801), (37, 1, 333), (5, 1100, 4802))


def ln_bwd_inputs(shape, device, seed, dtype=torch.bfloat16):
    """x off-centre and wider than unit scale, a unit cotangent, an
    init-scale f32 weight."""
    g = torch.Generator().manual_seed(seed)
    r, c = shape
    x = (torch.randn(r, c, generator=g) * 1.5 + 0.3).to(device, dtype)
    dy = torch.randn(r, c, generator=g).to(device, dtype)
    return x, dy, (1 + 0.1 * torch.randn(c, generator=g)).to(device)


def ln_bwd_f64(x, dy, weight, eps):
    """The LayerNorm backward in f64: the reference both versions are held to."""
    xd, dyd, g = x.double(), dy.double(), weight.double()
    mean = xd.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xd - mean).square().mean(-1, keepdim=True) + eps)
    xhat = (xd - mean) * rstd
    dyg = dyd * g
    dx = rstd * (dyg - dyg.mean(-1, keepdim=True) - xhat * (dyg * xhat).mean(-1, keepdim=True))
    return dx, (dyd * xhat).sum(0), dyd.sum(0)


def phase_ln_bwd_kernel(device, cases=None) -> dict:
    """Kernel 11 against its plain version and an f64 computation: bf16 at
    both main-path shapes, f32 at the small one.  Returns its max abs dx
    error at the first case."""
    from demo2_tpu_torch.ops import norm

    if cases is None:
        cases = tuple((shape, torch.bfloat16) for shape in LN_BWD_SHAPES) + (
            (LN_BWD_SHAPES[1], torch.float32),)
    errors = {}
    for shape, dtype in cases:
        x, dy, w = ln_bwd_inputs(shape, device, seed=13, dtype=dtype)
        got = norm.layernorm_bwd(x, dy, w, LN_EPS)
        again = norm.layernorm_bwd(x, dy, w, LN_EPS)
        plain = norm.layernorm_bwd_plain(x, dy, w, LN_EPS)
        f64 = ln_bwd_f64(x, dy, w, LN_EPS)
        sync()
        what = f"kernel 11 {tuple(shape)} {str(dtype).split('.')[-1]}"
        for name, yk, yp, y64 in zip(("dx", "dweight", "dbias"), got, plain, f64):
            d = (yk.double() - yp.double()).abs()
            k64 = (yk.double() - y64).abs().mean().item()
            p64 = (yp.double() - y64).abs().mean().item()
            scale = y64.abs().max().item()
            log(f"[ln-bwd] {what} {name}: vs plain max {d.max().item():.3e} mean "
                f"{d.mean().item():.3e}; mean error vs f64 kernel {k64:.3e}, plain {p64:.3e} "
                f"(max |f64| {scale:.3e})")
            require(bool(torch.isfinite(yk).all()), f"{what} {name}: non-finite")
            require(k64 <= F32_MEAN_RATIO * p64 + F32_ROUNDING_FLOOR * scale,
                    f"{what} {name}: error vs f64 {k64} > {F32_MEAN_RATIO} x the plain "
                    f"version's {p64}")
            if name == "dx":
                require(yk.dtype == dtype, f"{what} dx: dtype {yk.dtype}")
                require(d.max().item() <= MAX_ABS_TOL, f"{what} dx: max abs {d.max().item()}")
                require(d.mean().item() <= MEAN_ABS_TOL, f"{what} dx: mean abs {d.mean().item()}")
                errors.setdefault("layernorm_bwd", d.max().item())
            else:
                require(yk.dtype == torch.float32, f"{what} {name}: dtype {yk.dtype}")
                require(d.max().item() <= LN_SUM_REL * scale,
                        f"{what} {name}: off by {d.max().item()} of {scale}")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"{what}: two runs differ in their bits")
        log(f"[ln-bwd] {what}: dx, dweight and dbias bit-identical over two runs")
    log(f"[ln-bwd] tolerances: dx max abs <= {MAX_ABS_TOL}, mean abs <= {MEAN_ABS_TOL}; "
        f"dweight / dbias within {LN_SUM_REL} of their largest; each error vs f64 <= "
        f"{F32_MEAN_RATIO} x the plain version's (+ {F32_ROUNDING_FLOOR} of the largest "
        f"value); bit-identical reruns: ok")
    return errors


def clustered_features(nq, ng, device, seed, dim=1536, per_id=24):
    """Unit-norm embeddings of nq + ng samples, `per_id` to an identity,
    around random centres, identities interleaved over queries and gallery;
    a few exact duplicates, as repeated frames give them."""
    g = torch.Generator().manual_seed(seed)
    total = nq + ng
    ids = max(total // per_id, 2)
    centres = torch.randn(ids, dim, generator=g)
    f = centres[torch.arange(total) % ids] + torch.randn(total, dim, generator=g)
    f[nq + 1], f[total - 1], f[nq + 2] = f[nq + 7], f[total - 2], f[0]
    f = f / f.norm(dim=1, keepdim=True)
    return f[:nq].to(device), f[nq:].to(device)


def rerank_weights(nq, ng, device, seed=17, k2=15):
    """The min-sum's operands as re_ranking gives them: Vq (nq, n), V (n, n)."""
    from demo2_tpu_torch.utils import reranking as rr

    qf, gf = clustered_features(nq, ng, device, seed)
    v, _ = rr.reciprocal_weights(qf, gf, 50, k2)
    return v[:nq].contiguous(), v.contiguous()


def uniform_weights(nq, ng, device, seed=19):
    """Weights with no zero: Vq (nq, n), V (n, n), uniform in [1e-3, 1 + 1e-3)
    before each row is scaled to sum 1."""
    g = torch.Generator().manual_seed(seed)
    v = torch.rand(nq + ng, nq + ng, generator=g) + 1e-3
    v = (v / v.sum(1, keepdim=True)).to(device)
    return v[:nq].contiguous(), v


def edge_weights(nq, ng, depth, device, seed=5):
    """Vq (nq, depth) and Vg (ng, depth) whose row r is all non-zero, 5%
    non-zero or all zero as r % 3 is 0, 1 or 2; each non-zero row sums to 1."""
    g = torch.Generator().manual_seed(seed)

    def rows(count):
        kind = torch.arange(count)[:, None] % 3
        v = torch.rand(count, depth, generator=g) + 1e-3
        v = v * ((kind == 0) | ((kind == 1) & (torch.rand(count, depth, generator=g) < 0.05)))
        return (v / v.sum(1, keepdim=True).clamp(min=1e-12)).to(device)

    return rows(nq), rows(ng)


def density(v) -> float:
    return 100 * (v != 0).float().mean().item()


def check_min_sum(min_sum, vq, vg, what, bitwise, tol=JACCARD_TOL) -> float:
    """One case of phase_jaccard_kernel; returns the max abs error against
    the plain version."""
    from demo2_tpu_torch.utils import reranking as rr

    got, again = min_sum(vq, vg), min_sum(vq, vg)
    ordered = rr.jaccard_min_sum_ordered(vq, vg)
    plain = rr.jaccard_min_sum_plain(vq, vg)
    control = rr.jaccard_min_sum_ordered(vq.flip(1), vg.flip(1))  # descending k
    sync()
    d = (got - plain).abs().max().item()
    equal, control_equal = torch.equal(got, ordered), torch.equal(control, ordered)
    log(f"[jaccard] kernel 12 {what}: Vq {tuple(vq.shape)} ({density(vq):.2f}% non-zero) x Vg "
        f"{tuple(vg.shape)} ({density(vg):.2f}%): bitwise equal to the ascending sum {equal} "
        f"(the descending-k control {control_equal}, {(control != ordered).sum().item()} of "
        f"{ordered.numel()} outputs differ); vs plain max abs {d:.3e}; values in "
        f"[{got.min().item():.3e}, {got.max().item():.6f}]")
    require(got.shape == (vq.shape[0], vg.shape[0]) and bool(torch.isfinite(got).all()),
            f"kernel 12 {what}: shape {tuple(got.shape)} or non-finite")
    require(not control_equal, f"kernel 12 {what}: the descending-k control passes the "
                               "bitwise check")
    if bitwise:
        require(equal, f"kernel 12 {what}: {(got != ordered).sum().item()} outputs differ in "
                       "their bits from the ascending sum")
    require(d <= tol, f"kernel 12 {what}: max abs {d} > {tol}")
    require(got.min().item() >= 0.0 and got.max().item() <= 1.0 + tol,
            f"kernel 12 {what}: a min-sum of unit-sum rows outside [0, 1]")
    require(torch.equal(got, again), f"kernel 12 {what}: two runs differ")
    return d


def phase_jaccard_kernel(device, sizes=JACCARD_SIZES, edges=JACCARD_EDGES, min_sum=None) -> dict:
    """Kernel 12 (or `min_sum`) bitwise equal to the ascending-k sum, which a
    descending-k control must fail, within JACCARD_TOL of its plain version
    and bit-identical over two runs: on the re-ranking weights of clustered
    features at k2 = 15 and k2 = 1 and on uniform weights at every size, and
    on edge_weights at every edge; then negative inputs, which the kernel
    sums densely with the same bits.  On the CPU the wrapper is the plain version, which sums
    in another order: the bitwise check only logs there unless `min_sum` is
    given.  Returns the max abs error at the first size."""
    from demo2_tpu_torch.utils import reranking as rr

    bitwise = device.type == "cuda" or min_sum is not None
    min_sum = min_sum or rr.jaccard_min_sum
    errors = {}
    for nq, ng in sizes:
        for name, weights, tol in (
                ("k2=15", lambda: rerank_weights(nq, ng, device), JACCARD_TOL),
                ("k2=1", lambda: rerank_weights(nq, ng, device, k2=1), JACCARD_TOL),
                ("uniform", lambda: uniform_weights(nq, ng, device), JACCARD_DENSE_TOL)):
            d = check_min_sum(min_sum, *weights(), f"{nq} x {nq + ng} {name}", bitwise, tol)
            errors.setdefault("jaccard_min_sum", d)
    for nq, ng, depth in edges:
        check_min_sum(min_sum, *edge_weights(nq, ng, depth, device), f"edge {nq} x {ng} x "
                      f"{depth}", bitwise, JACCARD_DENSE_TOL)
    for side in (0, 1):  # negative values in Vq, then in Vg: the kernel's dense form
        ops = list(edge_weights(3, 1100, 65, device))
        ops[side] = ops[side].clone()
        ops[side][1, 7], ops[side][2, 3] = -0.5, -1e-3
        got = rr.jaccard_min_sum(*ops)
        want = rr.jaccard_min_sum_ordered(*ops)
        sync()
        what = f"[jaccard] kernel 12 with negative values in {('Vq', 'Vg')[side]}"
        d = (got - rr.jaccard_min_sum_plain(*ops)).abs().max().item()
        log(f"{what}: computed, bitwise equal to the ascending sum {torch.equal(got, want)}, "
            f"vs plain max abs {d:.3e}")
        require(d <= JACCARD_TOL, f"{what}: max abs {d} from the plain version")
        if device.type == "cuda":
            require(torch.equal(got, want), f"{what}: differs in its bits from the ascending sum")
    log(f"[jaccard] tolerance: bitwise equal to the ascending-k sum"
        f"{'' if bitwise else ' (logged only: the plain version on the CPU)'}, max abs from "
        f"the plain version <= {JACCARD_TOL} ({JACCARD_DENSE_TOL} where rows are full), "
        f"bit-identical reruns: ok")
    return errors


def jaccard_timing(vq, v):
    """timed(...) of kernel 12 on Vq, V: two operations for each (i, j, k)
    where both operands are non-zero, beside its plain version and the
    identity min(a, b) = (a + b - |a - b|) / 2 through torch.cdist(p=1)."""
    from demo2_tpu_torch.utils import reranking as rr

    pairs = int(((vq != 0).sum(0).double() * (v != 0).sum(0).double()).sum().item())
    return timed(lambda: rr.jaccard_min_sum(vq, v), lambda: rr.jaccard_min_sum_plain(vq, v),
                 2 * pairs, (tuple(vq.shape), tuple(v.shape)), [vq, v],
                 library=lambda: (vq.sum(1)[:, None] + v.sum(1)[None, :]
                                  - torch.cdist(vq, v, p=1)) / 2,
                 peak=F32_PEAK_TFLOPS, iters=10, plain_iters=2,
                 moved=tensor_bytes([vq, v]) + 4 * vq.shape[0] * v.shape[0])


# ---------------------------------------------------------------- phase 15


def ln_bwd_cfg(fused: bool, **overrides):
    """The flagship with TPU.PALLAS_LN_BWD on its kernel path; the plain path
    keeps the default LayerNorm backward."""
    return flagship_cfg(fused, TPU__PALLAS_LN_BWD=fused, **overrides)


# ---------------------------------------------------------------- phase 16


RERANK_DIST_TOL = 1e-5
EVAL_IDS, EVAL_QUERIES_PER_ID = 40, 2  # 80 queries and 240 gallery samples of 40 identities


def eval_cache_from(train_cache, cfg):
    """An eval DeviceCache cut from the training images already on the card:
    of each of the first EVAL_IDS identities, the first images as queries,
    then the rest as gallery.  Returns (cache, number of queries)."""
    import dataclasses

    require(tuple(cfg.INPUT.SIZE_TEST) == tuple(train_cache.size), "eval and train sizes differ")
    per = TRAIN_IMGS_PER_PID
    rows = torch.arange(EVAL_IDS * per).reshape(EVAL_IDS, per)  # the cache is identity-major
    sel = torch.cat([rows[:, :EVAL_QUERIES_PER_ID].flatten(),
                     rows[:, EVAL_QUERIES_PER_ID:].flatten()]).to(train_cache.images.device)
    val = dataclasses.replace(train_cache, images=train_cache.images[sel],
                              pids=train_cache.pids[sel], camids=train_cache.camids[sel],
                              viewids=train_cache.viewids[sel], train=False)
    return val, EVAL_IDS * EVAL_QUERIES_PER_ID


def phase_rerank_eval(device, model, train_cache) -> dict:
    """do_inference and run_eval with TEST.RE_RANKING on the kernel path, the
    second under MSVR310's scene protocol with its rank list file; then the
    same calls with kernel 12 swapped for its plain version.  Returns the
    launches of the two evals."""
    import tempfile

    from demo2_tpu_torch.engine.eval import do_inference, run_eval
    from demo2_tpu_torch.utils import reranking as rr

    kw = dict(TEST__RE_RANKING="yes", TEST__IMS_PER_BATCH=64)
    val, nq = eval_cache_from(train_cache, flagship_cfg(True, **kw))
    n = val.images.shape[0]
    layers, batches = num_blocks(model), math.ceil(n / 64)
    per_eval = launch_dict(fused_attention_block=layers * batches,
                           fused_mlp_block=layers * batches, jaccard_min_sum=1)
    distances = []
    real_re_ranking, kernel = rr.re_ranking, rr.jaccard_min_sum

    def recording(*args, **kwargs):
        distances.append(real_re_ranking(*args, **kwargs))
        return distances[-1]

    def both_evals(tmp, tag, counted):
        """name -> (CMC, mAP, launches of the eval, seconds); launches are
        read only while the wrappers are in place (`counted`)."""
        out = {}
        for name, fn, cfg, path in (
                ("do_inference", do_inference, flagship_cfg(True, **kw), None),
                ("run_eval MSVR310", run_eval,
                 flagship_cfg(True, DATASETS__NAMES="MSVR310", **kw), f"{tmp}/re_{tag}.txt")):
            before = counts() if counted else {}
            t0 = time.perf_counter()
            cmc, m_ap = fn(cfg, model, val, nq, rank_list_path=path)
            sync()
            wall = time.perf_counter() - t0
            rose = {k: v - before[k] for k, v in counts().items()} if counted else {}
            out[name] = (cmc, m_ap, rose, wall)
        return out

    rr.re_ranking = recording
    try:
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts()
            on_kernel = both_evals(tmp, "kernel", counted=True)
            launches = counts()
            rr.jaccard_min_sum = rr.jaccard_min_sum_plain
            on_plain = both_evals(tmp, "plain", counted=False)
            rank_list = open(f"{tmp}/re_kernel.txt").read().splitlines()
    finally:
        rr.re_ranking, rr.jaccard_min_sum = real_re_ranking, kernel
    for i, (name, (cmc, m_ap, rose, wall)) in enumerate(on_kernel.items()):
        require_launches(rose, per_eval, f"[rerank-eval] {name}")
        p_cmc, p_map = on_plain[name][:2]
        dist, p_dist = distances[i], distances[i + 2]
        d = (dist - p_dist).abs().max().item()
        log(f"[rerank-eval] {name}: {nq} queries x {n - nq} gallery in {wall:.2f} s, mAP "
            f"{m_ap:.4f}, Rank-1 {cmc[0]:.3f}; launches {rose}; distances vs the plain "
            f"min-sum max abs {d:.3e}; plain mAP {p_map:.4f}")
        require(dist.shape == (nq, n - nq) and bool(torch.isfinite(dist).all()),
                f"[rerank-eval] {name}: distances {tuple(dist.shape)} or non-finite")
        require(cmc.shape == (50,) and 0.0 < m_ap <= 1.0, f"[rerank-eval] {name}: mAP {m_ap}")
        require(d <= RERANK_DIST_TOL, f"[rerank-eval] {name}: distances differ by {d}")
        require(bool(np.all(np.abs(cmc - p_cmc) <= 1e-6)) and abs(m_ap - p_map) <= 1e-6,
                f"[rerank-eval] {name}: CMC / mAP differ from the plain min-sum's")
    require(rank_list[0] == "rank list file" and len(rank_list) == 1 + 2 * nq
            and "_s" in rank_list[1], "[rerank-eval] MSVR310's rank list file is malformed")
    log(f"[rerank-eval] rank list: {len(rank_list)} lines, first query {rank_list[1]} "
        f"{' '.join(rank_list[2].split()[:4])} ...")
    log(f"[rerank-eval] main path: 2 evals, launches {launches}")
    return launches


# ---------------------------------------------------------------- phase 17


def phase_rerank_ln_timing(device, card, ln_cfg, ln_model, cfg, model, cache, sampler) -> dict:
    """Kernels 11 and 12 against their plain versions (11 also beside
    aten's native_layer_norm_backward, which reads the statistics the forward
    saved; 12 on V of three densities, beside the min-sum through
    torch.cdist(p=1), with its byte bound, the dense sum's and this V's
    operations), re_ranking as a whole with the kernel and with its plain version,
    and the train step with and without PALLAS_LN_BWD, each pair in turns,
    with a profile of one step of each."""
    from demo2_tpu_torch.ops import norm
    from demo2_tpu_torch.utils import reranking as rr

    shape = LN_BWD_SHAPES[0]
    x, dy, w = ln_bwd_inputs(shape, device, seed=13)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + LN_EPS)
    wb, bb = w.to(x.dtype), torch.zeros_like(w).to(x.dtype)
    nq, ng = JACCARD_SIZES[0]
    jaccard = {f"jaccard_min_sum{name}": jaccard_timing(*weights)
               for name, weights in (("", rerank_weights(nq, ng, device)),
                                     (" k2=1", rerank_weights(nq, ng, device, k2=1)),
                                     (" uniform", uniform_weights(nq, ng, device)))}
    times = time_kernels({
        "layernorm_bwd": timed(
            lambda: norm.layernorm_bwd(x, dy, w, LN_EPS),
            lambda: norm.layernorm_bwd_plain(x, dy, w, LN_EPS),
            12 * x.numel(), shape, [x, dy, w],
            library=lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [shape[1]], mean, rstd, wb, bb, [True, True, True]),
            peak=F32_PEAK_TFLOPS),
        **jaccard,
    }, card)
    for name, case in jaccard.items():
        vq, v = case["inputs"]
        dense_ms = roofline(2 * vq.shape[0] * v.numel(), F32_PEAK_TFLOPS, 0)[0]
        log(f"[time] {name}: bounds {roofline(0, F32_PEAK_TFLOPS, case['moved'])[0]:.4f} ms "
            f"by bytes, {dense_ms:.4f} ms by the dense sum's operations, "
            f"{roofline(case['flops'], F32_PEAK_TFLOPS, 0)[0]:.6f} ms by this V's (Vq "
            f"{density(vq):.2f}%, V {density(v):.2f}% non-zero); kernel "
            f"{times[name]['ms']:.4f} ms ({card})")
        split = device_ms(case["kernel"], iters=1 if density(v) > 50 else 10)
        log(f"[time] {name}, device time by launch: " + ", ".join(
            f"{key.split('::')[-1].split('(')[0]} {ms:.4f}" for key, ms in split.items())
            + f" ms ({card})")

    qf, gf = clustered_features(nq, ng, device, seed=17)
    kernel = rr.jaccard_min_sum

    def whole_ms(min_sum, reps=3):
        rr.jaccard_min_sum = min_sum
        try:
            rr.re_ranking(qf, gf)
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                rr.re_ranking(qf, gf)
            sync()
            return (time.perf_counter() - t0) * 1e3 / reps
        finally:
            rr.jaccard_min_sum = kernel

    k_ms, p_ms = alternate(lambda: whole_ms(rr.jaccard_min_sum_plain), lambda: whole_ms(kernel))
    log(f"[time] re_ranking of {nq} queries x {ng} gallery (k1 50, k2 15), whole: with kernel "
        f"12 {k_ms:.2f} ms, with its plain version {p_ms:.2f} ms ({card})")
    time_train_step(device, card, ln_cfg, ln_model, cfg, model, cache, sampler,
                    label="PALLAS_LN_BWD ", names=("flag on", "flag off"))
    return times


# ---------------------------------------------------------------- phase 18


QKV_SHAPES = (QKV_SHAPE, (3, 129, 2304))                  # kernel 8's qkv (3B, S, 3C)
# Kernel 8 also at the edges of its three stages: kernel 4's (SAVED_EDGE_SHAPES),
# width 512 (C = 512 is no multiple of the GEMM's 192 columns; 1,032 rows, one
# slice of dW's K with a ragged end) and 3,096 rows (two slices of dW's K, the
# second ragged).
FUSED_DW_EDGE_SHAPES = SAVED_EDGE_SHAPES + ((8, 129, 1536), (24, 129, 2304))
ABLATE_SHAPES = ((192, 136, 2304), (8, 136, 2304))     # the tool's qkv, and a small batch
DT_COS_MIN = 0.9999
# Kernel 8's dt follows two stacked bf16 roundings (dS, then dq / dk / dv) and a
# contraction over 3C = 2,304 columns: where an f32 sum taken in another order
# flips one of those roundings, every dt that reads it moves.  On an H100 the
# kernel lands 1e-5 of mean |dt| from its plain version; contracting the
# unrounded dq, dk, dv lands 1.7e-3 away.  The bound sits between the two.
FUSED_DW_ROUNDING_REL = 1e-4
# Kernel 2's h is bf16(f32 h): one bf16 ulp from the plain version's where the
# f32 sums land on either side of a rounding.  Where a LayerNorm output feeding
# the product is itself an ulp apart (2^-6 at |t| < 4), the f32 h moves by that
# times a weight (init scale 0.036, up to ~0.2): the floor.  Such elements are
# rare: the share that differs at all is bounded too.
HIDDEN_FLOOR = 4e-3
HIDDEN_DIFFER_SHARE = 2e-3


def fused_dw_inputs(shape, device, seed):
    """Kernel 8's inputs as the block backward gives them: qkv and probs from
    the training forward of a block (kernel 3 on the card), a unit cotangent
    of the attention output, the LayerNorm output t and the qkv weight."""
    from demo2_tpu_torch.ops import fused_block as fb

    b, s, c3 = shape
    x, p, do = train_kernel_inputs((b, s, c3 // 3), device, seed)
    w = {k: (v.to(torch.bfloat16) if k in ("wqkv", "wout") else v) for k, v in p.items()}
    kw = dict(num_heads=c3 // 3 // 64, scale=64 ** -0.5)
    _, qkv, _, probs = fb.fused_attention_block_train(x, **w, **kw)
    t = fb._layernorm_f32(x, p["ln_weight"], p["ln_bias"]).to(torch.bfloat16)
    return (qkv, probs, do, t, w["wqkv"]), kw


def fused_dw_f64(qkv, probs, do, t, w, *, num_heads, scale):
    """The function kernel 8 computes, in f64 with no rounding anywhere: the
    reference the kernel and its plain version are both held to."""
    from demo2_tpu_torch.ops.packed_attention import merge_heads, split_heads

    s, c = qkv.shape[1], qkv.shape[2] // 3
    q, k, v = (split_heads(x, num_heads).double() for x in qkv.split(c, dim=-1))
    dof, p = split_heads(do, num_heads).double(), probs[..., :s].double()
    dp = dof @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dqkv = torch.cat([merge_heads(ds @ k * scale), merge_heads(ds.transpose(-1, -2) @ q * scale),
                      merge_heads(p.transpose(-1, -2) @ dof)], dim=-1).reshape(-1, 3 * c)
    return ((dqkv @ w.double()).reshape(do.shape), dqkv.t() @ t.reshape(-1, c).double(),
            dqkv.sum(0))


def misrounded_fused_dw(qkv, probs, do, t, w, *, num_heads, scale):
    """Kernel 8's dt with dq, dk, dv contracted as the f32 values they are
    before their rounding to bf16: what a kernel that feeds its accumulators
    straight into the next product would compute."""
    from demo2_tpu_torch.ops.packed_attention import merge_heads, split_heads

    s, c = qkv.shape[1], qkv.shape[2] // 3
    q, k, v = (split_heads(x, num_heads).float() for x in qkv.split(c, dim=-1))
    dof, p = split_heads(do, num_heads).float(), probs[..., :s].float()
    dp = dof @ v.transpose(-1, -2)
    ds = _bf16(p * (dp - (dp * p).sum(-1, keepdim=True)))
    dqkv = torch.cat([merge_heads(ds @ k * scale), merge_heads(ds.transpose(-1, -2) @ q * scale),
                      merge_heads(p.transpose(-1, -2) @ dof)], dim=-1)
    return (dqkv.reshape(-1, 3 * c) @ w.float()).to(qkv.dtype).reshape(do.shape)


def check_fused_dw(device, shape, control: bool = True) -> float:
    """Kernel 8 against its plain version and f64 at qkv `shape`, and the
    misrounded control beside it (not over one key, where dS is exactly zero
    and nothing is rounded)."""
    from demo2_tpu_torch.ops import packed_attention as pa

    inputs, kw = fused_dw_inputs(shape, device, seed=19)
    got = pa.attention_bwd_fused_dw(*inputs, **kw)
    again = pa.attention_bwd_fused_dw(*inputs, **kw)
    plain = pa.attention_bwd_fused_dw_plain(*inputs, **kw)
    f64 = fused_dw_f64(*inputs, **kw)
    wrong = misrounded_fused_dw(*inputs, **kw)
    sync()
    what = f"kernel 8 {tuple(shape)}"
    for name, yk, yp, y64 in zip(("dt", "dW", "db"), got, plain, f64):
        d = (yk.double() - yp.double()).abs()
        k64 = (yk.double() - y64).abs().mean().item()
        p64 = (yp.double() - y64).abs().mean().item()
        scale, size = y64.abs().max().item(), y64.abs().mean().item()
        log(f"[new-kernel] {what} {name}: vs plain max {d.max().item():.3e} mean "
            f"{d.mean().item():.3e}; mean error vs f64 kernel {k64:.3e}, plain {p64:.3e} "
            f"(|f64| max {scale:.3e} mean {size:.3e})")
        require(bool(torch.isfinite(yk).all()), f"{what} {name}: non-finite")
        require(k64 <= F32_MEAN_RATIO * p64 + F32_ROUNDING_FLOOR * scale,
                f"{what} {name}: error vs f64 {k64} > {F32_MEAN_RATIO} x the plain version's {p64}")
        if name == "dt":
            dw_ = mean_err(wrong, yp)
            log(f"[new-kernel] {what} dt: control contracting the unrounded dq, dk, dv: vs "
                f"plain mean {dw_:.3e} ({dw_ / size:.3e} of mean |dt|), held to it {control}")
            require(yk.dtype == torch.bfloat16, f"{what} dt: dtype {yk.dtype}")
            require(d.max().item() <= MAX_ABS_TOL, f"{what} dt: max abs {d.max().item()}")
            require(d.mean().item() <= MEAN_ABS_TOL, f"{what} dt: mean abs {d.mean().item()}")
            require(d.mean().item() <= FUSED_DW_ROUNDING_REL * size,
                    f"{what} dt: mean abs {d.mean().item()} > {FUSED_DW_ROUNDING_REL} of mean "
                    f"|dt| {size}: the kernel rounds where its plain version does not")
            require(not control or dw_ > FUSED_DW_ROUNDING_REL * size,
                    f"{what} dt: the misrounded control is within {FUSED_DW_ROUNDING_REL} of "
                    f"the plain version, so the bound cannot tell where a kernel rounds")
        else:
            require(yk.dtype == torch.float32, f"{what} {name}: dtype {yk.dtype}")
            require(d.max().item() <= LN_SUM_REL * scale,
                    f"{what} {name}: off by {d.max().item()} of {scale}")
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            f"{what}: two runs differ in their bits")
    log(f"[new-kernel] {what}: dt, dW and db bit-identical over two runs")
    return (got[0].float() - plain[0].float()).abs().max().item()


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |v| (f32): 2^(exponent - 7)."""
    return torch.ldexp(torch.ones_like(v), torch.frexp(v)[1] - 8)


def check_mlp_train(device, shape) -> dict:
    from demo2_tpu_torch.ops import fused_block as fb

    x, _, mlp = block_inputs(shape, device, seed=1)
    out, h = fb.fused_mlp_block_train(x, **mlp)
    p_out, p_h = fb.mlp_block_train_plain(x, **mlp)
    out32, _ = fb.mlp_block_train_plain(x.float(), **{k: v.float() for k, v in mlp.items()})
    sync()
    what = f"kernel 2 (training form) {tuple(shape)}"
    d = (out.float() - p_out.float()).abs()
    k32, p32 = mean_err(out, out32), mean_err(p_out, out32)
    dh = (h.float() - p_h.float()).abs()
    over = (dh - bf16_ulp(torch.maximum(h.float().abs(), p_h.float().abs()))).max().item()
    log(f"[new-kernel] {what}: out vs plain bf16 max {d.max().item():.3e} mean "
        f"{d.mean().item():.3e}; vs f32 kernel {k32:.3e}, plain bf16 {p32:.3e}; h "
        f"{tuple(h.shape)} vs plain max {dh.max().item():.3e} mean {dh.mean().item():.3e}, "
        f"{(dh > 0).float().mean().item():.2e} of its elements differ, the furthest "
        f"{over:.3e} beyond one bf16 ulp")
    require(bool(torch.isfinite(out).all()) and bool(torch.isfinite(h).all()), f"{what}: non-finite")
    require(d.max().item() <= MAX_ABS_TOL, f"{what}: out max abs {d.max().item()}")
    require(d.mean().item() <= MEAN_ABS_TOL, f"{what}: out mean abs {d.mean().item()}")
    require(k32 <= F32_MEAN_RATIO * p32, f"{what}: out less accurate than the plain bf16 path")
    require(h.shape == (x.numel() // x.shape[-1], mlp["w1"].shape[0]) and h.dtype == x.dtype,
            f"{what}: h {tuple(h.shape)} {h.dtype}")
    require(over <= HIDDEN_FLOOR,
            f"{what}: h more than one bf16 ulp (+ {HIDDEN_FLOOR}) from the plain's")
    require((dh > 0).float().mean().item() <= HIDDEN_DIFFER_SHARE,
            f"{what}: more than {HIDDEN_DIFFER_SHARE} of h differs from the plain's")
    out_control, h_control = _misrounded_mlp(x, mlp)
    check_rounding(f"{what} out", out, p_out, out_control)
    differ = ((h_control.float() - p_h.float()).abs() > 0).float().mean().item()
    log(f"[new-kernel] {what}: control with h rounded before the bias: {differ:.2e} of h "
        f"differs from the plain's")
    require(differ > HIDDEN_DIFFER_SHARE,
            f"{what}: the misrounded h differs in no more than {HIDDEN_DIFFER_SHARE} of its "
            f"elements, so the bound cannot tell where a kernel rounds")
    return {"max_abs": d.max().item(), "out": out}


def _misrounded_mlp(x, mlp):
    """Kernel 2's out with fc2's residual added in bf16 (the out-projection's
    rounding), and h rounded once before the bias and again after it."""
    from demo2_tpu_torch.ops import fused_block as fb

    c = x.shape[-1]
    t = fb._layernorm_f32(x, mlp["ln_weight"], mlp["ln_bias"]).to(x.dtype).reshape(-1, c)
    product = fb._mm_f32(t, mlp["w1"].t())
    hf = product + mlp["b1"].float()
    g = (hf * torch.sigmoid(1.702 * hf)).to(x.dtype)
    y = (fb._mm_f32(g, mlp["w2"].t()) + mlp["b2"].float()).to(x.dtype)
    h = (product.to(x.dtype).float() + mlp["b1"].float()).to(x.dtype)
    return x + y.reshape(x.shape), h


def ablate_input(shape, device, seed=23, std=0.5):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * std).to(device, torch.bfloat16)


def check_ablate(device, shape) -> float:
    from demo2_tpu_torch.tools import bench_kernel_ablate as ab

    qkv = ablate_input(shape, device)
    worst = 0.0
    for mode, heads in ab.CASES:
        got = ab.ablate_attention(qkv, mode, heads).float()
        plain = ab.ablate_attention_plain(qkv, mode, heads).float()
        sync()
        what = f"kernel 13 {mode} h={heads} {tuple(shape)}"
        cols = heads * ab.HEAD_DIM
        d = (got - plain).abs()
        size = plain[..., :cols].abs().mean().item()
        mean = d[..., :cols].mean().item()
        over = (d - 2.0 ** -7 * (plain.abs() + size)).max().item()
        log(f"[new-kernel] {what}: vs plain max {d.max().item():.3e} mean {mean:.3e} (mean "
            f"|plain| {size:.3e})")
        require(bool(torch.isfinite(got).all()), f"{what}: non-finite")
        require(over <= 0.0, f"{what}: an element more than two bf16 ulps from the plain's")
        require(mean <= ROUNDING_MEAN_TOL * size,
                f"{what}: mean abs {mean} > {ROUNDING_MEAN_TOL} of mean |plain| {size}")
        require(size > 1e-3 and not bool(got[..., cols:].any()),
                f"{what}: an empty output, or columns of the heads left out written")
        worst = max(worst, d.max().item())
    return worst


def phase_new_kernels(device, qkv_shapes=QKV_SHAPES, ablate_shapes=ABLATE_SHAPES,
                      fused_dw_edges=FUSED_DW_EDGE_SHAPES) -> dict:
    """Kernel 8, the training form of kernel 2 and kernel 13's five cases
    against their plain versions; kernel 8 also at `fused_dw_edges`.
    Returns name -> max abs error at the first shape."""
    exact_products()
    errors = {}
    for shape in qkv_shapes:
        errors.setdefault("attention_bwd_fused_dw", check_fused_dw(device, shape))
        b, s, c3 = shape
        errors.setdefault("fused_mlp_block_train",
                          check_mlp_train(device, (b, s, c3 // 3))["max_abs"])
    for shape in fused_dw_edges:
        check_fused_dw(device, shape, control=shape[1] > 1)
    for shape in ablate_shapes:
        errors.setdefault("attention_ablate", check_ablate(device, shape))
    log(f"[new-kernel] tolerances: kernel 8 dt max abs <= {MAX_ABS_TOL}, mean abs <= "
        f"{MEAN_ABS_TOL} and <= {FUSED_DW_ROUNDING_REL} of mean |dt| (the misrounded control above "
        f"it); dW / db within {LN_SUM_REL} of their largest; each error vs f64 <= "
        f"{F32_MEAN_RATIO} x the plain version's; bit-identical reruns.  Kernel 2's training "
        f"form: out as phase 2, h within one bf16 ulp (+ {HIDDEN_FLOOR}), at most "
        f"{HIDDEN_DIFFER_SHARE} of it differing.  Kernel 13: two bf16 "
        f"ulps, mean <= {ROUNDING_MEAN_TOL} of mean |plain|: ok")
    return errors


# ---------------------------------------------------------------- phase 19


def phase_block_backward(device, shape=FLAGSHIP) -> dict:
    """The block backward with the fused-dW kernel in its middle: the
    training forward (kernel 3), then attention_block_backward(fused_dw=True)
    (kernel 8), against the route training runs (kernel 4 and the two
    products).  Returns the launches of the kernel-8 route."""
    from demo2_tpu_torch.ops import fused_block as fb

    x, p, g = train_kernel_inputs(shape, device, seed=29)
    kw = dict(num_heads=shape[-1] // 64, scale=64 ** -0.5)
    wqkv, wout = p["wqkv"].to(torch.bfloat16), p["wout"].to(torch.bfloat16)
    args = (p["ln_weight"], p["ln_bias"], wqkv, p["bqkv"], wout, p["bout"])
    reset_counts()
    _, qkv, attn, probs = fb.fused_attention_block_train(x, *args, **kw)
    saved = (x, qkv, attn, probs, p["ln_weight"], p["ln_bias"], wqkv, wout, g)
    via_8 = fb.attention_block_backward(*saved, **kw, fused_dw=True)
    sync()
    launches = counts()
    require_launches(launches, launch_dict(fused_attention_block_train=1,
                                           attention_bwd_fused_dw=1), "[block-bwd] kernel-8 route")
    via_4 = fb.attention_block_backward(*saved, **kw, fused_dw=False)
    sync()
    # Kernel 8's db is kernel 4's own: the same instantiation and the same
    # fixed-order sum of its per-sample partials.
    same_db = torch.equal(via_8[4], via_4[4])
    log(f"[block-bwd] grad bqkv: kernel-8 route bitwise equal to the kernel-4 route {same_db}")
    require(same_db or REHEARSAL, "[block-bwd] grad bqkv: the kernel-8 route's differs in its bits "
            "from the kernel-4 route's")
    for name, a, r in zip(("x", "ln_weight", "ln_bias", "wqkv", "bqkv", "wout", "bout"),
                          via_8, via_4):
        cos = cosine(a.float(), r.float())
        d = (a.float() - r.float()).abs()
        log(f"[block-bwd] grad {name} {tuple(a.shape)}: kernel-8 route vs kernel-4 route cosine "
            f"{cos:.8f}, max abs {d.max().item():.3e} mean {d.mean().item():.3e}")
        require(bool(torch.isfinite(a).all()), f"[block-bwd] grad {name}: non-finite")
        require(cos >= DT_COS_MIN, f"[block-bwd] grad {name}: cosine {cos} < {DT_COS_MIN}")
        if name == "x":
            require(d.max().item() <= MAX_ABS_TOL and d.mean().item() <= MEAN_ABS_TOL,
                    f"[block-bwd] dx: max abs {d.max().item()}, mean abs {d.mean().item()}")
    log(f"[block-bwd] main path: forward + backward of one block, launches {launches}")
    return launches


# ---------------------------------------------------------------- phases 20-21


def mlp_train_cfg(fused: bool, **overrides):
    """The flagship with TPU.FUSED_MLP_TRAIN on its kernel path; the flag does
    nothing on the plain path, whose blocks are unfused."""
    return flagship_cfg(fused, TPU__FUSED_MLP_TRAIN=fused, **overrides)


def phase_mlp_train_timing(device, card, mlp_cfg, mlp_model, cfg, model, cache, sampler) -> dict:
    """Kernel 8 beside the route it fuses, kernel 2's training form beside the
    unfused MLP's forward, the ablation tool's five cases through the
    function its main() times them with, and the train step with and without
    FUSED_MLP_TRAIN in turns.  Returns (times, the tool's launches)."""
    import torch.nn.functional as F

    from demo2_tpu_torch.ops import fused_block as fb, packed_attention as pa
    from demo2_tpu_torch.ops.activations import quick_gelu
    from demo2_tpu_torch.tools import bench_kernel_ablate as ab

    shape = QKV_SHAPES[0]
    b, s, c3 = shape
    c = c3 // 3
    m = b * s
    inputs, kw = fused_dw_inputs(shape, device, seed=19)
    qkv, probs, do, t, w = inputs
    t_m = t.reshape(-1, c)

    def separate():
        dqkv, db = pa.attention_bwd_saved_db(qkv, probs, do, **kw)
        dqkv_m = dqkv.reshape(-1, c3)
        return dqkv_m @ w, torch.mm(dqkv_m.t(), t_m, out_dtype=torch.float32), db

    sep_ms = (cuda_ms(separate) + cuda_ms(separate)) / 2
    log(f"[time] kernel 4 + the two torch.mm that kernel 8 fuses (dt = dqkv W, dW = dqkv^T t; "
        f"dqkv through device memory) x{shape}: {sep_ms:.4f} ms ({card})")
    time_fused_dw_stages(inputs, kw, card)

    x, _, mlp = block_inputs((b, s, c), device, seed=1)
    bf = {k: v.to(torch.bfloat16) for k, v in mlp.items()}

    def unfused_mlp():
        y = F.layer_norm(x.float(), (c,), mlp["ln_weight"], mlp["ln_bias"], 1e-5).to(x.dtype)
        return x + F.linear(quick_gelu(F.linear(y, bf["w1"], bf["b1"])), bf["w2"], bf["b2"])

    unfused_ms = (cuda_ms(unfused_mlp) + cuda_ms(unfused_mlp)) / 2
    log(f"[time] the unfused MLP's forward (layer_norm in f32, two F.linear, QuickGELU, the "
        f"residual) x{(b, s, c)}: {unfused_ms:.4f} ms ({card})")

    a_shape = ABLATE_SHAPES[0]
    ab_b, ab_s = a_shape[:2]
    aqkv = ablate_input(a_shape, device, seed=0, std=0.05)  # the tool's input scale
    heads12 = [y.reshape(ab_b, ab_s, 12, 64).transpose(1, 2)
               for y in aqkv.split(a_shape[2] // 3, dim=-1)]
    key_mask = (torch.arange(ab_s, device=device) < ab.VALID_KEYS).expand(ab_s, ab_s)
    sdpa = lambda: F.scaled_dot_product_attention(*heads12, attn_mask=key_mask,
                                                  scale=ab.FULL_SCALE)
    products = {"full": 4, "no_softmax": 4, "scores_only": 2, "slice_only": 0}
    cases = {
        "attention_bwd_fused_dw": timed(
            lambda: pa.attention_bwd_fused_dw(*inputs, **kw),
            lambda: pa.attention_bwd_fused_dw_plain(*inputs, **kw),
            8 * b * s * s * c + 4 * m * c * c3, shape, list(inputs), plain_iters=5),
        "fused_mlp_block_train": timed(
            lambda: fb.fused_mlp_block_train(x, **mlp),
            lambda: fb.mlp_block_train_plain(x, **mlp),
            block_flops("fused_mlp_block", (b, s, c)), (b, s, c), [x, *mlp.values()]),
    }
    for mode, heads in ab.CASES:
        cases[f"attention_ablate {mode} h={heads}"] = timed(
            lambda mode=mode, heads=heads: ab.ablate_attention(aqkv, mode, heads),
            lambda mode=mode, heads=heads: ab.ablate_attention_plain(aqkv, mode, heads),
            products[mode] * ab_b * ab_s * ab_s * heads * ab.HEAD_DIM, a_shape, [aqkv],
            library=sdpa if (mode, heads) == ("full", 12) else None,
            moved=ab.case_bytes(a_shape, heads))
    times = time_kernels(cases, card)
    times["attention_ablate"] = full12 = times["attention_ablate full h=12"]
    require(full12["ms"] <= full12["library_ms"],
            f"kernel 13 full h=12 takes {full12['ms']} ms, the library's call "
            f"{full12['library_ms']} ms on the same inputs")

    # The tool's own path: what `python3 -m demo2_tpu_torch.tools.bench_kernel_ablate` runs.
    reset_counts()
    tool_ms = ab.time_cases(aqkv)
    tool_launches = counts()
    for (mode, heads), ms in tool_ms.items():
        bound = ab.case_bytes(a_shape, heads) / (HBM_PEAK_TBS * 1e9)
        log(f"[ablate] {mode} h={heads}: {ms:.4f} ms/iter; bound {bound:.4f} ms by bytes "
            f"({100 * bound / ms:.1f}% of it reached) ({card})")
    full, nosm, scores, slices = (tool_ms[k] for k in (("full", 12), ("no_softmax", 12),
                                                       ("scores_only", 12), ("slice_only", 12)))
    log(f"[ablate] the forward's {full:.4f} ms by what each case leaves out: the loads of q, k "
        f"and v, the ring and the store alone {slices:.4f}; QK^T with q and k alone loaded "
        f"{scores:.4f}; + the load of v and PV {nosm - scores:.4f}; + softmax {full - nosm:.4f} "
        f"ms; 4 of 12 heads take {tool_ms[('full', 4)]:.4f} ms ({card})")
    log(f"[ablate] main path: {len(tool_ms)} cases through time_cases, launches {tool_launches}")

    time_train_step(device, card, mlp_cfg, mlp_model, cfg, model, cache, sampler,
                    label="FUSED_MLP_TRAIN ", names=("flag on", "flag off"))
    return times, tool_launches


def time_fused_dw_stages(inputs, kw, card) -> dict:
    """Kernel 8's launches by the profiler, each beside its own bound (the
    larger of its operations over the bf16 peak and the bytes it must move
    over the memory rate); their sum beside the function's bound.  Returns
    stage -> ms, each stage under a part of its kernel's name."""
    from demo2_tpu_torch.ops import packed_attention as pa

    qkv, probs, do, t, w = inputs
    b, s, c3 = qkv.shape
    c, m = c3 // 3, b * s
    slices = -(-m // pa.DW_SLICE_ROWS)
    product = 2 * m * c3 * c  # each of dt = dqkv W and dW = dqkv^T t
    partials = 4 * slices * c3 * c if slices > 1 else 0
    stages = {  # part of the kernel's name: (what it computes, operations, bytes)
        "attention_regs_bwd_kernel": ("1. kernel 4: dqkv and db's per-sample partials",
                                      8 * b * s * s * c,
                                      tensor_bytes((qkv, probs, do, qkv)) + 4 * b * c3),
        "db_reduce_kernel": ("1. db: the samples' partials added in order", 0,
                             4 * (b + 1) * c3),
        "RoundEpilogue": ("2. dt = bf16(dqkv W) over K = 3C", product,
                          tensor_bytes((qkv, w, do))),
        "F32Epilogue": ("3. dW = dqkv^T t, the f32 partials of K's slices", product,
                        tensor_bytes((qkv, t)) + (partials or 4 * c3 * c)),
        "sum_slices_kernel": ("3. dW: the slices' partials added in order", 0,
                              partials + 4 * c3 * c if partials else 0),
    }
    call = lambda: pa.attention_bwd_fused_dw(*inputs, **kw)
    kernels = device_ms(call)
    got, floor = {}, 0.0
    for part, (what, ops, moved) in stages.items():
        ms = sum(v for key, v in kernels.items() if part in key)
        stage_bound = roofline(ops, BF16_PEAK_TFLOPS, moved)[0]
        got[part] = ms
        floor += stage_bound
        log(f"[time] kernel 8 stage {what}: {ms:.4f} ms, its bound {stage_bound:.4f} ms ({card})")
        require(ms > 0 or (part == "sum_slices_kernel" and slices == 1),
                f"kernel 8: no device time under {part}")
    other = sum(kernels.values()) - sum(got.values())
    bound, by = roofline(8 * b * s * s * c + 2 * product, BF16_PEAK_TFLOPS,
                         tensor_bytes(inputs) + tensor_bytes((do,)) + 4 * (c3 * c + c3))
    log(f"[time] kernel 8 x{tuple(qkv.shape)}: its launches {sum(got.values()):.4f} ms (other "
        f"device time {other:.4f}); the stages' bounds add to {floor:.4f} ms, the function's "
        f"bound {bound:.4f} ms by {by}; CUDA events {cuda_ms(call):.4f} ms a call, the host's "
        f"enqueue {host_ms(call):.4f} ({card})")
    return got


# ---------------------------------------------------------------- phase 22


def pattern_widths(model) -> dict:
    """The embedding's width at each return_pattern of an HDM + ATMoE model."""
    c = model.feat_dim
    return {1: 3 * c, 2: 7 * c, 3: 10 * c}


def phase_demo_eval(device, cfg, model, train_cache) -> None:
    """run_eval at return_pattern 1, 2 and 3 over an eval cache cut from the
    training images: each pattern's embedding width, pattern 3 equal to
    [pattern 2, pattern 1], kernels 1 and 2 launched once per block and
    forward and no other kernel, mAP in (0, 1]."""
    from demo2_tpu_torch.engine.eval import eval_step, miss_mask, run_eval

    val, nq = eval_cache_from(train_cache, cfg)
    layers = num_blocks(model)
    forwards = math.ceil(val.images.shape[0] / cfg.TEST.IMS_PER_BATCH)
    idx = torch.arange(8, device=device)
    images, _, camids = val.batch(idx)
    feats = {}
    for pattern, width in pattern_widths(model).items():
        feats[pattern] = eval_step(model, images, camids, miss_mask("None", device=device),
                                   val.viewids[idx], pattern)
        require(feats[pattern].shape == (8, width) and bool(torch.isfinite(feats[pattern]).all()),
                f"pattern {pattern}: embedding {tuple(feats[pattern].shape)}, expected width "
                f"{width}, or not finite")
        before = counts()
        cmc, m_ap = run_eval(cfg, model, val, nq, pattern)
        sync()
        require_launches({k: v - before[k] for k, v in counts().items()},
                         launch_dict(fused_attention_block=layers * forwards,
                                     fused_mlp_block=layers * forwards),
                         f"[demo-eval] run_eval return_pattern {pattern}")
        require(0.0 < m_ap <= 1.0, f"pattern {pattern}: mAP {m_ap}")
        log(f"[demo-eval] run_eval return_pattern {pattern}: embedding width {width}, "
            f"{nq} queries, mAP {m_ap:.4f}, Rank-1 {cmc[0]:.3f}")
    both = torch.cat([feats[2], feats[1]], dim=1)
    require(torch.allclose(feats[3], both, rtol=1e-5, atol=1e-5),
            f"pattern 3 is not [moe, ori]: {(feats[3] - both).abs().max().item()}")


FUSION_KEYS = ("general_fusion.hdm.", "general_fusion.moe.expert_kernel",
               "general_fusion.moe.expert_bn.running_", "general_fusion.moe.linear_re_bn.running_")


def phase_demo(device, card, flag_cfg, flag_model, cache, sampler) -> None:
    """configs/RGBNT201/DeMo.yml at full width, the kernel path and the plain
    path with the same weights: serving through FeatureExtractor (phase 3's
    checks), run_eval at each return_pattern, training (phase 6's checks,
    HDM's parameters, ATMoE's experts and both of its BatchNorms' statistics
    among what must change), do_train with its pattern loop, then phase 23's
    timing beside the flagship."""
    make_cfg = cut_depth(demo_cfg)
    cfg, model, plain_cfg, plain = build_models(device, make_cfg)
    layers = num_blocks(model)
    log(f"[demo] configs/RGBNT201/DeMo.yml at {layers} blocks: "
        f"{sum(p.numel() for p in model.parameters())} "
        f"parameters, HDM {model.feat_dim // 64} heads of 64, ATMoE HEAD {cfg.MODEL.HEAD}, "
        f"branches {list(model.branch_heads)}, embedding widths by pattern "
        f"{pattern_widths(model)}")
    phase_slice(device, cfg, model, plain_cfg, plain,
                launch_dict(fused_attention_block=layers, fused_mlp_block=layers),
                label="demo-slice")
    phase_demo_eval(device, cfg, model, cache)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()
              if k.startswith(FUSION_KEYS)}
    phase_train(device, cfg, model, plain_cfg, plain, cache, sampler,
                launch_dict(fused_attention_block_train=layers, attention_bwd_saved_db=layers),
                label="demo-train")
    after = model.state_dict()
    moved = {k: (after[k].float() - v.float()).abs().max().item() for k, v in before.items()}
    log(f"[demo-train] largest change over the 20 steps: {moved}")
    require(len(moved) == 10 and all(d > 0 for d in moved.values()),
            f"HDM / ATMoE tensors the steps did not change: {moved}")
    phase_do_train(device, model, cache, sampler, make_cfg)
    phase_demo_timing(device, card, cfg, model, plain, flag_cfg, flag_model, cache, sampler)


# ---------------------------------------------------------------- phase 23


def phase_demo_timing(device, card, cfg, model, plain, flag_cfg, flag_model, cache,
                      sampler) -> None:
    """DeMo.yml's train step and request beside the flagship's, in turns (the
    host clock, and the profiler's device busy time of one of each); HDM +
    ATMoE alone at batch 64 (the plain model's copy: its BatchNorm statistics
    move), at eval and in training."""
    names = ("DeMo.yml", "flagship")
    time_train_step(device, card, cfg, model, flag_cfg, flag_model, cache, sampler,
                    label="DeMo.yml vs flagship: ", names=names)
    time_extractor(device, card, cfg, model, flag_cfg, flag_model, label="DeMo.yml vs flagship: ",
                   names=names)
    images, cams = request_images(64, cfg, seed=6)
    with torch.no_grad():
        patches, globals_ = plain.backbone(torch.from_numpy(images).to(device, plain.dtype),
                                           torch.from_numpy(cams).to(device))
    fusion = plain.general_fusion
    gen = torch.Generator(device=device).manual_seed(0)
    x = (patches.requires_grad_(True), globals_.requires_grad_(True))

    def eval_fusion():
        with torch.inference_mode():
            fusion(patches, globals_)

    def train_fusion():
        fusion(*x, True, gen).float().square().mean().backward()

    for what, fn in (("eval forward", eval_fusion), ("training forward + backward", train_fusion)):
        busy = sum(device_ms(fn).values())
        log(f"[time] HDM + ATMoE alone, batch 64 ({tuple(patches.shape)} patches), {what}: "
            f"device busy {busy:.4f} ms (profiler), {cuda_ms(fn):.4f} ms (CUDA events) ({card})")
    fusion.zero_grad(set_to_none=True)


# ---------------------------------------------------------------- phase 24


BRANCH_DEPTH = 2
BRANCH_CASES = (  # (label, configs/ file, overrides)
    ("Baseline", "RGBNT201/Baseline.yml", {}),
    ("SDTPS, branch 2", "RGBNT201/DeMo_SDTPS.yml", {}),
    ("DGAF v3, branch 3", "RGBNT201/DeMo_DGAF.yml", {}),
    ("DGAF v1 + GLOBAL_LOCAL, branch 3", "RGBNT201/DeMo_DGAF.yml",
     {"MODEL__DGAF_VERSION": "v1", "MODEL__GLOBAL_LOCAL": True}),
    ("shared SDTPS + DGAF", "RGBNT201/DeMo_SDTPS_shared.yml", {}),
    ("optimized", "RGBNT201/DeMo_optimized.yml", {}),
    ("MSVR310 DeMo.yml, scene protocol", "MSVR310/DeMo.yml", {}),
    ("SACR + SDTPS, DeMoBeiyong", "RGBNT201/DeMo_SACR_SDTPS.yml", {}),
    ("LIF + SDTPS, DeMoBeiyong", "RGBNT201/DeMo_LIF.yml", {}),
    ("MultiModalSACR v1 + SDTPS + DGAF, DeMoBeiyong",
     "RGBNT201/DeMo_MultiModalSACR_SDTPS_DGAF.yml", {}),
    ("MultiModalSACR v2 + SDTPS + DGAF, DeMoBeiyong",
     "RGBNT201/DeMo_MultiModalSACR_SDTPS_DGAF_v2.yml", {}),
    ("SDTPSComplete + DGAF", "RGBNT201/DeMo_SDTPS_DGAF.yml", {"MODEL__SDTPS_VARIANT": "complete"}),
)


def phase_branches(device) -> None:
    """Each BRANCH_CASES model at BRANCH_DEPTH blocks, kernels on: one train
    step through build_train_step (a finite loss; kernels 3 and 4 once per
    block, no other kernel) and one run_eval (embeddings of the model's
    width; kernels 1 and 2 once per block and forward, no other; mAP in
    (0, 1]; MSVR310 under the scene protocol, writing its rank list file)."""
    import tempfile

    from demo2_tpu_torch.data.datasets import SyntheticTriModal
    from demo2_tpu_torch.data.device_cache import DeviceCache
    from demo2_tpu_torch.data.sampler import RandomIdentitySampler
    from demo2_tpu_torch.engine.eval import eval_step, miss_mask, run_eval
    from demo2_tpu_torch.engine.state import create_train_state
    from demo2_tpu_torch.engine.train import build_train_step
    from demo2_tpu_torch.models import make_model

    data = {}
    for label, path, overrides in BRANCH_CASES:
        cfg = yaml_cfg(path, True, TPU__BACKBONE_DEPTH=BRANCH_DEPTH, **overrides)
        size, bs = tuple(cfg.INPUT.SIZE_TRAIN), cfg.SOLVER.IMS_PER_BATCH
        if size not in data:
            ds = SyntheticTriModal(num_pids=16, num_cams=CAMERA_NUM, imgs_per_pid=8,
                                   image_size=size, seed=2)
            val_ds = SyntheticTriModal(num_pids=8, num_cams=CAMERA_NUM, imgs_per_pid=4,
                                       image_size=size, seed=3)
            val_samples = val_ds.query + val_ds.gallery
            data[size] = (
                ds, DeviceCache.from_arrays(ds.render_all(ds.train), ds.train, train=True,
                                            cfg=cfg, device=device),
                DeviceCache.from_arrays(val_ds.render_all(val_samples), val_samples,
                                        train=False, cfg=cfg, device=device),
                len(val_ds.query),
                RandomIdentitySampler(ds.train, bs, cfg.DATALOADER.NUM_INSTANCE,
                                      seed=cfg.SOLVER.SEED))
        ds, train, val, nq, sampler = data[size]
        model = make_model(cfg, ds.num_train_pids, CAMERA_NUM, device=device,
                           generator=torch.Generator().manual_seed(3))
        step = build_train_step(cfg, model, create_train_state(cfg, model, len(sampler) // bs),
                                train)
        idx = torch.from_numpy(sampler.epoch_indices(1)[:bs]).to(device)
        reset_counts()
        loss = step(idx)["loss"].item()
        require_launches(counts(), launch_dict(fused_attention_block_train=BRANCH_DEPTH,
                                               attention_bwd_saved_db=BRANCH_DEPTH),
                         f"[branches] {label}: train step")
        require(math.isfinite(loss), f"{label}: loss {loss}")
        images, _, camids = val.batch(torch.arange(4, device=device))
        emb = eval_step(model, images, camids, miss_mask("None", device=device))
        require(emb.shape == (4, model.embed_dim) and bool(torch.isfinite(emb).all()),
                f"{label}: embedding {tuple(emb.shape)}, width {model.embed_dim}")
        scene = cfg.DATASETS.NAMES == "MSVR310"
        forwards = math.ceil(val.images.shape[0] / cfg.TEST.IMS_PER_BATCH)
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts()
            cmc, m_ap = run_eval(cfg, model, val, nq,
                                 rank_list_path=f"{tmp}/re.txt" if scene else None)
            require_launches(counts(), launch_dict(fused_attention_block=BRANCH_DEPTH * forwards,
                                                   fused_mlp_block=BRANCH_DEPTH * forwards),
                             f"[branches] {label}: run_eval")
            if scene:
                with open(f"{tmp}/re.txt") as f:
                    require(f.read().startswith("rank list file"), "no MSVR310 rank list")
        require(0.0 < m_ap <= 1.0, f"{label}: mAP {m_ap}")
        protocol = ", scene protocol, rank list written" if scene else ""
        log(f"[branches] {label} ({path}, {BRANCH_DEPTH} blocks, {size[0]}x{size[1]}): branches "
            f"{list(model.branch_heads)}, step-1 loss {loss:.4f}, embedding width "
            f"{model.embed_dim}, mAP {m_ap:.4f}{protocol}")
        del model, step


# ---------------------------------------------------------------- phase 25


# (label, configs/ file, the state-dict prefixes of its own modules, whether
# the whole model's step-1 gradient and its losses are held to the plain
# path's).  DeMo_Parallel's are not: its sdtps_* branches take SDTPS's
# masked token mean straight to the losses, and SDTPS's gradient with
# respect to its input is ill-conditioned at random weights: 0.4% of noise
# on the input turns it by a cosine of 0.844 in f32, in the port and the JAX
# package alike, DGAF v3's by 0.99999 (tests/test_torch_parallel_frca.py::
# test_sdtps_input_gradient_is_ill_conditioned_in_both_packages).  So the
# bf16 rounding that separates the two paths' backbone outputs turns the
# whole model's step-1 gradient by a cosine of 0.87 on the card, and the
# trajectories part by 4-6% within ten steps.  Its backbone is held from one
# upstream gradient instead (check_backbone_grads); both readings are
# printed.
ASSEMBLY_CASES = (
    ("legacy", "RGBNT201/DeMo_SACR_SDTPS_LIF.yml", ("sacr.", "lif.", "sdtps.", "gl_fuse."), True),
    ("parallel", "RGBNT201/DeMo_Parallel.yml", ("sdtps.", "dgaf.", "gl_fuse.", "head_"), False),
    ("frca", "RGBNT201/DeMo_FRCA_DGAF.yml", ("frca_", "dgaf."), True),
)
SPECTRUM_REL = 1e-5  # the card's f32 spectrum vs numpy's f64, of its largest bin


def assembly_cfg(path: str):
    return lambda fused, **overrides: yaml_cfg(path, fused, **overrides)


def phase_assembly_eval(device, cfg, model, train_cache, label: str) -> None:
    """run_eval at the model's embedding width: kernels 1 and 2 once per
    block and forward and no other kernel, mAP in (0, 1]."""
    from demo2_tpu_torch.engine.eval import eval_step, miss_mask, run_eval

    val, nq = eval_cache_from(train_cache, cfg)
    layers = num_blocks(model)
    forwards = math.ceil(val.images.shape[0] / cfg.TEST.IMS_PER_BATCH)
    images, _, camids = val.batch(torch.arange(8, device=device))
    emb = eval_step(model, images, camids, miss_mask("None", device=device))
    require(emb.shape == (8, model.embed_dim) and bool(torch.isfinite(emb).all()),
            f"[{label}] embedding {tuple(emb.shape)}, expected width {model.embed_dim}")
    reset_counts()
    cmc, m_ap = run_eval(cfg, model, val, nq)
    sync()
    require_launches(counts(), launch_dict(fused_attention_block=layers * forwards,
                                           fused_mlp_block=layers * forwards),
                     f"[{label}] run_eval")
    require(0.0 < m_ap <= 1.0, f"[{label}] mAP {m_ap}")
    log(f"[{label}] run_eval: embedding width {model.embed_dim}, {nq} queries, mAP {m_ap:.4f}, "
        f"Rank-1 {cmc[0]:.3f}")


def check_lif_loss(device, cfg, model, cache, sampler, label: str) -> None:
    """A training forward gives a finite, positive aux_loss['lif'], and the
    step's loss is the branch losses plus LIF_LOSS_WEIGHT times it."""
    from demo2_tpu_torch.engine.train import loss_and_grads
    from demo2_tpu_torch.losses.losses import branch_weights, make_loss_fn

    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    idx = torch.from_numpy(sampler.epoch_indices(1)[:cfg.SOLVER.IMS_PER_BATCH]).to(device)
    gen = torch.Generator(device=device).manual_seed(cfg.SOLVER.SEED)
    images, pids, camids = cache.batch(idx, gen)
    loss_fn = make_loss_fn(cfg, NUM_CLASSES)
    with torch.no_grad():
        out = model(images.to(model.dtype), camids, None, None, train=True,
                    generator=torch.Generator(device=device).manual_seed(1))
    model.load_state_dict(init)
    lif = out["aux_loss"]["lif"].item()
    weights = branch_weights(cfg, out["branches"])
    branch = sum(weights[k] * loss_fn(lg, f, pids) for k, (lg, f) in out["branches"].items())
    loss = loss_and_grads(cfg, model, loss_fn, images, pids, camids,
                          torch.Generator(device=device).manual_seed(1))[0].item()
    model.load_state_dict(init)
    want = branch.item() + cfg.MODEL.LIF_LOSS_WEIGHT * lif
    log(f"[{label}] aux_loss['lif'] {lif:.6f}; step loss {loss:.6f} = branch losses "
        f"{branch.item():.6f} + {cfg.MODEL.LIF_LOSS_WEIGHT} x lif ({want:.6f})")
    require(math.isfinite(lif) and lif > 0, f"aux_loss['lif'] {lif}")
    require(abs(loss - want) <= 1e-3 * abs(want), f"the step's loss {loss} is not {want}")


def phase_frca_spectrum(device, cfg, model, label: str) -> None:
    """FRCA's channel spectrum on the card (cuFFT) against numpy's f64 FFT of
    the same descriptor on the host: within SPECTRUM_REL of its largest bin,
    and at the real bins (DC, the even sizes' Nyquist rows and columns) the
    phase 0 or pi by the sign of the real part.  Prints what cuFFT itself
    leaves there."""
    import torch.nn.functional as F

    from demo2_tpu_torch.models.frca import _grid_dims, channel_spectrum, real_bins

    images, cams = request_images(64, cfg, seed=7)
    with torch.inference_mode():
        patches, _ = model.backbone(torch.from_numpy(images).to(device, model.dtype),
                                    torch.from_numpy(cams).to(device))
        m, b, n, c = patches.shape
        descs = [getattr(model, f"frca_{nm}").clc3(patches[i].reshape(b, *model.grid, c))
                 .float().mean((1, 2)) for i, nm in enumerate(("rgb", "nir", "tir"))]
        desc = torch.cat(descs)
        hc, wc, pad = _grid_dims(c)
        spec = channel_spectrum(desc).cpu().numpy()
        raw = torch.fft.fft2(F.pad(desc, (0, pad)).reshape(-1, hc, wc)).cpu().numpy()
    ref = np.fft.fft2(np.pad(desc.cpu().double().numpy(), ((0, 0), (0, pad)))
                      .reshape(-1, hc, wc))
    real = real_bins(hc, wc, torch.device("cpu")).numpy()
    rel = float(np.abs(spec - ref).max() / np.abs(ref).max())
    phase, want = np.angle(spec)[:, real], np.where(ref.real[:, real] < 0, np.float32(np.pi), 0.0)
    negative = int((ref.real[:, real] < 0).sum())
    raw_nonzero = int((raw.imag[:, real] != 0).sum())
    raw_flips = int(((ref.real[:, real] < 0) & np.signbit(raw.imag[:, real])).sum())
    log(f"[{label}] FRCA spectrum ({desc.shape[0]} descriptors on the {hc} x {wc} grid of "
        f"C = {c}): card vs numpy f64 {rel:.3e} of the largest bin; {real.sum()} real bins a "
        f"grid, {negative} of {phase.size} negative; torch.fft on the device leaves "
        f"{raw_nonzero} non-zero imaginary parts there, {raw_flips} of the negative ones at "
        f"-pi; numpy {int((ref.imag[:, real] != 0).sum())}")
    require(rel <= SPECTRUM_REL, f"FRCA spectrum vs numpy: {rel} > {SPECTRUM_REL}")
    require(np.array_equal(phase, want), "FRCA phase at the real bins is not 0 / pi by the "
            "sign of numpy's real part")
    require(np.allclose(np.abs(np.angle(ref)[:, real]), phase, atol=1e-6),
            "FRCA phase at the real bins differs from numpy's beyond its sign")


def phase_assemblies(device, card, flag_cfg, flag_model, cache, sampler,
                     timing: bool = True) -> None:
    """Each ASSEMBLY_CASES file at full width, the kernel path and the plain
    path with the same weights: serving (phase 3's checks), run_eval at its
    width, training (phase 6's checks; the assembly's own parameters and
    BatchNorm statistics among what must change, the LIF loss in the step),
    FRCA's spectrum on the card, then phase 26's timing beside the
    flagship."""
    for label, path, own, whole_model in ASSEMBLY_CASES:
        cfg, model, plain_cfg, plain = build_models(device, cut_depth(assembly_cfg(path)))
        layers = num_blocks(model)
        log(f"[{label}] configs/{path} at {layers} blocks: {type(model).__name__}, "
            f"{sum(p.numel() for p in model.parameters())} parameters, branches "
            f"{list(model.branch_heads)}, embedding width {model.embed_dim}")
        phase_slice(device, cfg, model, plain_cfg, plain,
                    launch_dict(fused_attention_block=layers, fused_mlp_block=layers),
                    label=f"{label}-slice")
        phase_assembly_eval(device, cfg, model, cache, f"{label}-eval")
        if cfg.MODEL.USE_LIF:
            check_lif_loss(device, cfg, model, cache, sampler, f"{label}-train")
        before = {k: v.detach().clone() for k, v in model.state_dict().items()
                  if k.startswith(own)}
        phase_train(device, cfg, model, plain_cfg, plain, cache, sampler,
                    launch_dict(fused_attention_block_train=layers, attention_bwd_saved_db=layers),
                    label=f"{label}-train", whole_model=whole_model)
        after = model.state_dict()
        moved = {}
        for k, v in before.items():
            group = k.split(".")[0]
            change = (after[k].float() - v.float()).abs().max().item()
            moved[group] = max(moved.get(group, 0.0), change)
        unmoved = [k for k, v in before.items() if torch.equal(after[k], v)]
        log(f"[{label}-train] largest change of its own modules over the steps: {moved}")
        require(not unmoved, f"[{label}] tensors the steps did not change: {unmoved}")
        if hasattr(model, "frca_rgb"):
            phase_frca_spectrum(device, cfg, model, f"{label}-frca")
        if timing:
            phase_assembly_timing(device, card, label, cfg, model, plain, flag_cfg, flag_model,
                                  cache, sampler)
        del model, plain
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 26


def assembly_modules(model, patches, globals_, images):
    """{name: fn(train)} of the assembly's own modules on one batch-64 input:
    SACR's core, LIF's predictors and targets, FRCA with its cross-attention,
    DeMoParallel's nine heads."""
    from demo2_tpu_torch.models.lif import lif_loss

    m, b, n, c = patches.shape
    fns = {}
    if hasattr(model, "sacr"):
        grid = patches.reshape(m * b, *model.grid, c)
        fns["SACR core"] = lambda train: model.sacr.core(grid, train)
    if hasattr(model, "lif"):
        def lif(train):
            q = model.lif(images, train)
            return lif_loss(q, images) if train else q
        fns["LIF predictors + targets"] = lif
    if hasattr(model, "frca_rgb"):
        fns["FRCA x 3 + cross-attention + V3Multi"] = lambda train: model._frca_cross(
            model._frca_stack(patches), train)
    if len(model.branch_heads) == 9:
        fns["nine heads"] = lambda train: torch.stack([
            getattr(model, f"head_{name}")(globals_[0], train)
            for name in model.branch_heads.values()])
    return fns


def phase_assembly_timing(device, card, label, cfg, model, plain, flag_cfg, flag_model, cache,
                          sampler) -> None:
    """The assembly's train step and batch-64 request beside the flagship's,
    in turns, with a profile of each (device busy), and its own modules'
    device time at batch 64 (the plain model's copies: their BatchNorm
    statistics move), at eval and in training."""
    names = (label, "flagship")
    time_train_step(device, card, cfg, model, flag_cfg, flag_model, cache, sampler,
                    label=f"{label} vs flagship: ", names=names)
    time_extractor(device, card, cfg, model, flag_cfg, flag_model,
                   label=f"{label} vs flagship: ", names=names)
    images_np, cams = request_images(64, cfg, seed=6)
    images = torch.from_numpy(images_np).to(device, plain.dtype)
    with torch.no_grad():
        patches, globals_ = plain.backbone(images, torch.from_numpy(cams).to(device))
    patches.requires_grad_(True)
    for name, fn in assembly_modules(plain, patches, globals_, images).items():
        def eval_fn():
            with torch.inference_mode():
                fn(False)

        def train_fn():
            fn(True).float().square().mean().backward()

        for what, f in (("eval forward", eval_fn), ("training forward + backward", train_fn)):
            busy = sum(device_ms(f).values())
            log(f"[time] {label}: {name} alone, batch 64, {what}: device busy {busy:.4f} ms "
                f"(profiler), {cuda_ms(f):.4f} ms (CUDA events) ({card})")
    plain.zero_grad(set_to_none=True)


# ---------------------------------------------------------------- phase 27


# The decode check, in u8 levels: PIL against the native loader at eval
# (max 8, mean 1.5: tests/test_data.py's bounds) plus the error of a quality-95
# JPEG of phase 27's images resized to 256x128 (on the CPU with libjpeg, over
# all 960: bicubic max 19, mean 2.115; bilinear 16, 1.617; held by
# tests/test_torch_data.py).  The source shifted by one pixel reads a mean of
# 20-27 and fails.
PIL_NATIVE_MAX_U8, PIL_NATIVE_MEAN_U8 = 8.0, 1.5
JPEG_Q95_MAX_U8, JPEG_Q95_MEAN_U8 = 20.0, 2.2
DECODE_MAX_U8 = PIL_NATIVE_MAX_U8 + JPEG_Q95_MAX_U8
DECODE_MEAN_U8 = PIL_NATIVE_MEAN_U8 + JPEG_Q95_MEAN_U8


def resized_reference(src: torch.Tensor, size, mode: str) -> torch.Tensor:
    """uint8 (..., H, W, 3) images resized to `size` by F.interpolate with
    antialiasing ("bicubic" as TrainTransform, "bilinear" as EvalTransform),
    rounded to u8 levels, as f32."""
    lead = src.shape[:-3]
    x = src.reshape(-1, *src.shape[-3:]).permute(0, 3, 1, 2).float()
    y = torch.nn.functional.interpolate(x, size=tuple(size), mode=mode, antialias=True,
                                        align_corners=False)
    return y.round().clamp(0, 255).permute(0, 2, 3, 1).reshape(*lead, *size, 3)


DATA_SRC = (288, 144)        # the source images' size, as tools/make_synthetic_jpegs.py
DATA_IDS = (32, 8)           # train and test ids, 8 images each: 960 JPEGs
DATA_IMGS = 8
DATA_EPOCHS = 2


def data_opts(root: str, out: str, data_cache: str) -> list:
    """The command line of the flagship's training on the JPEG tree: the keys
    of configs/RGBNT201/DeMo_SDTPS_DGAF.yml, apply_flagship's production
    flags, 2 epochs with an eval and a checkpoint each."""
    keys = YAML_KEYS["RGBNT201/DeMo_SDTPS_DGAF.yml"] + [
        "TPU.COMPUTE_DTYPE", "bfloat16", "TPU.USE_FLASH_ATTENTION", True,
        "TPU.BF16_MOMENTS", True, "TPU.BF16_SECOND_MOMENT", True,
        "DATASETS.NAMES", "RGBNT201", "DATASETS.ROOT_DIR", root, "SOLVER.MAX_EPOCHS", DATA_EPOCHS,
        "SOLVER.EVAL_PERIOD", 1, "SOLVER.CHECKPOINT_PERIOD", 1, "SOLVER.LOG_PERIOD", 2,
        "TPU.DATA_CACHE", data_cache, "OUTPUT_DIR", out]
    if REHEARSAL:
        keys += ["TPU.BACKBONE_DEPTH", 2, "TPU.BACKBONE_WIDTH", 64, "TPU.BACKBONE_HEADS", 2,
                 "INPUT.SIZE_TRAIN", [64, 32], "INPUT.SIZE_TEST", [64, 32],
                 "SOLVER.IMS_PER_BATCH", 16, "DATALOADER.NUM_INSTANCE", 2, "MODEL.DEVICE", "cpu"]
    return [v if isinstance(v, str) else str(v) for v in keys]


def write_jpeg_tree(root: str) -> dict:
    """An RGBNT201 tree, <root>/RGBNT201/{train_171,test}/{RGB,NI,TI}/
    <pid>_cam<k>_<j>.jpg, of SyntheticTriModal's hard recipe at DATA_SRC,
    written at quality 95 by tools/make_synthetic_jpegs.py's generate with
    the port's JPEG writer (no PIL needed).  Returns {RGB path: the sample's
    (3, H, W, 3) uint8 source}."""
    import os

    from demo2_tpu_torch.data.datasets import SyntheticTriModal
    from demo2_tpu_torch.tools.make_synthetic_jpegs import generate

    generate(root, num_pids=DATA_IDS[0], imgs_per_pid=DATA_IMGS, test_pids=DATA_IDS[1],
             test_imgs_per_pid=DATA_IMGS, num_cams=CAMERA_NUM, src_size=DATA_SRC,
             writer="native")
    renderer = SyntheticTriModal(num_pids=max(DATA_IDS), num_cams=CAMERA_NUM, imgs_per_pid=1,
                                 image_size=DATA_SRC, seed=0, hard=True)
    return {os.path.join(root, "RGBNT201", split, "RGB",
                         f"{pid:06d}_cam{(pid + j) % CAMERA_NUM + 1}_{j:03d}.jpg"):
            np.stack(renderer.render((tag, pid, j)))
            for split, ids, tag in (("train_171", DATA_IDS[0], "train"),
                                    ("test", DATA_IDS[1], "test"))
            for pid in range(ids) for j in range(DATA_IMGS)}


def check_decode(device, pipe, sources, train: bool) -> None:
    """build_device_cache's decode of `pipe` against the source arrays
    resized on the device by F.interpolate with antialiasing, within
    DECODE_MAX_U8 / DECODE_MEAN_U8; the source shifted by one pixel (a
    control on the same cache) must fail them."""
    from demo2_tpu_torch.data.device_cache import build_device_cache

    cache = build_device_cache(pipe, device, train=train)
    src = torch.from_numpy(np.stack([sources[s[0][0]] for s in pipe.samples])).to(device)
    mode = "bicubic" if train else "bilinear"
    errs = []
    for shift in (0, 1):
        want = resized_reference(torch.roll(src, shift, dims=3), cache.size, mode)
        d = (cache.images.float() - want).abs()
        errs.append((d.max().item(), d.mean().item()))
    (mx, mean), (cmx, cmean) = errs
    within = lambda m, a: m <= DECODE_MAX_U8 and a <= DECODE_MEAN_U8
    log(f"[data] {'train' if train else 'eval'} cache {tuple(cache.images.shape)} decoded in "
        f"{cache.decode_seconds:.2f} s against the sources resized ({mode}, antialiased): max "
        f"{mx:.0f}, mean {mean:.4f} u8 levels (bounds {DECODE_MAX_U8:.0f}, "
        f"{DECODE_MEAN_U8:.1f}); shifted by one pixel: max {cmx:.0f}, mean {cmean:.4f}")
    require(within(mx, mean), f"decode error max {mx} / mean {mean} outside the bounds")
    require(not within(cmx, cmean), "the shifted control passes the decode bounds")


def phase_data(device, root: str) -> dict:
    """Phase 27: the input path from disk and the CLIs.  Returns the
    launches of the two training runs."""
    import os

    from demo2_tpu_torch.data import device_cache
    from demo2_tpu_torch.data.loader import make_dataloader
    from demo2_tpu_torch.data.native import native_library
    from demo2_tpu_torch.tools import test as test_cli, train as train_cli
    from demo2_tpu_torch.utils.metrics_log import load_metrics

    nl = native_library()
    require(nl.lib is not None, f"the native loader did not build: {nl.error}")
    log(f"[data] native loader: {nl.decoder} decoder, {nl.path}")
    device_cache.DECODE_CACHE_DIR = os.path.join(root, "decoded")  # nothing outside the tree
    t0 = time.perf_counter()
    sources = write_jpeg_tree(root)
    log(f"[data] wrote {3 * len(sources)} JPEGs ({DATA_SRC[0]}x{DATA_SRC[1]}, quality 95) in "
        f"{time.perf_counter() - t0:.1f} s")
    cli_device = None if device.type == "cuda" else device  # the card by the CLIs' own rule
    # The decode is checked at 256x128 (the bounds' size) in a rehearsal too.
    cfg = train_cli.load_config("", data_opts(root, os.path.join(root, "check"), "device") + [
        "INPUT.SIZE_TRAIN", "[256, 128]", "INPUT.SIZE_TEST", "[256, 128]"])
    train_pipe, _, val_pipe, *_ = make_dataloader(cfg.freeze())
    require(train_pipe.use_native and val_pipe.use_native,
            "make_dataloader did not take the native loader for the JPEG tree")
    check_decode(device, train_pipe, sources, train=True)
    check_decode(device, val_pipe, sources, train=False)

    cfg = train_cli.load_config("", data_opts(root, os.path.join(root, "check"), "host"))
    _, sampler, val_pipe, *_ = make_dataloader(cfg.freeze())
    bs = cfg.SOLVER.IMS_PER_BATCH
    steps = DATA_EPOCHS * (len(sampler) // bs)
    evals = DATA_EPOCHS * math.ceil(len(val_pipe.samples) / cfg.TEST.IMS_PER_BATCH)
    layers = 2 if REHEARSAL else 12
    want = launch_dict(fused_attention_block=layers * evals, fused_mlp_block=layers * evals,
                       fused_attention_block_train=layers * steps,
                       attention_bwd_saved_db=layers * steps)
    launches = {}
    for data_cache in ("host", "device"):
        out = os.path.join(root, f"run_{data_cache}")
        opts = data_opts(root, out, data_cache)
        reset_counts()
        t0 = time.perf_counter()
        state, best = train_cli.main(["--exp_name", "smoke"] + opts, device=cli_device)
        sync()
        wall = time.perf_counter() - t0
        launches[data_cache] = counts()
        losses = [e["loss"] for e in state.history]
        last = state.history[-1]
        log(f"[data] tools/train.main, TPU.DATA_CACHE {data_cache}: {steps} steps of {bs} and "
            f"{evals} eval forwards in {wall:.1f} s; losses by epoch {losses}; mAP "
            f"{[e['mAP'] for e in state.history]}, Rank-1 {[e['Rank-1'] for e in state.history]}; "
            f"launches {launches[data_cache]}")
        require_launches(launches[data_cache], want, f"[data] tools/train.main ({data_cache})")
        require(len(losses) == DATA_EPOCHS and all(math.isfinite(x) for x in losses),
                f"losses {losses}")
        tags = {r["tag"] for r in load_metrics(os.path.join(out, "smoke_metrics.jsonl"))}
        require(tags == {"Train/Loss", "Train/Acc", "Train/LR", "Val/mAP", "Val/Rank-1",
                         "Val_Best/mAP"}, f"metrics file tags {tags}")
        logs = [f for f in os.listdir(out) if f.startswith("train_log_")]
        best_dir = os.path.join(out, "checkpoints_best")
        require(logs and os.path.isdir(best_dir) and os.listdir(best_dir),
                f"log {logs} or best checkpoint missing")
        for weights, (m_ap, r1) in (("checkpoints", (last["mAP"], last["Rank-1"])),
                                    ("checkpoints_best", (best["mAP"], best["Rank-1"]))):
            cmc, got = test_cli.main(opts + ["TEST.WEIGHT", os.path.join(out, weights)],
                                     device=cli_device)
            log(f"[data] tools/test.main on {weights}: mAP {got}, Rank-1 {cmc[0]} (the run's "
                f"{m_ap}, {r1})")
            require((got, float(cmc[0])) == (m_ap, r1),
                    f"tools/test.main on {weights} gives mAP {got}, Rank-1 {cmc[0]}, the run "
                    f"{m_ap}, {r1}")
    return launches


# ---------------------------------------------------------------- phase 28


def phase_data_timing(device, card, root: str) -> None:
    """Phase 28 (printed only): the native loader's decode rate over phase
    27's train JPEGs by thread count, and the flagship's batch-64 train step
    fed by the host pipe against the device cache, in turns, with the device
    busy share of a profiled window of each."""
    import os

    from demo2_tpu_torch.data.device_cache import build_device_cache
    from demo2_tpu_torch.data.loader import device_batches, make_dataloader
    from demo2_tpu_torch.data.native import load_batch_native, sample_train_params
    from demo2_tpu_torch.engine.state import create_train_state
    from demo2_tpu_torch.engine.train import build_host_train_step, build_train_step
    from demo2_tpu_torch.models import make_model
    from demo2_tpu_torch.tools.train import load_config

    cfg = load_config("", data_opts(root, os.path.join(root, "timing"), "host")).freeze()
    train_pipe, sampler, *_ = make_dataloader(cfg)
    h, w = cfg.INPUT.SIZE_TRAIN
    paths = [p for s in train_pipe.samples for p in s[0]]
    params = [sample_train_params(np.random.default_rng((0, i)), (h, w))
              for i in range(len(paths))]
    for threads in (1, 2, 4, 8):
        load_batch_native(paths[:16], params[:16], h, w, cfg.INPUT.PIXEL_MEAN,
                          cfg.INPUT.PIXEL_STD, num_threads=threads)
        t0 = time.perf_counter()
        load_batch_native(paths, params, h, w, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD,
                          num_threads=threads)
        seconds = time.perf_counter() - t0
        log(f"[data-time] native loader, {len(paths)} JPEGs {DATA_SRC[0]}x{DATA_SRC[1]} -> "
            f"{h}x{w} with the train transform, {threads} threads: {seconds:.3f} s, "
            f"{len(paths) / seconds:.1f} images/s ({card})")

    bs = cfg.SOLVER.IMS_PER_BATCH
    model = make_model(cfg, DATA_IDS[0], CAMERA_NUM, device=device,
                       generator=torch.Generator().manual_seed(0))
    cache = build_device_cache(train_pipe, device, train=True)
    state = create_train_state(cfg, model, len(sampler) // bs)
    cache_step = build_train_step(cfg, model, state, cache)
    host_step = build_host_train_step(cfg, model, state, device)
    order = torch.from_numpy(sampler.epoch_indices(1)).to(device)

    def host_batches():
        for epoch in range(1, 10**6):
            yield from device_batches(train_pipe, sampler.epoch_indices(epoch), device,
                                      seed=epoch)

    batches = host_batches()
    steppers = {"host pipe": lambda i: host_step(*next(batches)[1:]),
                "device cache": lambda i: cache_step(order[(i % (len(order) // bs)) * bs:][:bs])}

    def step_ms(which, reps=6):
        run = steppers[which]
        for i in range(2):
            run(i)
        sync()
        t0 = time.perf_counter()
        for i in range(reps):
            run(i)
        sync()
        return (time.perf_counter() - t0) * 1e3 / reps

    try:
        turns = [(which, step_ms(which)) for which in ("host pipe", "device cache",
                                                       "device cache", "host pipe")]
        log(f"[data-time] flagship train step, batch {bs}, in turns: "
            + ", ".join(f"{which} {ms:.2f} ms" for which, ms in turns) + f" ({card})")
        for which in ("host pipe", "device cache"):
            wall, busy = profile(f"train step of {bs} fed by the {which}, 4 steps",
                                 lambda: [steppers[which](i) for i in range(4)], card, top=6)
            log(f"[data-time] {which}: device busy {100 * busy / wall:.1f}% of 4 steps "
                f"({busy:.2f} of {wall:.2f} ms) ({card})")
    finally:
        batches.close()  # stops the pipe's producer


# ---------------------------------------------------------------- phase 29


REMAT_GRAD_COS = 0.99999  # a gradient that remat does not give bit for bit
KNOB_PHASE_BUDGET_S = 60.0


def phase_remat(device, card, cfg, model, cache, sampler) -> dict:
    """Phase 29, part 1: one training forward and backward of the flagship
    at batch 64 with TPU.REMAT_BACKBONE and one without, from the same
    weights, batch and draws.  The loss bit-equal, every gradient bit-equal
    (where one is not: named, and held to a cosine of REMAT_GRAD_COS); with
    remat kernel 3 launched twice a block (the forward, the recompute) and
    kernel 4 once, by the wrappers' counts and by the profiler's count of
    their attention launches; remat's peak memory lower.  Then both train
    steps timed in turns.  Returns the remat step's launches."""
    from demo2_tpu_torch.engine.train import loss_and_grads
    from demo2_tpu_torch.losses.losses import make_loss_fn
    from demo2_tpu_torch.models import make_model

    remat_cfg = flagship_cfg(True, TPU__REMAT_BACKBONE=True)
    remat = make_model(remat_cfg, NUM_CLASSES, CAMERA_NUM, device=device,
                       generator=torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    bs = cfg.SOLVER.IMS_PER_BATCH
    idx = torch.from_numpy(sampler.epoch_indices(1)[:bs]).to(device)
    layers = num_blocks(model)

    def step(c, m):
        m.load_state_dict(init)
        gen = torch.Generator(device=device).manual_seed(cfg.SOLVER.SEED)
        images, pids, camids = cache.batch(idx, gen)
        return loss_and_grads(c, m, make_loss_fn(c, NUM_CLASSES), images, pids, camids, gen)

    card_memory = device.type == "cuda"
    runs = {}
    for label, c, m in (("no remat", cfg, model), ("remat", remat_cfg, remat)):
        sync()
        if card_memory:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() if card_memory else 0
        reset_counts()
        loss, _, grads = step(c, m)
        sync()
        runs[label] = dict(loss=loss.item(), grads={k: g.cpu() for k, g in grads.items()},
                           peak=torch.cuda.max_memory_allocated() if card_memory else 0,
                           resident=resident, launches=counts())
        del loss, grads
        log(f"[remat] {label}: step-1 loss {runs[label]['loss']:.6f}, peak device memory "
            f"{runs[label]['peak'] / 2**30:.2f} GiB ({(runs[label]['peak'] - resident) / 2**30:.2f}"
            f" above the {resident / 2**30:.2f} resident), launches {runs[label]['launches']} "
            f"({card})")
    plain_run, remat_run = runs["no remat"], runs["remat"]
    require_launches(plain_run["launches"], launch_dict(fused_attention_block_train=layers,
                                                        attention_bwd_saved_db=layers),
                     "[remat] the step without remat")
    require_launches(remat_run["launches"], launch_dict(fused_attention_block_train=2 * layers,
                                                        attention_bwd_saved_db=layers),
                     "[remat] the step with remat")
    require(remat_run["loss"] == plain_run["loss"],
            f"remat's loss {remat_run['loss']!r} != {plain_run['loss']!r}")
    unequal = {k: cosine(g, plain_run["grads"][k]) for k, g in remat_run["grads"].items()
               if not torch.equal(g, plain_run["grads"][k])}
    log(f"[remat] loss bit-equal; {len(remat_run['grads']) - len(unequal)} of "
        f"{len(remat_run['grads'])} gradients bit-equal"
        + "".join(f"; {k} not, cosine {v:.8f}" for k, v in sorted(unequal.items())))
    require(all(v >= REMAT_GRAD_COS for v in unequal.values()),
            f"remat gradients below a cosine of {REMAT_GRAD_COS}: {unequal}")
    require(remat_run["peak"] < plain_run["peak"] or not card_memory,
            "remat's peak memory is not lower")
    if not REHEARSAL:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as torch_profile

        want = {"attention_regs_fwd_kernel": 2 * layers, "attention_regs_bwd_kernel": layers}
        for attempt in range(4):  # CUPTI now and then drops events
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step(remat_cfg, remat)
                sync()
            got = {name: sum(e.count for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA and name in e.key)
                   for name in want}
            if got == want:
                break
            log(f"[remat] profiler launches {got}, not {want} (attempt {attempt + 1})")
        log(f"[remat] profiler, one remat step: kernel 3's attention launched "
            f"{got['attention_regs_fwd_kernel']} times, kernel 4's "
            f"{got['attention_regs_bwd_kernel']} ({card})")
        require(got == want, f"profiler launches {got} != {want}")
    del runs
    if card_memory:
        time_train_step(device, card, remat_cfg, remat, cfg, model, cache, sampler,
                        label="remat: ", names=("remat", "no remat"), profiles=False)
    model.load_state_dict(init)
    return remat_run["launches"]


def knobs_cfg(fused: bool, **overrides):
    """The flagship with center loss and the timm cosine schedule."""
    return flagship_cfg(fused, MODEL__METRIC_LOSS_TYPE="triplet_center",
                        TPU__ENABLE_COSINE_SCHEDULE=True, SOLVER__LR_SCHEDULER="cosine",
                        **overrides)


def phase_knobs(device, cache, sampler) -> None:
    """Phase 29, part 2: phase 6 on the flagship with METRIC_LOSS_TYPE
    triplet_center and the cosine schedule (the step-1 gradients with the
    center loss, 20 steps against the plain path), then the centers: moved
    for the ids the steps saw, unmoved for the others, finite; the lr of
    every step the cosine recipe's (timm_cosine_lr, in f32), not the
    multistep rule's."""
    from demo2_tpu_torch.losses.losses import CenterLossState
    from demo2_tpu_torch.solver.optim import (make_lr_schedule, timm_cosine_lr,
                                              warmup_multistep_lr)

    cfg, model, plain_cfg, plain = build_models(device, knobs_cfg)
    layers = num_blocks(model)
    states = []
    phase_train(device, cfg, model, plain_cfg, plain, cache, sampler,
                launch_dict(fused_attention_block_train=layers, attention_bwd_saved_db=layers),
                label="knob-train", states=states)
    state = states[0]
    s = cfg.SOLVER
    start = CenterLossState.create(torch.Generator().manual_seed(s.SEED), NUM_CLASSES, 2048,
                                   device).centers
    bs = s.IMS_PER_BATCH
    order = torch.from_numpy(sampler.epoch_indices(1)[: TRAIN_STEPS * bs]).to(device)
    seen = torch.zeros(NUM_CLASSES, dtype=torch.bool, device=device)
    seen[cache.pids[order]] = True
    moved = (state.centers != start).any(1)
    log(f"[knob-train] centers: {int(moved.sum())} of {NUM_CLASSES} rows moved, "
        f"{int(seen.sum())} ids seen; largest move "
        f"{(state.centers - start).abs().max().item():.6f}")
    require(bool(torch.isfinite(state.centers).all()), "non-finite centers")
    require(torch.equal(moved, seen), "the centers that moved are not the ids the steps saw")
    spe = len(sampler.epoch_indices(1)) // bs
    rule = timm_cosine_lr(s.BASE_LR, t_initial=s.MAX_EPOCHS, lr_min=0.001 * s.BASE_LR,
                          decay_rate=0.1, warmup_t=s.WARMUP_ITERS,
                          warmup_lr_init=0.1 * s.BASE_LR, cycle_limit=1,
                          noise_range_t=(0, s.MAX_EPOCHS))
    multistep = warmup_multistep_lr(s.BASE_LR, s.STEPS, s.GAMMA, s.WARMUP_FACTOR,
                                    s.WARMUP_ITERS, s.WARMUP_METHOD)
    steps = range(state.step + 2 * spe)
    lrs = [state.schedule(i) for i in steps]
    want = [float(np.float32(rule(1 + i // spe))) for i in steps]
    log(f"[knob-train] lr by epoch: {sorted(set(lrs), key=lrs.index)} after {state.step} steps")
    require(state.step == TRAIN_STEPS, f"{state.step} optimizer steps")
    require(lrs == want and lrs == [make_lr_schedule(cfg, spe)(i) for i in steps],
            "the schedule is not the cosine recipe's")
    require(lrs != [float(np.float32(multistep(1 + i // spe))) for i in steps],
            "the schedule is the multistep rule's")


def phase_gate(device, root: str) -> None:
    """Phase 29, part 3: the quality gate's mechanics, quality_gate.main
    with --report-only over 2 epochs of a small tree (16 ids x 8, 8 test
    ids) at full width: the report written with two evals in [0, 1] and
    finite losses; kernels 3 and 4 launched 12 times a step, 1 and 2 12
    times an eval forward, no other."""
    import json as json_
    import os

    from demo2_tpu_torch.data import device_cache
    from demo2_tpu_torch.data.loader import make_dataloader
    from demo2_tpu_torch.tools import quality_gate

    device_cache.DECODE_CACHE_DIR = os.path.join(root, "decoded")  # nothing outside the tree
    report = os.path.join(root, "gate.json")
    argv = ["--report-only", "--epochs", "2", "--pids", "16", "--imgs-per-pid", "8",
            "--test-pids", "8", "--root", os.path.join(root, "gate"), "--report", report]
    if REHEARSAL:
        argv.append("--tiny")
    reset_counts()
    t0 = time.perf_counter()
    code = quality_gate.main(argv, device=None if device.type == "cuda" else device)
    sync()
    wall = time.perf_counter() - t0
    launches = counts()
    rec = json_.load(open(report))
    log(f"[gate] quality_gate.main {' '.join(argv[:9])}: exit {code} in {wall:.1f} s; mAP "
        f"{rec['mAP_trajectory']}, losses {rec['loss_trajectory']}, checks {rec['checks']}; "
        f"launches {launches}")
    require(code == 0, f"quality_gate.main returned {code}")
    require(len(rec["mAP_trajectory"]) == 2 and all(0 <= m <= 1 for m in rec["mAP_trajectory"])
            and all(math.isfinite(x) for x in rec["loss_trajectory"]),
            f"the gate's report {rec}")
    args = quality_gate.parse_args(argv)
    cfg, _ = quality_gate.gate_config(args)
    _, sampler, val_pipe, *_ = make_dataloader(cfg)
    steps = 2 * (len(sampler) // cfg.SOLVER.IMS_PER_BATCH)
    evals = 2 * math.ceil(len(val_pipe.samples) / cfg.TEST.IMS_PER_BATCH)
    layers = 2 if REHEARSAL else 12
    require_launches(launches, launch_dict(
        fused_attention_block=layers * evals, fused_mlp_block=layers * evals,
        fused_attention_block_train=layers * steps, attention_bwd_saved_db=layers * steps),
        "[gate] quality_gate.main")


# ---------------------------------------------------------------- phase 30


TUNING_CASES = (  # (label, the flagship's overrides)
    ("lora-qkv", dict(MODEL__FROZEN=True)),
    ("lora-qv", dict(MODEL__FROZEN=True, TPU__LORA_ENABLE="qv")),
    ("lora-conv", dict(MODEL__FROZEN=True, TPU__LORA_CONV=True)),
    ("frozen-adapter", dict(MODEL__FROZEN=True, MODEL__ADAPTER=True, TPU__LORA_RANK=0)),
    ("adapter", dict(MODEL__ADAPTER=True)),
    ("prompt", dict(MODEL__PROMPT=True)),
)
TUNING_STEPS = 10
ZERO_INIT = ("lora_b", "conv_lora_b", "adapter_prompts")  # drawn at random before the checks
# Device kernels by the names the profiler gives them: the attention of
# kernels 1 and 3 (and 5), of kernels 4 and 7 (and 6), and kernel 2's fc1
# (its eval form).
ATTN_FWD, ATTN_BWD, MLP_FC1 = "attention_regs_fwd_kernel", "attention_regs_bwd_kernel", \
    "BiasQuickGeluEpilogue"


def profiled_launches(fn, want: dict, card, label: str) -> None:
    """One call of `fn` under torch.profiler: the device kernels whose name
    contains each key of `want`, counted, must be launched the times it
    says; the call's host wall and device busy time printed.  A count under
    the one wanted (CUPTI dropped events) profiles the call again, up to
    four times in all; a count over it fails at once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    if REHEARSAL:
        log(f"[rehearsal] {label}: profiler launches on the card only, {want}")
        return
    fn()
    sync()
    for attempt in range(4):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        got = {name: sum(e.count for e in rows if name in e.key) for name in want}
        if got == want or any(got[k] > want[k] for k in want):
            break
        log(f"[profile] {label}: profiler launches {got}, fewer than {want} "
            f"(attempt {attempt + 1})")
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"[profile] {label}: launches {got} by the profiler; host wall {wall_ms:.3f} ms, device "
        f"busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%) ({card})")
    require(got == want, f"{label}: profiler launches {got} != {want}")


def randomize_zero_init(model, plain, seed=31) -> list:
    """LoRA's B, ConvLoRA's B and the prompts drawn at random (std 0.02), the
    same in both models: at their zero init the deltas would be zero.
    Returns their names."""
    g = torch.Generator().manual_seed(seed)
    names = []
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in ZERO_INIT:
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
                names.append(name)
    plain.load_state_dict(model.state_dict())
    return names


def check_tuned_eval(device, card, label, cfg, model, plain_cfg, plain) -> None:
    """A batch-64 request through FeatureExtractor: kernel 1 once a block and
    kernel 2 once a block, none under the adapter (wrappers and profiler),
    the embedding against the plain path's."""
    from demo2_tpu_torch.serving import FeatureExtractor

    layers = num_blocks(model)
    mlp = 0 if cfg.MODEL.ADAPTER else layers
    images, cams = request_images(64, cfg, seed=2)
    fx = FeatureExtractor(cfg, model, device=device, batch_size=64)
    reset_counts()
    emb = fx.extract(images, cams)
    sync()
    require_launches(counts(), launch_dict(fused_attention_block=layers, fused_mlp_block=mlp),
                     f"[{label}] a request of 64")
    ref = FeatureExtractor(plain_cfg, plain, device=device, batch_size=64).extract(images, cams)
    cos = np.sum(emb * ref, axis=1) / (np.linalg.norm(emb, axis=1) * np.linalg.norm(ref, axis=1))
    log(f"[{label}] request of 64: embedding {emb.shape}, cosine to the plain path min "
        f"{cos.min():.6f} mean {cos.mean():.6f}")
    require(emb.shape == (64, model.embed_dim) and bool(np.isfinite(emb).all()),
            f"[{label}] embedding {emb.shape} or not finite")
    require(float(cos.min()) >= COSINE_MIN, f"[{label}] cosine {cos.min()} < {COSINE_MIN}")
    profiled_launches(lambda: fx.extract(images, cams), {ATTN_FWD: layers, MLP_FC1: mlp}, card,
                      f"[{label}] one request of 64")


def check_tuned_grads(cfg, model, plain_cfg, plain, cache, idx, label) -> None:
    """The step-1 gradients of the trainable parameters on both paths, from
    the same batch and draws: their set, the whole cosine (GRAD_COS_MODEL)
    and each block's per module (GRAD_COS_BLOCK)."""
    from demo2_tpu_torch.engine.train import loss_and_grads
    from demo2_tpu_torch.losses.losses import make_loss_fn

    grads = []
    for c, m in ((cfg, model), (plain_cfg, plain)):
        gen = torch.Generator(device=cache.images.device).manual_seed(cfg.SOLVER.SEED)
        images, pids, camids = cache.batch(idx, gen)
        loss, _, g = loss_and_grads(c, m, make_loss_fn(c, NUM_CLASSES), images, pids, camids, gen)
        grads.append(g)
        log(f"[{label}] step-1 loss, {'kernel' if c is cfg else 'plain'} path: {loss.item():.6f}")
    gk, gp = grads
    trainable = {k for k, p in model.named_parameters() if p.requires_grad}
    require(set(gk) == trainable == set(gp), f"[{label}] gradients not of the trainable set")
    whole = grads_cosine(gk, gp)
    prefix = "backbone.base.resblocks.{}."
    groups = sorted({(i, k[len(prefix.format(i)):].split(".")[0]) for i in range(num_blocks(model))
                     for k in gk if k.startswith(prefix.format(i))})
    worst = min((grads_cosine(gk, gp, prefix.format(i) + grp + (
        "." if grp not in ("adapter_prompts",) else "")), f"{prefix.format(i)}{grp}")
                for i, grp in groups)
    log(f"[{label}] step-1 gradient cosine of the {len(gk)} trainable tensors, kernel vs plain "
        f"path: whole {whole:.6f}; lowest block module {worst[0]:.6f} ({worst[1]}) of "
        f"{sorted({g for _, g in groups})}")
    if REHEARSAL:  # the tiny bf16 model's plain versions round unlike the card's kernels
        log(f"[rehearsal] [{label}] gradient cosines held on the card only")
        return
    require(whole >= GRAD_COS_MODEL, f"[{label}] step-1 gradient cosine {whole}")
    require(worst[0] >= GRAD_COS_BLOCK, f"[{label}] {worst[1]} gradient cosine {worst[0]}")


def phase_tuning_case(device, card, label, overrides, cache, sampler, flag_cfg,
                      flag_model) -> dict:
    """Phase 30 for one configuration; returns the launches of its steps."""
    from demo2_tpu_torch.engine.state import create_train_state

    cfg, model, plain_cfg, plain = build_models(device, cut_depth(
        lambda fused, **more: flagship_cfg(fused, **overrides, **more)))
    randomized = randomize_zero_init(model, plain)
    layers = num_blocks(model)
    log(f"[{label}] {overrides} at {layers} blocks: drawn at random {len(randomized)} "
        f"zero-init tensors")
    check_tuned_eval(device, card, label, cfg, model, plain_cfg, plain)
    # MODEL.FROZEN: make_model built the frozen parameters not requiring grad
    frozen = [k for k, p in model.named_parameters() if not p.requires_grad]
    require(bool(frozen) == cfg.MODEL.FROZEN and all(k.startswith("backbone.base.")
                                                     for k in frozen),
            f"[{label}] frozen parameters {frozen[:4]}")
    order = sampler.epoch_indices(1)
    bs = cfg.SOLVER.IMS_PER_BATCH
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    check_tuned_grads(cfg, model, plain_cfg, plain, cache,
                      torch.from_numpy(order[:bs]).to(device), label)
    model.load_state_dict(init)
    plain.load_state_dict(init)
    # FROZEN leaves the qkv bias without a gradient: the backward is kernel 7
    bwd = "attention_bwd_saved" if cfg.MODEL.FROZEN else "attention_bwd_saved_db"
    want = launch_dict(fused_attention_block_train=layers, **{bwd: layers})

    def per_step(i, rose):
        if i == 0 or not REHEARSAL:
            require_launches(rose, want, f"[{label}] train step {i}")

    reset_counts()
    losses = train_steps(cfg, model, cache, order, TUNING_STEPS, per_step)
    launches = counts()
    plain_losses = train_steps(plain_cfg, plain, cache, order, TUNING_STEPS)
    rel = [abs(k - p) / abs(p) for k, p in zip(losses, plain_losses)]
    log(f"[{label}] {TUNING_STEPS} steps, kernel path losses {' '.join(f'{x:.4f}' for x in losses)}"
        f"; plain path {' '.join(f'{x:.4f}' for x in plain_losses)}; largest relative "
        f"difference {max(rel):.4%}; launches {launches}")
    require(all(math.isfinite(x) for x in losses), f"[{label}] a non-finite loss")
    require(max(rel) <= LOSS_REL, f"[{label}] kernel vs plain loss differ by {max(rel):.4%}")
    after = model.state_dict()
    moved = [k for k in frozen if not torch.equal(after[k], init[k])]
    stale = [k for k, p in model.named_parameters()
             if p.requires_grad and torch.equal(after[k], init[k])]
    log(f"[{label}] after the steps: {len(frozen)} frozen tensors bit for bit unchanged: "
        f"{not moved}; {len(init) - len(frozen)} others, trainable moved: {not stale}")
    require(not moved, f"[{label}] frozen parameters changed: {moved[:4]}")
    require(not stale, f"[{label}] trainable parameters the steps did not change: {stale[:4]}")
    if device.type == "cuda":
        from demo2_tpu_torch.engine.train import build_train_step

        step = build_train_step(cfg, model, create_train_state(cfg, model, len(order) // bs),
                                cache)
        idx = torch.from_numpy(order[:bs]).to(device)
        profiled_launches(lambda: step(idx), {ATTN_FWD: layers, ATTN_BWD: layers}, card,
                          f"[{label}] one train step of {bs}")
        time_train_step(device, card, cfg, model, flag_cfg, flag_model, cache, sampler,
                        label=f"{label}: ", names=(label, "flagship"), profiles=False, reps=3)
    return launches


def time_prompt_kernels(device, card) -> None:
    """Kernels 1, 3, 4 and 7 timed at the prompts' S = 141 beside their
    bounds and plain versions (printed)."""
    from demo2_tpu_torch.ops import fused_block as fb, packed_attention as pa

    shape = PROMPT_SHAPE
    x, attn, _ = block_inputs(shape, device, seed=1)
    xt, p, grad_out = train_kernel_inputs(shape, device, seed=5)
    w = {k: (v.to(torch.bfloat16) if k in ("wqkv", "wout") else v) for k, v in p.items()}
    kw = dict(num_heads=HEADS, scale=(shape[-1] // HEADS) ** -0.5)
    _, qkv, _, probs = fb.fused_attention_block_train(xt, **w, **kw)
    saved = [qkv, probs, grad_out]
    time_kernels({
        "fused_attention_block": timed(
            lambda: fb.fused_attention_block(x, **attn, **kw),
            lambda: fb.attention_block_plain(x, **attn, **kw),
            block_flops("fused_attention_block", shape), shape, [x, *attn.values()]),
        "fused_attention_block_train": timed(
            lambda: fb.fused_attention_block_train(xt, **w, **kw),
            lambda: fb.attention_block_train_plain(xt, **w, **kw),
            train_kernel_flops("fused_attention_block_train", shape), shape, [xt, *w.values()]),
        "attention_bwd_saved_db": timed(
            lambda: pa.attention_bwd_saved_db(qkv, probs, grad_out, **kw),
            lambda: pa.attention_bwd_saved_plain(qkv, probs, grad_out, with_db=True, **kw),
            train_kernel_flops("attention_bwd_saved_db", shape), shape, saved),
        "attention_bwd_saved": timed(
            lambda: pa.attention_bwd_saved(qkv, probs, grad_out, **kw),
            lambda: pa.attention_bwd_saved_plain(qkv, probs, grad_out, with_db=False, **kw),
            train_kernel_flops("attention_bwd_saved", shape), shape, saved),
    }, card)


def phase_tuning(device, card, cache, sampler, flag_cfg, flag_model,
                 cases=TUNING_CASES) -> dict:
    """Phase 30: the six tuning configurations, then (on the card) kernels 1,
    3, 4 and 7 timed at S = 141.  Returns each configuration's step launches."""
    t0 = time.perf_counter()
    launches = {}
    for label, overrides in cases:
        launches[label] = phase_tuning_case(device, card, label, overrides, cache, sampler,
                                            flag_cfg, flag_model)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if device.type == "cuda":
        time_prompt_kernels(device, card)
    log(f"[tuning] phase 30 in {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 31


def _reference_values(shape, name, g) -> torch.Tensor:
    if name.endswith("running_var"):
        return torch.rand(shape, generator=g) + 0.5
    if len(shape) >= 2:
        return torch.randn(shape, generator=g) / math.sqrt(max(1, math.prod(shape[1:])))
    if name.endswith("weight"):  # a norm's scale
        return 1.0 + 0.1 * torch.randn(shape, generator=g)
    return 0.1 * torch.randn(shape, generator=g)


SETS = ("r", "n", "t", "rn", "rt", "nt", "rnt")  # HDM's modality sets, in the reference's order
SDTPS_ATTN = {(0, 0): "rgb_self_attn", (0, 1): "rgb_cross_nir", (0, 2): "rgb_cross_tir",
              (1, 0): "nir_cross_rgb", (1, 1): "nir_self_attn", (1, 2): "nir_cross_tir",
              (2, 0): "tir_cross_rgb", (2, 1): "tir_cross_nir", (2, 2): "tir_self_attn"}


def reference_state_dict(model, seed: int = 0) -> dict:
    """Random tensors under the key names and shapes of the reference's
    torch.save(model.state_dict()) of `model`, a DeMo or DeMoParallel of
    the port (on an ImageNet ViT: a CLIP one's tower keeps the port's names,
    which the converters do not read): the keys utils/ref_convert.py reads (a
    reference BatchNorm's bias too, and the global-local reduce stacks the
    reference always builds).  Imports no JAX: tests/test_torch_ref_convert.py
    proves each such dict right with JAX's convert_demo and graft."""
    sd = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    c = model.feat_dim
    shapes = {}
    for k, shape in sd.items():
        if k == "backbone.cv_embed":  # the CLIP branch's SIE rows, (cameras, 1, 768) there
            shapes["BACKBONE.cv_embed"] = (shape[0], 1, shape[1])
        elif k.startswith("backbone.base."):
            shapes["BACKBONE.base." + k[len("backbone.base."):].replace(
                "patch_embed_proj", "patch_embed.proj")] = shape
        elif k.startswith("head_"):
            head, _, rest = k[len("head_"):].partition(".")
            sfx = "" if head == "ori" else "_" + head
            if rest == "classifier.weight":
                shapes[f"classifier{sfx}.weight"] = shape
            else:
                field = rest.rsplit(".", 1)[1]
                shapes[f"bottleneck{sfx}.{field}"] = shape
                if field == "weight":
                    shapes[f"bottleneck{sfx}.bias"] = shape
        elif k.startswith("sdtps.modal_weight_mlp."):
            i, sub, field = k.split(".")[2:]
            layer = {"fc0": 0, "ln": 1, "fc1": 4, "fc2": 6}[sub]
            nm = ("rgb", "nir", "tir")[int(i)]
            shapes[f"sdtps.{nm}_sparse.modal_weight_mlp.{layer}.{field}"] = shape
        elif k.startswith("dgaf."):
            rest = k[len("dgaf."):]
            for port, ref in (("pool.attn_pool.", "attn_pool."), ("pool.attn_norm.", "attn_norm."),
                              ("core.entropy_proj.", "entropy_proj."),
                              ("core.gate_fc0.", "gate_net.0."), ("core.gate_ln.", "gate_net.1."),
                              ("core.gate_fc1.", "gate_net.3."),
                              ("modal_enhance.fc.", "modal_enhance.0."),
                              ("modal_enhance.ln.", "modal_enhance.1.")):
                if rest.startswith(port):
                    shapes["dgaf." + ref + rest[len(port):]] = shape
            if rest == "core.alpha":
                shapes["dgaf._alpha"] = ()
            if rest == "pool.queries":
                names = (("rgb_query", "nir_query", "tir_query") if shape[0] == 3
                         else tuple(f"queries.{i}" for i in range(shape[0])))
                shapes.update({f"dgaf.{nm}": (1, 1, c) for nm in names})
    if "sdtps.q_proj_kernel" in sd:
        cols = sd["sdtps.q_proj_kernel"][1]
        names = (SDTPS_ATTN.values() if cols == 3
                 else ("rgb_shared_attn", "nir_shared_attn", "tir_shared_attn"))
        for nm in names:
            for proj in ("q_proj", "k_proj"):
                shapes[f"sdtps.{nm}.{proj}.weight"], shapes[f"sdtps.{nm}.{proj}.bias"] = (c, c), (c,)
    for nm in ("rgb", "nir", "tir"):  # built whether or not GLOBAL_LOCAL uses them
        shapes.update({f"{nm}_reduce.0.weight": (2 * c,), f"{nm}_reduce.0.bias": (2 * c,),
                       f"{nm}_reduce.1.weight": (c, 2 * c), f"{nm}_reduce.1.bias": (c,)})
    if "general_fusion.hdm.set_tokens" in sd:
        for nm in SETS:
            gf = f"generalFusion.{nm}"
            shapes.update({f"{gf}_token": (1, 1, c), f"{gf}.in_proj_weight": (3 * c, c),
                           f"{gf}.in_proj_bias": (3 * c,), f"{gf}.out_proj.weight": (c, c),
                           f"{gf}.out_proj.bias": (c,)})
    if "general_fusion.moe.expert_kernel" in sd:
        head, sets, d, _ = sd["general_fusion.moe.expert_kernel"]
        gate = "generalFusion.moe.gating_network.gate."
        shapes.update({gate + "linear_re.0.weight": sd["general_fusion.moe.linear_re_fc.weight"],
                       gate + "linear_re.0.bias": (c,), gate + "q_.weight": (c, c),
                       gate + "k_.weight": (c, c)})
        for field in ("weight", "bias", "running_mean", "running_var"):
            shapes[gate + f"linear_re.2.{field}"] = (c,)
        for h in range(head):
            for s_ in range(sets):
                mlp = f"generalFusion.moe.experts.{h}.expertHead.{s_}.mlp."
                shapes.update({mlp + "0.weight": (d, d), mlp + "0.bias": (d,)})
                for field in ("weight", "bias", "running_mean", "running_var"):
                    shapes[mlp + f"2.{field}"] = (d,)
    g = torch.Generator().manual_seed(seed)
    return {k: _reference_values(shape, k, g) for k, shape in sorted(shapes.items())}


def migration_opts(root: str, out: str) -> list:
    """Phase 27's command line (the flagship's keys, the JPEG tree, the
    device cache) on vit_base_patch16_224 at its full width, one epoch."""
    return data_opts(root, out, "device") + [
        "MODEL.TRANSFORMER_TYPE", "vit_base_patch16_224", "TPU.BACKBONE_WIDTH", "-1",
        "TPU.BACKBONE_HEADS", "-1", "SOLVER.MAX_EPOCHS", "1"]


def phase_migration(device, card, root: str) -> dict:
    """Phase 31 (on phase 27's tree in `root`): a reference-layout DeMo on
    the ImageNet ViT, evaluated by tools/test.main, its embedding against
    the plain path, then tools/train.main --init_pth for one epoch.  Returns
    the launches of the training run."""
    import os

    from demo2_tpu_torch.data.loader import make_dataloader
    from demo2_tpu_torch.models import make_model
    from demo2_tpu_torch.serving import FeatureExtractor
    from demo2_tpu_torch.tools import test as test_cli, train as train_cli
    from demo2_tpu_torch.utils.ref_convert import load_reference_checkpoint

    t0 = time.perf_counter()
    cli_device = None if device.type == "cuda" else device
    opts = migration_opts(root, os.path.join(root, "migrate"))
    cfg = train_cli.load_config("", opts).freeze()
    _, sampler, val_pipe, _, num_classes, cam_num, view_num = make_dataloader(cfg)
    gen = lambda: torch.Generator().manual_seed(7)
    model = make_model(cfg, num_classes, cam_num, view_num, device=device, generator=gen())
    layers = num_blocks(model)
    ref = reference_state_dict(model, seed=3)
    pth = os.path.join(root, "reference_demo.pth")
    torch.save(ref, pth)
    log(f"[migrate] reference-layout DeMo (SDTPS + DGAF v3) on vit_base_patch16_224: "
        f"{len(ref)} tensors, {sum(v.numel() for v in ref.values()) / 1e6:.1f}M values, "
        f"{os.path.getsize(pth) / 2**20:.0f} MiB written with torch.save")

    reset_counts()
    cmc, m_ap = test_cli.main(opts + ["TEST.WEIGHT", pth], device=cli_device)
    sync()
    evals = math.ceil(len(val_pipe.samples) / cfg.TEST.IMS_PER_BATCH)
    log(f"[migrate] tools/test.main with TEST.WEIGHT {os.path.basename(pth)}: mAP {m_ap:.4f}, "
        f"Rank-1 {cmc[0]:.4f}; launches {counts()}")
    require_launches(counts(), launch_dict(packed_attention_fwd=layers * evals),
                     "[migrate] tools/test.main")
    require(0.0 <= m_ap <= 1.0, f"mAP {m_ap}")

    plain_cfg = train_cli.load_config("", opts + ["TPU.USE_FLASH_ATTENTION", "False"]).freeze()
    plain = make_model(plain_cfg, num_classes, cam_num, view_num, device=device, generator=gen())
    for c, m in ((cfg, model), (plain_cfg, plain)):
        load_reference_checkpoint(m, pth, c)
    sd = model.state_dict()
    for key, ref_key in (("backbone.base.blocks.0.attn.qkv.weight",
                          "BACKBONE.base.blocks.0.attn.qkv.weight"),
                         ("head_dgaf.classifier.weight", "classifier_dgaf.weight")):
        require(torch.equal(sd[key].cpu(), ref[ref_key]), f"{key} is not the checkpoint's")
    images, cams = request_images(64, cfg, seed=6)
    emb = FeatureExtractor(cfg, model, device=device, batch_size=64).extract(images, cams)
    want = FeatureExtractor(plain_cfg, plain, device=device, batch_size=64).extract(images, cams)
    cos = np.sum(emb * want, axis=1) / (np.linalg.norm(emb, axis=1) * np.linalg.norm(want, axis=1))
    log(f"[migrate] load_reference_checkpoint, a request of 64: cosine to the plain path min "
        f"{cos.min():.6f} mean {cos.mean():.6f}")
    require(bool(np.isfinite(emb).all()) and float(cos.min()) >= COSINE_MIN,
            f"[migrate] cosine {cos.min()} < {COSINE_MIN}")
    del model, plain

    bs = cfg.SOLVER.IMS_PER_BATCH
    steps = len(sampler) // bs
    reset_counts()
    state, best = train_cli.main(["--exp_name", "migrate", "--init_pth", pth] + opts,
                                 device=cli_device)
    sync()
    launches = counts()
    losses = [e["loss"] for e in state.history]
    log(f"[migrate] tools/train.main --init_pth: {steps} steps of {bs}, losses {losses}, mAP "
        f"{best['mAP']:.4f}; launches {launches}; phase 31 in {time.perf_counter() - t0:.1f} s "
        f"({card})")
    require_launches(launches, launch_dict(packed_attention_fwd=layers * (steps + evals),
                                           packed_attention_bwd=layers * steps),
                     "[migrate] tools/train.main --init_pth")
    require(len(losses) == 1 and all(math.isfinite(x) for x in losses), f"losses {losses}")
    return launches


# ---------------------------------------------------------------- phases 32-33


BACKBONE_STEPS = 10    # train steps of each ViT-family backbone phase, both paths
# A CNN trunk from its random init learns slowly at the first epoch's warmup
# learning rate (3.8e-5), and PK batches differ step to step: its loss is
# held over phase 6's TRAIN_STEPS (the mean of the last 5 below the first 5's).
BACKBONE_DEPTHS = {"t2t_vit_t_24": 24, "vit_small_patch16_224": 8}
CUDNN_F32_REL = 1e-4   # the card's f32 trunk (TF32 off) vs the CPU's, of its largest value


def backbone_cfg(tt: str, stride=(16, 16)):
    """The flagship recipe (SDTPS + DGAF v3) with only TRANSFORMER_TYPE and
    STRIDE_SIZE changed; `make_cfg(fused)` for build_models.  Full width (a
    rehearsal keeps apply_tiny's on T2T, whose width follows it)."""
    def make_cfg(fused: bool, **overrides):
        if tt.startswith("vit") or not REHEARSAL:
            overrides = dict(TPU__BACKBONE_WIDTH=-1, TPU__BACKBONE_HEADS=-1, **overrides)
        return flagship_cfg(fused, MODEL__TRANSFORMER_TYPE=tt, MODEL__STRIDE_SIZE=tuple(stride),
                            **overrides)

    return make_cfg


def phase_vit_backbone(device, tt: str, stride, per_forward: dict, per_step: dict, cache,
                       sampler):
    """Phases 3 and 6 on DeMo over `tt` at `stride`: requests against the
    plain path, each forward launching `per_forward`; the backbone's step-1
    gradient from one upstream gradient (cosine >= 0.999 whole, >= 0.99 per
    block's qkv / proj), BACKBONE_STEPS steps each launching `per_step`, the
    loss falling and within LOSS_REL of the plain path's.  Returns (cfg,
    model, launches of the steps)."""
    make_cfg = backbone_cfg(tt, stride)
    cfg, model, plain_cfg, plain = build_models(device, make_cfg)
    label = tt.split("_")[0] + ("" if tuple(stride) == (16, 16) else f"-s{stride[0]}")
    tokens = math.prod(model.grid) + 1
    log(f"[{label}] {tt} at stride {tuple(stride)}: {num_blocks(model)} blocks of width "
        f"{model.feat_dim}, {tokens} tokens, feat_dim {model.feat_dim}")
    phase_slice(device, cfg, model, plain_cfg, plain, per_forward, label=f"{label}-slice")
    trained = phase_train(device, cfg, model, plain_cfg, plain, cache, sampler, per_step,
                          label=f"{label}-train", whole_model=False, hold_losses=True,
                          steps=BACKBONE_STEPS)
    del plain
    return cfg, model, trained


def check_cudnn_f32(device, tt: str) -> None:
    """The CNN trunk in f32 on the card, cuDNN with TF32 off, against the
    same trunk on the CPU: an eval forward of two 256x128 images."""
    from demo2_tpu_torch.models.osnet import OSNET_AIN_VARIANTS, OSNET_CONFIGS, OSNet
    from demo2_tpu_torch.models.resnet import RESNET_CONFIGS, ResNet

    cpu = torch.device("cpu")
    h, w = (64, 32) if REHEARSAL else (256, 128)
    x = torch.randn(2, h, w, 3, generator=torch.Generator().manual_seed(4))

    def make(dev):
        kw = dict(dtype=torch.float32, device=dev, generator=torch.Generator().manual_seed(5))
        if tt in RESNET_CONFIGS:
            layers, ibn = RESNET_CONFIGS[tt]
            return ResNet(layers, ibn=ibn, **kw).eval()
        layers, chans = OSNET_CONFIGS[tt]
        return OSNet(layers, chans, block_variants=OSNET_AIN_VARIANTS, conv1_in=True, **kw).eval()

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            got = make(device)(x.to(device)).cpu()
            want = make(cpu)(x)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = (got - want).abs().max().item() / want.abs().max().item()
    log(f"[{tt}] f32 trunk on the card (cuDNN, TF32 off) vs the CPU: max abs {err:.3e} of the "
        f"largest value (bound {CUDNN_F32_REL})")
    require(err <= CUDNN_F32_REL, f"{tt}: f32 trunk differs by {err} of its largest value")


def phase_cnn_backbone(device, tt: str, cache, sampler):
    """DeMo (the flagship fusion) on a CNN trunk, which runs no hand-written
    kernel (cuDNN convolutions, as JAX leaves them to XLA): TRAIN_STEPS
    steps, each finite and launching no kernel of the port, the loss
    falling, the BatchNorm running statistics moving (the trunk's too);
    run_eval's mAP in (0, 1]; the f32 trunk against the CPU's.  Returns
    (cfg, model)."""
    from demo2_tpu_torch.engine.eval import run_eval
    from demo2_tpu_torch.models import make_model

    cfg = backbone_cfg(tt)(fused=True)
    model = make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=device,
                       generator=torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    order = sampler.epoch_indices(1)

    def per_step(i, rose):
        require_launches(rose, launch_dict(), f"[{tt}] train step {i}")

    t0 = time.perf_counter()
    losses = train_steps(cfg, model, cache, order, TRAIN_STEPS, per_step)
    log(f"[{tt}] {TRAIN_STEPS} steps of {cfg.SOLVER.IMS_PER_BATCH} in "
        f"{time.perf_counter() - t0:.1f} s, feat_dim {model.feat_dim}; losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}")
    require(all(math.isfinite(x) for x in losses), f"[{tt}] a non-finite loss")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    require(last < first, f"[{tt}] the loss did not fall: {first} -> {last}")
    after = model.state_dict()
    bn = [k for k in after if k.endswith(("running_mean", "running_var"))]
    moved = [k for k in bn if not torch.equal(after[k], init[k])]
    require(len(moved) == len(bn) and any(k.startswith("backbone.base.") for k in bn),
            f"[{tt}] BatchNorm statistics that did not move: {sorted(set(bn) - set(moved))}")
    log(f"[{tt}] loss falls ({first:.4f} -> {last:.4f}); all {len(bn)} BatchNorm statistics "
        f"moved, {sum(k.startswith('backbone.base.') for k in bn)} of them the trunk's")
    val, nq = eval_cache_from(cache, cfg)
    reset_counts()
    cmc, m_ap = run_eval(cfg, model, val, nq)
    sync()
    require_launches(counts(), launch_dict(), f"[{tt}] run_eval")
    require(0.0 < m_ap <= 1.0, f"[{tt}] mAP {m_ap}")
    log(f"[{tt}] run_eval: embedding width {model.embed_dim}, {nq} queries, mAP {m_ap:.4f}, "
        f"Rank-1 {cmc[0]:.3f}")
    if device.type == "cuda":
        check_cudnn_f32(device, tt)
    return cfg, model


def time_beside_flagship(device, card, label, cfg, model, flag_cfg, flag_model, cache,
                         sampler) -> None:
    """The backbone's train step and batch-64 request beside the flagship's,
    in turns (host clock), with the profiler's device busy share of one step
    and one request of the backbone."""
    from demo2_tpu_torch.serving import FeatureExtractor

    names = (label, "flagship")
    time_train_step(device, card, cfg, model, flag_cfg, flag_model, cache, sampler,
                    label=f"{label} vs flagship: ", names=names, profiles=False, reps=3)
    images, cams = request_images(64, cfg, seed=3)
    fxs = {names[0]: FeatureExtractor(cfg, model, device=device, batch_size=64),
           names[1]: FeatureExtractor(flag_cfg, flag_model, device=device, batch_size=64)}

    def request_ms(which, reps=3):
        fxs[which].extract(images, cams)
        t0 = time.perf_counter()
        for _ in range(reps):
            fxs[which].extract(images, cams)
        return (time.perf_counter() - t0) * 1e3 / reps

    p1, k1, k2, p2 = (request_ms(names[1]), request_ms(names[0]), request_ms(names[0]),
                      request_ms(names[1]))
    log(f"[time] {label} vs flagship: batch-64 request {(k1 + k2) / 2:.2f} ms, flagship "
        f"{(p1 + p2) / 2:.2f} ms; turns {p1:.2f}, {k1:.2f}, {k2:.2f}, {p2:.2f} ms, host arrays "
        f"in and out included ({card})")
    step = build_timed_step(cfg, model, cache, sampler)
    profile(f"{label}, one train step of {cfg.SOLVER.IMS_PER_BATCH}", step, card, top=6)
    profile(f"{label}, one batch-64 request", lambda: fxs[names[0]].extract(images, cams), card,
            top=6)


def build_timed_step(cfg, model, cache, sampler):
    """One build_train_step step on a fixed batch, as a call."""
    from demo2_tpu_torch.engine.state import create_train_state
    from demo2_tpu_torch.engine.train import build_train_step

    bs = cfg.SOLVER.IMS_PER_BATCH
    order = sampler.epoch_indices(3)
    step = build_train_step(cfg, model, create_train_state(cfg, model, len(order) // bs), cache)
    idx = torch.from_numpy(order[:bs]).to(cache.images.device)
    return lambda: step(idx)


def phase_backbones(device, card, flag_cfg, flag_model, cache, sampler, timing=True):
    """Phase 32: DeMo (SDTPS + DGAF v3) on T2T-ViT-24 (kernels 5 and 6, 24
    launches each), on vit_small at stride 12 (211 tokens, heads of 96: the
    wide pair, 8 launches each), on ResNet-50-IBN-a and OSNet-AIN x1.0 (no
    kernel); phase 33 (`timing`): the wide pair timed at WIDE_SHAPES beside
    its bound and SDPA's forward / backward, and each backbone's step and
    request beside the flagship's.  Returns (launches of the vit_small
    steps, the wide pair's times)."""
    t0 = time.perf_counter()
    models = {}
    layers = 2 if REHEARSAL else BACKBONE_DEPTHS["t2t_vit_t_24"]
    cfg, model, _ = phase_vit_backbone(
        device, "t2t_vit_t_24", (16, 16), launch_dict(packed_attention_fwd=layers),
        launch_dict(packed_attention_fwd=layers, packed_attention_bwd=layers), cache, sampler)
    models["t2t_vit_t_24"] = (cfg, model)
    layers = 2 if REHEARSAL else BACKBONE_DEPTHS["vit_small_patch16_224"]
    cfg, model, trained = phase_vit_backbone(
        device, "vit_small_patch16_224", (12, 12),
        launch_dict(packed_attention_wide_fwd=layers),
        launch_dict(packed_attention_wide_fwd=layers, packed_attention_wide_bwd=layers),
        cache, sampler)
    models["vit_small_patch16_224 s12"] = (cfg, model)
    for tt in ("resnet50_ibn_a", "osnet_ain_x1_0"):
        models[tt] = phase_cnn_backbone(device, tt, cache, sampler)
    log(f"[backbones] phase 32 in {time.perf_counter() - t0:.1f} s")
    times = {}
    if timing:
        t0 = time.perf_counter()
        for shape in WIDE_SHAPES:
            cases = wide_attention_cases(device, shape, seed=7)
            got = time_kernels({
                name: timed(kernel, lambda plain_fn=plain_fn, inputs=inputs: plain_fn(*inputs),
                            flops, tuple(inputs[0].shape), inputs, library, plain_iters=5)
                for name, (kernel, plain_fn, inputs, flops, library) in cases.items()}, card)
            times = times or got  # the JSON line's: WIDE_SHAPES[0]
        for label, (cfg, model) in models.items():
            time_beside_flagship(device, card, label, cfg, model, flag_cfg, flag_model, cache,
                                 sampler)
        log(f"[backbones] phase 33 in {time.perf_counter() - t0:.1f} s")
    return trained, times


# ---------------------------------------------------------------- phase 34


INT8_MODES = ("dynamic", "static")
# The flagship's two MLP products at batch 64: (3B x S, C) x (C, 4C), (3B x S, 4C) x (4C, C).
INT8_PRODUCT_SHAPES = ((24768, 768, 3072), (24768, 3072, 768))
INT8_STEPS = 3           # train steps on each path, each mode
CAM_BATCH = 8            # images a Grad-CAM call
CAM_MAP_TOL = 0.05       # largest |difference| of two [0, 1] maps, kernel vs plain path
PHASE34_BUDGET_S = 45.0


def int8_cfg(mode: str):
    """The flagship with TPU.INT8_MLP `mode` (both GEMMs of each MLP in int8)."""
    return lambda fused, **overrides: flagship_cfg(fused, TPU__INT8_MLP=mode, **overrides)


def no_sdtps_cfg(use_dgaf: bool):
    """The flagship without SDTPS: the Baseline, or DGAF v3 alone."""
    return lambda fused, **overrides: flagship_cfg(fused, MODEL__USE_SDTPS=False,
                                                   MODEL__USE_DGAF=use_dgaf, **overrides)


def quantize_toward_zero(xf, s):
    """The misquantized control: round toward zero, not half to even."""
    return torch.clamp(torch.trunc(xf / s), -127, 127).to(torch.int8)


def int8_dense_reference(x: torch.Tensor, w: torch.Tensor, act_scale: float) -> torch.Tensor:
    """ops/quant.py::int8_dense's forward by other means: the scales and the
    half-to-even rounding in numpy on the host, the integer product exact in
    f64 on the device (every partial sum an integer below 2^53), the
    rescale in numpy in int8_dense's association, the cast by torch."""
    xf = x.float().cpu().numpy().reshape(-1, x.shape[-1])
    wf = w.float().cpu().numpy()
    s = np.float32(act_scale) if act_scale > 0 else np.maximum(
        np.abs(xf).max() / np.float32(127.0), np.float32(1e-8))
    sw = np.maximum(np.abs(wf).max(axis=1) / np.float32(127.0), np.float32(1e-8))
    xq = np.clip(np.rint(xf / s), -127, 127)
    wq = np.clip(np.rint(wf / sw[:, None]), -127, 127)
    dev = x.device
    y32 = (torch.from_numpy(xq).to(dev, torch.float64)
           @ torch.from_numpy(wq).to(dev, torch.float64).t()).cpu().numpy().astype(np.float32)
    y = torch.from_numpy(y32 * (s * sw))
    return y.to(x.dtype).reshape(*x.shape[:-1], w.shape[0])


def check_int8_products(device, shapes=INT8_PRODUCT_SHAPES) -> None:
    """torch._int_mm (quant.int8_matmul) bit-equal to the exact product at the
    flagship's MLP shapes (an f32 product is not exact there: 3,072 x 127^2
    > 2^24); int8_dense on the flagship's fc1 input bit-equal to its
    reference in both modes, which the misquantized control fails."""
    from demo2_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(41)
    for m, k, n in shapes:
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).to(device)
        w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).to(device)
        got = quant.int8_matmul(a, w)
        exact = a.double() @ w.double().t()
        require(got.dtype == torch.int32 and torch.equal(got.double(), exact),
                f"_int_mm ({m}, {k}) x ({k}, {n}) differs from the exact product")
        log(f"[int8] _int_mm ({m}, {k}) x ({k}, {n}): bit-equal to the exact f64 product, "
            f"largest |value| {exact.abs().max().item():.0f} (> 2^24 = 16777216: "
            f"{exact.abs().max().item() > 2 ** 24})")
    m, k, n = shapes[0]
    x = (torch.randn(m, k, generator=g) * 2.0).to(device, torch.bfloat16)
    w = (torch.randn(n, k, generator=g) * k ** -0.5).to(device)
    for mode, s in (("dynamic", 0.0), ("static", 10.0 / 127.0)):
        want = int8_dense_reference(x, w, s)
        got = quant.int8_dense(x, w, s).cpu()
        require(torch.equal(got, want), f"int8_dense ({mode}) differs from its reference")
        kept = quant.quantize
        quant.quantize = quantize_toward_zero
        try:
            wrong = quant.int8_dense(x, w, s).cpu()
        finally:
            quant.quantize = kept
        differ = (wrong != want).float().mean().item()
        require(differ > 0, f"the misquantized control ({mode}) passed the reference check")
        log(f"[int8] int8_dense ({mode}) at x ({m}, {k}) bf16: bit-equal to its reference; the "
            f"control rounding toward zero differs in {differ:.2%} of the outputs")


def phase_int8(device, card, cache, sampler, flag_cfg, flag_model) -> dict:
    """Phase 34, part 1: TPU.INT8_MLP on the flagship at full width, both
    modes.  The int8 products (check_int8_products); an eval request of 64
    against the plain path with the same INT8_MLP (embedding cosine >=
    COSINE_MIN; kernel 1 12 times, kernel 2 never); the step-1 gradient
    against the plain path (phase 6's cosines, ln_2 and the MLP among the
    groups) and INT8_STEPS steps on each path (kernels 3 and 4 12 times a
    step, the losses within LOSS_REL); then the int8 step and request timed
    beside the bf16 flagship's in turns.  Returns the launches of the steps."""
    from demo2_tpu_torch.serving import FeatureExtractor

    t0 = time.perf_counter()
    check_int8_products(device, ((64, 64, 256), (64, 256, 64)) if REHEARSAL
                        else INT8_PRODUCT_SHAPES)
    layers = 2 if REHEARSAL else 12
    per_forward = launch_dict(fused_attention_block=layers)
    per_step = launch_dict(fused_attention_block_train=layers, attention_bwd_saved_db=layers)
    images, cams = request_images(64, flag_cfg, seed=5)
    order = sampler.epoch_indices(4)
    bs = flag_cfg.SOLVER.IMS_PER_BATCH
    idx = torch.from_numpy(order[:bs]).to(device)
    built, launches = {}, {}
    for mode in INT8_MODES:
        label = f"int8 {mode}"
        cfg, model, plain_cfg, plain = build_models(device, int8_cfg(mode))
        fx = FeatureExtractor(cfg, model, device=device, batch_size=64)
        fx_plain = FeatureExtractor(plain_cfg, plain, device=device, batch_size=64)
        reset_counts()
        emb = fx.extract(images, cams)
        sync()
        require_launches(counts(), per_forward, f"[{label}] eval request of 64")
        ref = fx_plain.extract(images, cams)
        cos = np.sum(emb * ref, axis=1) / (np.linalg.norm(emb, axis=1)
                                          * np.linalg.norm(ref, axis=1))
        require(bool(np.isfinite(emb).all()) and float(cos.min()) >= COSINE_MIN,
                f"[{label}] embedding cosine to the plain path {cos.min()} < {COSINE_MIN}")
        log(f"[{label}] eval request of 64: embedding cosine to the plain path min "
            f"{cos.min():.6f} mean {cos.mean():.6f}; kernel 1 {layers} launches, kernel 2 none")
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        check_step1_grads(cfg, model, plain_cfg, plain, cache, idx, label,
                          extra_groups=("ln_2.", "mlp.c_fc.", "mlp.c_proj."))
        model.load_state_dict(init)
        plain.load_state_dict(init)

        def checked(i, rose, label=label):
            if i == 0 or not REHEARSAL:
                require_launches(rose, per_step, f"[{label}] train step {i}")

        reset_counts()
        losses = train_steps(cfg, model, cache, order, INT8_STEPS, checked)
        launches[mode] = counts()
        plain_losses = train_steps(plain_cfg, plain, cache, order, INT8_STEPS)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
        log(f"[{label}] {INT8_STEPS} steps of {bs}: kernel path losses "
            f"{' '.join(f'{x:.4f}' for x in losses)}, plain path "
            f"{' '.join(f'{x:.4f}' for x in plain_losses)}; largest relative difference "
            f"{rel:.4%}; launches {launches[mode]}")
        require(all(math.isfinite(x) for x in losses) and rel <= LOSS_REL,
                f"[{label}] losses differ from the plain path's by {rel:.4%}")
        model.load_state_dict(init)
        built[mode] = (cfg, model)
        del plain, fx_plain
    if device.type == "cuda":
        time_int8(device, card, built, flag_cfg, flag_model, cache, sampler, images, cams)
    log(f"[int8] phase 34, INT8_MLP part, in {time.perf_counter() - t0:.1f} s")
    return launches


def time_int8(device, card, built, flag_cfg, flag_model, cache, sampler, images, cams) -> None:
    """The int8 models' train step and batch-64 request beside the bf16
    flagship's, in turns (host clock, the mean of 3 after 1): flagship,
    dynamic, static, static, dynamic, flagship; then a profile of one step
    of the flagship and of the dynamic model."""
    from demo2_tpu_torch.serving import FeatureExtractor

    models = {"bf16 flagship": (flag_cfg, flag_model),
              **{f"int8 {mode}": built[mode] for mode in INT8_MODES}}
    steps = {name: build_timed_step(c, m, cache, sampler) for name, (c, m) in models.items()}
    fxs = {name: FeatureExtractor(c, m, device=device, batch_size=64)
           for name, (c, m) in models.items()}
    calls = {"train step": lambda name: steps[name](),
             "batch-64 request": lambda name: fxs[name].extract(images, cams)}
    names = list(models)
    for what, call in calls.items():
        readings = {name: [] for name in names}
        for name in names + names[::-1]:
            call(name)
            sync()
            t0 = time.perf_counter()
            for _ in range(3):
                call(name)
            sync()
            readings[name].append((time.perf_counter() - t0) * 1e3 / 3)
        log(f"[time] {what}, INT8_MLP beside the bf16 flagship: " + "; ".join(
            f"{name} {np.mean(r):.2f} ms (turns {', '.join(f'{x:.2f}' for x in r)})"
            for name, r in readings.items()) + f" ({card})")
    for name in names[:2]:  # where the int8 step's time goes, beside the bf16 step's
        profile(f"{name}, one train step of {flag_cfg.SOLVER.IMS_PER_BATCH}", steps[name],
                card, top=8)


def map_difference(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max())


def phase_saliency(device, card, flag_cfg, flag_model, flag_plain) -> dict:
    """Phase 34, part 2: the saliency maps at full width, batch CAM_BATCH,
    class_idx pinned.  On the flagship, gradcam (kernels 1 and 2 12 times:
    the eval kernels, its probe lying after the backbone) and
    gradcam_heatmaps (the input-gradient pass: kernels 3, 7 and 2's training
    form) on both paths: the probed patch activations held (cosine >=
    COSINE_MIN), the maps' agreement printed (SDTPS's input gradient is
    ill-conditioned at random weights).  The maps held within CAM_MAP_TOL of
    the plain path's where no SDTPS lies on the gradient's way: gradcam on
    DGAF v3 alone, gradcam_heatmaps on the Baseline (whose branches never
    read the patch tokens, so its Grad-CAM maps are zero); the maps of
    other images (the control) are further.  Returns the launches."""
    from demo2_tpu_torch.visualize import gradcam, gradcam_heatmaps

    t0 = time.perf_counter()
    layers = 2 if REHEARSAL else 12
    images, cams = request_images(CAM_BATCH, flag_cfg, seed=6)
    x = torch.from_numpy(images).to(device)
    c = torch.from_numpy(cams).to(device)
    pinned = torch.arange(CAM_BATCH, device=device) * 7 % NUM_CLASSES
    flag_plain.load_state_dict(flag_model.state_dict())
    launches = {}

    def maps(model, kind, images=x):
        if kind == "gradcam":
            return gradcam(model, images, c, class_idx=pinned)
        return gradcam_heatmaps(model, images, c, model.grid)

    for kind, want in (("gradcam", launch_dict(fused_attention_block=layers,
                                               fused_mlp_block=layers)),
                       ("gradcam_heatmaps", launch_dict(fused_attention_block_train=layers,
                                                        attention_bwd_saved=layers,
                                                        fused_mlp_block_train=layers))):
        reset_counts()
        got = maps(flag_model, kind)
        sync()
        launches[kind] = counts()
        require_launches(launches[kind], want, f"[saliency] flagship {kind}")
        ref = maps(flag_plain, kind)
        require(got.shape == (3, CAM_BATCH, *flag_model.grid) and bool(np.isfinite(got).all()),
                f"flagship {kind}: maps {got.shape}")
        log(f"[saliency] flagship {kind}, batch {CAM_BATCH}: launches {launches[kind]}; maps "
            f"vs the plain path: largest difference {map_difference(got, ref):.4f}, mean "
            f"{np.abs(got - ref).mean():.4f} (printed, not held: SDTPS lies on the way)")
    gh, gw = flag_model.grid
    probe = torch.zeros(3, CAM_BATCH, gh * gw, flag_model.feat_dim, device=device)
    with torch.no_grad():
        acts = [m(x, c, patch_perturb=probe)["patches"] for m in (flag_model, flag_plain)]
    cos = cosine(acts[0], acts[1])
    log(f"[saliency] flagship probed patch activations, kernel vs plain path: cosine {cos:.6f}")
    require(cos >= COSINE_MIN, f"probed patch activations: cosine {cos} < {COSINE_MIN}")

    for kind, make_cfg in (("gradcam", no_sdtps_cfg(True)), ("gradcam_heatmaps",
                                                             no_sdtps_cfg(False))):
        _, model, _, plain = build_models(device, make_cfg)
        got, ref = maps(model, kind), maps(plain, kind)
        other = maps(plain, kind, images=x.roll(1, dims=0))
        diff, control = map_difference(got, ref), map_difference(other, ref)
        name = "DGAF v3 alone" if kind == "gradcam" else "the Baseline"
        log(f"[saliency] {name}, {kind}: maps vs the plain path largest difference {diff:.4f}, "
            f"mean {np.abs(got - ref).mean():.4f} (bound {CAM_MAP_TOL}); other images' maps "
            f"{control:.4f} away")
        require(diff <= CAM_MAP_TOL < control, f"{name} {kind}: maps {diff} from the plain "
                f"path's (bound {CAM_MAP_TOL}), the control {control}")
        del model, plain
    log(f"[saliency] phase 34, saliency part, in {time.perf_counter() - t0:.1f} s")
    return launches


def phase_miss_sweep(device, root: str) -> dict:
    """Phase 34, part 3 (after phase 27, on its JPEG tree and best
    checkpoint): tools.miss_sweep's seven conditions through the device
    cache, kernels 1 and 2 12 times an eval forward and no other; "None"'s
    mAP and Rank-1 equal to tools/test.main's on the same checkpoint."""
    import os

    from demo2_tpu_torch.tools import miss_sweep, test as test_cli

    t0 = time.perf_counter()
    out = os.path.join(root, "run_device")
    opts = data_opts(root, out, "device") + ["TEST.WEIGHT", os.path.join(out, "checkpoints_best")]
    cli_device = None if device.type == "cuda" else device
    cfg = test_cli.load_config("", opts)
    reset_counts()
    results = miss_sweep.main(opts, device=cli_device)
    sync()
    launches = counts()
    from demo2_tpu_torch.data.loader import make_dataloader

    _, _, val_pipe, *_ = make_dataloader(cfg.freeze())
    forwards = len(miss_sweep.CONDITIONS) * math.ceil(len(val_pipe.samples)
                                                      / cfg.TEST.IMS_PER_BATCH)
    layers = 2 if REHEARSAL else 12
    require_launches(launches, launch_dict(fused_attention_block=layers * forwards,
                                           fused_mlp_block=layers * forwards),
                     "[miss-sweep] tools.miss_sweep")
    cmc, m_ap = test_cli.main(opts, device=cli_device)
    log(f"[miss-sweep] seven conditions, mAP / Rank-1: " + ", ".join(
        f"{miss} {a:.4f} / {r:.4f}" for miss, (a, r) in results.items())
        + f"; tools/test.main {m_ap:.4f} / {cmc[0]:.4f}; launches {launches}")
    require(list(results) == list(miss_sweep.CONDITIONS)
            and all(0.0 < a <= 1.0 for a, _ in results.values()), f"sweep {results}")
    require(results["None"] == (m_ap, cmc[0]),
            f"the sweep's full mAP / Rank-1 {results['None']} differ from tools/test.main's "
            f"{(m_ap, cmc[0])}")
    log(f"[miss-sweep] phase 34, sweep part, in {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 35

DP_WORLD = 2             # ranks on one card, over gloo
DP_STEPS = 3
DP_IDS = 24              # 24 ids x 8 images: DP_STEPS PK batches of 64
DP_VAL = (16, 4)         # val ids x images: 32 queries + 64 gallery, one eval batch of 128
DP_GRAD_COS_MODEL = 0.9999
DP_GRAD_COS_BLOCK = 0.999
DP_GRAD_NORM_REL = 1e-3  # step-1 gradient norm, two ranks against one process
DP_LOSS_REL = 1e-3
DP_BN_REL = 1e-2         # BatchNorm running statistics after the steps, of each tensor's largest
DP_PHASE_BUDGET_S = 90.0
DP_JOIN_TIMEOUT_S = 300


def dp_data(cfg, device):
    """The phase's train cache (DP_IDS ids at 256x128), its PK order and an
    eval cache whose one batch is padded (96 samples in a batch of 128)."""
    from demo2_tpu_torch.data.datasets import SyntheticTriModal
    from demo2_tpu_torch.data.device_cache import DeviceCache
    from demo2_tpu_torch.data.sampler import RandomIdentitySampler

    size = tuple(cfg.INPUT.SIZE_TRAIN)
    ds = SyntheticTriModal(num_pids=DP_IDS, num_cams=CAMERA_NUM,
                           imgs_per_pid=TRAIN_IMGS_PER_PID, image_size=size, seed=0)
    cache = DeviceCache.from_arrays(ds.render_all(ds.train), ds.train, train=True, cfg=cfg,
                                    device=device)
    sampler = RandomIdentitySampler(ds.train, cfg.SOLVER.IMS_PER_BATCH,
                                    cfg.DATALOADER.NUM_INSTANCE, seed=cfg.SOLVER.SEED)
    val_ds = SyntheticTriModal(num_pids=DP_VAL[0], num_cams=CAMERA_NUM, imgs_per_pid=DP_VAL[1],
                               image_size=size, seed=1)
    val_samples = val_ds.query + val_ds.gallery
    val = DeviceCache.from_arrays(val_ds.render_all(val_samples), val_samples, train=False,
                                  cfg=cfg, device=device)
    return cache, sampler.epoch_indices(1), val, len(val_ds.query)


def dp_one_process_step(cfg, ref_model, model, cache, idx, step: int) -> dict:
    """The one-process step from `model`'s current state on the global
    batch `idx`: its loss, gradients and BatchNorm running statistics after,
    computed on `ref_model` (loaded with `model`'s state) with the draws the
    train step takes at optimizer step `step`."""
    from demo2_tpu_torch.engine.train import loss_and_grads
    from demo2_tpu_torch.losses.losses import make_loss_fn

    ref_model.load_state_dict(model.state_dict())
    gen = torch.Generator(device=cache.images.device).manual_seed(
        cfg.SOLVER.SEED * 2**32 + step)  # engine/train.py's seed of the step
    images, pids, camids = cache.batch(idx, gen)
    loss, _, grads = loss_and_grads(cfg, ref_model, make_loss_fn(cfg, NUM_CLASSES), images,
                                    pids, camids, gen, cache.viewids[idx])
    return {"loss": loss.item(), "grads": grads, "stats": bn_stats(ref_model)}


def bn_stats(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def dp_train(cfg, model, init, cache, order, world, control: str = "",
             ref_model=None) -> dict:
    """DP_STEPS optimizer steps of `model` from the weights `init` through
    build_train_step in `world` (this rank's rows of each global batch).
    With `ref_model` (rank 0) each step is held against the one-process step
    from the same state on the same global batch (dp_one_process_step):
    its loss, its gradients after the sum over the ranks (cosine whole
    backbone and lowest block, norm) and the BatchNorm statistics after it.
    `control` 'averaged' divides the summed gradients by W, 'per_rank_bn'
    leaves the BatchNorm statistics per rank.  Returns the losses, the
    comparisons by step, the train state, the launches, the step function
    and this rank's index batches."""
    import contextlib
    from unittest import mock

    from demo2_tpu_torch.engine import train as engine_train
    from demo2_tpu_torch.engine.state import create_train_state
    from demo2_tpu_torch.ops import norm
    from demo2_tpu_torch.parallel.multihost import iter_index_batches

    model.load_state_dict(init)
    state = create_train_state(cfg, model, DP_STEPS)
    reduce = engine_train.reduce_gradients
    summed = {}

    def keep(w, grads):
        reduce(w, grads)
        if control == "averaged":
            for g in grads.values():
                g.div_(w.size)
        if ref_model is not None:
            summed.update({k: g.detach().clone() for k, g in grads.items()})

    per_rank = (mock.patch.object(norm, "active_shard", lambda: None)
                if control == "per_rank_bn" else contextlib.nullcontext())
    bs = cfg.SOLVER.IMS_PER_BATCH
    dev = cache.images.device
    rows = [torch.from_numpy(r).to(dev)
            for r, _ in iter_index_batches(world, order[: DP_STEPS * bs], bs)]
    prefix, groups = block_groups(model)
    losses, compared, launches = [], [], launch_dict()
    with mock.patch.object(engine_train, "reduce_gradients", keep), per_rank:
        step = engine_train.build_train_step(cfg, model, state, cache, world)
        for i, idx in enumerate(rows):
            ref = None
            if ref_model is not None:
                ref = dp_one_process_step(cfg, ref_model, model, cache, torch.from_numpy(
                    order[i * bs : (i + 1) * bs]).to(dev), state.step)
            reset_counts()
            losses.append(step(idx)["loss"].item())
            launches = {k: launches[k] + v for k, v in counts().items()}
            if ref is None:
                continue
            gp = ref["grads"]
            norm_of = lambda gs: math.sqrt(sum(g.double().square().sum().item()
                                               for g in gs.values()))
            mine = bn_stats(model)
            compared.append({
                "loss": abs(losses[-1] - ref["loss"]) / abs(ref["loss"]),
                "cos": grads_cosine(summed, gp, "backbone."),
                "block": min(grads_cosine(summed, gp, prefix.format(b) + g)
                             for b in range(num_blocks(model)) for g in groups),
                "norm": abs(norm_of(summed) / norm_of(gp) - 1.0),
                "stats": max(((mine[k].float() - v.float()).abs().max()
                              / v.float().abs().max()).item() for k, v in ref["stats"].items())})
            summed.clear()
    return {"losses": losses, "compared": compared, "state": state, "launches": launches,
            "step": step, "rows": rows}


def dp_bounds(got: dict, same_on_ranks: bool) -> dict:
    """Phase 35's bounds on a run against the one-process steps from the
    same states: {name: (value, holds)}."""
    c = got["compared"]
    first, loss = c[0], max(x["loss"] for x in c)
    stats = max(x["stats"] for x in c)
    return {"backbone step-1 gradient cosine": (first["cos"], first["cos"] >= DP_GRAD_COS_MODEL),
            "lowest block gradient cosine": (first["block"],
                                             first["block"] >= DP_GRAD_COS_BLOCK),
            "step-1 gradient norm, relative error": (first["norm"],
                                                     first["norm"] <= DP_GRAD_NORM_REL),
            "losses, largest relative error": (loss, loss <= DP_LOSS_REL),
            "ranks bitwise equal": (same_on_ranks, same_on_ranks),
            "BatchNorm statistics, largest relative error": (stats, stats <= DP_BN_REL)}


def dp_step_times(step, idx) -> tuple:
    """Two more steps on this rank: the wall ms of one, and the device ms of
    the other (the profiler's kernels of this process; None where it records
    none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    sync()
    t0 = time.perf_counter()
    step(idx)
    sync()
    wall = 1e3 * (time.perf_counter() - t0)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(idx)
        sync()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    return wall, (busy or None)


def dp_rank(rank: int, port: int, out: str, rehearsal: bool) -> None:
    """One rank of phase 35: joins the gloo group on the shared card, trains
    the flagship DP_STEPS steps on its rows of each global batch of 64, then
    the two controls, and evaluates; rank 0 holds each step of every run
    against the one-process step from the same state (dp_train), and first
    runs the one-process trajectory alone (its losses printed beside the
    two ranks', its step timed).  Writes its lines and launches to
    <out>/rank<r>.json; any failed check raises.  `rehearsal` is the
    parent's REHEARSAL."""
    import os

    global REHEARSAL
    REHEARSAL = rehearsal
    from demo2_tpu_torch.engine.eval import run_eval
    from demo2_tpu_torch.engine.state import replica_tensors
    from demo2_tpu_torch.models import make_model
    from demo2_tpu_torch.ops.kernel_lib import kernel_library
    from demo2_tpu_torch.parallel.collectives import check_replicas_equal
    from demo2_tpu_torch.parallel.mesh import World, join_process_group
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_WORLD), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    device = torch.device("cpu") if rehearsal else torch.device("cuda", 0)
    lines = []

    def say(msg):
        lines.append(msg)
        log(f"[dp rank {rank}] {msg}")

    if not rehearsal:
        require(kernel_library().build_seconds == 0.0, "a rank rebuilt the kernels")
    world = join_process_group("cpu" if rehearsal else "cuda:0", device, timeout_s=240)
    require((world.size, world.rank, world.backend) == (DP_WORLD, rank, "gloo"),
            f"world {world}")
    say(f"joined: backend {world.backend}, rank {world.rank} of {world.size}, {device}")
    cfg = flagship_cfg(True, TEST__IMS_PER_BATCH=128)
    model = make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=device,
                       generator=torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    cache, order, val, num_query = dp_data(cfg, device)
    layers = num_blocks(model)
    ref_model = free = None
    if rank == 0:  # the one-process trajectory on the same global batches (rank 1 waits)
        free = dp_train(cfg, model, init, cache, order, World(device=device))
        free_wall, free_busy = (None, None) if rehearsal else dp_step_times(
            free["step"], torch.from_numpy(order[: cfg.SOLVER.IMS_PER_BATCH]).to(device))
        say(f"one process: losses {free['losses']}; a step's wall ms {free_wall}, device-busy "
            f"ms {free_busy if free_busy is not None else 'not measured'}")
        ref_model = make_model(cfg, NUM_CLASSES, CAMERA_NUM, device=device,
                               generator=torch.Generator().manual_seed(0))
    dist.barrier()
    runs = {}
    for control in ("", "averaged", "per_rank_bn"):
        got = dp_train(cfg, model, init, cache, order, world, control, ref_model)
        try:
            check_replicas_equal(world, replica_tensors(got["state"]), "the train states")
            same = True
        except RuntimeError:
            same = False
        label = control or "two ranks"
        say(f"{label}: losses {got['losses']}, launches of kernels 3 / 4 "
            f"{got['launches']['fused_attention_block_train']} / "
            f"{got['launches']['attention_bwd_saved_db']} over {DP_STEPS} steps")
        require_launches(got["launches"], launch_dict(
            fused_attention_block_train=layers * DP_STEPS,
            attention_bwd_saved_db=layers * DP_STEPS), f"[dp] {label}, rank {rank}")
        if rank == 0:
            bounds = dp_bounds(got, same)
            say(f"{label} against the one-process steps from the same states: " + "; ".join(
                f"{k} {v}{'' if ok else ' (fails)'}" for k, (v, ok) in bounds.items())
                + f"; by step {got['compared']}; the free trajectories' losses "
                f"{max(abs(a - b) / abs(b) for a, b in zip(got['losses'], free['losses']))} "
                "apart (printed)")
            runs[control] = all(ok for _, ok in bounds.values())
        if control == "":
            # two more steps a rank, without the one-process comparison
            wall, busy = (None, None) if rehearsal else dp_step_times(got["step"],
                                                                      got["rows"][0])
            say(f"two-rank step: wall ms {wall}, device-busy ms of this rank's step "
                f"{busy if busy is not None else 'not measured'}")
            reset_counts()
            cmc, m_ap = run_eval(cfg, model, val, num_query, world=world)
            ev = counts()
            say(f"eval of {len(val.pids)} samples (one batch of {cfg.TEST.IMS_PER_BATCH}, "
                f"{cfg.TEST.IMS_PER_BATCH // DP_WORLD} rows a rank): mAP {m_ap}, Rank-1 "
                f"{cmc[0]}; launches of kernels 1 / 2 {ev['fused_attention_block']} / "
                f"{ev['fused_mlp_block']}")
            require_launches(ev, launch_dict(fused_attention_block=layers,
                                             fused_mlp_block=layers), f"[dp] eval, rank {rank}")
            every = [None] * DP_WORLD
            dist.all_gather_object(every, (m_ap, [float(x) for x in cmc]))
            require(all(e == every[0] for e in every), f"the ranks' eval differs: {every}")
            launches = {k: got["launches"][k] for k in ("fused_attention_block_train",
                                                         "attention_bwd_saved_db")}
            launches.update({k: ev[k] for k in ("fused_attention_block", "fused_mlp_block")})
        del got
    if rank == 0:
        require(runs[""], "the two-rank run fails a bound")
        require(not runs["averaged"] and not runs["per_rank_bn"],
                f"a control passes every bound: {runs}")
    dist.barrier()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"lines": lines, "launches": launches}, f)
    dist.destroy_process_group()


def phase_data_parallel(device, card) -> dict:
    """Phase 35 (a): DP_WORLD ranks (spawned processes) on cuda:0 over gloo
    train and evaluate the flagship at full width (dp_rank).  Returns each
    rank's launches of kernels 1-4."""
    import multiprocessing
    import socket
    import tempfile

    t0 = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as out:
        procs = [ctx.Process(target=dp_rank, args=(r, port, out, REHEARSAL))
                 for r in range(DP_WORLD)]
        for p in procs:
            p.start()
        try:
            deadline = time.perf_counter() + DP_JOIN_TIMEOUT_S
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.perf_counter()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        require(codes == [0] * DP_WORLD, f"[dp] rank exit codes {codes}")
        ranks = []
        for r in range(DP_WORLD):
            with open(f"{out}/rank{r}.json") as f:
                ranks.append(json.load(f))
    seconds = time.perf_counter() - t0
    log(f"[dp] {DP_WORLD} ranks sharing one card measure correctness, not scaling ({card}); "
        f"phase 35 (a) in {seconds:.1f} s (budget {DP_PHASE_BUDGET_S:.0f} s)")
    return {k: [rk["launches"][k] for rk in ranks] for k in ranks[0]["launches"]}


def phase_distributed_cli(device, root: str) -> None:
    """Phase 35 (b): tools/train --distributed in a one-rank NCCL world
    launched by torch.distributed.run, one epoch and an eval on phase 27's
    JPEG tree, against tools/train without --distributed, each a fresh
    process (this one's globals are not the defaults: exact_products turns
    cuBLAS's reduced-precision bf16 sums off): the checkpoint (parameters,
    buffers, optimizer moments) and the mAP bit for bit.  Rehearsed on the
    CPU, the world is gloo's."""
    import glob
    import os
    import socket

    from demo2_tpu_torch.utils.metrics_log import load_metrics

    t0 = time.perf_counter()
    backend = "gloo" if device.type == "cpu" else "nccl"
    runs = {}
    for mode in (backend, "none"):
        out = os.path.join(root, f"dist_{mode}")
        opts = data_opts(root, out, "device") + ["SOLVER.MAX_EPOCHS", "1"]
        cmd = [sys.executable, "-m", "demo2_tpu_torch.tools.train", "--exp_name", "dist"] + opts
        if mode == backend:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            cmd[1:3] = ["-m", "torch.distributed.run", "--nproc_per_node", "1",
                        "--master_port", str(port), "-m", "demo2_tpu_torch.tools.train",
                        "--distributed"]
        proc = subprocess.run(cmd, env=dict(os.environ, PYTHONPATH=os.getcwd()),
                              capture_output=True, text=True, timeout=600)
        text = proc.stdout + proc.stderr
        require(proc.returncode == 0, f"[dist] {mode} exit {proc.returncode}:\n{text[-3000:]}")
        if mode == backend:
            require(f"data parallel: backend {backend}, 1 ranks" in text,
                    f"[dist] no {backend} startup line:\n{text[-2000:]}")
        m_ap = max(r["value"] for r in load_metrics(os.path.join(out, "dist_metrics.jsonl"))
                   if r["tag"] == "Val/mAP")
        (path,) = glob.glob(os.path.join(out, "checkpoints", "step_*.pt"))
        runs[mode] = (torch.load(path, map_location="cpu", weights_only=True), m_ap)
    (dist_sd, dist_map), (sd, m_ap) = runs[backend], runs["none"]
    flat = lambda d: {f"{k}.{j}": v for k, x in d.items() if isinstance(x, dict)
                      for j, v in flat(x).items()} | {k: x for k, x in d.items()
                                                      if not isinstance(x, dict)}
    a, b = flat(dist_sd), flat(sd)
    differ = [k for k in b if not (torch.equal(a[k], b[k]) if isinstance(b[k], torch.Tensor)
                                   else a[k] == b[k])]
    log(f"[dist] torchrun --nproc_per_node 1 tools/train --distributed ({backend}) against "
        f"tools/train: mAP {dist_map} / {m_ap}; checkpoint entries that differ "
        f"{len(differ)} of {len(b)}; {time.perf_counter() - t0:.1f} s")
    require(a.keys() == b.keys() and not differ and dist_map == m_ap,
            f"[dist] differs from the run without a group: {differ[:5]}, mAP {dist_map} / "
            f"{m_ap}")


# ---------------------------------------------------------------- phase 36


LONG_SHAPE = (192, 211, 768)  # the stride-12 flagship's x (3B, tokens, width) at batch 64
# The block kernels' wide forms (heads of 64, 145 <= S <= 256): the stride-12
# flagship, one token past the register tiles, the 384x128 crop's 193 and the
# longest the forms take, each at a batch that gives every block of the
# persistent grid several (sample, head) items (17 or 18 at 192 x 12 heads
# over 132 SMs), the mbarrier-parity trap of attention_regs_fwd.cuh's
# wait_started.  The tiling's edges: S16 a multiple of the 64-column probs
# box only at 256 (160, 176, 208 and 224 end in a part box), 16-row tiles a
# head of 10, 11, 13, 14 and 16, so the backward's four query warps meet
# each item at another tile and its last key warp holds one tile or none.
LONG_BLOCK_SHAPES = (LONG_SHAPE, (192, 145, 768), (64, 193, 768), (48, 256, 768),
                     (96, 161, 768))
# Kernels 4 and 7 alone at the edges of the wide form's tiling: 256 tokens at
# batch 192 (18 items a block), S16 = 160 with 8 heads, a batch of 3, and
# S = 161 at batch 256 (23 or 24 items a block, 11 tiles an item).
LONG_SAVED_EDGES = ((192, 256, 2304), (16, 150, 1536), (3, 211, 2304), (256, 161, 2304))
LONG_CROP = (384, 128)  # a taller crop at stride 16: 24 x 8 patches + 1 = 193 tokens
LONG_PHASE_BUDGET_S = 60.0


def form_names(form: str) -> tuple:
    """The wrappers of kernels 1, 3, 4 and 7 in `form` ("_wide", "_long")."""
    return tuple(name + form for name in ("fused_attention_block", "fused_attention_block_train",
                                          "attention_bwd_saved_db", "attention_bwd_saved"))


def long_shape_launches(fused_dw: bool, form: str = "_wide") -> dict:
    """The launches of one pass of phase 36 (a)'s (or 37 (a)'s) checks at a
    shape of `form`: every one on that form, none on the others."""
    k1, k3, k4, k7 = form_names(form)
    return launch_dict(**{k1: 1, k3: 2, k4: 2, k7: 1},
                       attention_bwd_fused_dw=2 if fused_dw else 0)


def phase_long_block_kernels(device, card, shapes=LONG_BLOCK_SHAPES,
                             edges=LONG_SAVED_EDGES, form: str = "_wide") -> tuple:
    """Phase 36 (a) (and, with `form` "_long", 37 (a)): kernels 1, 3, 4, 7
    and 8 past the register tiles, at `shapes` (x (B, S, C)): kernel 1
    against its plain bf16 version (phase 2's bounds) and bitwise equal to
    kernel 3's out; kernel 3 with its residuals and probs (phase 5's bounds,
    within BLOCK_ROUNDING_REL of the plain version, which its misrounded
    control, p rounded before it is normalised, fails); kernels 4 and 7 on
    kernel 3's qkv and probs (phase 5's bounds, the dS-in-f32 control
    failing ROUNDING_MEAN_TOL, bit-identical reruns, 7 bitwise 4's dqkv);
    kernel 8 (phase 18's bounds, its first stage the `form` of 4); the
    training Function's grads at the first shape; 4 and 7 also at `edges`
    (packed qkv).  Each wrapper's launches show that the `form` ran and no
    other.  On the card, the four timed at the first shape beside their
    bounds (and kernel 8 there, printed).  Returns (name -> max abs error,
    name -> times) for the four at the first shape."""
    from demo2_tpu_torch.ops import fused_block as fb

    exact_products()
    tag = "[long]" if form == "_wide" else "[longer]"
    k1, k3, k4, k7 = form_names(form)
    errors = {}
    for shape in shapes:
        b, s, c = shape
        x, attn, _ = block_inputs(shape, device, seed=1)
        kw = dict(num_heads=c // 64, scale=64 ** -0.5)
        reset_counts()
        eval_out, eval_err = check_eval_kernel(
            "fused_attention_block", lambda: fb.fused_attention_block(x, **attn, **kw),
            lambda xx, w: fb.attention_block_plain(xx, **w, **kw), attn, x, shape)
        train = check_train_forward(x, {k: v.float() for k, v in attn.items()}, shape, kw)
        if REHEARSAL:
            log(f"[rehearsal] kernel 1 {shape}: bitwise equality to kernel 3 on the card only")
        else:
            require(torch.equal(eval_out, train["residuals"][0]),
                    f"kernel 1 {shape}: output not bitwise equal to kernel 3's")
            log(f"{tag} kernel 1 {shape}: output bitwise equal to kernel 3's")
        _, qkv, _, probs = train["residuals"]
        do = torch.randn(shape, generator=torch.Generator().manual_seed(b + s)).to(
            device, torch.bfloat16)
        bwd = check_train_backward(qkv, probs, do, kw)
        check_fused_dw(device, (b, s, 3 * c))
        require_launches(counts(), long_shape_launches(True, form), f"{tag} checks at {shape}")
        if shape == shapes[0]:
            check_train_function(x, {k: v.float() for k, v in attn.items()}, do, shape, kw)
            errors.update({k1: eval_err, k3: train["max_abs"], k4: bwd["max_abs"],
                           k7: bwd["max_abs"]})
    for shape in edges:
        kw = dict(num_heads=shape[-1] // 3 // 64, scale=64 ** -0.5)
        reset_counts()
        check_train_backward(*saved_probs_inputs(shape, device, seed=9), kw)
        require_launches(counts(), launch_dict(**{k4: 2, k7: 1}),
                         f"{tag} kernels 4 and 7 at {shape}")
    log(f"{tag} tolerances as phases 2, 5 and 18 (the misrounded controls beyond them) at "
        f"{len(shapes)} shapes and {len(edges)} edges of kernel 4's {form[1:]} form; every "
        f"launch on the {form[1:]} forms: ok")
    times = (time_long_block_kernels(device, card, shapes[0], form) if device.type == "cuda"
             else {})
    return errors, times


def time_long_block_kernels(device, card, shape, form: str = "_wide") -> dict:
    """Kernels 1, 3, 4 and 7 in `form` timed at `shape` beside their bounds
    and plain versions; kernel 8 there too (printed)."""
    from demo2_tpu_torch.ops import fused_block as fb, packed_attention as pa

    b, s, c = shape
    k1, k3, k4, k7 = form_names(form)
    x, attn, _ = block_inputs(shape, device, seed=1)
    xt, p, grad_out = train_kernel_inputs(shape, device, seed=5)
    w = {k: (v.to(torch.bfloat16) if k in ("wqkv", "wout") else v) for k, v in p.items()}
    kw = dict(num_heads=c // 64, scale=64 ** -0.5)
    _, qkv, _, probs = getattr(fb, k3)(xt, **w, **kw)
    saved = [qkv, probs, grad_out]
    times = time_kernels({
        k1: timed(lambda: getattr(fb, k1)(x, **attn, **kw),
                  lambda: fb.attention_block_plain(x, **attn, **kw),
                  block_flops("fused_attention_block", shape), shape, [x, *attn.values()]),
        k3: timed(lambda: getattr(fb, k3)(xt, **w, **kw),
                  lambda: fb.attention_block_train_plain(xt, **w, **kw),
                  train_kernel_flops("fused_attention_block_train", shape), shape,
                  [xt, *w.values()]),
        k4: timed(lambda: getattr(pa, k4)(qkv, probs, grad_out, **kw),
                  lambda: pa.attention_bwd_saved_plain(qkv, probs, grad_out, with_db=True, **kw),
                  train_kernel_flops("attention_bwd_saved_db", shape), shape, saved),
        k7: timed(lambda: getattr(pa, k7)(qkv, probs, grad_out, **kw),
                  lambda: pa.attention_bwd_saved_plain(qkv, probs, grad_out, with_db=False, **kw),
                  train_kernel_flops("attention_bwd_saved", shape), shape, saved),
    }, card)
    inputs, kw8 = fused_dw_inputs((b, s, 3 * c), device, seed=19)
    time_kernels({"attention_bwd_fused_dw": timed(
        lambda: pa.attention_bwd_fused_dw(*inputs, **kw8),
        lambda: pa.attention_bwd_fused_dw_plain(*inputs, **kw8),
        8 * b * s * s * c + 4 * b * s * c * 3 * c, (b, s, 3 * c), list(inputs))}, card)
    return times


def long_cfg(stride=(12, 12), size=None):
    """The flagship at MODEL.STRIDE_SIZE `stride` and, with `size`, at that
    crop (a rehearsal shrinks it as apply_tiny does: a quarter of each
    side); `make_cfg(fused)` for build_models."""
    def make_cfg(fused: bool, **overrides):
        if size is not None:
            h, w = (size[0] // 4, size[1] // 4) if REHEARSAL else size
            overrides = dict(INPUT__SIZE_TRAIN=(h, w), INPUT__SIZE_TEST=(h, w), **overrides)
        return flagship_cfg(fused, MODEL__STRIDE_SIZE=tuple(stride), **overrides)

    return make_cfg


def phase_long_flagship(device, card, flag_cfg, flag_model, cache, sampler) -> dict:
    """Phase 36 (b) and (c): the flagship past 144 tokens on both paths.
    (b) At MODEL.STRIDE_SIZE (12, 12), 211 tokens at 256x128: phase 3's
    requests (kernels 1 and 2 12 times a forward, 1 in its wide form),
    phase 6 over BACKBONE_STEPS steps (3 and 4 in their wide forms 12 times
    a step) with the backbone's step-1 gradient held from one upstream
    gradient (SDTPS's input gradient is ill-conditioned) and the losses held,
    the input-gradient pass (3 and 7 wide, 12 times); on the card its step and
    request beside the flagship's.  (c) At 384x128, stride 16, 193 tokens, at
    CUT_DEPTH blocks (its kernels' checks are phase 36 (a)'s): one batch-64
    request against the plain path and one step (the backbone's gradient
    held as in (b), the step's launches, a finite loss).  Returns
    the launches of (b)'s requests, steps and input-gradient pass."""
    t0 = time.perf_counter()
    make_cfg = long_cfg()
    cfg, model, plain_cfg, plain = build_models(device, make_cfg)
    layers = num_blocks(model)
    log(f"[s12] the flagship at stride (12, 12): {layers} blocks, "
        f"{math.prod(model.grid) + 1} tokens")
    served = phase_slice(device, cfg, model, plain_cfg, plain,
                         launch_dict(fused_attention_block_wide=layers, fused_mlp_block=layers),
                         label="s12-slice")
    trained = phase_train(device, cfg, model, plain_cfg, plain, cache, sampler,
                          launch_dict(fused_attention_block_train_wide=layers,
                                      attention_bwd_saved_db_wide=layers),
                          label="s12-train", whole_model=False, hold_losses=True,
                          steps=BACKBONE_STEPS)
    frozen = phase_input_grad(device, cfg, model, plain, make_cfg, form="_wide")
    launches = {"fused_attention_block_wide": served["fused_attention_block_wide"],
                "fused_attention_block_train_wide": trained["fused_attention_block_train_wide"],
                "attention_bwd_saved_db_wide": trained["attention_bwd_saved_db_wide"],
                "attention_bwd_saved_wide": frozen["attention_bwd_saved_wide"]}
    del plain
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # (c) the 384x128 crop at stride 16, at CUT_DEPTH blocks
    check_crop(device, cut_depth(long_cfg((16, 16), LONG_CROP)), "_wide", "crop")
    log(f"[long] phase 36 (b, c) in {time.perf_counter() - t0:.1f} s")
    if device.type == "cuda":
        torch.cuda.empty_cache()
        time_beside_flagship(device, card, "flagship s12", cfg, model, flag_cfg, flag_model,
                             cache, sampler)
    return launches


def check_requests(device, cfg, model, plain_cfg, plain, per_forward: dict, label: str,
                   ns=(1, 64)) -> dict:
    """Requests of `ns` images through FeatureExtractor, each forward
    launching `per_forward` (all twenty-four kernels' counts), the embeddings
    of unit norm and within COSINE_MIN of the plain path's.  Returns the
    launches of the requests."""
    from demo2_tpu_torch.serving import FeatureExtractor

    images, cams = request_images(max(ns), cfg, seed=6)
    fx = FeatureExtractor(cfg, model, device=device, batch_size=64)
    fx_plain = FeatureExtractor(plain_cfg, plain, device=device, batch_size=64)
    total = launch_dict()
    for n in ns:
        reset_counts()
        emb = fx.extract(images[:n], cams[:n])
        sync()
        forwards = math.ceil(n / fx.batch_size)
        require_launches(counts(), {k: v * forwards for k, v in per_forward.items()},
                         f"[{label}] N={n} request")
        total = {k: v + counts()[k] for k, v in total.items()}
        ref = fx_plain.extract(images[:n], cams[:n])
        norms = np.linalg.norm(emb, axis=1)
        cos = np.sum(emb * ref, axis=1) / (norms * np.linalg.norm(ref, axis=1))
        log(f"[{label}] N={n} request: shape {emb.shape}, cosine to the plain path min "
            f"{cos.min():.6f} mean {cos.mean():.6f}")
        require(emb.shape == (n, model.embed_dim) and bool(np.isfinite(emb).all()),
                f"[{label}] N={n} request: shape or non-finite")
        require(bool(np.all(np.abs(norms - 1.0) < 1e-4)), f"[{label}] N={n}: not unit norm")
        require(float(cos.min()) >= COSINE_MIN,
                f"[{label}] N={n}: cosine to the plain path {cos.min()} < {COSINE_MIN}")
    return total


def check_crop(device, make_cfg, form: str, label: str) -> None:
    """The flagship at another crop on both paths: one batch-64 request (the
    block kernels in `form`) and one train step of a cache of its own, 16 ids
    x 8 (its launches, a finite loss), the backbone's step-1 gradient held
    from one upstream gradient."""
    cfg, model, plain_cfg, plain = build_models(device, make_cfg)
    layers = num_blocks(model)
    log(f"[{label}] the flagship at {tuple(cfg.INPUT.SIZE_TRAIN)}, stride "
        f"{tuple(cfg.MODEL.STRIDE_SIZE)}: {layers} blocks, {math.prod(model.grid) + 1} tokens")
    k1, k3, k4, _ = form_names(form)
    check_requests(device, cfg, model, plain_cfg, plain,
                   launch_dict(**{k1: layers}, fused_mlp_block=layers), label, ns=(64,))
    cache, sampler = build_train_data(cfg, device, num_pids=16)
    idx = torch.from_numpy(sampler.epoch_indices(1)[:cfg.SOLVER.IMS_PER_BATCH]).to(device)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    check_backbone_grads(cfg, model, plain_cfg, plain, cache, idx, label)
    model.load_state_dict(init)

    def per_step(i, rose):
        require_launches(rose, launch_dict(**{k3: layers, k4: layers}),
                         f"[{label}] train step {i}")

    losses = train_steps(cfg, model, cache, sampler.epoch_indices(1), 1, per_step)
    require(math.isfinite(losses[0]), f"[{label}] a non-finite loss")
    log(f"[{label}] one train step of {cfg.SOLVER.IMS_PER_BATCH}: loss {losses[0]:.4f}")
    del plain, model, cache
    if device.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 37


LONGER_SHAPE = (192, 442, 768)  # the flagship's x at 256x256, stride 12, batch 64
# The block kernels' long forms (heads of 64, 257 <= S <= 512): the 256x256
# crop at stride 12, one token past the wide forms (17 key tiles: the
# backward's two blocks of a cluster take 9 and 8; the forward's last 64-row
# query tile holds one row), the 384x128 crop's 311, a last query tile of a
# few rows (300: 44; 340: 20) and the longest the forms take, each at a batch that
# gives a block (and a cluster) of the persistent grid many (sample, head)
# items, the mbarrier-parity trap of attention_regs_fwd.cuh's wait_started.
# S16 = 272, 304, 320, 352 and 448 are not multiples of 64 (a part 64-column
# probs box, a part 64-row tile), and each of the forward's four builds (5-8
# chunks of 32 keys a warpgroup) runs.
LONGER_BLOCK_SHAPES = (LONGER_SHAPE, (192, 257, 768), (64, 311, 768), (48, 512, 768),
                       (8, 300, 768), (8, 340, 768))
# Kernels 4 and 7 alone: a batch of 3 (36 items, one a cluster), 256 at
# S16 = 272 (3,072 items, ~47 a cluster), 24 key tiles (12 a block) and 29
# (15 and 14) with a last 16-row tile of one row.
LONGER_SAVED_EDGES = ((3, 442, 2304), (256, 272, 2304), (16, 384, 2304), (4, 449, 2304))
# TransReID's stride-12 crops: 256x256 (its VeRi config; 21 x 21 patches + 1
# = 442 tokens) and 384x128 (its person configs; 31 x 10 + 1 = 311).
LONGER_CROPS = ((256, 256), (384, 128))
LONGER_PIDS = 80  # 80 ids x 8: BACKBONE_STEPS PK batches of 64 at 256x256


def time_step_request(device, card, label, cfg, model, cache, sampler, reps=3) -> None:
    """One model's train step and batch-64 request: host wall (the mean of
    `reps` calls after one), the profiler's device busy of one call each, and
    the peak device memory of a step."""
    from demo2_tpu_torch.serving import FeatureExtractor

    step = build_timed_step(cfg, model, cache, sampler)
    images, cams = request_images(64, cfg, seed=3)
    fx = FeatureExtractor(cfg, model, device=device, batch_size=64)

    def request():
        fx.extract(images, cams)

    def wall_ms(fn):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) * 1e3 / reps

    step_ms, request_ms = wall_ms(step), wall_ms(request)
    torch.cuda.reset_peak_memory_stats()
    step()
    sync()
    peak = torch.cuda.max_memory_allocated() / 2**30
    bs = cfg.SOLVER.IMS_PER_BATCH
    _, step_busy = profile(f"{label}, one train step of {bs}", step, card, top=8)
    _, request_busy = profile(f"{label}, one batch-64 request", request, card, top=8)
    log(f"[time] {label}: train step of {bs} {step_ms:.2f} ms (device busy {step_busy:.2f}), "
        f"batch-64 request {request_ms:.2f} ms (device busy {request_busy:.2f}); peak device "
        f"memory of a step {peak:.2f} GiB ({card})")


def phase_longer_flagship(device, card, flag_cfg, flag_model, cache, sampler) -> dict:
    """Phase 37 (b) and (c): the flagship on TransReID's stride-12 crops, at
    full width and all 12 blocks, on both paths.  (b) 256x256 (442 tokens):
    requests of 1 and 64 images against the plain path (kernels 1 and 2 12
    times a forward, 1 in its long form), phase 6 over BACKBONE_STEPS steps
    on a cache of LONGER_PIDS ids (3 and 4 in their long forms 12 times a
    step) with the backbone's step-1 gradient held from one upstream gradient
    and each step's loss held to the plain path's (their fall is printed
    only: at 442 tokens the random-init model starts on the ~2.57 plateau
    that the 129- and 211-token models reach after their first step, so ten
    steps need not fall on either path), the input-gradient pass (3 and 7
    long, 12 times; its references 16 images at a time), the peak memory
    over phase 6 (both paths); on the card its step and batch-64
    request timed beside the 129-token flagship's.  (c) 384x128 (311
    tokens): one batch-64 request against the plain path and one step (the
    backbone's gradient held, the step's launches, a finite loss).  Returns
    the launches of (b)'s requests, steps and input-gradient pass."""
    t0 = time.perf_counter()
    make_cfg = long_cfg((12, 12), LONGER_CROPS[0])
    cfg, model, plain_cfg, plain = build_models(device, make_cfg)
    layers = num_blocks(model)
    log(f"[s12-256] the flagship at {tuple(cfg.INPUT.SIZE_TRAIN)}, stride (12, 12): {layers} "
        f"blocks, {math.prod(model.grid) + 1} tokens")
    served = check_requests(device, cfg, model, plain_cfg, plain,
                            launch_dict(fused_attention_block_long=layers,
                                        fused_mlp_block=layers), "s12-256")
    lcache, lsampler = build_train_data(cfg, device, num_pids=LONGER_PIDS)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trained = phase_train(device, cfg, model, plain_cfg, plain, lcache, lsampler,
                          launch_dict(fused_attention_block_train_long=layers,
                                      attention_bwd_saved_db_long=layers),
                          label="s12-256-train", whole_model=False, hold_losses=True,
                          steps=BACKBONE_STEPS, hold_fall=False)
    if device.type == "cuda":
        log(f"[s12-256] peak device memory over phase 6's checks and both paths' steps: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
    frozen = phase_input_grad(device, cfg, model, plain, make_cfg, form="_long", ref_chunk=16)
    launches = {"fused_attention_block_long": served["fused_attention_block_long"],
                "fused_attention_block_train_long": trained["fused_attention_block_train_long"],
                "attention_bwd_saved_db_long": trained["attention_bwd_saved_db_long"],
                "attention_bwd_saved_long": frozen["attention_bwd_saved_long"]}
    del plain
    if device.type == "cuda":
        torch.cuda.empty_cache()
        time_step_request(device, card, "flagship s12 256x256", cfg, model, lcache, lsampler)
        time_step_request(device, card, "flagship 256x128", flag_cfg, flag_model, cache, sampler)
    del model, lcache
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # (c) 384x128 at stride 12
    check_crop(device, long_cfg((12, 12), LONGER_CROPS[1]), "_long", "s12-384")
    log(f"[longer] phase 37 (b, c) in {time.perf_counter() - t0:.1f} s")
    return launches


# The stride-12 flagship's crops that tools/compare_trees.py --steps times, by
# their tokens: (the crop, None for the config's 256x128; the ids of its
# cache, as phase 37 cuts the 256x256 cache).
STEP_CROPS = {211: (None, NUM_CLASSES), 442: (LONGER_CROPS[0], LONGER_PIDS)}


def time_long_step(device, card, rounds=6, reps=3, warmup=2, tokens=211) -> str:
    """The stride-12 flagship's train step (batch 64) and batch-64 request at
    the crop of `tokens` (STEP_CROPS), as tools/compare_trees.py --steps
    times them in each checkout: host wall per call, the mean of `reps`
    calls after `warmup`, `rounds` times each, and on the card the
    profiler's device busy of one step and one request with their largest
    items.  Returns the summary line."""
    from demo2_tpu_torch.serving import FeatureExtractor

    size, pids = STEP_CROPS[tokens]
    cfg, model, _, _ = build_models(device, long_cfg((12, 12), size))
    cache, sampler = build_train_data(cfg, device, num_pids=pids)
    step = build_timed_step(cfg, model, cache, sampler)
    images, cams = request_images(64, cfg, seed=3)
    fx = FeatureExtractor(cfg, model, device=device, batch_size=64)

    def request():
        fx.extract(images, cams)

    def wall_ms(fn):
        for _ in range(warmup):
            fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) * 1e3 / reps

    step_ms, request_ms = [], []
    for _ in range(rounds):
        step_ms.append(wall_ms(step))
        request_ms.append(wall_ms(request))
    label = "s12" if tokens == 211 else f"s12-{tokens}"
    line = (f"{label} step {spread(step_ms)} ms, batch-64 request {spread(request_ms)} ms "
            f"(host wall)")
    if device.type == "cuda":
        bs = cfg.SOLVER.IMS_PER_BATCH
        _, step_busy = profile(f"{label}, one train step of {bs}", step, card, top=8)
        _, request_busy = profile(f"{label}, one batch-64 request", request, card, top=12)
        line += f", device busy step {step_busy:.2f} ms, request {request_busy:.2f} ms ({card})"
    return line


def phase_long_cli(device, root: str) -> None:
    """Phase 36 (d), on phase 27's JPEG tree: tools/train.main at
    MODEL.STRIDE_SIZE (12, 12) (211 tokens; one epoch with an eval and a
    checkpoint, the decoded device cache), its launches all on the block
    kernels' wide forms, then tools/test.main on its checkpoint reproducing
    the run's mAP and Rank-1."""
    import os

    from demo2_tpu_torch.data.loader import make_dataloader
    from demo2_tpu_torch.tools import test as test_cli, train as train_cli

    out = os.path.join(root, "run_s12")
    opts = data_opts(root, out, "device") + ["MODEL.STRIDE_SIZE", "[12, 12]",
                                             "SOLVER.MAX_EPOCHS", "1"]
    cfg = train_cli.load_config("", opts)
    _, sampler, val_pipe, *_ = make_dataloader(cfg.freeze())
    steps = len(sampler) // cfg.SOLVER.IMS_PER_BATCH
    evals = math.ceil(len(val_pipe.samples) / cfg.TEST.IMS_PER_BATCH)
    layers = 2 if REHEARSAL else 12
    cli_device = None if device.type == "cuda" else device
    reset_counts()
    t0 = time.perf_counter()
    state, best = train_cli.main(["--exp_name", "s12"] + opts, device=cli_device)
    sync()
    launches = counts()
    last = state.history[-1]
    log(f"[s12-cli] tools/train.main at stride (12, 12): {steps} steps and {evals} eval "
        f"forwards in {time.perf_counter() - t0:.1f} s; loss {last['loss']:.4f}, mAP "
        f"{last['mAP']}, Rank-1 {last['Rank-1']}; launches {launches}")
    require(math.isfinite(last["loss"]), "[s12-cli] a non-finite loss")
    require_launches(launches, launch_dict(
        fused_attention_block_wide=layers * evals, fused_mlp_block=layers * evals,
        fused_attention_block_train_wide=layers * steps,
        attention_bwd_saved_db_wide=layers * steps), "[s12-cli] tools/train.main")
    cmc, got = test_cli.main(opts + ["TEST.WEIGHT", os.path.join(out, "checkpoints")],
                             device=cli_device)
    log(f"[s12-cli] tools/test.main on its checkpoint: mAP {got}, Rank-1 {cmc[0]} (the run's "
        f"{last['mAP']}, {last['Rank-1']})")
    require((got, float(cmc[0])) == (last["mAP"], last["Rank-1"]),
            f"[s12-cli] tools/test.main gives mAP {got}, Rank-1 {cmc[0]}")


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
    "packed_attention_fwd": ("demo2_tpu_torch/csrc/packed_attention.cu",
                             "demo2_tpu/ops/packed_attention.py:52"),
    "packed_attention_bwd": ("demo2_tpu_torch/csrc/packed_attention.cu",
                             "demo2_tpu/ops/packed_attention.py:91"),
    "flash_attention_fwd": ("demo2_tpu_torch/csrc/flash_attention.cu",
                            "demo2_tpu/ops/flash_attention.py:53"),
    "flash_attention_bwd": ("demo2_tpu_torch/csrc/flash_attention.cu",
                            "demo2_tpu/ops/flash_attention.py:67"),
    "layernorm_bwd": ("demo2_tpu_torch/csrc/layernorm_bwd.cu", "demo2_tpu/ops/norm.py:183"),
    "jaccard_min_sum": ("demo2_tpu_torch/csrc/jaccard_min_sum.cu",
                        "demo2_tpu/utils/reranking.py:23"),
    "fused_mlp_block_train": ("demo2_tpu_torch/csrc/fused_mlp_block.cu",
                              "demo2_tpu/ops/fused_block.py:369"),
    "attention_bwd_fused_dw": ("demo2_tpu_torch/csrc/attention_bwd.cu",
                               "demo2_tpu/ops/packed_attention.py:377"),
    "attention_ablate": ("demo2_tpu_torch/csrc/attention_ablate.cu",
                         "tools/bench_kernel_ablate.py:25"),
    "packed_attention_wide_fwd": ("demo2_tpu_torch/csrc/packed_attention_wide.cu",
                                  "demo2_tpu/ops/packed_attention.py:52"),
    "packed_attention_wide_bwd": ("demo2_tpu_torch/csrc/packed_attention_wide.cu",
                                  "demo2_tpu/ops/packed_attention.py:91"),
    "fused_attention_block_wide": ("demo2_tpu_torch/csrc/attention_wide_block.cuh",
                                   "demo2_tpu/ops/fused_block.py:128"),
    "fused_attention_block_train_wide": ("demo2_tpu_torch/csrc/attention_wide_block.cuh",
                                         "demo2_tpu/ops/fused_block.py:118"),
    "attention_bwd_saved_db_wide": ("demo2_tpu_torch/csrc/attention_wide_block.cuh",
                                    "demo2_tpu/ops/packed_attention.py:264"),
    "attention_bwd_saved_wide": ("demo2_tpu_torch/csrc/attention_wide_block.cuh",
                                 "demo2_tpu/ops/packed_attention.py:231"),
    "fused_attention_block_long": ("demo2_tpu_torch/csrc/attention_long_block.cuh",
                                   "demo2_tpu/ops/fused_block.py:128"),
    "fused_attention_block_train_long": ("demo2_tpu_torch/csrc/attention_long_block.cuh",
                                         "demo2_tpu/ops/fused_block.py:118"),
    "attention_bwd_saved_db_long": ("demo2_tpu_torch/csrc/attention_long_block.cuh",
                                    "demo2_tpu/ops/packed_attention.py:264"),
    "attention_bwd_saved_long": ("demo2_tpu_torch/csrc/attention_long_block.cuh",
                                 "demo2_tpu/ops/packed_attention.py:231"),
}


def clock(t0: float, what: str) -> None:
    """The script's seconds since t0 at the end of `what`."""
    log(f"[clock] {what}: {time.perf_counter() - t0:.1f} s")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    card = phase_device()
    errors = phase_kernels(device)
    errors.update(phase_train_kernels(device))
    errors.update(phase_attention_kernels(device))
    errors.update(phase_wide_attention_kernels(device))
    errors.update(phase_ln_bwd_kernel(device))
    errors.update(phase_jaccard_kernel(device))
    errors.update(phase_new_kernels(device))
    # The block kernels past the register tiles' 144 tokens (phase 36 (a)):
    # the wide forms of kernels 1, 3, 4, 7 and 8.
    t36 = time.perf_counter()
    long_errors, long_times = phase_long_block_kernels(device, card)
    errors.update(long_errors)
    phase36_s = time.perf_counter() - t36
    # Past 256 tokens (phase 37 (a)): the long forms of kernels 1, 3, 4, 7 and 8.
    t37 = time.perf_counter()
    longer_errors, longer_times = phase_long_block_kernels(
        device, card, LONGER_BLOCK_SHAPES, LONGER_SAVED_EDGES, form="_long")
    errors.update(longer_errors)
    phase37_s = time.perf_counter() - t37
    clock(t0, "the kernel phases (1, 2, 5, 9, 14, 18, 36 (a), 37 (a))")

    # The CLIP flagship: serving (kernels 1, 2), training (3, 4), the input
    # gradient (7), do_train, timing.
    cfg, model, plain_cfg, plain = build_models(device)
    layers = num_blocks(model)
    served = phase_slice(device, cfg, model, plain_cfg, plain,
                         launch_dict(fused_attention_block=layers, fused_mlp_block=layers))
    launches = {k: served[k] for k in ("fused_attention_block", "fused_mlp_block")}
    times = phase_timing(device, card, cfg, model, plain_cfg, plain)
    cache, sampler = build_train_data(cfg, device)
    trained = phase_train(device, cfg, model, plain_cfg, plain, cache, sampler,
                          launch_dict(fused_attention_block_train=layers,
                                      attention_bwd_saved_db=layers))
    launches.update({k: trained[k] for k in ("fused_attention_block_train",
                                             "attention_bwd_saved_db")})
    launches["attention_bwd_saved"] = phase_input_grad(device, cfg, model,
                                                       plain)["attention_bwd_saved"]
    phase_do_train(device, model, cache, sampler)
    times.update(phase_train_timing(device, card, cfg, model, plain_cfg, plain, cache, sampler))
    clock(t0, "phases 3-8")

    # The training knobs (phase 29): the flagship with REMAT_BACKBONE (kernel
    # 3 twice a block), with center loss and the cosine schedule, and the
    # quality gate's mechanics.
    import tempfile

    t29 = time.perf_counter()
    remat_launches = phase_remat(device, card, cfg, model, cache, sampler)
    phase_knobs(device, cache, sampler)
    with tempfile.TemporaryDirectory() as root:
        phase_gate(device, root)
    log(f"[knobs] phase 29 in {time.perf_counter() - t29:.1f} s (budget "
        f"{KNOB_PHASE_BUDGET_S:.0f} s)")
    clock(t0, "phase 29")
    # The CLIP tower's tuning paths (phase 30, CUT_DEPTH blocks): LoRA,
    # ConvLoRA, the adapter (kernel 2 off), the prompts (kernels 1, 3, 4 at
    # S = 141), FROZEN's backward through kernel 7.
    tuned = phase_tuning(device, card, cache, sampler, cfg, model)
    log(f"[tuning] launches of the 10 steps by configuration: {tuned}")
    clock(t0, "phase 30")
    # TPU.INT8_MLP (kernels 1, 3, 4; kernel 2 off) and the saliency maps
    # (phase 34, parts 1 and 2; part 3 runs on phase 27's JPEG tree).
    t34 = time.perf_counter()
    int8_launches = phase_int8(device, card, cache, sampler, cfg, model)
    log(f"[int8] launches of the {INT8_STEPS} steps by mode: {int8_launches}")
    phase_saliency(device, card, cfg, model, plain)
    phase34_s = time.perf_counter() - t34
    # The flagship at stride 12 (211 tokens) and at 384x128 (193), served and
    # trained through the block kernels' wide forms (phase 36 (b, c)).
    t36 = time.perf_counter()
    launches.update(phase_long_flagship(device, card, cfg, model, cache, sampler))
    times.update(long_times)
    log(f"[long] phase 36 in {phase36_s + time.perf_counter() - t36:.1f} s, its timing "
        f"included (budget {LONG_PHASE_BUDGET_S:.0f} s)")
    clock(t0, "phases 34 (parts 1, 2) and 36 (b, c)")
    # The flagship on TransReID's stride-12 crops, 256x256 (442 tokens) and
    # 384x128 (311), through the block kernels' long forms (phase 37 (b, c)).
    t37 = time.perf_counter()
    launches.update(phase_longer_flagship(device, card, cfg, model, cache, sampler))
    times.update(longer_times)
    log(f"[longer] phase 37 in {phase37_s + time.perf_counter() - t37:.1f} s, its timing "
        f"included")
    clock(t0, "phase 37 (b, c)")

    # DeMo's own model, configs/RGBNT201/DeMo.yml (HDM + ATMoE; kernels 1-4),
    # at full width and CUT_DEPTH blocks, timed beside the flagship; the
    # other DeMo branches of configs/ at BRANCH_DEPTH.
    phase_demo(device, card, cfg, model, cache, sampler)
    clock(t0, "phases 22-23")
    phase_branches(device)
    clock(t0, "phase 24")
    # The DeMoBeiyong cascade, DeMo_Parallel and FRCA at full width and
    # CUT_DEPTH blocks (kernels 1-4), each timed beside the flagship.
    phase_assemblies(device, card, cfg, model, cache, sampler)
    clock(t0, "phases 25-26")

    # The flagship with PALLAS_LN_BWD (kernel 11 beside 3 and 4), its
    # re-ranked eval (kernel 12 beside 1 and 2), their timing.
    ln_cfg, ln_model, ln_plain_cfg, ln_plain = build_models(device, ln_bwd_cfg)
    trained = phase_train(device, ln_cfg, ln_model, ln_plain_cfg, ln_plain, cache, sampler,
                          launch_dict(fused_attention_block_train=layers,
                                      attention_bwd_saved_db=layers, layernorm_bwd=layers),
                          label="ln-train", extra_groups=("ln_2.",), block_min=GRAD_COS_MODEL)
    launches["layernorm_bwd"] = trained["layernorm_bwd"]
    del ln_plain
    launches["jaccard_min_sum"] = phase_rerank_eval(device, model, cache)["jaccard_min_sum"]
    times.update(phase_rerank_ln_timing(device, card, ln_cfg, ln_model, cfg, model, cache,
                                        sampler))
    del ln_model
    clock(t0, "phases 15-17")

    # The block backward through kernel 8; the flagship with FUSED_MLP_TRAIN
    # (the training form of kernel 2 beside 3 and 4), its do_train epoch, the
    # ablation tool (kernel 13), their timing.
    launches["attention_bwd_fused_dw"] = phase_block_backward(device)["attention_bwd_fused_dw"]
    mlp_cfg, mlp_model, mlp_plain_cfg, mlp_plain = build_models(device, mlp_train_cfg)
    trained = phase_train(device, mlp_cfg, mlp_model, mlp_plain_cfg, mlp_plain, cache, sampler,
                          launch_dict(fused_attention_block_train=layers,
                                      attention_bwd_saved_db=layers,
                                      fused_mlp_block_train=layers),
                          label="mlp-train", extra_groups=("ln_2.", "mlp.c_fc.", "mlp.c_proj."),
                          block_min=GRAD_COS_MODEL)
    launches["fused_mlp_block_train"] = trained["fused_mlp_block_train"]
    del mlp_plain
    phase_do_train(device, mlp_model, cache, sampler, mlp_train_cfg,
                   per_step=("fused_mlp_block_train",))
    new_times, tool_launches = phase_mlp_train_timing(device, card, mlp_cfg, mlp_model, cfg,
                                                      model, cache, sampler)
    times.update(new_times)
    launches["attention_ablate"] = tool_launches["attention_ablate"]
    del plain, mlp_model
    torch.cuda.empty_cache()
    clock(t0, "phases 19-21")

    # The other backbones (phases 32, 33): T2T-ViT-24 (kernels 5, 6),
    # vit_small at stride 12 (the wide pair), ResNet-50-IBN-a and OSNet-AIN,
    # each beside the flagship.
    trained, wide_times = phase_backbones(device, card, cfg, model, cache, sampler)
    launches.update({k: trained[k] for k in ("packed_attention_wide_fwd",
                                             "packed_attention_wide_bwd")})
    times.update(wide_times)
    del model
    torch.cuda.empty_cache()

    # The head-major route (kernels 9, 10).
    routed = phase_head_major(device)
    launches.update({k: routed[k] for k in ("flash_attention_fwd", "flash_attention_bwd")})
    clock(t0, "phases 32-33 and 10")

    # DeMo on vit_base_patch16_224: serving (kernel 5), training (5, 6), timing.
    cfg, model, plain_cfg, plain = build_models(device, vit_cfg)
    layers = num_blocks(model)
    phase_slice(device, cfg, model, plain_cfg, plain, launch_dict(packed_attention_fwd=layers),
                label="vit-slice")
    trained = phase_train(device, cfg, model, plain_cfg, plain, cache, sampler,
                          launch_dict(packed_attention_fwd=layers, packed_attention_bwd=layers),
                          label="vit-train")
    launches.update({k: trained[k] for k in ("packed_attention_fwd", "packed_attention_bwd")})
    times.update(phase_vit_timing(device, card, cfg, model, plain_cfg, plain, cache, sampler))
    del model, plain, cache
    torch.cuda.empty_cache()

    # Data parallel (phase 35 (a)): two ranks on this card over gloo train
    # and evaluate the flagship (kernels 3, 4 and 1, 2 on each rank).
    dp_launches = phase_data_parallel(device, card)
    clock(t0, "phases 11-13 and 35 (a)")

    # The input path from disk: a JPEG tree written on the card's machine,
    # the native loader, tools/train.main with the host pipe and with the
    # decoded device cache (kernels 3, 4 in training, 1, 2 at eval),
    # tools/test.main on the checkpoints; then the loader and the host-fed
    # step timed.
    with tempfile.TemporaryDirectory() as root:
        phase_data(device, root)
        phase_long_cli(device, root)
        t34 = time.perf_counter()
        phase_miss_sweep(device, root)
        phase34_s += time.perf_counter() - t34
        log(f"[int8] phase 34 in {phase34_s:.1f} s (budget {PHASE34_BUDGET_S:.0f} s)")
        phase_data_timing(device, card, root)
        log(f"[migrate] launches of the --init_pth run: {phase_migration(device, card, root)}")
        # tools/train --distributed in a one-rank NCCL world (phase 35 (b)).
        phase_distributed_cli(device, root)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errors[name], **times[name],
         # a remat step's launches (phase 29) beside the default step's
         **({"launches_remat": remat_launches[name]}
            if name in ("fused_attention_block_train", "attention_bwd_saved_db") else {}),
         # each rank's launches in phase 35 (a): 3 steps, one eval forward
         **({"launches_data_parallel": dp_launches[name]} if name in dp_launches else {})}
        for name, (src, rep) in KERNEL_SOURCES.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
