"""k-reciprocal re-ranking (CVPR'17) on the caller's device
(demo2_tpu/utils/reranking.py).

  jaccard_min_sum: out[i, j] = sum_k min(vq[i, k], vg[j, k])
      replaces the Pallas kernel reranking.py::_jaccard_kernel
      (csrc/jaccard_min_sum.cu, demo2_jaccard_min_sum): a sum over the
      non-zeros of the non-negative weights with the bits of the dense
      ascending sum, `jaccard_min_sum_ordered`.

`re_ranking` follows `re_ranking_device` step by step: the k-reciprocal sets
are boolean rank masks, the 2/3-overlap expansion is one mask product, and
the Jaccard numerator is the min-sum above; no loop over samples.

The wrapper takes the plain version for tensors on the CPU and launches the
kernel for CUDA tensors (it raises on what the kernel does not take); it
counts its launches in `.launches`.

The two f32 products here (`feat @ feat.T`, `topk2 @ V`) must run in full
f32: with TF32 (about three decimal digits) distances that differ in the
fifth digit swap, and the rank positions near ties move with them.
`re_ranking` turns TF32 off around them whatever the caller's global is.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops.kernel_lib import check, expect, kernel_library


@contextlib.contextmanager
def full_f32_matmul():
    """f32 matrix products in full f32 on a CUDA device inside the block."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def jaccard_min_sum_plain(vq: torch.Tensor, vg: torch.Tensor, block_q: int = 64,
                          block_g: int = 256) -> torch.Tensor:
    """The blocked broadcast-min-sum of re_ranking_device's off-TPU branch:
    one (block_q, block_g, K) intermediate per block pair.
    vq (nq, K), vg (ng, K) -> (nq, ng)."""
    nq, ng = vq.shape[0], vg.shape[0]
    out = torch.empty((nq, ng), dtype=vq.dtype, device=vq.device)
    for i in range(0, nq, block_q):
        qb = vq[i:i + block_q, None, :]
        for j in range(0, ng, block_g):
            out[i:i + block_q, j:j + block_g] = torch.minimum(
                qb, vg[None, j:j + block_g, :]).sum(-1)
    return out


def jaccard_min_sum_ordered(vq: torch.Tensor, vg: torch.Tensor) -> torch.Tensor:
    """The min-sum in f32 in ascending k from +0.0, one add per k: the bits
    the kernel gives.  vq (nq, K), vg (ng, K) -> (nq, ng)."""
    acc = torch.zeros((vq.shape[0], vg.shape[0]), dtype=vq.dtype, device=vq.device)
    for k in range(vq.shape[1]):
        acc = acc + torch.minimum(vq[:, k, None], vg[None, :, k])
    return acc


def jaccard_min_sum(vq: torch.Tensor, vg: torch.Tensor) -> torch.Tensor:
    """out[i, j] = sum_k min(vq[i, k], vg[j, k]), f32 vq (nq, K) and vg
    (ng, K) -> (nq, ng): the kernel on CUDA tensors (with the bits of
    `jaccard_min_sum_ordered`), the plain version on CPU tensors."""
    if vq.device.type == "cpu":
        return jaccard_min_sum_plain(vq, vg)
    if vq.device.type != "cuda":
        raise ValueError(f"jaccard_min_sum: the kernel takes CUDA tensors, got {vq.device}")
    nq, depth = vq.shape
    ng = vg.shape[0]
    expect(vq, "vq", (nq, depth), torch.float32, vq.device)
    expect(vg, "vg", (ng, depth), torch.float32, vq.device)
    out = torch.empty((nq, ng), dtype=torch.float32, device=vq.device)
    if out.numel() == 0:
        return out
    if depth == 0:
        return out.zero_()
    kl = kernel_library()
    tiles = -(-ng // kl.lib.demo2_jaccard_tile())
    # The compacted rows of vq and columns of vg as (index, value) pairs in
    # slots of fixed size, their counts and the negative-input flag (the C
    # entry's layout).
    pairs = 2 * (nq + tiles * kl.lib.demo2_jaccard_tile()) * depth
    scratch = torch.empty(pairs + nq + tiles * depth + 1, dtype=torch.int32,
                          device=vq.device)
    with torch.cuda.device(vq.device):
        err = kl.lib.demo2_jaccard_min_sum(
            vq.data_ptr(), vg.data_ptr(), out.data_ptr(), scratch.data_ptr(), nq, ng, depth,
            torch.cuda.current_stream(vq.device).cuda_stream,
        )
    check(err, "jaccard_min_sum")
    jaccard_min_sum.launches += 1
    return out


jaccard_min_sum.launches = 0


def _rank_positions(dist: torch.Tensor) -> torch.Tensor:
    """ranks[i, j] = position of j in the ascending stable sort of row i."""
    order = torch.argsort(dist, dim=1, stable=True)
    positions = torch.arange(dist.shape[1], device=dist.device).expand_as(order)
    return torch.empty_like(order).scatter_(1, order, positions)


def _mask_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of 0/1 masks as exact f32 counts.  The operands go in as bf16:
    every count is at most k1 + 1 <= 256, an integer that bf16 holds, so the
    product is exact however the sums are split."""
    return (a.to(torch.bfloat16) @ b.to(torch.bfloat16)).float()


def reciprocal_weights(prob_fea: torch.Tensor, gal_fea: torch.Tensor, k1: int, k2: int):
    """The front half of re-ranking: (V (n, n), dist (n, n)) over the n =
    nq + ng stacked samples; V the k2-averaged Gaussian weights of each
    sample's expanded k-reciprocal set, dist the row-normalised squared
    distances."""
    # The mask products are integer-exact only while counts stay <= 256;
    # counts are bounded by k1 + 1.
    if k1 >= 256:
        raise ValueError(
            f"re_ranking: k1={k1} >= 256 would overflow the bf16 integer-exact range used "
            "for the set-intersection products"
        )
    feat = torch.cat([prob_fea, gal_fea], dim=0).float()
    sq = feat.square().sum(1)
    with full_f32_matmul():
        dist0 = sq[:, None] + sq[None, :] - (2.0 * feat) @ feat.t()
    # The reference form is (dist0 / colmax).T; dist0 is symmetric, so that is
    # dist0 / rowmax without the transpose.
    dist = dist0 / dist0.max(dim=1, keepdim=True).values

    ranks = _rank_positions(dist)
    fwd = ranks <= k1
    half = int(np.around(k1 / 2))  # numpy rounds half to even: k1 = 5 gives 2
    fwd_h = ranks <= half
    r = fwd & fwd.t()       # k-reciprocal sets
    rh = fwd_h & fwd_h.t()  # the half-k sets

    inter = _mask_product(r, rh.t())  # inter[i, j] = |R_i & Rh_j|
    sizes_h = rh.float().sum(1)       # |Rh_j|
    cond = r & (inter > (2.0 / 3.0) * sizes_h[None, :])
    expanded = r | (_mask_product(cond, rh) > 0)

    w = torch.where(expanded, torch.exp(-dist), 0.0)
    v = w / w.sum(1, keepdim=True).clamp(min=1e-12)
    if k2 != 1:
        topk2 = (ranks <= (k2 - 1)).float()
        with full_f32_matmul():
            v = (topk2 @ v) / k2
    return v, dist


def re_ranking(prob_fea: torch.Tensor, gal_fea: torch.Tensor, k1: int = 50, k2: int = 15,
               lambda_value: float = 0.3) -> torch.Tensor:
    """The re-ranked (nq, ng) distance matrix of query features prob_fea
    (nq, D) against gallery features gal_fea (ng, D), on their device."""
    query_num = prob_fea.shape[0]
    v, dist = reciprocal_weights(prob_fea, gal_fea, k1, k2)
    temp_min = jaccard_min_sum(v[:query_num].contiguous(), v.contiguous())
    jaccard = 1.0 - temp_min / (2.0 - temp_min)
    final = jaccard * (1 - lambda_value) + dist[:query_num] * lambda_value
    return final[:, query_num:]
