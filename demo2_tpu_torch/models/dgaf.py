"""DGAF: dual-gated adaptive fusion (demo2_tpu/models/dgaf.py: AttentionPool,
_DualGateCore, _Enhance, DualGatedPostFusion (v1), DualGatedAdaptiveFusionV2,
V3 behind an attention pool, V4 with three outputs, V3Multi over N token
sets).  Entropies, gates and softmaxes run in f32.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import MultiHeadAttention
from ..ops.activations import gelu
from ..ops.linear import Linear, normal_init, make_param
from ..ops.norm import LayerNorm


def compute_entropy(feat: torch.Tensor) -> torch.Tensor:
    """H(|h| / sum |h|) over the last axis, in f32."""
    f = feat.float().abs() + 1e-8
    p = f / f.sum(-1, keepdim=True)
    return -(p * torch.log(p + 1e-8)).sum(-1)


class _DualGateCore(nn.Module):
    """IEG + MIG + alpha blend over stacked (M, B, C) features -> (B, C) f32."""

    def __init__(self, feat_dim: int, num_modalities: int, *, tau: float, init_alpha: float,
                 dtype: torch.dtype, device: torch.device, generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.tau = tau
        self.entropy_proj = Linear(feat_dim, feat_dim, **kw)
        self.gate_fc0 = Linear(num_modalities * feat_dim, feat_dim, **kw)
        self.gate_ln = LayerNorm(feat_dim, device=device)
        self.gate_fc1 = Linear(feat_dim, num_modalities, **kw)
        self.alpha = nn.Parameter(torch.tensor(float(init_alpha), device=device))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        hf = h.float()
        # IEG: entropy-weighted softmax over the modalities.
        ent = compute_entropy(h)  # (M, B)
        z = self.entropy_proj(h).float().mean(-1)
        w = torch.softmax(z * torch.exp(-ent / self.tau), dim=0)
        h_entropy = (w[..., None] * hf).sum(0)
        # MIG: sigmoid importance gates from the concatenated features.
        g = self.gate_fc0(torch.cat(list(h), dim=-1))
        g = self.gate_fc1(torch.relu(self.gate_ln(g)))
        gates = torch.sigmoid(g.float())  # (B, M)
        h_importance = (gates.t()[..., None] * hf).sum(0)
        alpha = torch.sigmoid(self.alpha)
        return alpha * h_entropy + (1.0 - alpha) * h_importance


class _Enhance(nn.Module):
    """modal_enhance: Linear + LayerNorm."""

    def __init__(self, feat_dim: int, *, dtype: torch.dtype, device: torch.device,
                 generator: torch.Generator):
        super().__init__()
        self.fc = Linear(feat_dim, feat_dim, dtype=dtype, device=device, generator=generator)
        self.ln = LayerNorm(feat_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(self.fc(x))


class DualGatedPostFusion(nn.Module):
    """DGAF v1: (3, B, C) features -> (B, 3C)."""

    def __init__(self, feat_dim: int, *, tau: float, init_alpha: float,
                 dtype: torch.dtype, device: torch.device, generator: torch.Generator,
                 num_modalities: int = 3):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.core = _DualGateCore(feat_dim, num_modalities, tau=tau, init_alpha=init_alpha,
                                  **kw)
        self.modal_enhance = _Enhance(feat_dim, **kw)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        enh = self.modal_enhance(self.core(h).to(h.dtype))
        return torch.cat(list(h + enh[None].to(h.dtype)), dim=-1)


class AttentionPool(nn.Module):
    """A learnable query per modality, one MHA shared by all modalities:
    (M, B, K, C) -> (M, B, C) in one cross-attention call of query length 1."""

    def __init__(self, feat_dim: int, num_heads: int, num_modalities: int, *,
                 dtype: torch.dtype, device: torch.device, generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.queries = make_param((num_modalities, 1, feat_dim), normal_init(feat_dim ** -0.5),
                                  generator=generator, device=device)
        self.attn_pool = MultiHeadAttention(feat_dim, num_heads, dtype=dtype, device=device,
                                            generator=generator)
        self.attn_norm = LayerNorm(feat_dim, device=device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        m, b, k, c = tokens.shape
        q = self.queries[:, None].expand(m, b, 1, c).reshape(m * b, 1, c)
        pooled = self.attn_pool(q.to(self.dtype), tokens.reshape(m * b, k, c))
        return self.attn_norm(pooled[:, 0]).reshape(m, b, c)


class DualGatedAdaptiveFusionV3(nn.Module):
    """(3, B, K, C) tokens -> (B, 3C)."""

    def __init__(self, feat_dim: int, *, tau: float, init_alpha: float, num_heads: int,
                 dtype: torch.dtype, device: torch.device, generator: torch.Generator,
                 num_modalities: int = 3):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.pool = AttentionPool(feat_dim, num_heads, num_modalities, **kw)
        self.core = _DualGateCore(feat_dim, num_modalities, tau=tau, init_alpha=init_alpha,
                                  **kw)
        self.modal_enhance = _Enhance(feat_dim, **kw)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        h = self.pool(tokens)
        fused = self.core(h)
        enh = self.modal_enhance(fused.to(tokens.dtype))
        out = h.to(tokens.dtype) + enh[None]
        return torch.cat(list(out), dim=-1)


class DualGatedAdaptiveFusionV3Multi(DualGatedAdaptiveFusionV3):
    """V3 over N token sets (N, B, K, C) -> (B, N C): the FRCA bridge's six
    directed cross-attention outputs.  Its tree is V3's at N modalities."""

    def __init__(self, feat_dim: int, *, tau: float, init_alpha: float, num_heads: int,
                 dtype: torch.dtype, device: torch.device, generator: torch.Generator,
                 num_modalities: int = 6):
        super().__init__(feat_dim, tau=tau, init_alpha=init_alpha, num_heads=num_heads,
                         dtype=dtype, device=device, generator=generator,
                         num_modalities=num_modalities)


class DualGatedAdaptiveFusionV4(nn.Module):
    """(3, B, C) -> three enhanced (3, B, C): v1 without the concatenation."""

    def __init__(self, feat_dim: int, *, tau: float, init_alpha: float,
                 dtype: torch.dtype, device: torch.device, generator: torch.Generator):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.core = _DualGateCore(feat_dim, 3, tau=tau, init_alpha=init_alpha, **kw)
        self.modal_enhance = _Enhance(feat_dim, **kw)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        enh = self.modal_enhance(self.core(h).to(h.dtype))
        return h + enh[None].to(h.dtype)


class DualGatedAdaptiveFusionV2(nn.Module):
    """(3, B, C) globals, optionally (3, B, N, C) tokens -> (3, B, C).  Its
    MIG scales each modality by its gate and projects the concatenation
    (Linear + LayerNorm + ReLU); the fused feature then queries each
    modality's tokens through one shared attention (LayerNorm, residual), and
    its projection (Linear + LayerNorm + exact GELU) is added to each."""

    def __init__(self, feat_dim: int, *, tau: float, init_alpha: float,
                 dtype: torch.dtype, device: torch.device, generator: torch.Generator,
                 use_cross_modal_attn: bool = True, num_heads: int = 4):
        super().__init__()
        c, m = feat_dim, 3
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.tau = tau
        self.use_cross_modal_attn = use_cross_modal_attn
        self.entropy_proj = Linear(c, c, **kw)
        self.gate_fc0 = Linear(m * c, c, **kw)
        self.gate_fc1 = Linear(c, m, **kw)
        self.fusion_fc = Linear(m * c, c, **kw)
        self.fusion_ln = LayerNorm(c, device=device)
        self.alpha = nn.Parameter(torch.tensor(float(init_alpha), device=device))
        if use_cross_modal_attn:
            self.cross_attn = MultiHeadAttention(c, num_heads, **kw)
            self.cross_attn_norm = LayerNorm(c, device=device)
        self.output_fc = Linear(c, c, **kw)
        self.output_ln = LayerNorm(c, device=device)

    def forward(self, h: torch.Tensor, tokens: torch.Tensor = None,
                train: bool = False) -> torch.Tensor:
        hf = h.float()
        ent = compute_entropy(h)
        z = self.entropy_proj(h).float().mean(-1)
        h_entropy = (torch.softmax(z * torch.exp(-ent / self.tau), dim=0)[..., None] * hf).sum(0)
        g = self.gate_fc1(torch.relu(self.gate_fc0(torch.cat(list(h), dim=-1))))
        gates = torch.sigmoid(g.float())  # (B, M)
        gated = torch.cat([gates[:, i:i + 1] * hf[i] for i in range(h.shape[0])], dim=-1)
        h_importance = torch.relu(self.fusion_ln(self.fusion_fc(gated.to(h.dtype)))).float()
        alpha = torch.sigmoid(self.alpha)
        fused = alpha * h_entropy + (1.0 - alpha) * h_importance  # (B, C) f32
        if self.use_cross_modal_attn and tokens is not None:
            m, b, n, c = tokens.shape
            q = fused.to(tokens.dtype)[None, :, None, :].expand(m, b, 1, c).reshape(m * b, 1, c)
            attn_out = self.cross_attn(q, tokens.reshape(m * b, n, c), train=train)[:, 0]
            h = h + self.cross_attn_norm(attn_out).reshape(m, b, c).to(h.dtype)
        proj = gelu(self.output_ln(self.output_fc(fused.to(h.dtype))))
        return h + proj[None].to(h.dtype)
