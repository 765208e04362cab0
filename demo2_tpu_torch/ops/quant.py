"""Int8-forward matmul with the exact, unquantized backward
(demo2_tpu/ops/quant.py, TPU.INT8_MLP).

The forward quantizes both operands and multiplies them in int8 with int32
accumulation:

  * activations: one per-tensor scale, `act_scale` where it is > 0 (a
    calibrated constant, the "static" mode), else the dynamic
    max(max|x| / 127, 1e-8);
  * weights: one scale per output channel from the current parameter values;
  * both rounded half to even (torch.round, as jnp.round) and clipped to
    [-127, 127]; y = y32 * (s * sw), in that association, cast to x's dtype.
    Every division is a true division, on the card too (over_int8_max).

The backward is the unquantized one: dx = g @ W in g's dtype, and dW = g^T x
accumulated in f32 and cast to W's dtype, so only the forward activations
see quantization noise.

The int8 product is `torch._int_mm`, a library call on both devices: the JAX
package computes it as a plain `lax.dot_general` with int32 accumulation,
not in a Pallas kernel.  On CUDA it takes M > 16 rows and K, N multiples of
8; `check_int_mm_shape` raises for any other shape, naming it.  There is no
float fallback.

Weights are in torch's Linear layout (N, K), the transpose of the JAX
package's (K, N) kernel.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0
SCALE_FLOOR = 1e-8


def over_int8_max(t: torch.Tensor) -> torch.Tensor:
    """t / 127, rounded once.  The divisor is a tensor on t's device: CUDA
    multiplies by the reciprocal of a host scalar divisor instead, which
    can differ in the last bit and move a scale, and with it the rounding
    of every value near a .5 boundary."""
    return t / torch.full((), INT8_MAX, dtype=t.dtype, device=t.device)


def quantize(xf: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """f32 values over their scale, rounded half to even, clipped, as int8."""
    return torch.clamp(torch.round(xf / s), -INT8_MAX, INT8_MAX).to(torch.int8)


def quant_per_channel(w: torch.Tensor):
    """(N, K) -> (int8 (N, K), f32 scales (N,)): one scale per output channel."""
    wf = w.float()
    s = torch.clamp(over_int8_max(wf.abs().amax(dim=1)), min=SCALE_FLOOR)
    return quantize(wf, s[:, None]), s


def act_scale_of(xf: torch.Tensor, act_scale: float) -> torch.Tensor:
    """The per-tensor activation scale: `act_scale` where > 0, else dynamic."""
    if act_scale > 0:
        return torch.tensor(act_scale, dtype=torch.float32, device=xf.device)
    return torch.clamp(over_int8_max(xf.abs().amax()), min=SCALE_FLOOR)


def check_int_mm_shape(m: int, k: int, n: int) -> None:
    """Raise for a product (M, K) x (K, N) that torch._int_mm on CUDA refuses."""
    if m <= 16 or k % 8 or n % 8:
        raise ValueError(f"int8_dense: the int8 product ({m}, {k}) x ({k}, {n}) needs more than "
                         "16 rows and K, N multiples of 8 on CUDA (torch._int_mm)")


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (N, K)^T -> int32 (M, N), exact."""
    if xq.device.type == "cuda":
        check_int_mm_shape(xq.shape[0], xq.shape[1], wq.shape[0])
    return torch._int_mm(xq, wq.t())


class Int8DenseFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, act_scale):
        ctx.save_for_backward(x, w)
        xf = x.reshape(-1, x.shape[-1]).float()
        s = act_scale_of(xf, act_scale)
        xq = quantize(xf, s)
        wq, sw = quant_per_channel(w)
        y = (int8_matmul(xq, wq).float() * (s * sw)).to(x.dtype)
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = (g2 @ w.to(g2.dtype)).reshape(x.shape)
        dw = (g2.float().t() @ x.reshape(-1, x.shape[-1]).float()).to(w.dtype)
        return dx, dw, None


def int8_dense(x: torch.Tensor, w: torch.Tensor, act_scale: float = 0.0) -> torch.Tensor:
    """x (..., K) activations, w (N, K) weights -> (..., N) in x's dtype;
    `act_scale` 0.0 selects the dynamic per-tensor activation scale."""
    return Int8DenseFn.apply(x, w, float(act_scale))
