"""Fused softmax, LayerNorm and RMSNorm rows (kernels K7 and K8), and the
nonlinearity dispatcher.

Port of ``photonic_flash_attention_tpu/ops/nonlinearity.py``:

* :func:`fused_softmax`: a row softmax over the last axis (any other axis
  is moved there first), fp32 math, output in x's dtype. Kernel K7
  (``csrc/rownorm.cu::softmax_rows``, counted ``pfa_softmax``). It has no
  gradient, as the JAX function has none: it raises under autograd.
* :func:`fused_layer_norm` / :func:`fused_rms_norm`: fp32 statistics (the
  mean, then the centred variance; or the mean square), gamma and beta
  taken in fp32, output in x's dtype. Kernel K8 (``rownorm_rows``, counted
  ``pfa_layer_norm`` and ``pfa_rms_norm``). Differentiable: the backward
  recomputes from the saved inputs through the plain reference
  (``_ln_ref``, ``_rms_ref``), as the JAX custom VJP does in XLA.
* ``relu``, ``gelu`` (the tanh form, ``jax.nn.gelu``'s default) and
  :func:`apply_nonlinearity` with :class:`NonlinearityType`.

CUDA tensors launch the kernels (fp32 or bf16; other dtypes raise); CPU
tensors take the plain versions, which repeat the kernels' arithmetic.
"""

from __future__ import annotations

import enum
import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

from . import _build

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
#: K8 stages a row in shared memory as fp32 (64 KB): the widest row it takes.
MAX_NORM_D = 16384


class NonlinearityType(enum.Enum):
    """The kinds :func:`apply_nonlinearity` dispatches on."""

    SOFTMAX = "softmax"
    RELU = "relu"
    GELU = "gelu"
    LAYER_NORM = "layer_norm"
    RMS_NORM = "rms_norm"


def _row_view(x: torch.Tensor) -> torch.Tensor:
    """x (..., D) as a contiguous (rows, D) tensor."""
    return x.contiguous().reshape(math.prod(x.shape[:-1]), x.shape[-1])


def _check_kernel_rows(x2: torch.Tensor, name: str) -> None:
    if x2.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name} takes {KERNEL_DTYPES} on the card, got {x2.dtype}")
    if not x2.is_contiguous():
        raise ValueError(f"{name} needs a contiguous input")


# -- K7: softmax -------------------------------------------------------------


def softmax_rows_plain(x2: torch.Tensor) -> torch.Tensor:
    """K7's plain version: softmax over the rows of (rows, D) in fp32,
    exp(x - max) / sum, in x's dtype."""
    xf = x2.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x2.dtype)


def softmax_rows(x2: torch.Tensor) -> torch.Tensor:
    """Softmax over the rows of a (rows, D) tensor: K7 on CUDA, its plain
    version on CPU."""
    if x2.device.type == "cpu":
        return softmax_rows_plain(x2)
    if x2.device.type != "cuda":
        raise ValueError(f"unsupported device {x2.device}")
    _check_kernel_rows(x2, "K7 (softmax)")
    y = torch.empty_like(x2)
    if x2.numel():
        _build.launch("pfa_softmax", x2.device, x2.data_ptr(), y.data_ptr(), x2.shape[0],
                      x2.shape[1], _build.DTYPE_CODES[x2.dtype])
    return y


def fused_softmax(x: torch.Tensor, axis: int = -1, *, block_rows: int = 256) -> torch.Tensor:
    """Numerically stable softmax along ``axis`` in one fused pass (K7).

    ``block_rows`` is the TPU kernel's row tile: it is checked and has no
    counterpart (a block takes one row). No gradient: raises
    ``NotImplementedError`` when ``x`` requires one."""
    if block_rows <= 0:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError("fused_softmax has no gradient (as the JAX function)")
    if axis % x.ndim != x.ndim - 1:
        out = fused_softmax(x.movedim(axis, -1), -1, block_rows=block_rows)
        return out.movedim(-1, axis)
    return softmax_rows(_row_view(x)).view(x.shape)


# -- K8: LayerNorm / RMSNorm -------------------------------------------------


def rownorm_plain(x2: torch.Tensor, gamma: torch.Tensor, beta: Optional[torch.Tensor],
                  eps: float, rms: bool) -> torch.Tensor:
    """K8's plain version on (rows, D): the TPU kernel's arithmetic (sums
    times 1/D in fp32; LN takes the mean, then the centred variance)."""
    xf = x2.float()
    inv_d = 1.0 / x2.shape[-1]
    if rms:
        y = xf * torch.rsqrt((xf * xf).sum(dim=-1, keepdim=True) * inv_d + eps)
    else:
        xc = xf - xf.sum(dim=-1, keepdim=True) * inv_d
        y = xc * torch.rsqrt((xc * xc).sum(dim=-1, keepdim=True) * inv_d + eps)
    y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(x2.dtype)


def rownorm_rows(x2: torch.Tensor, gamma: torch.Tensor, beta: Optional[torch.Tensor],
                 eps: float, rms: bool) -> torch.Tensor:
    """LayerNorm (``rms`` False, ``beta`` given) or RMSNorm of the rows of
    (rows, D): K8 on CUDA, its plain version on CPU."""
    d = x2.shape[-1]
    if gamma.numel() != d or (beta is not None and beta.numel() != d):
        raise ValueError(f"gamma and beta must have {d} values")
    if x2.device.type == "cpu":
        return rownorm_plain(x2, gamma.reshape(d), None if beta is None else beta.reshape(d),
                             eps, rms)
    if x2.device.type != "cuda":
        raise ValueError(f"unsupported device {x2.device}")
    name = "K8 (RMSNorm)" if rms else "K8 (LayerNorm)"
    _check_kernel_rows(x2, name)
    if d > MAX_NORM_D:
        raise ValueError(f"{name} holds rows of at most {MAX_NORM_D} values, got {d}")
    if rms:
        beta = None
    elif beta is None:
        raise ValueError("LayerNorm needs beta")
    g = gamma.reshape(d).float().contiguous()
    b = beta.reshape(d).float().contiguous() if beta is not None else None
    for t in (g, b):
        if t is not None and t.device != x2.device:
            raise ValueError(f"gamma and beta must be on {x2.device}, got {t.device}")
    y = torch.empty_like(x2)
    if x2.numel():
        _build.launch(
            "pfa_rownorm", x2.device, x2.data_ptr(), g.data_ptr(),
            b.data_ptr() if b is not None else None, y.data_ptr(), x2.shape[0], d, 1.0 / d,
            float(eps), int(rms), _build.DTYPE_CODES[x2.dtype],
            count_as="pfa_rms_norm" if rms else "pfa_layer_norm",
        )
    return y


def _ln_ref(x, gamma, beta, eps):
    """The plain LayerNorm the backward differentiates (JAX ``_ln_ref``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(x.dtype)


def _rms_ref(x, gamma, eps):
    """The plain RMSNorm the backward differentiates (JAX ``_rms_ref``)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)


def _recompute_grads(ref, inputs, grad_out):
    """Gradients of ``ref(*inputs)`` recomputed from the saved inputs."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(ref(*leaves), leaves, grad_out)


class _LayerNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps = eps
        return rownorm_rows(_row_view(x), gamma, beta, eps, rms=False).view(x.shape)

    @staticmethod
    def backward(ctx, grad_out):
        eps = ctx.eps
        grads = _recompute_grads(lambda x, g, b: _ln_ref(x, g, b, eps), ctx.saved_tensors,
                                 grad_out)
        return (*grads, None)


class _RMSNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return rownorm_rows(_row_view(x), gamma, None, eps, rms=True).view(x.shape)

    @staticmethod
    def backward(ctx, grad_out):
        eps = ctx.eps
        grads = _recompute_grads(lambda x, g: _rms_ref(x, g, eps), ctx.saved_tensors, grad_out)
        return (*grads, None)


def fused_layer_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last axis in one fused pass (K8), fp32 statistics
    whatever x's dtype. ``beta`` None is zeros, as in JAX. Differentiable
    (the backward recomputes the statistics)."""
    if beta is None:
        beta = torch.zeros_like(gamma)
    return _LayerNormFn.apply(x, gamma, beta, float(eps))


def fused_rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (the Llama-family norm) over the last axis in one fused pass
    (K8's RMS mode). Differentiable."""
    return _RMSNormFn.apply(x, gamma, float(eps))


# -- elementwise activations and the dispatcher ------------------------------

relu = torch.relu


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (``jax.nn.gelu``'s default)."""
    return F.gelu(x, approximate="tanh")


def apply_nonlinearity(
    kind: Union[NonlinearityType, str],
    x: torch.Tensor,
    *,
    gamma: Optional[torch.Tensor] = None,
    beta: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    axis: int = -1,
) -> torch.Tensor:
    """Apply one :class:`NonlinearityType` (or its string value) to x;
    the norms take gamma of ones when none is given."""
    kind = NonlinearityType(kind) if isinstance(kind, str) else kind
    if kind is NonlinearityType.SOFTMAX:
        return fused_softmax(x, axis=axis)
    if kind is NonlinearityType.RELU:
        return relu(x)
    if kind is NonlinearityType.GELU:
        return gelu(x)
    if kind is NonlinearityType.LAYER_NORM:
        if gamma is None:
            gamma = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
        return fused_layer_norm(x, gamma, beta, eps=eps)
    if kind is NonlinearityType.RMS_NORM:
        if gamma is None:
            gamma = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
        return fused_rms_norm(x, gamma, eps=eps)
    raise ValueError(f"unknown nonlinearity: {kind}")
