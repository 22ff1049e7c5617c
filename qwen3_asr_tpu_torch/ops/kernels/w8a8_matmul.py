"""K10: W8A8 matmul: per-row int8 quantize of the activations, then an
int8 x int8 product.

Replaces ``qwen3_asr_tpu/ops/pallas/w8a8_matmul.py:w8a8_matmul``.  x (M, K)
bf16 is quantized per row to int8 against ``sx = max|x| / 127``, the
int8 x int8 product accumulates in int32, and the epilogue is
``float(acc) * sx * ws``.  Bound on the H100: int8 tensor-core operations
at prefill shapes.  The CUDA source (``csrc/w8a8_matmul.cu``) holds two
kernels, launched by one C call: ``quantize_rows`` reads each bf16 row of
x once and writes xq (M, K) int8 and sx (M,) f32 (IEEE divide, round half
to even, clip +-127); the GEMM streams xq and weight tiles by TMA into a
4-stage ring and runs ``wgmma`` m64n256k32 s8 x s8 -> s32 in two consumer
warpgroups of a persistent grid.  Integer ``wgmma`` reads both operands
K-major, so wq must be stored K-major, the transpose of a contiguous
(N, K) int8 tensor, as :func:`..quant.quantize_weight` stores it; no
other layout is taken or copied.  It takes K a multiple of 64 and N of 16,
any M.

A row-parallel shard (tensor parallelism) holds a K-slice of each row, so
its per-row scales must be the whole row's: the caller all-reduces the
rows' abs-max over the shards and passes ``row_scales``, and the quantize
pass (``quantize_rows_scaled_kernel``, one read of x, no reduction) uses
them (:func:`quantize_rows_scaled`, and ``w8a8_matmul(...,
row_scales=...)``, one C call for both kernels, counted as
:data:`NAME_SCALED`).

On a CPU tensor the wrapper runs :func:`w8a8_matmul_plain`: the JAX
package's W8A8 branch of ``qlinear`` (``quant.py:229-236``) with an exact
int32 product; on a CUDA tensor it launches the kernels or raises.  Kernel
and plain version compute the same function bit for bit.
"""

from __future__ import annotations

import torch

from ..quant_kv import div127
from . import _build
from .quantized_matmul import check_k_major

NAME = "w8a8_matmul"
#: The launches of the entry with the row scales given (the scaled quantize
#: kernel, then the same product), counted apart from :data:`NAME`'s.
NAME_SCALED = "w8a8_matmul_scaled"
_BK = 64


def row_amax(x2: torch.Tensor) -> torch.Tensor:
    """Per-row f32 ``max|x|`` of (M, K), exact in any dtype."""
    return torch.linalg.vector_norm(x2, float("inf"), dim=1, dtype=torch.float32)


def activation_scales(x2: torch.Tensor) -> torch.Tensor:
    """Per-row f32 scales ``max|x| / 127`` (1 for an all-zero row; an
    all-zero row divides 127 by 127)."""
    return scales_of_amax(row_amax(x2))


def scales_of_amax(amax: torch.Tensor) -> torch.Tensor:
    """Row scales ``amax / 127`` (1 for an all-zero row) of f32 abs-maxima,
    as :func:`activation_scales` takes them."""
    return div127(torch.where(amax > 0, amax, 127.0))


def quantize_activations(
    x2: torch.Tensor, scale: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: (M, K) -> (int8 (M, K), f32 scales (M,));
    ``qwen3_asr_tpu/ops/quant.py:quantize_activations``.  ``scale`` (M,)
    given (a row-parallel shard's, from the whole row) is used instead of
    the rows' own."""
    if scale is None:
        scale = activation_scales(x2)
    q = torch.clamp(torch.round(x2.float() / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_rows(x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_activations` of a (M, K) bf16 tensor; on the GPU K10's
    own quantize kernel (one read of x), bit-identical to it.  A helper of
    K10, whose launches count under :func:`w8a8_matmul`."""
    if not x2.is_cuda:
        return quantize_activations(x2)
    if x2.dim() != 2 or x2.dtype != torch.bfloat16 or not x2.is_contiguous():
        raise ValueError("x must be a contiguous (M, K) bf16 tensor")
    M, K = x2.shape
    if K % _BK or x2.data_ptr() % 16:
        raise ValueError(f"K={K} must be a multiple of {_BK} and x 16-byte aligned")
    xq = torch.empty((M, K), dtype=torch.int8, device=x2.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x2.device)
    err = _build.library().quantize_rows_bf16(
        x2.data_ptr(), xq.data_ptr(), sx.data_ptr(), M, K, _build.stream_ptr(x2))
    _build.check(err, NAME)
    return xq, sx


def quantize_rows_scaled(x2: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int8 (M, K) of :func:`quantize_activations` with the row scales
    given; on the GPU K10's scaled quantize kernel, bit-identical to it.  A
    helper of K10, whose launches count under :func:`w8a8_matmul`."""
    if not x2.is_cuda:
        return quantize_activations(x2, scale)[0]
    if x2.dim() != 2 or x2.dtype != torch.bfloat16 or not x2.is_contiguous():
        raise ValueError("x must be a contiguous (M, K) bf16 tensor")
    M, K = x2.shape
    if K % _BK or x2.data_ptr() % 16:
        raise ValueError(f"K={K} must be a multiple of {_BK} and x 16-byte aligned")
    _check_scales(scale, M, x2.device)
    xq = torch.empty((M, K), dtype=torch.int8, device=x2.device)
    err = _build.library().quantize_rows_scaled_bf16(
        x2.data_ptr(), scale.data_ptr(), xq.data_ptr(), M, K, _build.stream_ptr(x2))
    _build.check(err, NAME)
    return xq


def _check_scales(scale: torch.Tensor, M: int, device) -> None:
    if (scale.dtype != torch.float32 or scale.shape != (M,) or not scale.is_contiguous()
            or scale.device != device):
        raise ValueError(f"row_scales must be a contiguous ({M},) f32 tensor on {device}")


def w8a8_matmul_plain(
    x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, out_dtype: torch.dtype,
    row_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Quantize x per row (with ``row_scales`` when given), exact integer
    product, ``acc * sx * ws``."""
    xq, sx = quantize_activations(x, row_scales)
    if x.is_cuda:
        # No integer matmul on CUDA: an f64 product of int8 values is exact
        # (|acc| <= 127 * 127 * K < 2**53).
        acc = (xq.double() @ wq.double()).float()
    else:
        acc = (xq.int() @ wq.int()).float()
    return (acc * sx[:, None] * ws[None, :]).to(out_dtype)


def _check(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, out_dtype) -> None:
    if x.dim() != 2 or wq.dim() != 2 or ws.dim() != 1:
        raise ValueError("x must be (M, K), wq (K, N) and ws (N,)")
    M, K = x.shape
    Kw, N = wq.shape
    if Kw != K or ws.shape[0] != N:
        raise ValueError(f"shapes x {tuple(x.shape)}, wq {tuple(wq.shape)}, ws {tuple(ws.shape)}")
    if K % _BK or N % 16:
        raise ValueError(f"K={K} must be a multiple of {_BK} and N={N} of 16")
    if x.dtype != torch.bfloat16 or wq.dtype != torch.int8 or ws.dtype != torch.float32:
        raise TypeError(f"need bf16 x, int8 wq, f32 ws; got {x.dtype}, {wq.dtype}, {ws.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    for name, t in (("wq", wq), ("ws", ws)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    check_k_major(wq)
    if not (x.is_contiguous() and ws.is_contiguous()):
        raise ValueError("x and ws must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")


def w8a8_matmul(
    x: torch.Tensor,
    wq: torch.Tensor,
    ws: torch.Tensor,
    out_dtype: torch.dtype | None = None,
    row_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """(M, K) activations x (K, N) int8 weights with (N,) scales -> (M, N)
    in ``out_dtype`` (default x's dtype), activations quantized per row,
    against ``row_scales`` (M,) f32 when given (a row-parallel shard)."""
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return w8a8_matmul_plain(x, wq, ws, out_dtype, row_scales)
    _build.refuse_autograd(NAME, x, wq, ws)
    _check(x, wq, ws, out_dtype)
    M, K = x.shape
    N = wq.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    out_f32 = int(out_dtype == torch.float32)
    if row_scales is None:
        sx = torch.empty((M,), dtype=torch.float32, device=x.device)
        err = _build.library().w8a8_matmul_bf16(
            x.data_ptr(), xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), ws.data_ptr(),
            out.data_ptr(), M, N, K, out_f32, _build.stream_ptr(x),
        )
    else:
        _check_scales(row_scales, M, x.device)
        err = _build.library().w8a8_matmul_scaled_bf16(
            x.data_ptr(), row_scales.data_ptr(), xq.data_ptr(), wq.data_ptr(),
            ws.data_ptr(), out.data_ptr(), M, N, K, out_f32, _build.stream_ptr(x),
        )
    _build.check(err, NAME)
    _build.count(NAME if row_scales is None else NAME_SCALED)
    return out
