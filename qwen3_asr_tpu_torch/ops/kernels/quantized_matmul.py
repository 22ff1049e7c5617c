"""K9: weight-only int8 matmul (W8A16), ``(x @ wq) * s``.

Replaces ``qwen3_asr_tpu/ops/quant.py:quantized_matmul``.  x (M, K) bf16,
wq (K, N) int8 in the (in, out) layout, s (N,) f32 per-output-channel
scales; the result is bf16 or f32.  Bound on the H100: the int8 weight
bytes at decode (M is the batch), bf16 tensor-core operations at prefill.

The CUDA kernel (``csrc/quantized_matmul.cu``) computes ``out^T = wq^T
x^T``: int8 weight tiles arrive by TMA into a ring of 5-8 stages, each
thread converts its wgmma A fragment to bf16 in registers (exact) and runs
``wgmma`` with the x tile as the B operand.  It needs wq stored K-major,
the transpose of a contiguous (N, K) int8 tensor, as
:func:`..quant.quantize_weight` stores it; it takes no other layout and
copies none.  :func:`split_k_plan` picks the row tile (up to 256 rows in
one tile, so each weight byte is read once) and splits K at decode, where
the tiles alone would not fill the card; the partial sums are added in a
fixed order, so two identical calls give identical bits.  It takes K a multiple of 128
and N of 16, any M.

On a CPU tensor the wrapper runs :func:`quantized_matmul_plain`, the JAX
package's non-TPU lowering ``x @ dequantize_weight(w, x.dtype)``
(``quant.py:251``), in any layout; on a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from . import _build

NAME = "quantized_matmul"
_BK = 128
#: Row tiles (wgmma N) of the kernel; M above the largest walks row tiles.
ROW_TILES = (8, 16, 32, 64, 128, 256)
#: Output columns (weight rows) per block, and k per pipeline stage.
COL_TILE = 128
K_BLOCK = 64

#: A split plan keeps at most one block per SM with row tiles of at most
#: 64, so sms x 64 x 128 floats of split-K workspace and sms counters always
#: suffice.  Both, and the plans that hold their pointers, are the scratch
#: owner's (``_build.scratch``).


def quantized_matmul_plain(
    x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """``x @ dequantize(wq, s)`` in x's dtype, cast to ``out_dtype``."""
    w = (wq.float() * s[None, :]).to(x.dtype)
    return (x @ w).to(out_dtype)


def split_k_plan(M: int, N: int, K: int, sms: int) -> tuple[int, int, int]:
    """``(nb, splits, per)`` for an (M, K) x (K, N) call on a card of
    ``sms`` SMs: the row tile nb and ``splits`` contiguous ranges of
    ``per`` 64-deep k-blocks.

    nb is M rounded up to a power of two from 8, 256 at most, so one tile
    holds every row up to 256 and each weight byte is read once; from 128
    on it is halved where the (row tile, 128-column tile) pairs would not
    fill half the card.  Row tiles up to 64 (two blocks per SM) split K
    into as many ranges as one block per SM allows, at least two k-blocks
    a range; larger tiles do not split, since the sum of their partials
    costs more than it saves (device times on the H100 from
    tools/torch_k9_sweep.py)."""
    nb = next(b for b in ROW_TILES if b >= min(M, ROW_TILES[-1]))
    n_tiles = -(-N // COL_TILE)
    if nb >= 128 and -(-M // nb) * n_tiles < sms // 2:
        nb //= 2
    k_blocks = K // K_BLOCK
    splits = 1
    if nb <= 64:
        splits = max(1, min(sms // (-(-M // nb) * n_tiles), k_blocks // 2))
    per = -(-k_blocks // splits)
    return nb, -(-k_blocks // per), per


def k_ranges(K: int, splits: int, per: int) -> list[range]:
    """The k-blocks each split sums, in the order the kernel adds them."""
    k_blocks = K // K_BLOCK
    return [range(i * per, min((i + 1) * per, k_blocks)) for i in range(splits)]


def _check(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor, out_dtype) -> None:
    if x.dim() != 2 or wq.dim() != 2 or s.dim() != 1:
        raise ValueError("x must be (M, K), wq (K, N) and s (N,)")
    M, K = x.shape
    Kw, N = wq.shape
    if Kw != K or s.shape[0] != N:
        raise ValueError(f"shapes x {tuple(x.shape)}, wq {tuple(wq.shape)}, s {tuple(s.shape)}")
    if K % _BK or N % 16:
        raise ValueError(f"K={K} must be a multiple of {_BK} and N={N} of 16")
    if x.dtype != torch.bfloat16 or wq.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"need bf16 x, int8 wq, f32 s; got {x.dtype}, {wq.dtype}, {s.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    for name, t in (("wq", wq), ("s", s)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if wq.stride() != (1, K) or wq.data_ptr() % 16:
        check_k_major(wq)
    if not (x.is_contiguous() and s.is_contiguous()):
        raise ValueError("x and s must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")


def check_k_major(wq: torch.Tensor) -> None:
    """Raise unless the (K, N) int8 weight is stored K-major (the transpose
    of a contiguous (N, K) tensor, 16-byte aligned): the layout the TMA
    kernels K9 and K10 read, which they never copy into."""
    if not wq.t().is_contiguous() or wq.data_ptr() % 16:
        raise ValueError(
            f"wq {tuple(wq.shape)} with strides {wq.stride()} is not K-major: the kernels "
            "take the transpose of a contiguous (N, K) int8 tensor (quantize_weight stores it so)"
        )


def _plan(M: int, N: int, K: int, device: torch.device) -> tuple:
    """(nb, splits, per, workspace ptr, counters ptr) of an (M, N, K) call:
    the split-K workspace (f32) and the zeroed arrival counters (the kernel
    leaves them zeroed) are the scratch owner's."""
    pool = _build.scratch(device)
    plans = pool.setdefault("quantized_matmul_plans", {})
    plan = plans.get((M, N, K))
    if plan is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        nb, splits, per = split_k_plan(M, N, K, sms)
        ptrs = (None, None)
        if splits > 1:
            bufs = pool.setdefault("quantized_matmul_split_k", [])
            n_partial = max(splits * M * N, sms * 64 * COL_TILE)
            if not bufs or bufs[-2].numel() < splits * M * N:
                bufs += [torch.empty(n_partial, dtype=torch.float32, device=device),
                         torch.zeros(max(sms, 4096), dtype=torch.int32, device=device)]
            ptrs = (bufs[-2].data_ptr(), bufs[-1].data_ptr())
        plan = plans[(M, N, K)] = (nb, splits, per, *ptrs)
    return plan


def quantized_matmul(
    x: torch.Tensor,
    wq: torch.Tensor,
    s: torch.Tensor,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """(M, K) x (K, N) int8 with (N,) scales -> (M, N) in ``out_dtype``
    (default x's dtype)."""
    out_dtype = out_dtype or x.dtype
    if not x.is_cuda:
        return quantized_matmul_plain(x, wq, s, out_dtype)
    _build.refuse_autograd(NAME, x, wq, s)
    _check(x, wq, s, out_dtype)
    M, K = x.shape
    N = wq.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0:
        return out
    nb, splits, per, partial, counters = _plan(M, N, K, x.device)
    err = _build.library().quantized_matmul_bf16(
        x.data_ptr(), wq.data_ptr(), s.data_ptr(), out.data_ptr(), partial, counters,
        M, N, K, int(out_dtype == torch.float32), nb, splits, per, _build.stream_ptr(x),
    )
    _build.check(err, NAME)
    _build.count(NAME)
    return out
