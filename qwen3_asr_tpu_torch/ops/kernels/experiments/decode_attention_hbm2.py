"""K11a: one-token decode attention, one decode end for every lane (decode mode "3").

Replaces ``qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm2.py:
decode_attention_hbm2``.  K2's function with one ``decode_end`` for every
lane: cache row s of lane b is valid when ``s < prompt_len[b]`` or
``prompt_bucket <= s < decode_end``, and the step's fresh ``k_new``/``v_new``
row is folded in as a self-term.  ``decode_end`` is a 0-d (or (1,)) int32
tensor on q's device, which the kernel reads, as the TPU kernel reads its
end by scalar prefetch (``decode_attention_hbm2.py:38``, ``:164``): the
wrapper never waits for the device, so a CUDA graph holds the launch and
each replay takes the end the tensor then holds (the decode modes' graphed
loop).  The TPU walks the cache in blocks of
``block_k`` rows (halved from the requested size until it divides S and the
prompt bucket; :func:`tile_block_k`), which here decides only the input
check.  Its numerics are the TPU kernel's (q * scale rounded to bf16, bf16
P.V operands, a bf16-rounded self-term product), which K2 does not copy.

Bound on the H100: bytes, as K2.  The CUDA kernel
(``csrc/decode_attention_hbm2.cu`` over ``csrc/decode_pair_stream.cuh``) is
K11b's persistent stream under a name of its own: up to one block per SM
(:func:`stream_grid`), each owning a contiguous range of (lane, KV head)
pairs; a producer warp streams their 32-row tiles by bulk copies into a deep
``mbarrier`` ring, skipping the tiles whose rows are all masked, and eight
consumer warps take whole tiles, handing only the online softmax's running
values from tile to tile.  One launch, no split of a pair's rows and no
combine pass; the output is K11b's bit for bit.

Its plain version is K2's :func:`~..decode_attention.decode_attention_plain`
with the scalar decode end broadcast to every lane on the device, behind
this wrapper's shape checks and tiling rule; it runs on CPU tensors.  On a CUDA tensor the
wrapper launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import _build
from ..decode_attention import _sm_count, decode_attention_plain

NAME = "decode_attention_hbm2"
#: Cache rows per stage of the kernels' ring: ``block_k`` must be a multiple.
TILE_ROWS = 32


def stream_grid(pairs: int, sm_count: int) -> tuple[int, int]:
    """(blocks, pairs per block) of the stream over ``pairs`` (lane, KV head)
    pairs: up to one block per SM, each owning ``per`` contiguous pairs
    (the last block fewer)."""
    per = -(-pairs // max(1, min(pairs, sm_count)))
    return -(-pairs // per), per


def tile_block_k(S: int, prompt_bucket: int, block_k: int) -> int:
    """The block size the TPU wrappers use: ``block_k`` capped at S and
    halved (not below 128) until it divides both S and the prompt bucket;
    ValueError when the result still does not."""
    block_k = min(block_k, S)
    while block_k > 128 and (S % block_k or prompt_bucket % block_k):
        block_k //= 2
    if S % block_k or prompt_bucket % block_k:
        raise ValueError(f"S={S}/Pb={prompt_bucket} not tileable by {block_k}")
    return block_k


def scalar_end_plain(q, kall, vall, k_new, v_new, layer, prompt_len,
                     decode_end: torch.Tensor, prompt_bucket: int,
                     scale: float) -> torch.Tensor:
    """K2's plain version with the one-element ``decode_end`` tensor shared
    by every lane (broadcast on its device, no host read)."""
    dend = decode_end.to(prompt_len.device).reshape(()).expand(prompt_len.shape)
    return decode_attention_plain(q, kall, vall, k_new, v_new, layer, prompt_len,
                                  dend, prompt_bucket, scale)


def check_end(decode_end, device: torch.device) -> None:
    """The one decode end of K11a/K11b: a 0-d or (1,) int32 tensor on
    ``device`` (q's); a host int or a per-lane (B,) end is refused."""
    _build.check_device_int("decode_end", decode_end, device)


def check(q, kall, vall, k_new, v_new, layer, prompt_len, block_k: int) -> None:
    """What the stream kernels read: bf16 q (B, Hq, 128), cache (L, B, Hkv,
    S, 128) and fresh rows (B, Hkv, 1, 128) with a GQA group of 1, 2 or 4,
    int32 (B,) prompt lengths, all contiguous on q's device; q and the cache
    16-byte aligned; ``block_k`` a multiple of the 32-row tile."""
    if q.dim() != 3 or kall.dim() != 5:
        raise ValueError("q must be (B, Hq, D) and kall (L, B, Hkv, S, D)")
    B, hq, D = q.shape
    L, Bc, hkv, S, Dc = kall.shape
    if D != 128 or Dc != 128:
        raise ValueError(f"head_dim must be 128, got {D}/{Dc}")
    if Bc != B or vall.shape != kall.shape:
        raise ValueError("cache batch/shape mismatch")
    if hq % hkv or hq // hkv not in (1, 2, 4):
        raise ValueError(f"GQA group {hq}/{hkv} not supported (1, 2 or 4)")
    if tuple(k_new.shape) != (B, hkv, 1, D) or v_new.shape != k_new.shape:
        raise ValueError("k_new/v_new must be (B, Hkv, 1, D)")
    if not 0 <= layer < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    tensors = (("q", q), ("kall", kall), ("vall", vall), ("k_new", k_new),
               ("v_new", v_new))
    for name, t in tensors:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be torch.bfloat16, got {t.dtype}")
    if prompt_len.dtype != torch.int32 or tuple(prompt_len.shape) != (B,):
        raise ValueError("prompt_len must be int32 (B,)")
    for name, t in tensors + (("prompt_len", prompt_len),):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in tensors[:3]:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if block_k % TILE_ROWS:
        raise ValueError(f"block_k={block_k} must be a multiple of {TILE_ROWS}")


def scalar_end_stream(name: str, entry: str, q, kall, vall, k_new, v_new, layer: int,
                      prompt_len, decode_end: torch.Tensor, prompt_bucket: int,
                      scale: float | None, block_k: int) -> torch.Tensor:
    """K11a or K11b: the plain version on CPU tensors; on CUDA tensors the
    checks, then the stream kernel of C entry point ``entry``, counted under
    ``name``, reading ``decode_end`` on the device."""
    check_end(decode_end, q.device)
    block_k = tile_block_k(kall.shape[3], prompt_bucket, block_k)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return scalar_end_plain(q, kall, vall, k_new, v_new, layer, prompt_len,
                                decode_end, prompt_bucket, scale)
    check(q, kall, vall, k_new, v_new, layer, prompt_len, block_k)
    B, hq, _ = q.shape
    hkv, S = kall.shape[2], kall.shape[3]
    _, per = stream_grid(B * hkv, _sm_count(q.device))
    out = torch.empty_like(q)
    err = getattr(_build.library(), entry)(
        q.data_ptr(), kall.data_ptr(), vall.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), prompt_len.data_ptr(), out.data_ptr(), int(layer), B, hq,
        hkv, S, int(prompt_bucket), decode_end.data_ptr(), block_k, per, float(scale),
        _build.stream_ptr(q),
    )
    _build.check(err, name)
    _build.count(name)
    return out


def decode_attention_hbm2(
    q: torch.Tensor,            # (B, Hq, D)
    kall: torch.Tensor,         # (L, B, Hkv, S, D)
    vall: torch.Tensor,
    k_new: torch.Tensor,        # (B, Hkv, 1, D)
    v_new: torch.Tensor,
    layer: int,
    prompt_len: torch.Tensor,   # (B,) int32
    decode_end: torch.Tensor,   # 0-d int32 on q's device: one end for every lane
    prompt_bucket: int,
    scale: float | None = None,
    block_k: int = 512,
) -> torch.Tensor:
    """One-token attention of q over layer ``layer`` of the stacked cache plus
    the fresh row, with one ``decode_end`` for every lane, read on the
    device.  Returns (B, Hq, D)."""
    return scalar_end_stream(NAME, "decode_attention_hbm2_bf16", q, kall, vall, k_new, v_new,
                             layer, prompt_len, decode_end, prompt_bucket, scale, block_k)
