"""K11b: one-token decode attention as a persistent stream (decode mode "4").

Replaces ``qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm3.py:
decode_attention_hbm3``: the function, arguments, tiling rule and numerics
of K11a (:mod:`.decode_attention_hbm2`), on another schedule.

Bound on the H100: bytes.  The CUDA kernel (``csrc/decode_attention_hbm3.cu``)
runs up to one block per SM (:func:`stream_grid`); block i owns a
contiguous range of (lane, KV head) pairs, and a producer warp streams all
their 32-row tiles, across pair boundaries, by bulk copies into a deep
``mbarrier`` ring, skipping the tiles whose rows are all masked.  Eight
consumer warps take the tiles in turn and hand only the online softmax's
running values from tile to tile, so a pair's tiles overlap; the per-tile
arithmetic is the earlier ``cp.async`` version's, so the output is the same
bit for bit.  One launch, no combine pass.

Its plain version is K2's, as K11a's; it runs on CPU tensors.  On a CUDA
tensor the wrapper launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..decode_attention import _sm_count
from .decode_attention_hbm2 import check, launch, scalar_end_plain, tile_block_k

NAME = "decode_attention_hbm3"


def stream_grid(pairs: int, sm_count: int) -> tuple[int, int]:
    """(blocks, pairs per block) of the stream over ``pairs`` (lane, KV head)
    pairs: up to one block per SM, each owning ``per`` contiguous pairs
    (the last block fewer)."""
    per = -(-pairs // max(1, min(pairs, sm_count)))
    return -(-pairs // per), per


def decode_attention_hbm3(
    q: torch.Tensor,            # (B, Hq, D)
    kall: torch.Tensor,         # (L, B, Hkv, S, D)
    vall: torch.Tensor,
    k_new: torch.Tensor,        # (B, Hkv, 1, D)
    v_new: torch.Tensor,
    layer: int,
    prompt_len: torch.Tensor,   # (B,) int32
    decode_end: int,            # one slot for every lane
    prompt_bucket: int,
    scale: float | None = None,
    block_k: int = 512,
) -> torch.Tensor:
    """As :func:`~.decode_attention_hbm2.decode_attention_hbm2`, through the
    persistent stream.  Returns (B, Hq, D)."""
    block_k = tile_block_k(kall.shape[3], prompt_bucket, block_k)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.is_cuda:
        return scalar_end_plain(q, kall, vall, k_new, v_new, layer, prompt_len,
                                decode_end, prompt_bucket, scale)
    check(q, kall, vall, k_new, v_new, layer, prompt_len, block_k)
    _, per = stream_grid(q.shape[0] * kall.shape[2], _sm_count(q.device))
    return launch(NAME, "decode_attention_hbm3_bf16", q, kall, vall, k_new, v_new,
                  layer, prompt_len, decode_end, prompt_bucket, scale, block_k, per)
