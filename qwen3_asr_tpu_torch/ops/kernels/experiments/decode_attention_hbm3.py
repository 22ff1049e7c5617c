"""K11b: one-token decode attention as a persistent stream (decode mode "4").

Replaces ``qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm3.py:
decode_attention_hbm3``: the function, arguments, tiling rule and numerics
of K11a (:mod:`.decode_attention_hbm2`), on another schedule.

Bound on the H100: bytes.  The CUDA kernel (``csrc/decode_attention_hbm3.cu``
over ``csrc/decode_stream.cuh``) runs a fixed grid of at most one block per
SM and at most half the (lane, KV head) pairs; block i owns a contiguous
range of at least two pairs and walks all their 32-row tiles as one stream
through a 4-stage ``cp.async`` ring whose producer keeps prefetching across
pair boundaries, finalizing each pair (self-term, 1 / l) as its last tile
drains.  One launch, no combine pass.

Its plain version is K2's, as K11a's; it runs on CPU tensors.  On a CUDA
tensor the wrapper launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..decode_attention import _sm_count
from .decode_attention_hbm2 import check, launch, scalar_end_plain, tile_block_k

NAME = "decode_attention_hbm3"


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
    # At least two pairs per block, as the TPU's two cores each own half the
    # batch, so that every block's ring runs across a pair boundary.
    pairs = q.shape[0] * kall.shape[2]
    n_blocks = max(1, min(pairs // 2, _sm_count(q.device)))
    return launch(NAME, "decode_attention_hbm3_bf16", q, kall, vall, k_new, v_new,
                  layer, prompt_len, decode_end, prompt_bucket, scale, block_k,
                  n_blocks)
