"""K11b: one-token decode attention as a persistent stream (decode mode "4").

Replaces ``qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm3.py:
decode_attention_hbm3``: the function, arguments, tiling rule and numerics
of K11a (:mod:`.decode_attention_hbm2`), on another TPU schedule.

Bound on the H100: bytes.  The CUDA kernel (``csrc/decode_attention_hbm3.cu``
over ``csrc/decode_pair_stream.cuh``) runs the same persistent stream as
K11a's (:func:`~.decode_attention_hbm2.stream_grid` blocks, each owning a
contiguous range of (lane, KV head) pairs, bulk copies into a deep
``mbarrier`` ring, eight consumer warps taking whole tiles), under a name of
its own; the per-tile arithmetic is the earlier ``cp.async`` version's, so
the output is the same bit for bit.  One launch, no combine pass.

Its plain version is K2's, as K11a's; it runs on CPU tensors.  On a CUDA
tensor the wrapper launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .decode_attention_hbm2 import scalar_end_stream

NAME = "decode_attention_hbm3"


def decode_attention_hbm3(
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
    """As :func:`~.decode_attention_hbm2.decode_attention_hbm2`, through the
    persistent stream.  Returns (B, Hq, D)."""
    return scalar_end_stream(NAME, "decode_attention_hbm3_bf16", q, kall, vall, k_new, v_new,
                             layer, prompt_len, decode_end, prompt_bucket, scale, block_k)
