"""K11c: one-token decode attention with lane-grouped reads.

Replaces ``qwen3_asr_tpu/ops/pallas/experiments/decode_attention_hbm5.py:
decode_attention_hbm5``.  K2's function with per-lane decode ends: cache row
s of lane b is valid when ``s < prompt_len[b]`` or ``prompt_bucket <= s <
decode_end[b]``, and the step's fresh ``k_new``/``v_new`` row is folded in
as a self-term.  Prompt blocks have ``block_p`` rows (the first of 512, 256
and 128 that divides the prompt bucket), decode blocks 128.

Idle lanes: ``prompt_len`` is clamped to ``[1, prompt_bucket]`` (the TPU
wrapper clamps it to at least 1, :324-327, so that every lane owns a block),
so a lane with ``prompt_len`` 0 attends cache row 0 as well as its fresh
row.  K2 and K11a/K11b give such a lane its fresh row alone; the kernel,
the plain version and the Pallas kernel here agree with each other.

Bound on the H100: bytes.  The CUDA kernel (``csrc/decode_attention_hbm5.cu``
over ``csrc/decode_stream.cuh``) keeps the TPU design: 4 lanes share every
read.  One block per (group of 4 lanes, KV head) walks the group's largest
geometry as 32-row tiles; each stage of its 3-deep ``cp.async`` ring holds
the tile of all 4 lanes (64 KB), and each lane keeps its own softmax state
and two-interval mask.  The cache is not padded to whole groups: the last
group skips lanes past B.

Its plain version is K2's on the clamped prompt lengths and per-lane ends;
it runs on CPU tensors.  On a CUDA tensor the wrapper launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from .. import _build
from ..decode_attention import decode_attention_plain
from .decode_attention_hbm2 import check
from .decode_attention_sched import check_ends, lane_ends

NAME = "decode_attention_hbm5"
#: Rows per decode block: the decode region must be a multiple.
DECODE_BLOCK = 128


def prompt_block(prompt_bucket: int, S: int, block_p: int | None = None) -> int:
    """The TPU wrapper's tiling: ``block_p`` (default: the first of 512,
    256, 128 that divides the prompt bucket); ValueError when it does not
    divide the prompt bucket or 128 does not divide the decode region."""
    if block_p is None:
        block_p = next((bp for bp in (512, 256, 128) if prompt_bucket % bp == 0), 128)
    if block_p not in (128, 256, 512) or prompt_bucket % block_p:
        raise ValueError(f"prompt_bucket={prompt_bucket} not tileable by {block_p}")
    if (S - prompt_bucket) % DECODE_BLOCK:
        raise ValueError(
            f"decode region {S - prompt_bucket} not a multiple of {DECODE_BLOCK}"
        )
    return block_p


def decode_attention_hbm5(
    q: torch.Tensor,            # (B, Hq, D)
    kall: torch.Tensor,         # (L, B, Hkv, S, D)
    vall: torch.Tensor,
    k_new: torch.Tensor,        # (B, Hkv, 1, D)
    v_new: torch.Tensor,
    layer: int,
    prompt_len: torch.Tensor,   # (B,) int32
    decode_end,                 # int, or (B,) int32: per-lane decode end
    prompt_bucket: int,
    scale: float | None = None,
    block_p: int | None = None,
) -> torch.Tensor:
    """One-token attention of q over layer ``layer`` of the stacked cache plus
    the fresh row, 4 lanes to a read.  Returns (B, Hq, D)."""
    B, hq, D = q.shape
    hkv, S = kall.shape[2], kall.shape[3]
    block_p = prompt_block(prompt_bucket, S, block_p)
    if scale is None:
        scale = D ** -0.5
    dend = lane_ends(decode_end, B, q.device)
    if q.is_cuda:
        check(q, kall, vall, k_new, v_new, layer, prompt_len, block_p)
        check_ends(dend, q)
    plen = prompt_len.clamp(1, prompt_bucket)
    if not q.is_cuda:
        return decode_attention_plain(q, kall, vall, k_new, v_new, layer, plen, dend,
                                      prompt_bucket, scale)
    out = torch.empty_like(q)
    err = _build.library().decode_attention_hbm5_bf16(
        q.data_ptr(), kall.data_ptr(), vall.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), plen.data_ptr(), dend.data_ptr(), out.data_ptr(),
        int(layer), B, hq, hkv, S, int(prompt_bucket), block_p, float(scale),
        _build.stream_ptr(q),
    )
    _build.check(err, NAME)
    _build.LAUNCHES[NAME] += 1
    return out
