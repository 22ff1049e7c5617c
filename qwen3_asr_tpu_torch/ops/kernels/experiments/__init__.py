"""Kernels of the JAX package's experimental Pallas kernels
(``qwen3_asr_tpu/ops/pallas/experiments/``) that a mode of the port runs.

| Module (wrapper) | TPU kernel it replaces | Selected by |
| --- | --- | --- |
| ``conv_stem`` (``conv_s2_gelu``, K11e) | ``experiments/conv_stem.py:conv_s2_gelu`` | ``QWEN3_ASR_CONV_STEM=pallas`` |
| ``decode_attention_hbm2`` (``decode_attention_hbm2``, K11a) | ``experiments/decode_attention_hbm2.py`` (same name) | ``QWEN3_ASR_DECODE_KERNEL=3`` |
| ``decode_attention_hbm3`` (``decode_attention_hbm3``, K11b) | ``experiments/decode_attention_hbm3.py`` (same name) | ``QWEN3_ASR_DECODE_KERNEL=4`` |

As in ``ops/kernels``, each wrapper runs its plain PyTorch version for CPU
tensors, launches its kernel for CUDA tensors, and counts its launches in
``LAUNCHES`` under its own name.
"""
