"""Kernels of the JAX package's experimental Pallas kernels
(``qwen3_asr_tpu/ops/pallas/experiments/``): those a mode of the port runs,
and the two that only the kernel micro-bench runs, as in the JAX package
(no decode mode selects them there).

Module (wrapper, kernel): the TPU kernel it replaces, under
``qwen3_asr_tpu/ops/pallas/experiments/``; what selects it.

* ``conv_stem`` (``conv_s2_gelu``, K11e): ``conv_stem.py:conv_s2_gelu``;
  ``QWEN3_ASR_CONV_STEM=pallas``.
* ``decode_attention_hbm2`` (``decode_attention_hbm2``, K11a):
  ``decode_attention_hbm2.py`` (same name); ``QWEN3_ASR_DECODE_KERNEL=3``.
* ``decode_attention_hbm3`` (``decode_attention_hbm3``, K11b):
  ``decode_attention_hbm3.py`` (same name); ``QWEN3_ASR_DECODE_KERNEL=4``.
* ``decode_attention_hbm5`` (``decode_attention_hbm5``, K11c):
  ``decode_attention_hbm5.py`` (same name); ``tools/torch_micro_bench.py``
  (``kernelab``, ``kernelab-long``).
* ``decode_attention_sched`` (``decode_attention_sched``, K11d):
  ``decode_attention_sched.py`` (same name, with ``build_decode_schedule``);
  ``tools/torch_micro_bench.py`` (``kernelab``, ``kernelab-long``).

As in ``ops/kernels``, each wrapper runs its plain PyTorch version for CPU
tensors, launches its kernel for CUDA tensors, and counts its launches in
``LAUNCHES`` under its own name.
"""
