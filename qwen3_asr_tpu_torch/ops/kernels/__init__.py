"""Hand-written CUDA kernels of the decoder's hot path and their wrappers.

Module (wrapper, kernel): the TPU kernel it replaces, under
``qwen3_asr_tpu/ops/``.

* ``flash_attention`` (``flash_attention_causal``, K1):
  ``pallas/flash_attention.py:flash_attention_causal``.
* ``decode_attention`` (``decode_attention``, K2):
  ``pallas/decode_attention_hbm4.py:decode_attention_hbm4``.
* ``decode_attention`` (``decode_attention_q8``, K4):
  ``pallas/decode_attention_hbm4.py:decode_attention_hbm4_q8``.
* ``kv_write`` (``kv_write_rows``, ``kv_write_rows_batch``, K3):
  ``pallas/kv_write.py`` (same names).  K2 stores the fresh rows itself
  when given ``write_slots`` (K3 fused), and the decoder's split step
  calls K3 only under decode modes "3"/"4".
* ``kv_write`` (``kv_write_rows_q8``, K3 on the int8 cache):
  ``pallas/kv_write.py`` on int8 rows, with ``quantize_kv``; fused into K4
  on every decode path.
* ``kv_write`` (``kv_write_span_pair``, K5 on both caches in one launch;
  ``kv_write_span_batch``, its one-cache oracle):
  ``pallas/kv_write.py:kv_write_span_batch``.
* ``decode_attention_paged`` (``decode_attention_paged``, ``_q8``, K6):
  ``pallas/decode_attention_paged.py`` (same names).
* ``decode_attention_paged`` (``decode_attention_paged_verify``,
  ``_verify_q8``, K7): ``pallas/decode_attention_paged.py`` (same names).
* ``kv_write`` (``kv_write_rows_paged``, ``kv_write_rows_paged_q8``, K8):
  ``pallas/kv_write.py:kv_write_rows_paged``; fused into K6/K7 on every
  paged path (``write_pages``, ``write_offsets``).
* ``quantized_matmul`` (``quantized_matmul``, K9):
  ``quant.py:quantized_matmul``.
* ``w8a8_matmul`` (``w8a8_matmul``, K10): ``pallas/w8a8_matmul.py:w8a8_matmul``.
* ``experiments.*`` (K11a-K11e): ``pallas/experiments/`` (the table in
  ``experiments/__init__.py``).

Each wrapper runs its module's plain PyTorch version for CPU tensors and
launches its kernel (built at first use by ``_build``) for CUDA tensors.
``LAUNCHES`` counts kernel launches per wrapper; a launch of K2/K4/K6/K7
with a write target also counts under its fused store's name
(``kv_write_rows_fused``, ``kv_write_rows_q8_fused``,
``kv_write_rows_paged_fused``, ``kv_write_rows_paged_q8_fused``).  The submodules are
imported by name (``from .kernels.decode_attention import
decode_attention``), so no function shadows a submodule here.
"""

from ._build import LAUNCHES

__all__ = ["LAUNCHES"]
