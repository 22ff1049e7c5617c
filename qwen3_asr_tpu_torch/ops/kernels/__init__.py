"""Hand-written CUDA kernels of the decoder's hot path and their wrappers.

| Module (wrapper) | TPU kernel it replaces |
| --- | --- |
| ``flash_attention`` (``flash_attention_causal``, K1) | ``ops/pallas/flash_attention.py:flash_attention_causal`` |
| ``decode_attention`` (``decode_attention``, K2) | ``ops/pallas/decode_attention_hbm4.py:decode_attention_hbm4`` |
| ``kv_write`` (``kv_write_rows``, ``kv_write_rows_batch``, K3) | ``ops/pallas/kv_write.py`` (same names) |
| ``kv_write`` (``kv_write_rows_q8``, K3 on the int8 cache) | ``ops/pallas/kv_write.py`` on int8 rows, with ``quantize_kv`` |
| ``kv_write`` (``kv_write_span_batch``, K5) | ``ops/pallas/kv_write.py:kv_write_span_batch`` |
| ``decode_attention`` (``decode_attention_q8``, K4) | ``ops/pallas/decode_attention_hbm4.py:decode_attention_hbm4_q8`` |
| ``quantized_matmul`` (``quantized_matmul``, K9) | ``ops/quant.py:quantized_matmul`` |
| ``w8a8_matmul`` (``w8a8_matmul``, K10) | ``ops/pallas/w8a8_matmul.py:w8a8_matmul`` |
| ``decode_attention_paged`` (``decode_attention_paged``, ``_q8``, K6) | ``ops/pallas/decode_attention_paged.py`` (same names) |
| ``decode_attention_paged`` (``decode_attention_paged_verify``, ``_verify_q8``, K7) | ``ops/pallas/decode_attention_paged.py`` (same names) |
| ``kv_write`` (``kv_write_rows_paged``, ``kv_write_rows_paged_q8``, K8) | ``ops/pallas/kv_write.py:kv_write_rows_paged`` |
| ``experiments.conv_stem`` (``conv_s2_gelu``, K11e) | ``ops/pallas/experiments/conv_stem.py:conv_s2_gelu`` |
| ``experiments.decode_attention_hbm2`` (``decode_attention_hbm2``, K11a) | ``ops/pallas/experiments/decode_attention_hbm2.py`` (same name) |
| ``experiments.decode_attention_hbm3`` (``decode_attention_hbm3``, K11b) | ``ops/pallas/experiments/decode_attention_hbm3.py`` (same name) |
| ``experiments.decode_attention_hbm5`` (``decode_attention_hbm5``, K11c) | ``ops/pallas/experiments/decode_attention_hbm5.py`` (same name) |
| ``experiments.decode_attention_sched`` (``decode_attention_sched``, K11d; ``build_decode_schedule``) | ``ops/pallas/experiments/decode_attention_sched.py`` (same names) |

Each wrapper runs its module's plain PyTorch version for CPU tensors and
launches its kernel (built at first use by ``_build``) for CUDA tensors.
``LAUNCHES`` counts kernel launches per wrapper.  The submodules are
imported by name (``from .kernels.decode_attention import
decode_attention``), so no function shadows a submodule here.
"""

from ._build import LAUNCHES

__all__ = ["LAUNCHES"]
