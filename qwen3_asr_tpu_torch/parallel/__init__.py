"""Multi-device execution: the (dp, tp) mesh over ``torch.distributed``.

Counterpart of ``qwen3_asr_tpu/parallel``.  One process per rank, each
driving one device: call :func:`initialize` in every rank, then build
``Qwen3ASR(..., RuntimeConfig(dp=..., tp=...))`` in every rank and call
``transcribe``/``transcribe_batch`` with the same clips in every rank; each
rank gets the whole result list.  The tp collectives are explicit
(``collectives.py``); the servers keep a mesh's ranks in lockstep through
the control channels of ``lockstep.py``.
"""

from .collectives import (
    TP,
    all_reduce_max,
    copy_to_tp,
    gather_from_tp,
    reduce_from_tp,
    vocab_parallel_embed,
)
from .distributed import Topology, initialize, topology
from .mesh import Mesh, local_mesh, make_mesh
from .sharding import (
    check_tp,
    decoder_param_sharding,
    encoder_param_sharding,
    kv_cache_sharding,
    replicated,
    shard_params,
)

__all__ = [
    "make_mesh",
    "local_mesh",
    "decoder_param_sharding",
    "encoder_param_sharding",
    "kv_cache_sharding",
    "replicated",
    "shard_params",
    "Mesh",
    "check_tp",
    "initialize",
    "topology",
    "Topology",
    "TP",
    "copy_to_tp",
    "reduce_from_tp",
    "gather_from_tp",
    "vocab_parallel_embed",
    "all_reduce_max",
]
