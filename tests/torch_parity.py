"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Every parity test feeds the SAME inputs, made with numpy from a seed, to a
function of the JAX package (``qwen3_asr_tpu``) and to its counterpart in
the port (``qwen3_asr_tpu_torch``), both in float32 on the CPU, and holds
the results to a stated tolerance.  Parameters are numpy pytrees in the
JAX package's layout, handed to the JAX side as they are and to the port
through ``params_from_jax``.

JAX is imported inside the helpers, not at module level, so the test files
also collect where JAX is absent (the GPU machine runs only their
``cuda``-marked tests).
"""

from __future__ import annotations

import numpy as np

#: Tiny model: 2 encoder + 2 decoder layers, narrow widths, and decoder
#: head_dim 128 (the kernels' head dim) with a 2-head GQA group.
TINY_ENCODER = dict(
    d_model=32,
    encoder_layers=2,
    encoder_attention_heads=4,
    encoder_ffn_dim=64,
    output_dim=64,
    downsample_hidden_size=8,
)
TINY_DECODER = dict(
    hidden_size=64,
    num_hidden_layers=2,
    num_attention_heads=4,
    num_key_value_heads=2,
    head_dim=128,
    intermediate_size=128,
    vocab_size=512,
)
RUNTIME = dict(frame_buckets=(800, 1600, 3200), token_buckets=(16, 256))


def configs():
    """(JAX ModelConfig, port ModelConfig) of the tiny model."""
    from qwen3_asr_tpu import config as jc

    from qwen3_asr_tpu_torch import config as tc

    jcfg = jc.ModelConfig(
        audio_encoder=jc.AudioEncoderConfig(**TINY_ENCODER),
        text_decoder=jc.TextDecoderConfig(**TINY_DECODER),
    )
    tcfg = tc.ModelConfig(
        audio_encoder=tc.AudioEncoderConfig(**TINY_ENCODER),
        text_decoder=tc.TextDecoderConfig(**TINY_DECODER),
    )
    return jcfg, tcfg


def _fill(tree, rng, path=()):
    """Random values for a zero/one-initialized pytree of the JAX package:
    norms near 1, biases small, weights ~ N(0, 1/fan_in) so activations
    stay O(1) and the tiny model's greedy tokens vary."""
    if isinstance(tree, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape = tuple(tree.shape)
    name = path[-1]
    is_norm = name.startswith(("ln", "q_norm", "k_norm")) or name == "final_norm"
    if is_norm and not name.endswith("_b"):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name.endswith("_b") or name.startswith("b"):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name == "embedding":
        # Small next to the layers' O(1) outputs: with a tied lm_head a
        # dominant input embedding makes every step predict its own input.
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)
    if name.startswith("conv") and len(shape) == 4:      # HWIO
        fan_in = shape[0] * shape[1] * shape[2]
    else:
        fan_in = shape[-2]
    return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


def numpy_params(jcfg, seed: int = 0):
    """(encoder, decoder) numpy pytrees in the JAX package's layout."""
    import jax
    import jax.numpy as jnp

    from qwen3_asr_tpu.models.decoder import init_decoder_params
    from qwen3_asr_tpu.models.encoder import init_encoder_params

    rng = np.random.default_rng(seed)
    enc0 = jax.tree_util.tree_map(
        np.asarray, init_encoder_params(jcfg.audio_encoder, None, jnp.float32)
    )
    dec0 = jax.tree_util.tree_map(
        np.asarray, init_decoder_params(jcfg.text_decoder, None, jnp.float32)
    )
    return _fill(enc0, rng), _fill(dec0, rng)


class StubTokenizer:
    """Prompt-structure-preserving tokenizer over the tiny vocab (ids are
    taken mod 512, so the audio pads still start at slot 9)."""

    def encode(self, text):
        return [sum(map(ord, text)) % 509 + 1]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{t}" for t in ids)

    def build_prompt(self, n_audio_tokens, language="English"):
        from qwen3_asr_tpu_torch.tokenizer import build_detect_prompt, build_prompt

        if language is None:
            ids = build_detect_prompt(n_audio_tokens)
        else:
            ids = build_prompt(n_audio_tokens, self.encode(f" {language}"))
        return [t % 512 for t in ids]


def clips(seconds=(1.0, 2.3, 5.1), seed: int = 0) -> list[np.ndarray]:
    """Tone-plus-noise float32 clips at 16 kHz."""
    rng = np.random.default_rng(seed)
    out = []
    for s in seconds:
        t = np.arange(int(s * 16000)) / 16000.0
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 900) * t)
        out.append((x + 0.05 * rng.standard_normal(len(t))).astype(np.float32))
    return out


def port_config():
    """The port's ModelConfig of the tiny model (no JAX import)."""
    from qwen3_asr_tpu_torch import config as tc

    return tc.ModelConfig(
        audio_encoder=tc.AudioEncoderConfig(**TINY_ENCODER),
        text_decoder=tc.TextDecoderConfig(**TINY_DECODER),
    )


def jax_model(seed: int = 0, runtime: dict | None = None, params=None):
    """The JAX package's Qwen3ASR on the tiny float32 weights of ``seed``
    (or the numpy pytrees ``params``); a runtime with ``tp``/``dp`` runs on
    the virtual CPU mesh of ``tests/conftest.py``."""
    import jax.numpy as jnp

    from qwen3_asr_tpu.api import Qwen3ASR as JaxASR
    from qwen3_asr_tpu.config import RuntimeConfig as JaxRuntime

    jcfg, _ = configs()
    enc, dec = params if params is not None else numpy_params(jcfg, seed)
    return JaxASR(
        jcfg,
        {k: _to_jnp(v, jnp) for k, v in enc.items()},
        {k: _to_jnp(v, jnp) for k, v in dec.items()},
        StubTokenizer(),
        JaxRuntime(**dict(RUNTIME, **(runtime or {}))),
    )


def models(seed: int = 0, runtime: dict | None = None):
    """(JAX Qwen3ASR, port Qwen3ASR) on the same float32 weights."""
    from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig
    from qwen3_asr_tpu_torch.models.params import params_from_jax

    jcfg, tcfg = configs()
    enc, dec = numpy_params(jcfg, seed)
    rt = dict(RUNTIME, **(runtime or {}))
    jax = jax_model(runtime=runtime, params=(enc, dec))
    enc_t, dec_t = params_from_jax(enc, dec)
    port = Qwen3ASR(tcfg, enc_t, dec_t, StubTokenizer(), RuntimeConfig(**rt))
    return jax, port


def _to_jnp(tree, jnp):
    if isinstance(tree, dict):
        return {k: _to_jnp(v, jnp) for k, v in tree.items()}
    return jnp.asarray(tree)


def ids_of(results) -> list[list[int]]:
    """Token ids back from the stub tokenizer's ``t<id>`` text."""
    return [[int(w[1:]) for w in r.text.split()] for r in results]
