"""One training step on a (dp, tp) mesh of ``n`` ranks: the multi-device dry run.

Counterpart of ``__graft_entry__.dryrun_multichip``, with its mesh rule (tp
= 2 when ``n`` is even, dp = n / tp), its tiny float32 config, its batch
(B = max(dp, 2) clips of 800 mel frames, P = 144, 104 audio tokens, the loss
over [9 + 104, P)) and its check: one AdamW(1e-4) step over the mesh, a
finite loss, then the tp-sharded decoder logits of a fresh decoder within
1e-4 of one device's.  Where the JAX package runs one process over a
virtual mesh, the port spawns one process per rank: NCCL with one card a
rank when there are ``n`` cards, else gloo with the ranks sharing the cards
(CUDA tensors through host memory), or gloo on the CPU when the caller asks
for ``device="cpu"``.

    python -m qwen3_asr_tpu_torch.training.dryrun N [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

#: Seconds the ranks may take together (spawn, imports, the step).
TIMEOUT = 600
#: The JAX dry run's tiny config (``__graft_entry__.py:147-167``).
TINY_ENCODER = dict(d_model=64, encoder_layers=2, encoder_attention_heads=4,
                    encoder_ffn_dim=128, num_mel_bins=128, output_dim=64,
                    downsample_hidden_size=16)
TINY_DECODER = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=16, intermediate_size=128,
                    vocab_size=512)
FRAMES, PROMPT, N_AUDIO = 800, 144, 104


def mesh_shape(n_devices: int) -> tuple[int, int]:
    """(dp, tp) of ``n_devices`` ranks: tp = 2 when n is even."""
    tp = 2 if n_devices % 2 == 0 else 1
    return n_devices // tp, tp


def tiny_config():
    from ..config import AudioEncoderConfig, ModelConfig, TextDecoderConfig

    return ModelConfig(audio_encoder=AudioEncoderConfig(**TINY_ENCODER),
                       text_decoder=TextDecoderConfig(**TINY_DECODER))


def dryrun_batch(B: int):
    """The JAX dry run's batch: N(0, 0.1) mel from numpy seed 0, ids 7,
    labels 11, the loss over [9 + 104, P)."""
    from .train import Batch

    mel = np.random.default_rng(0).standard_normal((B, 128, FRAMES)).astype(np.float32) * 0.1
    mask = np.zeros((B, PROMPT), bool)
    mask[:, 9 + N_AUDIO:] = True
    return Batch(torch.from_numpy(mel), torch.full((B,), FRAMES, dtype=torch.int32),
                 torch.full((B, PROMPT), 7, dtype=torch.int32),
                 torch.full((B,), N_AUDIO, dtype=torch.int32),
                 torch.full((B, PROMPT), 11, dtype=torch.int32), torch.from_numpy(mask))


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Run one training step over an ``n_devices`` (dp, tp) mesh of spawned
    ranks and print ``dryrun_multichip ok: mesh=(dp=…, tp=…) loss=…
    tp-equivalence max|Δ|=…``.  ``device`` "cuda" (the default) needs a
    CUDA device and raises RuntimeError without one; "cpu" runs the ranks
    on the CPU over gloo.  A rank that fails or outlives :data:`TIMEOUT`
    raises RuntimeError with its output."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device (torch.cuda.is_available() is "
                           "False); pass device='cpu' to run the ranks on the CPU")
    cards = torch.cuda.device_count() if device == "cuda" else 0
    backend = "nccl" if cards >= n_devices else "gloo"
    workdir = Path(tempfile.mkdtemp(prefix="dryrun_multichip."))
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    if device == "cpu":
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", __name__, str(n_devices), "--rank", str(r), "--device", device,
         "--backend", backend, "--workdir", str(workdir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for r in range(n_devices)]
    outs, failed = [], []
    try:
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                failed.append((r, "timeout"))
            else:
                if p.returncode != 0:
                    failed.append((r, p.returncode))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    if failed:
        text = "\n".join(f"--- rank {r} ({rc}):\n{outs[r][-4000:] if r < len(outs) else ''}"
                         for r, rc in failed)
        raise RuntimeError(f"dryrun_multichip({n_devices}) failed:\n{text}")
    sys.stdout.write(outs[0])


def run_rank(rank: int, n_devices: int, device: str, backend: str, workdir: Path) -> None:
    """One rank of :func:`dryrun_multichip`; rank 0 prints the result."""
    from .. import parallel
    from ..models.decoder import decoder_forward, decoder_logits, embed_tokens
    from ..models.params import random_params
    from .train import init_train_state, make_train_step

    if device == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    parallel.initialize(num_processes=n_devices, process_id=rank, backend=backend,
                        init_method=f"file://{workdir / 'init'}")
    dp, tp = mesh_shape(n_devices)
    mesh = parallel.make_mesh(dp, tp)
    cfg = tiny_config()

    enc, dec = random_params(cfg, seed=0, dtype=torch.float32, device=dev)
    adamw = functools.partial(torch.optim.AdamW, lr=1e-4, weight_decay=1e-4)
    state = init_train_state(cfg, adamw, enc, dec, mesh)
    state, loss = make_train_step(cfg)(state, dryrun_batch(max(dp, 2)))
    loss = loss.item()
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    # Sharded against one device: the tp-sharded decoder logits of a fresh
    # decoder within 1e-4 of the whole decoder's.
    dec_ref = random_params(cfg, seed=7, dtype=torch.float32, device=dev)[1]
    ids = torch.tensor([[1, 5, 9, 200]], device=dev)
    pos = torch.arange(ids.shape[1], device=dev)[None]

    def logits(params, tp=None):
        h = embed_tokens(params, ids, tp)
        out, _ = decoder_forward(params, cfg.text_decoder, h, pos, attn_impl="causal", tp=tp)
        return decoder_logits(params, cfg.text_decoder, out, tp)

    with torch.no_grad():
        ref = logits(dec_ref)
        sharded = parallel.shard_params(dec_ref, parallel.decoder_param_sharding(dec_ref), mesh)
        got = logits(sharded, mesh.tp_group())
    delta = (got - ref).abs().max().item()
    if not delta <= 1e-4:
        raise AssertionError(f"tp-sharded logits {delta:.3e} from one device's")
    if rank == 0:
        print(f"dryrun_multichip ok: mesh=(dp={dp}, tp={tp}) loss={loss:.4f} "
              f"tp-equivalence max|Δ|={delta:.2e}", flush=True)
    torch.distributed.destroy_process_group()


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--backend", help=argparse.SUPPRESS)
    parser.add_argument("--workdir", type=Path, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is None:
        dryrun_multichip(args.n_devices, args.device)
    else:
        run_rank(args.rank, args.n_devices, args.device, args.backend, args.workdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
