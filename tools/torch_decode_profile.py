#!/usr/bin/env python3
"""Device busy share and launches per iteration of the PyTorch port's decode
loops and continuous engine on one CUDA GPU.

    python3 tools/torch_decode_profile.py [--runs 2] [--out DIR] [--no-engine]
                                          [--blocks 1,4,8,16]

Builds the 1.7B model from random weights (seed 0, bf16), and for the plain
loop (``speculative="off"``), the default speculative loop (``"auto"``)
and the plain loop over the int8 KV cache (``"off-int8"``), each graphed
(the default on the card: the step replayed as a CUDA graph in blocks of
``graphs.BLOCK``) and eager (``-eager``: ``decode(eager=True)``, one host
sync a step), and the plain loop under decode mode "4" (``"mode4"``: K11b
and the standalone K3 reading the decode end and the slot on the device,
graphed like the others, with ``"mode4-eager"`` its eager twin) runs greedy
``transcribe_batch`` of the smoke
batch (8 clips of 4-30 s, ``max_tokens=64``) and ``transcribe`` of its
30 s clip: once to warm up (and capture), ``--runs`` times unprofiled in
turns (decode ms per live iteration and per emitted token, replays and
host syncs), then ``--runs`` times under ``torch.profiler``.  From each
Chrome trace it takes the host window of the ``qwen3_asr/decode`` span and
the device kernels that start inside it, and prints per run: decode wall
ms, iterations, kernels, device copies (memcpy nodes) and fills (memset
nodes) per iteration, kernel ms per iteration, busy share (kernel time
over the window) and the top kernels by time; the device events per
iteration by name go to ``counts_*.json`` in ``--out``.

With ``--blocks``, first the graphed plain and speculative loops at each
block size given (``graphs.BLOCK`` set before each run), in turns, ``--runs``
x 2 each: decode ms per live iteration, replays and host syncs per decode
(how ``graphs.BLOCK`` was chosen).

Then (unless ``--no-engine``) the continuous engine on the same weights, as
the smoke's server runs it (8 slots, 16-step chunks, 30 s clips, 512-token
transcripts): paged bf16 and int8 pools under ``spec_engine`` "off" (paged
steps) and "auto" (paged verify iterations), and the flat bf16 engine; the
smoke batch admitted at once (64-token budgets), once unprofiled to warm
up (the chunks' graphs are captured there), then ``--runs``
times into the same engine under ``torch.profiler`` over its chunks to the
last retirement: chunk iterations, device kernels and copies and fills per
iteration (the chunks' own, such as the status fetch, included; copies and
fills apart), kernel ms per
iteration, the wall ms per iteration of the profiled run and the top
kernels (``tools/torch_streams.py`` compares two trees' token streams).
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import Counter
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import StubTokenizer, smoke_clips  # noqa: E402


def decode_window(trace: dict) -> dict:
    """Kernel count, kernel time and busy share inside the decode span, and
    the device copies and fills (``cudaMemcpyAsync``/``cudaMemsetAsync``
    nodes, which are not kernels: a same-dtype ``copy_`` of contiguous
    tensors is a copy) that start inside it, counted apart."""
    events = trace["traceEvents"]
    span = next(e for e in events
                if e.get("cat") == "user_annotation" and e.get("name") == "qwen3_asr/decode")
    lo, hi = span["ts"], span["ts"] + span["dur"]
    kernels = [e for e in events if e.get("cat") == "kernel" and lo <= e["ts"] < hi]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and lo <= e["ts"] < hi]
    fills = [e for e in events if e.get("cat") == "gpu_memset" and lo <= e["ts"] < hi]
    by_name = Counter()
    for k in kernels:
        by_name[k["name"][:60]] += k["dur"]
    busy = sum(k["dur"] for k in kernels)
    counts = Counter(short_name(e["name"]) for e in kernels + copies + fills)
    return {"wall_us": span["dur"], "kernels": len(kernels), "copies": len(copies),
            "fills": len(fills),
            "kernel_us": busy, "busy": busy / span["dur"], "top": by_name.most_common(5),
            "counts": counts}


def short_name(name: str) -> str:
    """A device event's name without its argument list and namespaces."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")[:80]


def write_counts(path: Path, counts: Counter, iterations: int) -> None:
    """Device events per iteration by name, as JSON (for comparing trees)."""
    path.write_text(json.dumps({k: v / max(iterations, 1) for k, v in sorted(counts.items())}))


#: The engine configurations: (runtime, paged).
ENGINES = {
    "paged bf16, spec_engine off": ({"spec_engine": "off"}, True),
    "paged bf16, spec_engine auto": ({}, True),
    "paged int8, spec_engine off": ({"kv_cache_dtype": "int8", "spec_engine": "off"}, True),
    "paged int8, spec_engine auto": ({"kv_cache_dtype": "int8"}, True),
    "flat bf16, spec_engine off": ({"spec_engine": "off"}, False),
}


def device_kernels(prof) -> tuple[int, int, int, float, Counter, Counter]:
    """(kernels, device copies, device fills, kernels' total us, us by
    kernel name, events by short name) of a profile's device events."""
    from torch.autograd import DeviceType

    by_name, counts = Counter(), Counter()
    n, copies, fills, total = 0, 0, 0, 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name.startswith("qwen3_asr/"):
            continue
        counts[short_name(e.name)] += 1
        if e.name.startswith(("Memcpy", "Memset")):
            copies += e.name.startswith("Memcpy")
            fills += e.name.startswith("Memset")
            continue
        n += 1
        total += e.time_range.elapsed_us()
        by_name[e.name[:60]] += e.time_range.elapsed_us()
    return n, copies, fills, total, by_name, counts


def engine_run(model, engine, clips, prof=None) -> tuple[dict, list]:
    """The smoke batch through ``engine`` (empty; its counters reset), all
    admitted at once, chunks until the last retirement (profiled when
    ``prof`` is a profiler context).  Returns (engine stats, per-clip
    tokens)."""
    import torch

    from qwen3_asr_tpu_torch.runtime.engine import EngineStats, SlotRequest

    engine.stats = EngineStats()
    kv, logits, prompts = model.prefill_group(clips, ["English"] * len(clips))
    reqs = [SlotRequest(samples=c, prompt=p, max_new=64, meta=i)
            for i, (c, p) in enumerate(zip(clips, prompts))]
    engine.admit(kv, logits, engine.free_slots(), reqs)
    torch.cuda.synchronize()
    out = {}
    t0 = time.perf_counter()
    with prof if prof is not None else nullcontext():
        while len(out) < len(clips):
            engine.step()
            for req, toks in engine.retire():
                out[req.meta] = [int(t) for t in toks]
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = engine.stats
    return {"iterations": st.iterations, "chunks": st.chunks, "wall_s": wall}, \
        [out[i] for i in range(len(clips))]


def engine_profile(card: str, base, clips, runs: int, out: Path) -> None:
    import torch

    from qwen3_asr_tpu_torch import Qwen3ASR, RuntimeConfig

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for label, (runtime, paged) in ENGINES.items():
        model = Qwen3ASR(base._config, base._encoder_params, base._decoder_params,
                         base._tokenizer, RuntimeConfig(**runtime))
        engine = model.make_engine(n_slots=8, max_duration=30.0, max_new_tokens=512,
                                   chunk_steps=16, paged=paged)
        engine_run(model, engine, clips)              # warm-up: captures the chunks' buckets
        for run in range(runs):
            prof = torch.profiler.profile(activities=acts)
            st, _ = engine_run(model, engine, clips, prof)
            n, copies, fills, us, by_name, counts = device_kernels(prof)
            it = max(st["iterations"], 1)
            tag = label.replace(", ", "_").replace(" ", "-")
            write_counts(out / f"counts_engine_{tag}_{run}.json", counts, it)
            print(f"[{card}] engine {label} run {run}: {st['chunks']} chunks, "
                  f"{st['iterations']} chunk iterations, {n / it:.1f} kernels, "
                  f"{copies / it:.1f} device copies and {fills / it:.1f} fills, "
                  f"{us / 1e3 / it:.3f} kernel-ms per iteration; profiled wall "
                  f"{st['wall_s'] * 1e3 / it:.2f} ms per iteration; top kernels (us): "
                  + ", ".join(f"{k} {d:.0f}" for k, d in by_name.most_common(5)))
        engine.close()
        del model, engine
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    ap.add_argument("--no-engine", action="store_true",
                    help="profile the decode loops only, not the continuous engine")
    ap.add_argument("--blocks", default="",
                    help="comma-separated graphs.BLOCK values to time the graphed loops at")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_decode_profile.py: no CUDA device", file=sys.stderr)
        return 1
    from functools import partialmethod

    from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR, RuntimeConfig
    from qwen3_asr_tpu_torch.models import decoder
    from qwen3_asr_tpu_torch.runtime import graphs
    from qwen3_asr_tpu_torch.runtime.generate import Generator

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    base = Qwen3ASR.from_random(ModelConfig(), tokenizer=StubTokenizer(),
                                runtime=RuntimeConfig(speculative="off"),
                                dtype=torch.bfloat16, seed=0, device="cuda")
    def sharing(runtime):
        return Qwen3ASR(base._config, base._encoder_params, base._decoder_params,
                        base._tokenizer, RuntimeConfig(**runtime))

    auto, off_int8 = sharing({}), sharing(dict(speculative="off", kv_cache_dtype="int8"))
    models = {
        "off": base, "off-eager": base, "auto": auto, "auto-eager": auto,
        "off-int8": off_int8, "off-int8-eager": off_int8, "mode4": base, "mode4-eager": base,
    }
    #: The decode kernel mode each loop runs under (decoder.DECODE_KERNEL_MODE).
    modes = {"mode4": "4", "mode4-eager": "4"}
    clips = smoke_clips()
    calls = {
        "B=8": lambda m: m.transcribe_batch(clips, max_tokens=64),
        "B=1": lambda m: [m.transcribe(clips[-1], max_tokens=64)],
    }
    real_decode = Generator.decode

    def run_loop(name, call, block=None):
        saved = decoder.DECODE_KERNEL_MODE, graphs.BLOCK
        decoder.DECODE_KERNEL_MODE = modes.get(name, saved[0])
        graphs.BLOCK = block or saved[1]
        if name.endswith("-eager"):
            Generator.decode = partialmethod(real_decode, eager=True)
        try:
            call(models[name])
        finally:
            decoder.DECODE_KERNEL_MODE, graphs.BLOCK = saved
            Generator.decode = real_decode

    def report(label, name, m, how="unprofiled"):
        st = m.last_stats
        ms = st.stages["decode"] * 1e3
        print(f"[{card}] {label} {name} {how}: "
              f"decode {ms:.1f} ms over {st.n_decode_steps} iterations "
              f"({st.n_decode_replays} run, {st.n_host_syncs} host syncs) = "
              f"{ms / max(st.n_decode_steps, 1):.3f} ms/iteration, "
              f"{ms / st.n_generated_tokens:.3f} ms per emitted token")

    for name in models:
        for call in calls.values():
            run_loop(name, call)
    torch.cuda.synchronize()
    blocks = [int(b) for b in args.blocks.split(",") if b]
    for run in range(2 * args.runs):
        for label, call in calls.items():
            for name in ("off", "auto"):
                for block in blocks if run % 2 == 0 else blocks[::-1]:
                    run_loop(name, call, block)
                    report(label, name, models[name], f"graphed, BLOCK={block}")
    # Unprofiled decode times, the loops in turns.
    order = ("off", "off-eager", "auto", "auto-eager", "off-int8", "off-int8-eager", "mode4",
             "mode4-eager")
    for run in range(args.runs):
        for label, call in calls.items():
            for name in order + order[::-1]:
                run_loop(name, call)
                report(label, name, models[name])
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for run in range(args.runs):
        for label, call in calls.items():
            for name, m in models.items():
                with torch.profiler.profile(activities=acts) as prof:
                    run_loop(name, call)
                    torch.cuda.synchronize()
                path = out / f"{name}_{label}_{run}.json"
                prof.export_chrome_trace(str(path))
                w = decode_window(json.loads(path.read_text()))
                st = m.last_stats
                it = max(st.n_decode_replays, 1)        # steps run, no-op ones included
                write_counts(out / f"counts_{name}_{label}_{run}.json", w["counts"], it)
                print(f"[{card}] {label} {name} run {run}: "
                      f"decode {w['wall_us'] / 1e3:.1f} ms (profiled) over {st.n_decode_steps} "
                      f"iterations ({st.n_decode_replays} run), {st.n_generated_tokens} tokens; "
                      f"{w['kernels'] / it:.0f} kernels, {w['copies'] / it:.1f} device copies "
                      f"(memcpy), {w['fills'] / it:.1f} fills (memset), and "
                      f"{w['kernel_us'] / 1e3 / it:.3f} kernel-ms per iteration run; "
                      f"device busy {w['busy']:.1%}; top kernels (us): "
                      + ", ".join(f"{n} {d:.0f}" for n, d in w["top"]))
                path.unlink()
    if not args.no_engine:
        engine_profile(card, base, clips, args.runs, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
