#!/usr/bin/env python3
"""Serving A/B of the PyTorch port on one CUDA GPU: batch-then-drain against
in-flight continuous batching, and open-loop Poisson load (the port of
``tools/serving_bench.py``).

    python3 tools/torch_serving_bench.py [--paged | --flat] [--n-short 12] [--wave-size 4]
        [--kv-dtype bf16|int8] [--spec auto|on|off] [--n-slots 16]
    python3 tools/torch_serving_bench.py --arrival poisson [--rates 2 5 10] [--n-requests 48]

Burst workload (default): one long-budget request arrives first and starts
decoding; short requests then arrive in WAVES while it runs, an open-loop
arrival pattern rather than one burst (a single burst is the drain server's
best case: it forms one batch, and continuous batching can only add
overhead; under sustained arrivals the drain server's head-of-line
blocking serializes each wave behind the long decode, while the continuous
server admits every wave at the next chunk boundary).  Each server runs the
exact workload once to capture its graphs, then the measured pass.

Poisson workload (``--arrival poisson``): open-loop arrivals at each
``--rates`` point (requests a second; times the clip's seconds = the
offered RTFx) against the continuous server: p50/p99 TTFT and completion
latency per offered load.  A run whose done-callbacks do not all arrive
raises rather than printing a row built on lost requests.

The model is ``Qwen3ASR.from_random(ModelConfig(), seed=None)``: the
published 1.7B widths with zero weights (timing does not depend on the
weights; zero weights emit a constant stream, so speculation's acceptance,
and its win, read at the UPPER bound).  Each pass reports the CUDA graph
captures it made (0 when the warm-up covered every bucket).  Prints the
card's ``nvidia-smi`` name and power limit first, progress on stderr and
one JSON line (``serving_mixed_workload`` or ``serving_poisson_load``).
Needs a CUDA device (exits 1 without one); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


class StubTok:
    def encode(self, text):
        return [sum(map(ord, text)) % 150000 + 1]

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))

    def build_prompt(self, n_audio_tokens, language="English"):
        from qwen3_asr_tpu_torch.tokenizer import build_prompt

        return build_prompt(n_audio_tokens, self.encode(f" {language}"))


def clip(sec: float, f: float = 440.0) -> np.ndarray:
    t = np.arange(int(sec * 16000)) / 16000
    return (0.3 * np.sin(2 * np.pi * f * t)).astype(np.float32)


def captures(server) -> int:
    """CUDA graph captures so far behind ``server``: the continuous
    server's engine chunks, or the drain server's model's decode loops."""
    engine = getattr(server, "_engine", None)
    graphs = engine.graphs if engine is not None else server._model._generator.graphs
    return graphs.captures if graphs is not None else 0


def run_workload(
    server, long_clip, short_clips, long_budget, short_budget,
    wave_size=4, wave_interval=0.5,
):
    """Submit the long clip, then the shorts in timed waves while it decodes.
    Returns (wall seconds, the shorts' latencies)."""
    t0 = time.time()
    f_long = server.submit(long_clip, max_tokens=long_budget)
    time.sleep(0.05)
    pending = []  # (future, submit time)
    for w0 in range(0, len(short_clips), wave_size):
        for c in short_clips[w0 : w0 + wave_size]:
            pending.append((server.submit(c, max_tokens=short_budget), time.time()))
        time.sleep(wave_interval)
    short_lat = []
    for f, t_sub in pending:
        f.result(timeout=1200)
        short_lat.append(time.time() - t_sub)
    f_long.result(timeout=1200)
    return time.time() - t0, short_lat


def run_poisson(server, clip_sec, n_requests, rate, budget, seed=0, callback_timeout=60.0):
    """Open-loop Poisson arrivals at ``rate`` req/s against ``server``.

    Returns (wall_s, ttfts, latencies) over the ``n_requests`` requests.
    Open-loop: submission ignores the server's backpressure, so queueing
    shows as TTFT growth rather than as a throttled offered load.  A
    future's ``result()`` returns before its done-callbacks run, so the
    records are awaited up to ``callback_timeout`` seconds after the last
    result; RuntimeError when fewer than ``n_requests`` came back.
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, n_requests)
    c = clip(clip_sec, 260.0)
    recs = []
    lock = threading.Lock()
    all_done = threading.Event()
    futs = []
    t_start = time.time()
    for i in range(n_requests):
        time.sleep(gaps[i])
        t0 = time.time()
        fut = server.submit(c, max_tokens=budget)

        def _done(f, t0=t0):
            tdone = time.time()
            with lock:
                recs.append((t0, tdone, getattr(f, "ttft_s", float("nan"))))
                if len(recs) == n_requests:
                    all_done.set()

        fut.add_done_callback(_done)
        futs.append(fut)
    for f in futs:
        f.result()
    if not all_done.wait(timeout=callback_timeout):
        with lock:
            got = len(recs)
        raise RuntimeError(
            f"run_poisson: {got} of {n_requests} done-callbacks arrived within "
            f"{callback_timeout} s of the last result")
    wall = time.time() - t_start
    lat = np.array([td - t0 for t0, td, _ in recs])
    ttft = np.array([t for *_, t in recs])
    return wall, ttft, lat


def make_model(args):
    import torch

    from qwen3_asr_tpu_torch import ModelConfig, Qwen3ASR, RuntimeConfig

    print("[serving-bench] loading 1.7B zero-init", file=sys.stderr, flush=True)
    model = Qwen3ASR.from_random(
        ModelConfig(), tokenizer=StubTok(),
        runtime=RuntimeConfig(kv_cache_dtype=args.kv_dtype, spec_engine=args.spec),
        seed=None,
    )
    torch.cuda.reset_peak_memory_stats()
    return model


def peak_gib() -> float:
    import torch

    return round(torch.cuda.max_memory_allocated() / 2**30, 3)


def poisson_study(args) -> int:
    """Sustained load on the continuous engine: p50/p99 TTFT and completion
    latency at each offered load (audio seconds submitted a wall second =
    rate x clip seconds; below the achieved capacity queues stay bounded,
    beyond it TTFT diverges)."""
    from qwen3_asr_tpu_torch.serving import ContinuousTranscriptionServer

    model = make_model(args)
    rows = []
    srv = ContinuousTranscriptionServer(
        model,
        n_slots=args.n_slots,
        max_duration=args.short_sec + 1,
        max_new_tokens=args.short_budget,
        chunk_steps=args.chunk_steps,
        admit_batch=args.admit_batch,
        paged=args.paged,
        warm=(args.short_sec,),
    )
    with srv:
        # One saturating burst captures every admission width and the steady
        # decode widths, so the measured passes replay captured graphs only.
        warm_futs = [
            srv.submit(clip(args.short_sec, 300.0), max_tokens=args.short_budget)
            for _ in range(max(8, args.n_slots))
        ]
        for f in warm_futs:
            f.result()
        for rate in args.rates:
            before = captures(srv)
            wall, ttft, lat = run_poisson(
                srv, args.short_sec, args.n_requests, rate, args.short_budget, seed=1,
            )
            row = {
                "rate_rps": rate,
                "offered_rtfx": round(rate * args.short_sec, 1),
                "achieved_rtfx": round(args.n_requests * args.short_sec / wall, 1),
                "n_requests": args.n_requests,
                "ttft_p50_s": round(float(np.nanpercentile(ttft, 50)), 3),
                "ttft_p99_s": round(float(np.nanpercentile(ttft, 99)), 3),
                "latency_p50_s": round(float(np.percentile(lat, 50)), 3),
                "latency_p99_s": round(float(np.percentile(lat, 99)), 3),
                "captures": captures(srv) - before,
            }
            st = srv.engine_stats
            if st.spec_chunks:
                row["spec_tokens_per_forward"] = round(st.spec_tokens_per_forward, 2)
            rows.append(row)
            print(f"[serving-bench] poisson {row}", file=sys.stderr, flush=True)
    print(json.dumps({
        "metric": "serving_poisson_load",
        "paged": args.paged,
        "spec": args.spec,
        "kv_dtype": args.kv_dtype,
        "n_slots": args.n_slots,
        "clip_sec": args.short_sec,
        "budget": args.short_budget,
        "peak_memory_gib": peak_gib(),
        "points": rows,
    }))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--paged", action="store_true", default=True,
        help="paged KV engine (default)",
    )
    ap.add_argument(
        "--flat", dest="paged", action="store_false",
        help="flat contiguous-cache engine (A/B comparison)",
    )
    ap.add_argument("--n-short", type=int, default=12)
    ap.add_argument("--long-sec", type=float, default=30.0)
    ap.add_argument("--short-sec", type=float, default=30.0)
    ap.add_argument("--long-budget", type=int, default=512)
    ap.add_argument("--short-budget", type=int, default=64)
    ap.add_argument("--n-slots", type=int, default=16)
    ap.add_argument(
        "--admit-batch", type=int, default=0,
        help="cap the admission group's width (0 = n_slots): the padded prefill of a "
        "full-width group must fit beside the page pool",
    )
    ap.add_argument("--chunk-steps", type=int, default=32)
    ap.add_argument("--wave-size", type=int, default=4)
    ap.add_argument("--wave-interval", type=float, default=0.5)
    ap.add_argument(
        "--kv-dtype", choices=("bf16", "int8"), default="bf16",
        help="engine KV-cache storage (int8 halves the decode read stream)",
    )
    ap.add_argument(
        "--spec", choices=("auto", "on", "off"), default="auto",
        help="engine speculative verify chunks (all-greedy chunks; zero weights emit a "
        "constant stream, so acceptance, and the win, read at the UPPER bound)",
    )
    ap.add_argument(
        "--arrival", choices=("burst", "poisson"), default="burst",
        help="burst = the long + waves A/B (default); poisson = open-loop sustained "
        "load on the continuous engine (p50/p99 TTFT and latency at each --rates point)",
    )
    ap.add_argument(
        "--rates", type=float, nargs="+", default=[2.0, 5.0, 10.0],
        help="poisson offered loads in requests/s (x clip seconds = offered RTFx)",
    )
    ap.add_argument("--n-requests", type=int, default=48)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_serving_bench.py: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_identity

    print(card_identity(), flush=True)
    if args.arrival == "poisson":
        return poisson_study(args)

    from qwen3_asr_tpu_torch.serving import ContinuousTranscriptionServer, TranscriptionServer

    model = make_model(args)
    long_c = clip(args.long_sec, 220.0)
    shorts = [clip(args.short_sec, 300.0 + 20 * i) for i in range(args.n_short)]
    audio_total = args.long_sec + args.n_short * args.short_sec

    results = {}
    for name in ("batch_drain", "continuous"):
        if name == "batch_drain":
            srv = TranscriptionServer(model, max_batch_size=args.n_slots)
        else:
            srv = ContinuousTranscriptionServer(
                model,
                n_slots=args.n_slots,
                max_duration=max(args.long_sec, args.short_sec) + 1,
                max_new_tokens=args.long_budget,
                chunk_steps=args.chunk_steps,
                admit_batch=args.admit_batch,
                paged=args.paged,
                warm=(args.long_sec, args.short_sec)
                if args.long_sec != args.short_sec
                else (args.long_sec,),
            )
        with srv:
            # Warm: the exact workload once, so every bucket (admission
            # group sizes, batch widths, token buckets) is captured before
            # the measured pass.
            run_workload(srv, long_c, shorts, args.long_budget, args.short_budget,
                         args.wave_size, args.wave_interval)
            before = captures(srv)
            wall, short_lat = run_workload(srv, long_c, shorts, args.long_budget,
                                           args.short_budget, args.wave_size,
                                           args.wave_interval)
            made = captures(srv) - before
        results[name] = {
            "wall_s": round(wall, 3),
            "rtfx": round(audio_total / wall, 1),
            "short_p50_s": round(float(np.median(short_lat)), 3),
            "short_p95_s": round(float(np.percentile(short_lat, 95)), 3),
            "captures": made,
        }
        if name == "continuous":
            st = srv.engine_stats
            if st.spec_chunks:
                results[name]["spec_tokens_per_forward"] = round(st.spec_tokens_per_forward, 2)
        print(f"[serving-bench] {name}: {results[name]}", file=sys.stderr, flush=True)

    speedup = results["batch_drain"]["wall_s"] / results["continuous"]["wall_s"]
    print(json.dumps({
        "metric": "serving_mixed_workload",
        "paged": args.paged,
        "spec": args.spec,
        "kv_dtype": args.kv_dtype,
        "audio_seconds": audio_total,
        **{f"{k}_{m}": v for k, r in results.items() for m, v in r.items()},
        "continuous_speedup": round(speedup, 2),
        "short_latency_ratio": round(
            results["batch_drain"]["short_p50_s"]
            / max(results["continuous"]["short_p50_s"], 1e-9), 2,
        ),
        "peak_memory_gib": peak_gib(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
