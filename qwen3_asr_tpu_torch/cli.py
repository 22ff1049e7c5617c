"""Command-line interface: ``python -m qwen3_asr_tpu_torch <audio files...>``.

Counterpart of ``qwen3_asr_tpu/cli.py``, with the same flags.  Prints one
transcript per input file; ``--json`` emits structured records with
per-request telemetry; ``--stream`` prints segments as they finalize at
low-energy boundaries (``StreamingTranscriber``), ``--live`` a refreshed
preview every REFRESH_SECONDS of audio (``IncrementalSession``).  The model
loads through ``Qwen3ASR.from_pretrained`` from a local checkpoint
directory onto the GPU.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qwen3_asr_tpu_torch",
        description="Qwen3-ASR speech-to-text on an NVIDIA GPU (PyTorch)",
    )
    p.add_argument("audio", nargs="+", help="audio file path(s)")
    p.add_argument("--model", required=True, help="checkpoint directory")
    p.add_argument("--language", default=None, help="language hint (e.g. en, German)")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--repetition-penalty", type=float, default=1.2)
    p.add_argument("--max-tokens", type=int, default=None)
    p.add_argument("--chunk-duration", type=float, default=1200.0)
    p.add_argument("--batch", action="store_true", help="transcribe files as one batch")
    p.add_argument("--json", action="store_true", help="emit JSON records")
    p.add_argument("--warm-up", action="store_true",
                   help="build the kernels and capture the decode graphs first")
    p.add_argument(
        "--stream",
        type=float,
        metavar="SEGMENT_SECONDS",
        default=None,
        help="streaming mode: feed each file incrementally and print "
        "segments as they finalize at low-energy boundaries",
    )
    p.add_argument(
        "--live",
        type=float,
        metavar="REFRESH_SECONDS",
        default=None,
        help="live-caption mode: feed each file incrementally and print "
        "a refreshed preview every REFRESH_SECONDS of audio (incremental "
        "decoder-prefix cache; token-identical to offline in float32)",
    )
    p.add_argument(
        "--no-spec",
        action="store_true",
        help="disable speculative greedy decoding (default: auto at "
        "batch <= 8; token-identical either way)",
    )
    p.add_argument(
        "--int8-weights",
        action="store_true",
        help="int8 weight-only quantization (small accuracy trade)",
    )
    p.add_argument(
        "--int8-kv",
        action="store_true",
        help="int8 KV cache (halves KV memory and bandwidth; small accuracy "
        "trade)",
    )
    p.add_argument(
        "--int8-act",
        action="store_true",
        help="with --int8-weights: also quantize prefill activations "
        "(W8A8 prefill and encoder; small extra accuracy trade)",
    )
    p.add_argument(
        "--spec-sampling",
        action="store_true",
        help="speculative decoding for sampled (temperature > 0) "
        "requests via rejection-sampling verification: exact sampling "
        "distribution, but per-seed streams differ from the plain "
        "sampler",
    )
    p.add_argument(
        "--compile-cache",
        default=None,
        metavar="DIR",
        help="RuntimeConfig.compile_cache_dir (kept for the JAX package's "
        "flag set; the port compiles no XLA programs)",
    )
    return p


def _emit_live_seg(args, path, seg) -> None:
    """Finalized-segment record for the --live long-audio fallback."""
    if args.json:
        print(json.dumps({
            "file": str(path), "start": seg.start,
            "end": seg.end, "text": seg.text, "final": True,
        }))
    else:
        print(f"{path} [{seg.start:.1f}-{seg.end:.1f}s]: {seg.text}")


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from .api import Qwen3ASR

    rt_kw = {}
    if args.no_spec:
        rt_kw["speculative"] = "off"
        rt_kw["spec_engine"] = "off"
    if args.int8_weights:
        rt_kw["quantization"] = "int8"
    if args.int8_kv:
        rt_kw["kv_cache_dtype"] = "int8"
    if args.int8_act:
        if not args.int8_weights:
            print("--int8-act requires --int8-weights", file=sys.stderr)
            return 2
        rt_kw["act_quant"] = "int8"
    if args.spec_sampling:
        rt_kw["spec_sampling"] = True
    if args.compile_cache:
        rt_kw["compile_cache_dir"] = args.compile_cache
    if rt_kw:
        from .config import RuntimeConfig

        model = Qwen3ASR.from_pretrained(args.model, runtime=RuntimeConfig(**rt_kw))
    else:
        model = Qwen3ASR.from_pretrained(args.model)
    if args.warm_up:
        model.warm_up()

    opts = dict(
        language=args.language,
        temperature=args.temperature,
        top_p=args.top_p,
        top_k=args.top_k,
        repetition_penalty=args.repetition_penalty,
        max_tokens=args.max_tokens,
    )

    def emit(path, result):
        if args.json:
            record = {
                "file": str(path),
                "text": result.text,
                "language": result.language,
                "duration": result.duration,
            }
            if model.last_stats is not None:
                record["stats"] = model.last_stats.as_dict()
            print(json.dumps(record))
        else:
            print(f"{path}: {result.text}")

    if args.live is not None:
        from .audio.io import SAMPLE_RATE, load_audio

        for path in args.audio:
            audio = load_audio(path)
            piece = max(1, int(args.live * SAMPLE_RATE))
            try:
                session = model.incremental_session(
                    max_duration=max(30.0, len(audio) / SAMPLE_RATE + 1.0),
                    **opts,
                )
            except ValueError as exc:
                # Audio longer than the largest frame bucket (20 min by
                # default), or a runtime the session refuses, falls back to
                # --stream-style segmented previews instead of failing.
                print(f"{path}: {exc}; falling back to segmented streaming",
                      file=sys.stderr)
                from .audio.mel import HOP_LENGTH
                from .streaming import StreamingTranscriber

                bucket_s = model._runtime.frame_buckets[-1] * HOP_LENGTH / SAMPLE_RATE
                stream = StreamingTranscriber(
                    model, segment_duration=max(6.0, min(30.0, bucket_s - 6.0)), **opts,
                )
                for i in range(0, len(audio), piece):
                    for seg in stream.feed(audio[i : i + piece]):
                        _emit_live_seg(args, path, seg)
                for seg in stream.flush():
                    _emit_live_seg(args, path, seg)
                continue
            for i in range(0, len(audio), piece):
                session.feed(audio[i : i + piece])
                p = session.preview()
                if args.json:
                    print(json.dumps({
                        "file": str(path), "t": session.duration,
                        "text": p.text, "final": False,
                    }))
                else:
                    print(f"{path} [{session.duration:6.1f}s] {p.text}")
        return 0

    if args.stream is not None:
        from .audio.io import SAMPLE_RATE, load_audio
        from .streaming import StreamingTranscriber

        def emit_seg(path, seg):
            if args.json:
                print(json.dumps({
                    "file": str(path), "start": seg.start,
                    "end": seg.end, "text": seg.text,
                }))
            else:
                print(f"{path} [{seg.start:.1f}-{seg.end:.1f}s]: {seg.text}")

        for path in args.audio:
            audio = load_audio(path)
            piece = 5 * SAMPLE_RATE
            session = StreamingTranscriber(model, segment_duration=args.stream, **opts)
            for i in range(0, len(audio), piece):
                for seg in session.feed(audio[i : i + piece]):
                    emit_seg(path, seg)
            for seg in session.flush():
                emit_seg(path, seg)
            if not args.json:
                print(f"{path}: {session.text}")
    elif args.batch:
        for path, result in zip(args.audio, model.transcribe_batch(args.audio, **opts)):
            emit(path, result)
    else:
        for path in args.audio:
            emit(path, model.transcribe(path, chunk_duration=args.chunk_duration, **opts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
