#!/usr/bin/env python3
"""Token streams of the smoke's 1.7B paths, to compare two trees of the port
on one CUDA GPU.

    python3 tools/torch_streams.py --out FILE
    python3 tools/torch_streams.py --compare A B

The first form builds ``chip_smoke``'s 1.7B model from random weights (seed
0, bf16) and runs, greedy with ``max_tokens=64`` unless noted, the smoke
batch (8 clips of 4-30 s, ``transcribe_batch``) and its 30 s clip
(``transcribe``) through: the plain loop (``speculative="off"``), the
default speculative loop, decode modes "3" and "4" and the "pallas" stem
(B=8), sampled B=8 (T=0.7, top_k 50, top_p 0.9, seed 1), sampled
speculative and int8-weights speculative (B=1), long-form (two 20 s clips
in 8 s chunks), the continuous engine under each of ``chip_smoke``'s server
configurations (the batch admitted at once, as
``tools/torch_decode_profile.py`` runs it: the smoke's two-wave server
admits by the clock) and the int8 model (``chip_smoke.INT8_RUNTIME``, its
own random weights).  It writes ``{path: [[token, ...], ...]}`` to FILE as
JSON.  The second form compares two such files path by path: identical, or
the first lane and position where they differ; it exits 1 on any
difference.

It uses ``chip_smoke``'s and ``torch_decode_profile``'s helpers from its
own tree, so a copy of this file and of ``tools/torch_decode_profile.py``
placed in an older tree runs that tree's package.  Needs a CUDA device for
the first form; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

SAMPLE_KW = dict(max_tokens=64, temperature=0.7, top_k=50, top_p=0.9, seed=1)


def long_clips():
    """The smoke's two 20 s long-form clips (quiet pockets at 8 s and 16 s)."""
    import numpy as np

    from chip_smoke import SEED

    rng = np.random.default_rng(SEED + 1)
    out = []
    for f in (230.0, 410.0):
        t = np.arange(20 * 16000) / 16000.0
        x = 0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(len(t))
        for pocket in (8.0, 16.0):
            x[int(pocket * 16000) - 1600 : int(pocket * 16000) + 1600] *= 0.01
        out.append(x.astype(np.float32))
    return out


def in_mode(module, attr: str, mode: str, fn):
    saved = getattr(module, attr)
    setattr(module, attr, mode)
    try:
        return fn()
    finally:
        setattr(module, attr, saved)


def streams() -> dict:
    import torch

    from chip_smoke import INT8_RUNTIME, SERVER_PATHS, _ids, build_model, smoke_clips
    from qwen3_asr_tpu_torch.models import decoder as dec_mod
    from qwen3_asr_tpu_torch.models import encoder as enc_mod
    from torch_decode_profile import engine_run

    clips = smoke_clips()
    out = {}

    def both(label, model, **kw):
        out[f"{label} B=8"] = _ids(model.transcribe_batch(clips, max_tokens=64, **kw))
        out[f"{label} B=1"] = _ids([model.transcribe(clips[-1], max_tokens=64, **kw)])

    base = build_model({"speculative": "off"})
    both("plain", base)
    for mode in ("3", "4"):
        out[f"decode mode {mode} B=8"] = in_mode(
            dec_mod, "DECODE_KERNEL_MODE", mode,
            lambda: _ids(base.transcribe_batch(clips, max_tokens=64)))
    out["stem pallas B=8"] = in_mode(enc_mod, "CONV_STEM_MODE", "pallas",
                                     lambda: _ids(base.transcribe_batch(clips, max_tokens=64)))
    auto = build_model({}, base)
    both("speculative", auto)
    out["sampled B=8"] = _ids(auto.transcribe_batch(clips, **SAMPLE_KW))
    out["long-form B=2"] = _ids(auto.transcribe_batch(long_clips(), chunk_duration=8.0))
    for label, runtime, fn in (
        ("sampled speculative B=1", {"spec_sampling": True},
         lambda m: m.transcribe(clips[-1], **SAMPLE_KW)),
        ("int8-weights speculative B=1", {"quantization": "int8"},
         lambda m: m.transcribe(clips[-1], max_tokens=64)),
    ):
        model = build_model(runtime, base)
        out[label] = _ids([fn(model)])
        model.close()
        del model
        torch.cuda.empty_cache()
    for label, (runtime, paged, *_) in SERVER_PATHS.items():
        model = build_model(runtime, base)
        engine = model.make_engine(n_slots=8, max_duration=30.0, max_new_tokens=512,
                                   chunk_steps=16, paged=paged)
        out[f"engine {label}"] = engine_run(model, engine, clips)[1]
        engine.close()
        del model, engine
        torch.cuda.empty_cache()
    auto.close()
    base.close()
    del auto, base
    torch.cuda.empty_cache()
    int8 = build_model(INT8_RUNTIME)
    both("int8", int8)
    int8.close()
    return out


def compare(a: dict, b: dict) -> bool:
    same = True
    for path in sorted(set(a) | set(b)):
        if path not in a or path not in b:
            print(f"{path}: only in {'the first' if path in a else 'the second'} file")
            same = False
            continue
        diff = [(lane, next((i for i, (x, y) in enumerate(zip(s, t)) if x != y),
                            min(len(s), len(t))))
                for lane, (s, t) in enumerate(zip(a[path], b[path])) if s != t]
        if len(a[path]) != len(b[path]) or diff:
            print(f"{path}: differs (lane, first position): {diff}")
            same = False
        else:
            print(f"{path}: identical ({sum(map(len, a[path]))} tokens)")
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path)
    ap.add_argument("--compare", nargs=2, type=Path)
    args = ap.parse_args()
    if args.compare:
        a, b = (json.loads(p.read_text()) for p in args.compare)
        return 0 if compare(a, b) else 1
    if args.out is None:
        ap.error("give --out FILE or --compare A B")
    import torch

    if not torch.cuda.is_available():
        print("torch_streams.py: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import card_identity

    print(card_identity())
    got = streams()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(got))
    print(f"{len(got)} paths, {sum(len(s) for v in got.values() for s in v)} tokens "
          f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
