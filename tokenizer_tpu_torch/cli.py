"""Console CLI of the port, mirroring the JAX package's (and the
reference console app).

``tokenizer-tpu-torch <model> <text>`` prints each token id with its
decoded string and the round-trip decode, like ``Tokenizer.exe``
(`Tokenizer_C#/Tokenizer/Program.cs:7-36`).  Extra subcommands expose
the bulk paths:

* ``tokenizer-tpu-torch encode-file <model> <path>`` — token count +
  throughput for a file.
* ``tokenizer-tpu-torch bench ...`` — the perf harness (see
  :mod:`tokenizer_tpu_torch.runtime.perf`).
* ``tokenizer-tpu-torch corpus ...`` — the chunked, resumable,
  shard-parallel bulk encode (see
  :mod:`tokenizer_tpu_torch.runtime.pipeline`).

Every subcommand runs on the card unless ``--device cpu`` asks for the
plain PyTorch merge on the host; ``corpus --no-gpu`` takes the host
engine.  ``--device cuda`` without a card raises.
"""

from __future__ import annotations

import argparse
import sys
import time


def _make_tokenizer(name: str, device="cuda"):
    """Model name first (the reference CLI's contract), then encoder
    name as a convenience (so `cl100k_synth`/`gpt2` work directly)."""
    from .builder import create_by_encoder_name, create_by_model_name

    try:
        return create_by_model_name(name, device=device)
    except ValueError:
        return create_by_encoder_name(name, device=device)


def _cmd_tokenize(args) -> int:
    tokenizer = _make_tokenizer(args.model, device=args.device)
    ids = tokenizer.encode(args.text, allowed_special="all")
    # Program.cs:19-27: print "<id> : <decoded piece>" per token, then the
    # round-trip decode of the whole sequence.
    for tid in ids:
        print(f"{tid} : {tokenizer.decode([tid])}")
    print(tokenizer.decode(ids))
    return 0


def _cmd_encode_file(args) -> int:
    tokenizer = _make_tokenizer(args.model, device=args.device)
    data = open(args.path, "r", encoding="utf-8", errors="replace").read()
    t0 = time.perf_counter()
    ids = tokenizer.encode_batch([data])[0]
    dt = time.perf_counter() - t0
    nbytes = len(data.encode("utf-8"))
    print(f"tokens: {len(ids)}")
    print(f"bytes: {nbytes}")
    print(f"seconds: {dt:.4f}")
    print(f"MB/s: {nbytes / dt / 1e6:.2f}")
    return 0


def _cmd_bench(args) -> int:
    import json

    from .runtime.perf import run_folder_benchmark

    result = run_folder_benchmark(
        args.folder,
        model=args.model,
        min_seconds=args.min_seconds,
        min_cycles=args.min_cycles,
        device=args.device,
    )
    print(json.dumps(result))
    return 0


def _cmd_corpus(args) -> int:
    """Production bulk encode: chunked, resumable, shard-parallel.

    Wraps :func:`tokenizer_tpu_torch.runtime.pipeline.encode_corpus` —
    the multi-process entry point (shard defaults to this process's rank
    in the torch.distributed job, e.g. under torchrun; output order
    restored by stable (shard, chunk, doc) indices).
    """
    import json

    from .parallel import multihost
    from .runtime.pipeline import encode_corpus, iter_corpus_files

    multihost.initialize()
    tokenizer = _make_tokenizer(
        args.model, device=None if args.no_gpu else args.device
    )
    # Unreadable files fail the run by default (a silent skip would
    # shift every later document's shard slot and desync resume
    # digests); --skip-unreadable opts into counted, logged skipping.
    skipped: list = []

    def _on_skip(path, exc):
        skipped.append(str(path))
        print(f"corpus: skipping unreadable {path}: {exc}", file=sys.stderr)

    progress = encode_corpus(
        iter_corpus_files(
            args.paths, on_skip=_on_skip if args.skip_unreadable else None
        ),
        tokenizer,
        args.out,
        chunk_bytes=args.chunk_bytes,
        shard=args.shard,
        n_shards=args.n_shards,
        allowed_special="all" if args.allow_specials else None,
        resume=not args.no_resume,
    )
    totals = multihost.all_sum(
        [progress.docs, progress.bytes_in, progress.tokens_out]
    )
    report = {
        "shard": progress.shard,
        "n_shards": progress.n_shards,
        "chunks_done": progress.chunks_done,
        "shard_bytes_in": progress.bytes_in,
        "shard_tokens_out": progress.tokens_out,
        "shard_seconds": round(progress.seconds, 3),
        "shard_MBps": round(
            progress.bytes_in / progress.seconds / 1e6, 2
        )
        if progress.seconds
        else None,
        "global_docs": int(totals[0]),
        "global_bytes_in": int(totals[1]),
        "global_tokens_out": int(totals[2]),
        "skipped_files": len(skipped),
    }
    print(json.dumps(report))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="tokenizer-tpu-torch",
        description="tiktoken-compatible BPE tokenizer with its merge on a CUDA card",
    )
    sub = parser.add_subparsers(dest="cmd")
    device = argparse.ArgumentParser(add_help=False)
    device.add_argument(
        "--device",
        default="cuda",
        help="where the merge runs: cuda (default), cuda:N, or cpu (plain PyTorch merge)",
    )

    # Default / positional form: <model> <text>  (Program.cs:12-16).
    p_tok = sub.add_parser("tokenize", parents=[device], help="tokenize a string")
    p_tok.add_argument("model")
    p_tok.add_argument("text")
    p_tok.set_defaults(fn=_cmd_tokenize)

    p_file = sub.add_parser(
        "encode-file", parents=[device], help="encode a file, print stats"
    )
    p_file.add_argument("model")
    p_file.add_argument("path")
    p_file.set_defaults(fn=_cmd_encode_file)

    p_bench = sub.add_parser(
        "bench", parents=[device], help="folder throughput benchmark"
    )
    p_bench.add_argument("folder")
    p_bench.add_argument("--model", default="gpt2")
    p_bench.add_argument("--min-seconds", type=float, default=10.0)
    p_bench.add_argument("--min-cycles", type=int, default=5)
    p_bench.set_defaults(fn=_cmd_bench)

    p_corpus = sub.add_parser(
        "corpus",
        parents=[device],
        help="bulk-encode a corpus (chunked, resumable, sharded)",
    )
    p_corpus.add_argument("paths", nargs="+", help="files or directories")
    p_corpus.add_argument("--out", required=True, help="output directory")
    p_corpus.add_argument("--model", default="gpt2")
    p_corpus.add_argument("--chunk-bytes", type=int, default=8 << 20)
    p_corpus.add_argument("--shard", type=int, default=None)
    p_corpus.add_argument("--n-shards", type=int, default=None)
    p_corpus.add_argument("--allow-specials", action="store_true")
    p_corpus.add_argument("--no-resume", action="store_true")
    p_corpus.add_argument(
        "--skip-unreadable",
        action="store_true",
        help="skip unreadable corpus files (counted + logged) instead of"
        " failing; skipping shifts shard assignment of later documents,"
        " so resume digests will catch any divergence loudly",
    )
    p_corpus.add_argument(
        "--no-gpu", action="store_true", help="the host engine, no merge kernel"
    )
    p_corpus.set_defaults(fn=_cmd_corpus)

    argv = list(sys.argv[1:] if argv is None else argv)
    # Bare "<model> <text>" without a subcommand, like Tokenizer.exe.
    if argv and argv[0] not in {"tokenize", "encode-file", "bench", "corpus", "-h", "--help"}:
        argv = ["tokenize", *argv]
    args = parser.parse_args(argv)
    if not hasattr(args, "fn"):
        parser.print_help()
        return 2
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
