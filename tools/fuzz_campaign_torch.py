"""Long-horizon randomized differential campaign of the PyTorch / CUDA port.

The port's counterpart of ``tools/fuzz_campaign.py``: random (encoding,
threads, subseg, dedup bound, route, specials, batch, budgets, API)
configurations of ``GpuTokenizer`` against the port's host
``TikTokenizer``, with the same atoms and iteration bodies.  Forced
device routing uses the port's knobs (``_host_wave_max = 0``,
``_host_pp = inf``).

Usage:

    python tools/fuzz_campaign_torch.py <mode> <seed> <seconds> [--device cuda|cpu]

where mode is ``encode`` (encode_batch / stream / single / decode
round-trip), ``trim`` (bulk suffix and prefix trims against the host
loop, budgets 0-30, both suffix modes), ``threads`` (one tokenizer, four
threads) or ``mesh`` (every wave sharded over a mesh: all of this
process's cards, two shards of ``cuda:0`` on a one-card host, eight
``cpu`` shards with ``--device cpu``).  The device defaults to the card.
Exit 0 = every iteration matched; exit 1 prints the failing
configuration (the draws are a pure function of the seed and the
iteration index, so a report replays by fast-forwarding them).
"""

from __future__ import annotations

import argparse
import math
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tokenizer_tpu_torch.engine import TikTokenizer
from tokenizer_tpu_torch.gpu import GpuTokenizer
from tokenizer_tpu_torch.models.registry import get_encoding_spec
from tokenizer_tpu_torch.vocab import Vocabulary

# Atom soup tuned to cross every scanner class boundary: ASCII words,
# digit runs, CJK, combining-free Latin-1, astral pairs, contractions
# (upper/lower), specials, long single-piece runs, whitespace shapes.
ATOMS = [
    "abc", "QRS", "xyz ", "0", "12", "345 ", "你好", "世界", "こん",
    "é", "ß", "💩", "⭐", "𝄞", "'ll", "'VE", "'s", "!", "@#$", " ",
    "\t", "\n", "\r\n", "/", "<|endoftext|>", "a" * 40, "好" * 30,
    " " * 6, "9" * 12, "\ud800", "a\udfff",
]

ENCODINGS = ["gpt2", "cl100k_synth", "o200k_synth"]

_VOCABS: dict = {}


def get(enc: str):
    if enc not in _VOCABS:
        v = Vocabulary.for_encoding(enc, allow_fetch=False)
        s = get_encoding_spec(enc)
        _VOCABS[enc] = (v, s, TikTokenizer(v, s.special_tokens, s.pattern))
    return _VOCABS[enc]


def make_tok(rng: random.Random, v, spec, device="cuda") -> GpuTokenizer:
    """Random runtime configuration on one device, with device routing
    FORCED in 40% of draws (every wave to the merge, however small)."""
    os.environ["TOKENIZER_TPU_THREADS"] = str(rng.choice([1, 2, 8]))
    os.environ["TOKENIZER_TPU_SUBSEG_BYTES"] = str(rng.choice([4096, 524288]))
    tok = GpuTokenizer(
        v,
        spec.special_tokens,
        spec.pattern,
        max_unique_rows=rng.choice([600, 1 << 20]),
        device=device,
        mesh=None,
    )
    if rng.random() < 0.4:
        tok._ensure_device()
        tok._host_wave_max = 0
        tok._host_pp = math.inf
    return tok


def iter_encode(rng: random.Random, device="cuda") -> None:
    enc = rng.choice(ENCODINGS)
    v, spec, host = get(enc)
    tok = make_tok(rng, v, spec, device)
    allowed = rng.choice([None, "all"])
    docs = [
        "".join(rng.choice(ATOMS) for _ in range(rng.randint(0, 80)))
        for _ in range(rng.randint(1, 60))
    ]
    want = [host.encode(t, allowed_special=allowed) for t in docs]
    api = rng.choice(["batch", "stream", "single"])
    if api == "batch":
        got = tok.encode_batch(docs, allowed_special=allowed)
        for g, w, t in zip(got, want, docs):
            assert list(g) == w, ("batch", t)
        dec = tok.decode_batch(got)
        for d_, w in zip(dec, want):
            assert d_ == host.decode(w), "decode"
    elif api == "stream":
        k = rng.randint(1, max(len(docs) // 2, 1))
        batches = [docs[i : i + k] for i in range(0, len(docs), k)]
        flat = [
            ids
            for b in tok.encode_batch_stream(iter(batches), allowed_special=allowed)
            for ids in b
        ]
        assert len(flat) == len(docs), "stream length"
        for g, w in zip(flat, want):
            assert list(g) == w, "stream"
    else:
        for t in docs[:10]:
            assert tok.encode(t, allowed_special=allowed) == host.encode(
                t, allowed_special=allowed
            ), ("single", t)


def iter_trim(rng: random.Random, device="cuda") -> None:
    enc = rng.choice(ENCODINGS)
    v, spec, host = get(enc)
    tok = make_tok(rng, v, spec, device)
    allowed = rng.choice([None, "all"])
    docs = [
        "".join(rng.choice(ATOMS) for _ in range(rng.randint(0, 80)))
        for _ in range(rng.randint(1, 40))
    ]
    budgets = [rng.randint(0, 30) for _ in docs]
    mode = rng.choice(["ts", "cs"])
    # Warm BOTH caches first: the reference's trimmed TEXT is LRU-
    # cache-state-dependent (docs/parity.md "Known divergences");
    # warm-cache behavior is the deterministic comparison target.
    for t in docs:
        host.encode(t, allowed_special=allowed)
        tok.encode_trim_suffix(t, 1 << 30, allowed_special=allowed)
    ts = tok.encode_trim_suffix_batch(docs, budgets, allowed_special=allowed, mode=mode)
    tp = tok.encode_trim_prefix_batch(docs, budgets, allowed_special=allowed)
    for t, b, rs, rp in zip(docs, budgets, ts, tp):
        es = host.encode_trim_suffix(t, b, allowed_special=allowed, mode=mode)
        ep = host.encode_trim_prefix(t, b, allowed_special=allowed)
        assert (rs.token_ids, rs.text) == tuple(es), ("suffix", t, b, mode)
        assert (rp.token_ids, rp.text) == tuple(ep), ("prefix", t, b)


def iter_threads(rng: random.Random, device="cuda") -> None:
    """ONE shared tokenizer, four threads each running a random API mix
    (the public entries are thread-safe, like the reference's
    ITokenizer); every thread's results must equal the host engine's.
    Seeded per-thread draws keep each thread deterministic."""
    from concurrent.futures import ThreadPoolExecutor

    enc = rng.choice(ENCODINGS)
    v, spec, host = get(enc)
    tok = make_tok(rng, v, spec, device)
    seeds = [rng.randrange(1 << 30) for _ in range(4)]

    def work(seed):
        r = random.Random(seed)
        for _ in range(3):
            docs = [
                "".join(r.choice(ATOMS) for _ in range(r.randint(0, 40)))
                for _ in range(r.randint(1, 12))
            ]
            api = r.choice(["batch", "trims", "stream"])
            if api == "batch":
                got = tok.encode_batch(docs)
                for g, t in zip(got, docs):
                    assert list(g) == host.encode(t), ("batch", t)
                assert tok.decode_batch(got) == [host.decode(host.encode(t)) for t in docs]
            elif api == "stream":
                flat = [ids for b in tok.encode_batch_stream(iter([docs])) for ids in b]
                for g, t in zip(flat, docs):
                    assert list(g) == host.encode(t), ("stream", t)
            else:
                b = r.randint(1, 30)
                for t in docs:
                    host.encode(t)  # warm the host LRU (docs/parity.md)
                for t, res in zip(docs, tok.encode_trim_suffix_batch(docs, b)):
                    want = host.encode_trim_suffix(t, b)
                    assert (res.token_ids, res.text) == tuple(want), ("trim", t, b)
        return True

    with ThreadPoolExecutor(max_workers=4) as ex:
        assert all(ex.map(work, seeds))


def mesh_devices(device="cuda") -> list:
    """The campaign's mesh: eight ``cpu`` shards on the CPU; on a card,
    all of this process's cards, or two shards of the one there is."""
    from tokenizer_tpu_torch.parallel.mesh import local_devices

    if device == "cpu":
        return ["cpu"] * 8
    local = local_devices()
    if not local:
        raise RuntimeError("mesh mode on the card, but no CUDA card is visible")
    return local if len(local) > 1 else local * 2


_MESH_TOKS: dict = {}


def _mesh_tok(rng: random.Random, enc: str, device="cuda") -> GpuTokenizer:
    """Process-cached mesh tokenizer.  Iterations randomly drop the dedup
    state instead of making a new one; with a small ``max_unique_rows``
    instance this covers cold packs, generational rotation under a
    mesh, and warm wave reuse."""
    key = (enc, rng.random() < 0.3, device)  # (encoding, small-rows instance)
    tok = _MESH_TOKS.get(key)
    if tok is None:
        from tokenizer_tpu_torch.parallel.mesh import data_mesh

        v, spec, _host = get(enc)
        tok = GpuTokenizer(
            v,
            spec.special_tokens,
            spec.pattern,
            max_unique_rows=600 if key[1] else 1 << 20,
            device=device,
            mesh=data_mesh(devices=mesh_devices(device)),
        )
        _MESH_TOKS[key] = tok
    if rng.random() < 0.5:
        tok._reset_dedup_full()
    return tok


def iter_mesh(rng: random.Random, device="cuda") -> None:
    """Every wave runs the sharded merge over the mesh (mesh tokenizers
    route no wave to the host router); encode_batch / stream / bulk trims
    mix, against the host engine."""
    os.environ["TOKENIZER_TPU_THREADS"] = str(rng.choice([1, 2, 8]))
    os.environ["TOKENIZER_TPU_SUBSEG_BYTES"] = str(rng.choice([4096, 524288]))
    enc = rng.choice(ENCODINGS)
    v, spec, host = get(enc)
    tok = _mesh_tok(rng, enc, device)
    assert tok.mesh is not None and tok.mesh.size > 1, "no mesh"
    allowed = rng.choice([None, "all"])
    docs = [
        "".join(rng.choice(ATOMS) for _ in range(rng.randint(0, 60)))
        for _ in range(rng.randint(1, 40))
    ]
    api = rng.choice(["batch", "stream", "trims"])
    if api == "batch":
        got = tok.encode_batch(docs, allowed_special=allowed)
        for g, t in zip(got, docs):
            assert list(g) == host.encode(t, allowed_special=allowed), ("mesh-batch", t)
    elif api == "stream":
        k = rng.randint(1, max(len(docs) // 2, 1))
        batches = [docs[i : i + k] for i in range(0, len(docs), k)]
        flat = [
            ids
            for b in tok.encode_batch_stream(iter(batches), allowed_special=allowed)
            for ids in b
        ]
        assert len(flat) == len(docs), "mesh-stream length"
        for g, t in zip(flat, docs):
            assert list(g) == host.encode(t, allowed_special=allowed), ("mesh-stream", t)
    else:
        b = rng.randint(1, 30)
        for t in docs:
            host.encode(t, allowed_special=allowed)  # warm host LRU
        ts = tok.encode_trim_suffix_batch(docs, b, allowed_special=allowed)
        tp = tok.encode_trim_prefix_batch(docs, b, allowed_special=allowed)
        for t, rs, rp in zip(docs, ts, tp):
            es = host.encode_trim_suffix(t, b, allowed_special=allowed)
            ep = host.encode_trim_prefix(t, b, allowed_special=allowed)
            assert (rs.token_ids, rs.text) == tuple(es), ("mesh-ts", t, b)
            assert (rp.token_ids, rp.text) == tuple(ep), ("mesh-tp", t, b)


STEPS = {
    "encode": iter_encode,
    "trim": iter_trim,
    "threads": iter_threads,
    "mesh": iter_mesh,
}


def run(mode: str, seed: int, seconds: float, device="cuda", log=print):
    """Iterate ``mode`` for ``seconds``; returns ``(iterations, None)``, or
    ``(iteration, message)`` at the first mismatch."""
    step = STEPS[mode]
    rng = random.Random(seed)
    t0 = time.time()
    it = 0
    while time.time() - t0 < seconds:
        it += 1
        try:
            step(rng, device)
        except AssertionError as e:
            return it, f"MISMATCH at iter {it} seed {seed} mode {mode}: {repr(e.args[0])[:300]}"
        if it % 200 == 0:
            log(f"iter {it} ok ({time.time() - t0:.0f}s)")
    return it, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="encode", choices=sorted(STEPS))
    ap.add_argument("seed", nargs="?", type=int, default=7)
    ap.add_argument("seconds", nargs="?", type=float, default=1500.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    t0 = time.time()
    its, failure = run(args.mode, args.seed, args.seconds, args.device,
                       log=lambda m: print(m, flush=True))
    if failure:
        print(failure)
        return 1
    print(
        f"CAMPAIGN PASS [{args.mode} seed={args.seed} device={args.device}]: "
        f"{its} iterations, {time.time() - t0:.0f}s"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
