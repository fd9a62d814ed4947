"""The multi-device dry run: the mesh path end to end, against the host engine.

The port's counterpart of ``__graft_entry__.dryrun_multichip``.  It runs
one raw sharded merge step with its counter and shard-layout checks,
then ``encode_batch`` over a mesh tokenizer against the host engine, then
the stream, both bulk trims and ``decode_batch`` over the same tokenizer,
and prints one summary line.  On the CPU it runs over
``devices=["cpu"] * 8``; on one card over ``["cuda:0"] * 2``; on a host
with several cards over all of them::

    python -c "from tokenizer_tpu_torch.parallel.dryrun import dryrun_multidevice as d; d(devices=['cpu'] * 8)"
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["dryrun_multidevice"]

TEXTS = [
    "Hello world, this is a multi-chip dry run! ⭐ éèê",
    "def tokenize(xs):\n    return [f(x) + 12345 for x in xs]\n" * 3,
    "   indented\tand  spaced   runs    of whitespace     here",
    "".join(chr(0x4E00 + i) for i in range(40)),
] * 2


def _check(cond: bool, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def _example_batch(table, L=16, B=256, seed=0):
    """``__graft_entry__._example_batch``: B columns of six words."""
    rng = np.random.default_rng(seed)
    ids = np.full((L, B), -1, np.int32)
    lengths = np.zeros(B, np.int32)
    words = [b"hello", b" world", b"the", b" tokenizer", b"a" * 12, b" 123"]
    for c in range(B):
        p = words[int(rng.integers(len(words)))]
        ids[: len(p), c] = table.byte_to_id[np.frombuffer(p, np.uint8)]
        lengths[c] = len(p)
    return ids, lengths


def dryrun_multidevice(
    n_devices: Optional[int] = None, devices: Optional[Sequence] = None
) -> dict:
    """Run the mesh path over ``data_mesh(n_devices, devices)``; raises
    AssertionError on the first disagreement.  Returns the counters it
    printed."""
    import torch

    from ..engine import TikTokenizer
    from ..gpu import GpuTokenizer
    from ..models.registry import get_encoding_spec
    from ..ops.merge_cuda import LANE
    from ..ops.merge_torch import device_table, merge_packed_torch
    from ..vocab import Vocabulary
    from .encode_step import gather_shards, make_sharded_merge_fn
    from .mesh import data_mesh

    mesh = data_mesh(n_devices, devices)
    n = mesh.size
    vocab = Vocabulary.for_encoding("gpt2", allow_fetch=False)
    spec = get_encoding_spec("gpt2")
    table = vocab.pair_table()

    # 1. Raw sharded merge step: counters, shard layout, the plain merge.
    fn = make_sharded_merge_fn(table, mesh)
    B = LANE * n
    ids, lengths = _example_batch(table, L=16, B=B)
    out_ids, out_n, counters = fn(ids, lengths)
    counters = counters.cpu().tolist()
    _check(counters[1] == B, (counters, B))
    got_ids, got_n = gather_shards(out_ids, out_n)
    _check(int(got_n.sum()) == counters[0], (int(got_n.sum()), counters))
    shapes = {tuple(o.shape) for o in out_ids}
    _check(shapes == {(16, B // n)}, shapes)
    _check([o.device for o in out_ids] == list(mesh.devices), [o.device for o in out_ids])
    want_ids, want_n = merge_packed_torch(
        device_table(table, "cpu"),
        torch.from_numpy(ids),
        torch.from_numpy(lengths),
        slot_bits=table.slot_bits,
        max_probes=table.max_probes,
    )
    _check(np.array_equal(got_n, want_n.numpy()), "sharded out_n != the plain merge")
    _check(np.array_equal(got_ids, want_ids.numpy()), "sharded out_ids != the plain merge")

    # 2. encode_batch over the mesh vs the host engine.
    tok = GpuTokenizer(
        vocab, spec.special_tokens, spec.pattern, device=mesh.devices[0].type, mesh=mesh
    )
    host = TikTokenizer(vocab, spec.special_tokens, spec.pattern)
    got = tok.encode_batch(TEXTS)
    want = [host.encode(t) for t in TEXTS]
    for g, w in zip(got, want):
        _check(list(g) == w, (list(g)[:8], w[:8]))
    _check(tok.mesh is mesh, "encode_batch did not use the mesh")
    st = tok.stats
    _check(st.device_pieces > 0, st.as_dict())

    # 3. Stream, bulk trims and decode over the same tokenizer.
    fresh = [t + " tail" for t in TEXTS]
    chunks = [fresh[: len(fresh) // 2], fresh[len(fresh) // 2 :]]
    streamed = [ids for b in tok.encode_batch_stream(chunks) for ids in b]
    _check(len(streamed) == len(fresh), len(streamed))
    for g, t in zip(streamed, fresh):
        _check(list(g) == host.encode(t), t[:40])
    budgets = list(range(1, len(TEXTS) + 1))
    for t, b, res in zip(TEXTS, budgets, tok.encode_trim_suffix_batch(TEXTS, budgets)):
        _check((res.token_ids, res.text) == tuple(host.encode_trim_suffix(t, b)), (t[:30], b))
    for t, res in zip(TEXTS, tok.encode_trim_prefix_batch(TEXTS, 4)):
        _check((res.token_ids, res.text) == tuple(host.encode_trim_prefix(t, 4)), t[:30])
    _check(tok.decode_batch(got) == [host.decode(w) for w in want], "decode_batch")

    rec = {
        "devices": [str(d) for d in mesh.devices],
        "step_tokens": counters[0],
        "step_pieces": counters[1],
        "tokens_out": st.tokens_out,
        "device_pieces": st.device_pieces,
        "device_waves": st.device_waves,
        "device_uploads": st.device_uploads,
    }
    print(
        f"dryrun_multidevice ok: {n} shards on {', '.join(rec['devices'])}; "
        f"step tokens={counters[0]} pieces={counters[1]}; encode_batch "
        f"tokens={st.tokens_out} device_pieces={st.device_pieces} device_waves="
        f"{st.device_waves} uploads={st.device_uploads}; stream+trims+decode parity ok",
        flush=True,
    )
    return rec

