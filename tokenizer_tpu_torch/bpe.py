"""Host byte-pair-merge core — the framework's exactness oracle.

Implements tiktoken's ``byte_pair_merge`` with the reference's precise
semantics (`Tokenizer_C#/TokenizerLib/Utils/BytePairEncoder.cs:13-76`,
`tokenizer_ts/src/bytePairEncode.ts:75-159`):

* adjacent-pair ranks initialised over the raw bytes;
* repeatedly merge at the FIRST index holding the minimal rank
  (strict ``<`` scan — ties break to the lowest index);
* after a merge only the ranks at ``j`` and ``j-1`` are recomputed
  (skip=1 lookups spanning the merged piece);
* emit the rank (== token id) of every surviving segment.

This pure-Python version is the parity arbiter for the packed NumPy /
XLA / Pallas kernels in :mod:`tokenizer_tpu.ops`; those must agree with
it bit-for-bit on every input.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

__all__ = ["MAX_RANK", "byte_pair_encode"]

#: Sentinel rank (int32 max), Constant.MaxRank / int.MaxValue in the reference.
MAX_RANK = 0x7FFFFFFF


def byte_pair_encode(piece: bytes, ranks: Mapping[bytes, int]) -> List[int]:
    """Encode one regex piece's UTF-8 bytes into token ids.

    ``ranks`` is the full byte-slice -> rank table (ranks are token ids).
    The caller is expected to have tried the whole-piece lookup first
    (TikTokenizer.cs:261-265) — this function still yields the identical
    result for any BPE-consistent vocabulary, but the reference's order
    of operations is: cache, whole piece, then this loop.
    """
    n = len(piece)
    if n == 1:
        return [ranks[piece]]

    get = ranks.get
    # Boundaries of current segments: piece[b[i]:b[i+1]] are the segments.
    b = list(range(n + 1))
    # r[i] = rank of merging segments i and i+1 (bytes b[i]:b[i+2]).
    r = [get(piece[i : i + 2], MAX_RANK) for i in range(n - 1)]

    while True:
        # First-minimal-index scan (BytePairEncoder.cs:45-54).
        min_rank = MAX_RANK
        j = -1
        for i, ri in enumerate(r):
            if ri < min_rank:
                min_rank = ri
                j = i
        if min_rank == MAX_RANK:
            break
        # Merge segments j and j+1: drop boundary b[j+1] and pair entry j.
        del b[j + 1]
        del r[j]
        m = len(b) - 1  # segment count after the merge
        # Recompute the two affected pair ranks (BytePairEncoder.cs:55-64).
        if j < m - 1:
            r[j] = get(piece[b[j] : b[j + 2]], MAX_RANK)
        if j > 0:
            r[j - 1] = get(piece[b[j - 1] : b[j + 1]], MAX_RANK)

    return [ranks[piece[b[i] : b[i + 1]]] for i in range(len(b) - 1)]
