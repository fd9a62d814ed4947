"""Exact (left_id, right_id) -> merged_id hash table for the merge kernel.

The reference probes a byte-slice-keyed dictionary inside its hot loop
(C# ``Dictionary<byte[],int>`` with ByteArrayComparer, `Tokenizer_C#/
TokenizerLib/Utils/BytePairComparer.cs:8-43`; TS ``BinaryMap`` trie,
`tokenizer_ts/src/bytePairEncode.ts:14-64`).  Neither structure maps to
a vector unit, so the TPU build replaces byte-slice keys with an EXACT
reformulation: during tiktoken's merge loop every segment is itself a
vocab token (segments start as single bytes — all 256 are in every
tiktoken vocab — and are only ever replaced by vocab tokens), so every
rank lookup of "bytes of segment i + bytes of segment i+1" equals a
lookup of the *id pair* ``(id_i, id_{i+1})``.  The table below stores,
for every vocab token that can be written as a concatenation of two
vocab tokens, the mapping ``(left_id, right_id) -> merged_id`` — keys
are exact id pairs compared in full, no byte hashing, no false
positives.

Layout is TPU-native: **pure 32-bit arithmetic** (TPUs have no native
64-bit vector ops and JAX runs 32-bit by default).  Keys live as two
parallel int32 arrays; the slot hash is a Murmur-style uint32 mix of
the pair followed by a Fibonacci multiply-shift.  Open addressing with
linear probing; the probe bound is verified at build time so device
probe loops have a static trip count.  Arrays are plain numpy; the
device pipeline uploads them once per vocabulary (a few MB, replicated
per chip — SURVEY.md §2.3: the rank table is never sharded).

Whole-piece parity: the reference short-circuits pieces whose full
bytes are a single vocab token (TikTokenizer.cs:261-265).  For real BPE
vocabs the merge loop reaches the same single token, which
``verify_merge_closure`` proves at build time per vocab; tokens that
fail the property (possible only for hand-built adversarial rank
tables) are returned so the host can route affected pieces through the
oracle instead.  This keeps the device path exact for ALL vocabularies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["PairTable", "MAX_RANK", "hash_pair_u32"]

MAX_RANK = 0x7FFFFFFF

# Murmur3-style mixing constants (public domain) + golden-ratio multiplier.
_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
_FIB = np.uint32(0x9E3779B9)


def hash_pair_u32(left: np.ndarray, right: np.ndarray, slot_bits: int) -> np.ndarray:
    """uint32 slot hash of an id pair — bit-identical on host and device.

    All operations wrap mod 2**32; the device kernels reproduce this
    exactly with jnp.uint32 math.
    """
    with np.errstate(over="ignore"):  # wraparound is the contract
        l = left.astype(np.uint32)
        r = right.astype(np.uint32)
        h = (l * _C1) ^ (r * _C2)
        h ^= h >> np.uint32(16)
        return ((h * _FIB) >> np.uint32(32 - slot_bits)).astype(np.int32)


@dataclass
class PairTable:
    """Open-addressed (left,right)->merged table plus merge metadata."""

    key_left: np.ndarray  # int32[slots], -1 = empty
    key_right: np.ndarray  # int32[slots]
    values: np.ndarray  # int32[slots], merged token id (== rank)
    slot_bits: int  # slots == 1 << slot_bits
    max_probes: int  # verified linear-probe bound over all keys
    byte_to_id: np.ndarray  # int32[256]
    n_vocab: int
    max_token_len: int
    n_pairs: int
    #: vocab tokens (2 <= len <= 128) NOT reachable by the pair merge
    #: loop from their own bytes — empty for every real BPE vocab.
    unreachable_tokens: Tuple[bytes, ...] = ()

    @property
    def n_slots(self) -> int:
        return 1 << self.slot_bits

    # ------------------------------------------------------------------
    # Build
    # ------------------------------------------------------------------

    @classmethod
    def build(cls, vocab, verify_closure: bool = True) -> "PairTable":
        """Build from a :class:`~tokenizer_tpu.vocab.Vocabulary`.

        For each vocab token t with len(t) >= 2, every split t = a+b
        with a, b both vocab tokens yields an entry (id_a, id_b) -> id_t.
        """
        encoder: Dict[bytes, int] = vocab.encoder
        lefts: List[int] = []
        rights: List[int] = []
        merged: List[int] = []
        get = encoder.get
        for tok, tid in encoder.items():
            L = len(tok)
            if L < 2:
                continue
            for k in range(1, L):
                ia = get(tok[:k])
                if ia is None:
                    continue
                ib = get(tok[k:])
                if ib is None:
                    continue
                lefts.append(ia)
                rights.append(ib)
                merged.append(tid)

        left_a = np.asarray(lefts, dtype=np.int32)
        right_a = np.asarray(rights, dtype=np.int32)
        merged_a = np.asarray(merged, dtype=np.int32)

        # Load factor <= 0.5, minimum 1<<7 slots (128 = one TPU vreg of
        # lanes, the largest table the Pallas kernel's vreg-local
        # dynamic gather can address — see ops/merge_pallas.py).
        slot_bits = 7
        while (1 << slot_bits) < 2 * max(len(left_a), 1):
            slot_bits += 1

        kl, kr, vals, max_probes = cls._insert_all(
            left_a, right_a, merged_a, slot_bits
        )
        # If probing degenerated (pathological clustering), grow.
        while max_probes > 16 and slot_bits < 26:
            slot_bits += 1
            kl, kr, vals, max_probes = cls._insert_all(
                left_a, right_a, merged_a, slot_bits
            )

        table = cls(
            key_left=kl,
            key_right=kr,
            values=vals,
            slot_bits=slot_bits,
            max_probes=max_probes,
            byte_to_id=vocab.byte_to_id.astype(np.int32),
            n_vocab=vocab.n_vocab,
            max_token_len=vocab.max_token_len,
            n_pairs=len(left_a),
        )
        if verify_closure:
            table.unreachable_tokens = tuple(table.verify_merge_closure(vocab))
        return table

    @staticmethod
    def _insert_all(
        left: np.ndarray, right: np.ndarray, vals: np.ndarray, slot_bits: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        n_slots = 1 << slot_bits
        kl = np.full(n_slots, -1, dtype=np.int32)
        kr = np.full(n_slots, -1, dtype=np.int32)
        kv = np.zeros(n_slots, dtype=np.int32)
        mask = n_slots - 1
        home = hash_pair_u32(left, right, slot_bits)
        max_probes = 1
        for i in range(len(left)):
            s = int(home[i])
            probes = 1
            while kl[s] != -1:
                s = (s + 1) & mask
                probes += 1
            kl[s] = left[i]
            kr[s] = right[i]
            kv[s] = vals[i]
            if probes > max_probes:
                max_probes = probes
        return kl, kr, kv, max_probes

    # ------------------------------------------------------------------
    # Host-side lookup (NumPy model of the device probe sequence)
    # ------------------------------------------------------------------

    def lookup(self, left: np.ndarray, right: np.ndarray) -> np.ndarray:
        """Vectorized merged-id lookup; MAX_RANK where the pair can't merge.

        The bit-exact NumPy model of the probe loop the XLA and Pallas
        kernels execute: up to ``max_probes`` gathers from the home
        slot, full (left,right) key comparison, stop at empty.  Ids < 0
        (padding lanes) never match because stored keys are >= 0.
        """
        left = np.asarray(left, dtype=np.int32)
        right = np.asarray(right, dtype=np.int32)
        valid = (left >= 0) & (right >= 0)
        slot = hash_pair_u32(
            np.where(valid, left, 0), np.where(valid, right, 0), self.slot_bits
        ).astype(np.int64)
        mask = self.n_slots - 1
        out = np.full(left.shape, MAX_RANK, dtype=np.int32)
        unresolved = valid.copy()
        for _ in range(self.max_probes):
            kl = self.key_left[slot]
            kr = self.key_right[slot]
            hit = unresolved & (kl == left) & (kr == right)
            out[hit] = self.values[slot][hit]
            unresolved &= (kl != -1) & ~hit
            if not unresolved.any():
                break
            slot = (slot + 1) & mask
        return out

    # ------------------------------------------------------------------
    # Merge-closure verification (exact whole-piece parity)
    # ------------------------------------------------------------------

    def verify_merge_closure(self, vocab, l_max: int = 128) -> List[bytes]:
        """Return vocab tokens whose bytes do NOT merge back to themselves.

        The reference's whole-piece dictionary hit (TikTokenizer.cs:
        261-265) emits ``[id(t)]`` for any piece equal to a vocab token
        t.  The device path instead runs the merge loop; this check
        proves (per vocab, once) that the loop converges to ``[id(t)]``
        for every token with ``2 <= len(t) <= l_max``.  Tokens returned
        here (none, for real tiktoken vocabs) are routed to the host
        oracle by the packer.
        """
        from ..bpe import byte_pair_encode

        bad: List[bytes] = []
        for tok, tid in vocab.encoder.items():
            if 2 <= len(tok) <= l_max:
                if byte_pair_encode(tok, vocab.encoder) != [tid]:
                    bad.append(tok)
        return bad

    # ------------------------------------------------------------------

    def nbytes(self) -> int:
        return (
            self.key_left.nbytes
            + self.key_right.nbytes
            + self.values.nbytes
            + self.byte_to_id.nbytes
        )
