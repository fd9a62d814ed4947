"""Vocabulary loading: tiktoken rank files, asset resolution, binary caching.

Covers the reference's rank-file handling: LoadTikTokenBpe parsing
(`Tokenizer_C#/TokenizerLib/TikTokenizer.cs:99-139`,
`tokenizer_ts/src/tikTokenizer.ts:13-44`) and the TS builder's
fetch-and-cache of rank files (`tokenizer_ts/src/tokenizerBuilder.ts:106-121,
269-285`).  TPU-first additions: a parsed binary cache (.npz) so 100k-200k
line base64 files parse once per machine, and precomputation hooks for the
device-side pair-merge hash table (see ops/pair_table.py).
"""

from __future__ import annotations

import base64
import os
import threading
from pathlib import Path
from typing import Dict, Iterable, Mapping, Optional

import numpy as np

from .models.registry import ENCODINGS, EncodingSpec

__all__ = [
    "parse_tiktoken_data",
    "load_tiktoken_file",
    "resolve_vocab_file",
    "load_encoding_ranks",
    "Vocabulary",
]


def default_cache_dir() -> Path:
    """Directory for downloaded rank files and parsed binary caches.

    Mirrors the TS builder's on-disk `model/` cache
    (tokenizerBuilder.ts:272-283) but respects TOKENIZER_TPU_CACHE_DIR.
    """
    env = os.environ.get("TOKENIZER_TPU_CACHE_DIR")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "tokenizer_tpu"


#: Directories searched (in order) for `<name>.tiktoken` before any network
#: fetch.  tokenizer_tpu/assets/ vendors gpt2 INSIDE the package (ships
#: in the wheel — the reference vendors model/gpt2.tiktoken the same
#: way); the repo-root vocab/ dir carries dev-only assets (synthetic
#: scale vocabs, maintainer-vendored rank files).
def _vocab_search_dirs() -> list:
    dirs = []
    env = os.environ.get("TOKENIZER_TPU_VOCAB_DIR")
    if env:
        dirs.append(Path(env))
    dirs.append(Path(__file__).resolve().parent / "assets")
    repo_vocab = Path(__file__).resolve().parent.parent / "vocab"
    dirs.append(repo_vocab)
    dirs.append(default_cache_dir())
    # Read-only reference mount used in CI images, if present.
    ref = Path("/root/reference/model")
    if ref.is_dir():
        dirs.append(ref)
    return dirs


def parse_tiktoken_data(data: bytes) -> Dict[bytes, int]:
    """Parse tiktoken rank-file content: one "<base64> <rank>" pair per line.

    Semantics match LoadTikTokenBpe (TikTokenizer.cs:99-139): blank lines are
    skipped, malformed lines raise.
    """
    ranks: Dict[bytes, int] = {}
    for line in data.splitlines():
        line = line.strip()
        if not line:
            continue
        parts = line.split(b" ")
        if len(parts) != 2:
            raise ValueError("Invalid format in the BPE encoder file stream")
        try:
            rank = int(parts[1])
        except ValueError:
            raise ValueError(f"Can't parse {parts[1]!r} to integer") from None
        ranks[base64.b64decode(parts[0])] = rank
    return ranks


def load_tiktoken_file(path: os.PathLike) -> Dict[bytes, int]:
    """Load a tiktoken rank file from disk (with a parsed .npz fast path).

    ``.gz`` files are decompressed transparently so vendored assets can be
    committed compressed (the reference vendors model/gpt2.tiktoken raw,
    835 KB; this repo vendors vocab/gpt2.tiktoken.gz, 366 KB).
    """
    path = Path(path)
    cached = _load_npz_cache(path)
    if cached is not None:
        return cached
    data = path.read_bytes()
    if path.suffix == ".gz":
        import gzip

        data = gzip.decompress(data)
    ranks = parse_tiktoken_data(data)
    _save_npz_cache(path, ranks)
    return ranks


# -- parsed binary cache -----------------------------------------------------
# Layout: flat uint8 blob of all token bytes + int32 offsets + int32 ranks.

def _npz_cache_path(src: Path) -> Path:
    st = src.stat()
    key = f"{src.name}.{st.st_size}.{int(st.st_mtime)}.npz"
    return default_cache_dir() / "parsed_torch" / key


def _load_npz_cache(src: Path) -> Optional[Dict[bytes, int]]:
    try:
        cpath = _npz_cache_path(src)
        if not cpath.is_file():
            return None
        with np.load(cpath) as z:
            blob = z["blob"].tobytes()
            offsets = z["offsets"]
            ranks = z["ranks"]
        out: Dict[bytes, int] = {}
        for i in range(len(ranks)):
            out[blob[offsets[i]:offsets[i + 1]]] = int(ranks[i])
        return out
    except Exception:
        return None


def _save_npz_cache(src: Path, ranks: Mapping[bytes, int]) -> None:
    try:
        cpath = _npz_cache_path(src)
        cpath.parent.mkdir(parents=True, exist_ok=True)
        toks = list(ranks.keys())
        blob = b"".join(toks)
        offsets = np.zeros(len(toks) + 1, dtype=np.int64)
        np.cumsum([len(t) for t in toks], out=offsets[1:])
        tmp = cpath.with_suffix(".tmp.npz")
        np.savez(
            tmp,
            blob=np.frombuffer(blob, dtype=np.uint8),
            offsets=offsets,
            ranks=np.asarray(list(ranks.values()), dtype=np.int64),
        )
        os.replace(tmp, cpath)
    except Exception:
        pass  # cache is best-effort


# -- asset resolution ---------------------------------------------------------

def _fetch(url: str, dest: Path) -> None:
    """Download a rank file (fetchAndSaveFile, tokenizerBuilder.ts:106-121)."""
    import urllib.request

    dest.parent.mkdir(parents=True, exist_ok=True)
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            if resp.status != 200:
                raise OSError(f"status code: {resp.status}")
            data = resp.read()
    except Exception as ex:
        raise OSError(f"Failed to fetch file from {url}. {ex}") from ex
    tmp = dest.with_suffix(dest.suffix + ".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, dest)


def resolve_vocab_file(encoder_name: str, allow_fetch: bool = True) -> Path:
    """Find (or fetch) the rank file for an encoding.

    Search order: $TOKENIZER_TPU_VOCAB_DIR, the repo's vocab/, the user
    cache dir, the read-only reference mount; then (if allow_fetch) a
    network download into the cache dir.  Encodings whose rank file content
    is shared with another encoding (r50k_base==gpt2, p50k_edit==p50k_base)
    fall back to the alias's file.
    """
    spec = ENCODINGS.get(encoder_name)
    if spec is None:
        raise ValueError(f"Doesn't support this encoder [{encoder_name}]")

    names = [f"{encoder_name}.tiktoken"]
    if spec.vocab_alias:
        names.append(f"{spec.vocab_alias}.tiktoken")
    # p50k_edit's URL basename is p50k_base.tiktoken
    url_base = spec.vocab_url.rsplit("/", 1)[-1]
    if url_base and url_base not in names:
        names.append(url_base)

    for d in _vocab_search_dirs():
        for n in names:
            for cand in (n, n + ".gz"):
                p = Path(d) / cand
                if p.is_file():
                    return p

    # Encodings derivable from a vendored base (p50k_base from gpt2) are
    # materialized into the cache dir instead of fetched.
    derived = _materialize_derived(encoder_name)
    if derived is not None:
        return derived

    if not allow_fetch or not spec.vocab_url:
        # Vendored-only encodings (synthetic vocabs: vocab_url == "")
        # get the clean not-found error, never a nonsense ''-URL fetch.
        raise FileNotFoundError(
            f"Rank file for {encoder_name} not found locally "
            f"(searched {[str(d) for d in _vocab_search_dirs()]})"
            + ("" if spec.vocab_url else "; encoding is vendored-only")
            + ("" if allow_fetch else " and fetch disabled")
        )
    dest = default_cache_dir() / url_base
    _fetch(spec.vocab_url, dest)
    return dest


#: p50k_base = the gpt2/r50k rank table plus 24 run-of-spaces tokens
#: (lengths 2..25 at ranks 50257..50280, ascending).  The derivation is
#: validated byte-for-byte by the reference's committed golden id arrays
#: (`Tokenizer_C#/TokenizerTest/testData/tokens_p50k_base.json`, 7,230 ids
#: for lib.rs.txt — tests/test_conformance.py) — gpt2 has NO multi-space
#: token, which is exactly the gap the code-model vocab filled.
_SPACE_RUN_BASE_RANK = 50257
_SPACE_RUN_LENGTHS = range(2, 26)

_DERIVED_FROM_GPT2 = ("p50k_base", "p50k_edit")


def _materialize_derived(encoder_name: str) -> Optional[Path]:
    """Write a derivable encoding's rank file into the cache dir.

    Returns the materialized path, or None if the encoding is not
    derivable / its base asset is unavailable offline.
    """
    if encoder_name not in _DERIVED_FROM_GPT2:
        return None
    try:
        base = resolve_vocab_file("gpt2", allow_fetch=False)
    except FileNotFoundError:
        return None
    dest = default_cache_dir() / "p50k_base.tiktoken"
    if not dest.is_file():
        lines = []
        for tok, rank in sorted(
            load_tiktoken_file(base).items(), key=lambda kv: kv[1]
        ):
            lines.append(base64.b64encode(tok) + b" " + str(rank).encode())
        for i, n in enumerate(_SPACE_RUN_LENGTHS):
            lines.append(
                base64.b64encode(b" " * n)
                + b" "
                + str(_SPACE_RUN_BASE_RANK + i).encode()
            )
        dest.parent.mkdir(parents=True, exist_ok=True)
        tmp = dest.with_suffix(".tmp")
        tmp.write_bytes(b"\n".join(lines) + b"\n")
        os.replace(tmp, dest)
    return dest


def load_encoding_ranks(encoder_name: str, allow_fetch: bool = True) -> Dict[bytes, int]:
    """Rank table for an encoding, resolving assets per resolve_vocab_file."""
    path = resolve_vocab_file(encoder_name, allow_fetch=allow_fetch)
    return load_tiktoken_file(path)


# -- Vocabulary ----------------------------------------------------------------


class Vocabulary:
    """A parsed rank table plus TPU-oriented derived structures.

    The reference keeps only the two dictionaries (Encoder/Decoder,
    TikTokenizer.cs:74-91).  The TPU build additionally derives, lazily:

    * ``byte_to_id`` — int32[256] mapping each single byte to its token id
      (every tiktoken vocab contains all 256 single-byte tokens), used to
      initialize the packed merge kernel's id lanes;
    * the pair-merge hash table (built in ops/pair_table.py) keyed by
      (left_id, right_id) with the merged token's id as value — the
      device-resident replacement for byte-slice rank lookups.
    """

    def __init__(self, ranks: Mapping[bytes, int], name: str = "custom"):
        self.name = name
        self.encoder: Dict[bytes, int] = dict(ranks)
        self.decoder: Dict[int, bytes] = {v: k for k, v in self.encoder.items()}
        if len(self.encoder) != len(self.decoder):
            # TikTokenizer.cs:84-87 / tikTokenizer.ts:113-115
            raise ValueError("Encoder and decoder sizes don't match")
        self.n_vocab = (max(self.decoder) + 1) if self.decoder else 0
        self.max_token_len = max((len(t) for t in self.encoder), default=0)
        # RLock: pair_table() holds the lock while PairTable.build reads
        # the byte_to_id property, which locks again on a cold cache.
        self._lock = threading.RLock()
        self._byte_to_id: Optional[np.ndarray] = None
        self._pair_table = None

    @classmethod
    def for_encoding(cls, encoder_name: str, allow_fetch: bool = True) -> "Vocabulary":
        return cls(load_encoding_ranks(encoder_name, allow_fetch), name=encoder_name)

    def __len__(self) -> int:
        return len(self.encoder)

    @property
    def byte_to_id(self) -> np.ndarray:
        if self._byte_to_id is None:
            with self._lock:
                if self._byte_to_id is None:
                    arr = np.full(256, -1, dtype=np.int32)
                    for b in range(256):
                        tid = self.encoder.get(bytes([b]))
                        if tid is None:
                            raise ValueError(
                                f"vocab {self.name} is missing single-byte token {b:#x}"
                            )
                        arr[b] = tid
                    self._byte_to_id = arr
        return self._byte_to_id

    def pair_table(self):
        """The (left_id, right_id) -> merged_id open-addressing table.

        Built once and cached; see ops/pair_table.py for the layout.
        """
        if self._pair_table is None:
            with self._lock:
                if self._pair_table is None:
                    from .ops.pair_table import PairTable

                    self._pair_table = PairTable.build(self)
        return self._pair_table
