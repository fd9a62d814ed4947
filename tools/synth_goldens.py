"""Golden ids of ``tests/testdata/lib.rs.txt`` for the synthetic vocabularies.

``cl100k_synth`` and ``o200k_synth`` have no published golden arrays, so
their goldens come from Rust ``tiktoken`` built from the same ranks: the
vendored rank file (``vocab/*_synth.tiktoken.gz``), the encoding's
pattern and the special table of the real encoding it stands in for.
Ids are those of ``encode(text, disallowed_special=())``, written as a
JSON list in the format of the other ``tokens_*.json`` files.

    python3 tools/synth_goldens.py

writes ``tests/testdata/tokens_cl100k_synth.json`` and
``tests/testdata/tokens_o200k_synth.json``; a second run rewrites them
byte for byte.  Only the PyTorch port's loaders are used, so the
script runs where the JAX package is absent.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tokenizer_tpu_torch.models.registry import (  # noqa: E402
    get_encoding_spec,
    get_special_tokens_by_encoder,
)
from tokenizer_tpu_torch.vocab import load_encoding_ranks  # noqa: E402

#: each synthetic vocabulary and the real encoding whose specials it carries.
SYNTH = {"cl100k_synth": "cl100k_base", "o200k_synth": "o200k_base"}
TESTDATA = ROOT / "tests" / "testdata"


def rust_encoding(name: str):
    """``tiktoken.Encoding`` of a synthetic vocabulary: its vendored ranks,
    its pattern and the real encoding's specials."""
    import tiktoken

    return tiktoken.Encoding(
        name=name,
        pat_str=get_encoding_spec(name).pattern,
        mergeable_ranks=load_encoding_ranks(name, allow_fetch=False),
        special_tokens=get_special_tokens_by_encoder(SYNTH[name]),
    )


def golden_path(name: str) -> Path:
    return TESTDATA / f"tokens_{name}.json"


def golden_bytes(name: str) -> bytes:
    """The golden file's content: tiktoken's ids of lib.rs.txt."""
    text = (TESTDATA / "lib.rs.txt").read_text(encoding="utf-8")
    ids = rust_encoding(name).encode(text, disallowed_special=())
    return json.dumps(ids).encode("ascii")


def main() -> int:
    for name in SYNTH:
        data = golden_bytes(name)
        golden_path(name).write_bytes(data)
        print(f"{golden_path(name).relative_to(ROOT)}: {len(json.loads(data))} ids")
    return 0


if __name__ == "__main__":
    sys.exit(main())
