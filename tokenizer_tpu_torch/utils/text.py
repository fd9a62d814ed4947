"""UTF-16 code-unit bookkeeping.

The reference counts trim offsets (``encodeLength``) in C#/JS string
units — UTF-16 code units — not Unicode code points
(`Tokenizer_C#/TokenizerLib/TikTokenizer.cs:298,315`,
`tokenizer_ts/src/tikTokenizer.ts:243`).  Python strings count code
points, so astral-plane characters (emoji, rare CJK) occupy ONE Python
character but TWO UTF-16 units.  These helpers keep the trim outputs
byte-for-byte identical with the reference.
"""

from __future__ import annotations

__all__ = [
    "utf16_len",
    "utf16_slice",
    "utf16_prefix_to_codepoints",
    "utf8_bytes",
]


def utf8_bytes(s: str) -> bytes:
    """UTF-8 bytes of ``s`` with the references' LONE-SURROGATE
    semantics: JS ``TextEncoder`` (tokenizer_ts/src/textEncoder.ts:24)
    and C# ``Encoding.UTF8.GetBytes`` (TikTokenizer.cs:261) both emit
    U+FFFD for an unpaired surrogate, where Python raises
    ``UnicodeEncodeError``.  Clean strings (the overwhelmingly common
    case) pay nothing: the try's encode IS the result.  A lone
    surrogate and its U+FFFD replacement occupy one UTF-16 unit each
    and fall in the same regex class (neither is ``\\p{L}``/``\\p{N}``
    /whitespace), so piece boundaries and trim offsets are unaffected.
    """
    try:
        return s.encode("utf-8")
    except UnicodeEncodeError:
        return (
            s.encode("utf-16-le", "surrogatepass")
            .decode("utf-16-le", "replace")
            .encode("utf-8")
        )


def utf16_len(s: str) -> int:
    """Length of ``s`` in UTF-16 code units (JS ``s.length``)."""
    # Each code point >= U+10000 encodes as a surrogate pair (2 units).
    # ASCII fast path (C-speed flag check); otherwise the UTF-16 encode
    # runs in C where the old per-character loop cost ~10 us/call on
    # trim-sized texts (profiled in the bulk-trim bookkeeping).
    if s.isascii():
        return len(s)
    return len(s.encode("utf-16-le", "surrogatepass")) // 2


def utf16_prefix_to_codepoints(s: str, units: int) -> int:
    """Number of leading code points of ``s`` spanning ``units`` UTF-16 units.

    If ``units`` lands in the middle of a surrogate pair, the JS slice would
    keep a lone surrogate; we round DOWN to the code-point boundary (the
    reference never produces mid-surrogate trims for valid inputs because
    piece boundaries are code-point boundaries).
    """
    if units <= 0:
        return 0
    # ``s[:units]`` always covers the answer (cp index <= unit index);
    # if that prefix is astral-free, unit and code-point counts match.
    pre = s[:units]
    if pre.isascii():
        return min(units, len(s))
    n16 = len(pre.encode("utf-16-le", "surrogatepass")) // 2
    if n16 == len(pre):  # BMP-only prefix: 1 unit per code point
        return min(units, len(s))
    u = 0
    for i, ch in enumerate(pre):
        w = 2 if ch >= "\U00010000" else 1
        if u + w > units:
            return i
        u += w
        if u == units:
            return i + 1
    return len(pre)


def utf16_slice(s: str, start_units: int, end_units: int) -> str:
    """``s.slice(start, end)`` with UTF-16 unit offsets (JS semantics)."""
    start_cp = utf16_prefix_to_codepoints(s, start_units)
    end_cp = utf16_prefix_to_codepoints(s, end_units)
    return s[start_cp:end_cp]
