from .lru import LRUCache, DEFAULT_CACHE_SIZE, BUILDER_CACHE_SIZE
from .text import utf16_len, utf16_slice, utf16_prefix_to_codepoints

__all__ = [
    "LRUCache",
    "DEFAULT_CACHE_SIZE",
    "BUILDER_CACHE_SIZE",
    "utf16_len",
    "utf16_slice",
    "utf16_prefix_to_codepoints",
]
