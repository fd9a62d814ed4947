"""Tokenizer builders for the port: model or encoder name -> GpuTokenizer.

The same resolution as :mod:`tokenizer_tpu.builder` (registry pattern,
rank file found offline first, extra specials merged over the
encoding's table), returning a :class:`~tokenizer_tpu_torch.gpu.GpuTokenizer`
on ``device``.
"""

from __future__ import annotations

from typing import Mapping, Optional

from .gpu import GpuTokenizer
from .models.registry import encoding_name_for_model, get_encoding_spec
from .utils.lru import BUILDER_CACHE_SIZE
from .vocab import Vocabulary, load_encoding_ranks

__all__ = ["create_by_model_name", "create_by_encoder_name", "create_tokenizer"]


def create_tokenizer(
    vocab,
    special_tokens: Mapping[str, int],
    pattern: str,
    cache_size: int = BUILDER_CACHE_SIZE,
    device="cuda",
    **options,
) -> GpuTokenizer:
    """A GpuTokenizer over ``vocab`` (a Vocabulary, rank dict or rank-file
    path); ``**options`` go to the constructor (``max_unique_rows=``)."""
    return GpuTokenizer(
        vocab, special_tokens, pattern, cache_size, device=device, **options
    )


def create_by_encoder_name(
    encoder_name: str,
    extra_special_tokens: Optional[Mapping[str, int]] = None,
    cache_size: int = BUILDER_CACHE_SIZE,
    allow_fetch: bool = True,
    device="cuda",
    **options,
) -> GpuTokenizer:
    """The GpuTokenizer of an encoding (``gpt2``, ``cl100k_synth``, ...)."""
    spec = get_encoding_spec(encoder_name)
    ranks = load_encoding_ranks(encoder_name, allow_fetch=allow_fetch)
    specials = dict(spec.special_tokens)
    specials.update(extra_special_tokens or {})
    return create_tokenizer(
        Vocabulary(ranks, name=encoder_name),
        specials,
        spec.pattern,
        cache_size,
        device=device,
        **options,
    )


def create_by_model_name(
    model_name: str,
    extra_special_tokens: Optional[Mapping[str, int]] = None,
    cache_size: int = BUILDER_CACHE_SIZE,
    allow_fetch: bool = True,
    device="cuda",
    **options,
) -> GpuTokenizer:
    """The GpuTokenizer of the encoding a model name maps to."""
    return create_by_encoder_name(
        encoding_name_for_model(model_name),
        extra_special_tokens,
        cache_size,
        allow_fetch=allow_fetch,
        device=device,
        **options,
    )
