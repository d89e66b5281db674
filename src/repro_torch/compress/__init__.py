"""Soft-label wire codecs (quantization, top-k sparsification,
cache-delta coding) with analytic payload accounting."""
from repro_torch.compress.codecs import (  # noqa: F401
    CODECS,
    CacheDeltaCodec,
    Codec,
    IdentityCodec,
    QuantCodec,
    TopKCodec,
    get_codec,
)
