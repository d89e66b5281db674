"""Soft-label wire codecs with analytic payload accounting."""
from repro_torch.compress.codecs import (  # noqa: F401
    CODECS,
    CacheDeltaCodec,
    Codec,
    IdentityCodec,
    QuantCodec,
    get_codec,
)
