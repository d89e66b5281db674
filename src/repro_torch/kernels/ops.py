"""Kernel entry points that the higher layers call (the counterpart of
``repro.kernels.ops``): ``core/era`` and the SCARLET strategy reach the
fused ERA kernel here, the quant codecs the quantize-dequantize kernel,
the device engine's fused path the fused round kernel, and the model
zoo's eligible attention (``models/common.attention``) the flash
attention kernel.  Each wrapper runs its plain PyTorch version for CPU
tensors and its CUDA kernel for CUDA tensors."""
from repro_torch.kernels.attn_kernel import flash_attention  # noqa: F401
from repro_torch.kernels.era_kernel import enhanced_era_fused  # noqa: F401
from repro_torch.kernels.quant_kernel import quantize_dequantize  # noqa: F401
from repro_torch.kernels.round_kernel import fused_round  # noqa: F401

KERNELS = (enhanced_era_fused, quantize_dequantize, fused_round, flash_attention)


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


def launches() -> dict:
    """``{wrapper name: launches since the last reset}``."""
    return {fn.__name__: fn.launches for fn in KERNELS}
