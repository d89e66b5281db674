"""Kernel entry points that the higher layers call (the counterpart of
``repro.kernels.ops``): ``core/era`` and the SCARLET strategy reach the
ERA kernels here, ``core/losses`` the distillation loss kernel, the quant
codecs the quantize-dequantize kernel, the device engine's fused path the
fused round kernel, and the model zoo's eligible attention
(``models/common.attention``) the flash attention kernel, and the static
analyzer's selftest (``repro_torch.analysis``) the three fixture kernels,
and ``core/prng`` (the reference's ``jax.random`` key stream) the threefry
counter hash.
Each kernel wrapper runs its plain PyTorch version for CPU tensors and its
CUDA kernel for CUDA tensors."""
import torch

from repro_torch.kernels import attn_kernel, distill_kernel, era_kernel, fixture_kernel
from repro_torch.kernels.prng_kernel import threefry  # noqa: F401
from repro_torch.kernels.era_kernel import enhanced_era_fused  # noqa: F401
from repro_torch.kernels.quant_kernel import quantize_dequantize  # noqa: F401
from repro_torch.kernels.round_kernel import fused_round  # noqa: F401

KERNELS = (enhanced_era_fused, quantize_dequantize, fused_round, attn_kernel.flash_attention,
           era_kernel.enhanced_era, distill_kernel.distill_loss, fixture_kernel.copy_vec4,
           fixture_kernel.scale, fixture_kernel.copy_smem, threefry)


# The model zoo's flash attention: the kernel forward (one launch) and the
# reference's recompute backward; with no gradient needed it builds no graph.
flash_attention = attn_kernel.flash_attention_diff


def enhanced_era(z_mean: torch.Tensor, beta) -> torch.Tensor:
    """(..., N) -> sharpened (..., N); leading dims flattened to rows."""
    shape = z_mean.shape
    return era_kernel.enhanced_era(z_mean.reshape(-1, shape[-1]), beta).reshape(shape)


def distill_loss(logits: torch.Tensor, teacher: torch.Tensor) -> torch.Tensor:
    """Mean soft-target CE over all rows of (..., V) inputs, float32."""
    V = logits.shape[-1]
    return distill_kernel.distill_loss(logits.reshape(-1, V),
                                       teacher.reshape(-1, V)).mean()


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


def launches() -> dict:
    """``{wrapper name: launches since the last reset}``."""
    return {fn.__name__: fn.launches for fn in KERNELS}
