"""Hand-written CUDA kernels for Hopper (``sm_90a``), one per Pallas
kernel of ``repro.kernels`` that the port's path runs:

- era_kernel:   Enhanced-ERA sharpening, fused with the client mean
  (``enhanced_era_fused``) and per row (``enhanced_era``)
- quant_kernel: per-row min-max quantize-dequantize round trip
- round_kernel: the fused round (codec round trip + weighted client sum +
  Enhanced ERA)
- attn_kernel:  flash attention forward (causal, GQA, sliding window)
- distill_kernel: per-row soft-target cross entropy over up to an LM's
  vocabulary (the distillation loss)
- prng_kernel:  the threefry2x32 counter hash of the reference's
  ``jax.random`` key stream (no Pallas kernel: XLA's threefry)
- fixture_kernel: the static analyzer's three fixtures (a float4 copy, a
  scale by a scalar, a copy through shared memory), each with a valid and
  a broken launch plan

Each module holds the wrapper, its launch count and its plain PyTorch
version; ``csrc/`` holds the CUDA sources and ``runtime`` builds them
with ``nvcc`` at first use and launches them with the plan each wrapper
computes.
"""
