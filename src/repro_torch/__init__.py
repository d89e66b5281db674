"""PyTorch/CUDA port of the SCARLET reproduction (``repro``).

Same subpackage layout and names as the JAX package; imports ``torch``,
numpy and the standard library only.  Entry points run on a CUDA device
by default and raise without one; ``device="cpu"`` runs the plain
PyTorch version of every kernel.
"""
