"""Model configurations of the port: ``ModelConfig``, the assigned input
shapes (``base``) and every configuration of the JAX package
(``registry``)."""
