"""Model configurations of the port: ``ModelConfig`` and the
configurations whose model is ported (``registry``)."""
