"""Launchers and inputs of the port: the model entry points' batches
(``specs.make_batch``), meshes and worlds of ranks (``mesh``) and the
paper's FL launcher (``fl_train``) and the LM training driver
(``train``)."""
