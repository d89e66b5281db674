"""Launchers and inputs of the port: the model entry points' batches
(``specs.make_batch``), meshes, worlds of ranks and their collectives
(``mesh``), the paper's FL launcher (``fl_train``), the LM training driver
(``train``) and the roofline's hardware model (``roofline``)."""
