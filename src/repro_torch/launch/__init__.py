"""Inputs for the port's model entry points (``specs.make_batch``)."""
