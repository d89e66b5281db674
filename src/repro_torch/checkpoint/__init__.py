"""npz checkpoints of nested tensor trees (counterpart of
``repro.checkpoint``; the client-parameter store of the active engine is
not ported yet)."""
from repro_torch.checkpoint.io import (  # noqa: F401
    CheckpointDtypeError,
    CheckpointError,
    CheckpointKeyError,
    CheckpointShapeError,
    load_pytree,
    save_pytree,
)
