"""npz checkpoints of nested tensor trees, and the active-set engine's
host-resident client-parameter store (counterpart of
``repro.checkpoint``)."""
from repro_torch.checkpoint.io import (  # noqa: F401
    CheckpointDtypeError,
    CheckpointError,
    CheckpointKeyError,
    CheckpointShapeError,
    load_pytree,
    save_pytree,
)
from repro_torch.checkpoint.store import ClientParamStore  # noqa: F401
