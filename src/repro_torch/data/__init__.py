from repro_torch.data.synthetic import (  # noqa: F401
    dirichlet_partition,
    make_classification_data,
    make_public_private,
    pad_client_shards,
    uniform_client_shards,
)
