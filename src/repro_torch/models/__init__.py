from repro_torch.models.resnet import apply_mlp, init_mlp  # noqa: F401
