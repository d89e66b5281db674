"""ResNet-20 on CIFAR-10 — the paper's own client/server model (Table III)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="resnet20-cifar",
    family="resnet",
    source="[SCARLET paper, Table III]",
    n_layers=20,
    d_model=16,   # base width
    vocab_size=10,  # classes
)
