"""Model configs: stdlib-only copies of ``repro.configs.base`` and
``repro.configs.resnet_cifar``."""
from repro_torch.configs.base import ModelConfig  # noqa: F401
