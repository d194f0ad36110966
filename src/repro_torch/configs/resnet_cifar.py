"""ResNet-family CNN for the paper-faithful pFedSOP reproduction.

The paper trains ResNet-18 (CIFAR-10) and ResNet-9 (CIFAR-100 / TinyImageNet)
with categorical cross-entropy.  BatchNorm is replaced by GroupNorm: batch
statistics leak across FL clients under vmap'd simulation and are a known
confounder in FL reproductions (see DESIGN.md §8).

``RESNET9_CIFAR100`` / ``RESNET18_CIFAR10`` are the paper-scale configs;
``SMALL_CNN`` is the CPU-budget variant used by the benchmark harness
(same family, reduced width).
"""
from repro_torch.configs.base import ModelConfig

RESNET18_CIFAR10 = ModelConfig(
    name="resnet18-cifar10",
    family="cnn",
    source="He et al. 2016 / pFedSOP Sec. V-B",
    cnn_channels=(64, 128, 256, 512),
    cnn_image_size=32,
    cnn_in_channels=3,
    n_classes=10,
    dtype="float32",
)

RESNET9_CIFAR100 = ModelConfig(
    name="resnet9-cifar100",
    family="cnn",
    source="He et al. 2016 / pFedSOP Sec. V-B",
    cnn_channels=(64, 128, 256),
    cnn_image_size=32,
    cnn_in_channels=3,
    n_classes=100,
    dtype="float32",
)

SMALL_CNN = ModelConfig(
    name="small-cnn",
    family="cnn",
    source="reduced ResNet family (CPU budget)",
    cnn_channels=(16, 32),
    cnn_image_size=16,
    cnn_in_channels=3,
    n_classes=10,
    dtype="float32",
)

CONFIG = RESNET9_CIFAR100
