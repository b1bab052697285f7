"""Paper-repro config: LeNet on (synthetic) FashionMNIST with m=20 workers.

Matches the paper's experimental setup (Section 5): m=20 workers, LeNet
[LeCun et al., 1998], mini-batch SGD with eta=0.03, beta=1/2, four
attacks at alpha in {0, 10%, 25%, 50%}.  The container is offline so the
data pipeline generates a FashionMNIST-like synthetic dataset
(class-conditional Gaussian blobs over 28x28 images, 10 classes).
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class LeNetConfig:
    name: str = "lenet-fmnist"
    image_size: int = 28
    n_classes: int = 10
    conv_channels: tuple = (6, 16)
    fc_dims: tuple = (120, 84)
    n_workers: int = 20
    batch_per_worker: int = 32
    lr: float = 0.03
    beta: float = 0.5


CONFIG = LeNetConfig()
