"""The paper's own experimental model: LeNet (431,080 learnable params)
trained on (Fashion-)MNIST with D-SGD, n=20 agents, b=128, eta=0.01.

This is a conv classifier, not an LM, so it lives outside the LM ArchConfig
registry; ``repro_torch.models.lenet`` implements it and the
paper-reproduction examples/benchmarks consume this config.

``conv_channels`` and ``hidden`` are not read by the model: it hard-codes
the Caffe widths 20/50/500, which give the paper's 431,080 parameters
(the JAX reference behaves the same way).
"""
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class LeNetConfig:
    image_size: int = 28
    in_channels: int = 1
    conv_channels: Tuple[int, int] = (6, 16)
    kernel: int = 5
    hidden: Tuple[int, int] = (120, 84)
    n_classes: int = 10


@dataclass(frozen=True)
class PaperExperimentConfig:
    """Section 5 experimental setup."""
    n_agents: int = 20
    r_values: Tuple[int, ...] = (0, 1, 3, 5, 10, 15)
    batch_size: int = 128
    step_size: float = 0.01
    iterations: int = 1000
    seeds: Tuple[int, ...] = (0, 1, 2, 3, 4)
    lenet: LeNetConfig = field(default_factory=LeNetConfig)


LENET = LeNetConfig()
PAPER_EXPERIMENT = PaperExperimentConfig()
