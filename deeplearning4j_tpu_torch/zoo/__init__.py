"""Model zoo (the port of ``deeplearning4j_tpu/zoo``).  So far ``LeNet`` and
``ResNet50``; the other architectures and the pretrained weights wait for
ROADMAP A9."""
from deeplearning4j_tpu_torch.zoo.models import (  # noqa: F401
    LeNet, ResNet50, ZooModel)
