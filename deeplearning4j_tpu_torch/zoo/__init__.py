"""Model zoo (the port of ``deeplearning4j_tpu/zoo``): every architecture
of the reference's zoo, BERT on SameDiff, and the local-file pretrained
loader.  ``SRGAN`` and ``PixelShuffleLayer`` wait for
``SameDiffLambdaLayer`` (ROADMAP A12b): their names import, and building
one raises naming that item."""
from deeplearning4j_tpu_torch.zoo.models import (  # noqa: F401
    DLRM, AlexNet, LeNet, ResNet50, SimpleCNN, TwoTowerRecommender, VGG16,
    ZooModel)
from deeplearning4j_tpu_torch.zoo.bert import (  # noqa: F401
    Bert, BertBase, BertConfig)
from deeplearning4j_tpu_torch.zoo.models2 import (  # noqa: F401
    C3D, Darknet19, InceptionResNetV1, SqueezeNet, TinyYOLO, UNet, VGG19,
    Xception)
from deeplearning4j_tpu_torch.zoo.models4 import (  # noqa: F401
    FaceNetNN4Small2, TextGenerationLSTM, YOLO2)
from deeplearning4j_tpu_torch.zoo.models3 import (  # noqa: F401
    NASNet, PixelShuffleLayer, SRGAN)
from deeplearning4j_tpu_torch.zoo.pretrained import (  # noqa: F401
    resolvePretrained, transplant, weightsDir)
