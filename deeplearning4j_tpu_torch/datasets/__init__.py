"""DataSet, iterators and normalizers (the port of
``deeplearning4j_tpu/datasets``; nd4j's ``org/nd4j/linalg/dataset`` and
deeplearning4j-data / -datasets)."""
from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: F401
    DataSet, MultiDataSet)
from deeplearning4j_tpu_torch.datasets.iterator import (  # noqa: F401
    DataSetIterator, ExistingDataSetIterator, INDArrayDataSetIterator,
    ListDataSetIterator)
from deeplearning4j_tpu_torch.datasets.normalizers import (  # noqa: F401
    ImagePreProcessingScaler, NormalizerMinMaxScaler, NormalizerStandardize)
from deeplearning4j_tpu_torch.datasets.mnist import (  # noqa: F401
    MnistDataSetIterator)
from deeplearning4j_tpu_torch.datasets.characters import (  # noqa: F401
    CharacterIterator)
from deeplearning4j_tpu_torch.datasets.fetchers import (  # noqa: F401
    Cifar10DataSetIterator, EmnistDataSetIterator, IrisDataSetIterator)
