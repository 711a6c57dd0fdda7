"""DataSet and iterators (the port of ``deeplearning4j_tpu/datasets``).
So far ``DataSet``, ``MultiDataSet``, ``DataSetIterator``,
``ListDataSetIterator`` and ``CharacterIterator``; the other iterators,
the normalizers and the MNIST/CIFAR fetchers wait for ROADMAP A9."""
from deeplearning4j_tpu_torch.datasets.characters import (  # noqa: F401
    CharacterIterator)
from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: F401
    DataSet, MultiDataSet)
from deeplearning4j_tpu_torch.datasets.iterator import (  # noqa: F401
    DataSetIterator, ListDataSetIterator)
