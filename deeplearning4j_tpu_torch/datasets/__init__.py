"""DataSet and iterators (the port of ``deeplearning4j_tpu/datasets``).
So far ``DataSet``, ``DataSetIterator`` and ``ListDataSetIterator``; the
other iterators, the normalizers and the MNIST/CIFAR fetchers wait for
ROADMAP A5."""
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: F401
from deeplearning4j_tpu_torch.datasets.iterator import (  # noqa: F401
    DataSetIterator, ListDataSetIterator)
