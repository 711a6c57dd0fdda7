"""Nearest neighbors, k-means and t-SNE — the port of
``deeplearning4j_tpu/clustering`` (reference: deeplearning4j-nearestneighbors-
parent — org/deeplearning4j/clustering/vptree/VPTree.java,
kdtree/KDTree.java, kmeans/KMeansClustering.java; plot/BarnesHutTsne)."""
from deeplearning4j_tpu_torch.clustering.trees import KDTree, VPTree  # noqa: F401
from deeplearning4j_tpu_torch.clustering.server import (  # noqa: F401
    NearestNeighborsClient, NearestNeighborsServer)
from deeplearning4j_tpu_torch.clustering.tsne import BarnesHutTsne  # noqa: F401
from deeplearning4j_tpu_torch.clustering.kmeans import (  # noqa: F401
    ClusterSet, KMeansClustering)
