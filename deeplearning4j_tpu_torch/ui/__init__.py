"""Training UI — the port of ``deeplearning4j_tpu/ui`` (reference:
deeplearning4j-ui-parent): ``StatsListener`` and its storages, and the
``UIServer`` dashboard."""
from deeplearning4j_tpu_torch.ui.stats import (  # noqa: F401
    FileStatsStorage, InMemoryStatsStorage, RemoteUIStatsStorageRouter,
    StatsListener, StatsStorage)
from deeplearning4j_tpu_torch.ui.server import UIServer  # noqa: F401
