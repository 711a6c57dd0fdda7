"""The port stands alone: ``deeplearning4j_tpu_torch`` and ``chip_smoke.py``
import neither ``jax`` nor anything of ``deeplearning4j_tpu``; importing
the port loads no other framework (tensorflow, onnx, transformers, keras,
h5py: the TF and ONNX importers read their protobufs with their own
readers, the Keras importer its HDF5 files); the port's entry
points default to CUDA with no silent CPU fallback; and the reference's
public import paths resolve in the port too (ROADMAP C7)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.autodiff import SameDiff
from deeplearning4j_tpu_torch.models import ComputationGraph
from deeplearning4j_tpu_torch.nlp.transformer import (TransformerLM,
                                                      TransformerLMConfig)
from deeplearning4j_tpu_torch.nn.conf.attention import KVCache
from deeplearning4j_tpu_torch.zoo import Bert, BertConfig, LeNet, ResNet50

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "deeplearning4j_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "deeplearning4j_tpu")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import deeplearning4j_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {forbidden!r})
print(len(names), "modules;", "leaked:", bad)
sys.exit(1 if bad else 0)
"""


OTHER_FRAMEWORKS = ("tensorflow", "onnx", "transformers", "keras",
                    "tf_keras", "h5py")


def _top(name):
    return name.split(".")[0]


def test_importing_every_port_module_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c",
         _IMPORT_ALL.format(forbidden=set(FORBIDDEN))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "leaked: []" in proc.stdout


def test_importing_every_port_module_loads_no_other_framework():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c",
         _IMPORT_ALL.format(forbidden=set(OTHER_FRAMEWORKS))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "leaked: []" in proc.stdout


def test_only_graphrunners_tensorflow_backend_names_tensorflow():
    """The port imports tensorflow in one place: inside the call that runs
    ``GraphRunner(backend="tensorflow")`` (the reference's meaning of that
    backend)."""
    found = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            if [n for n in names if _top(n) in OTHER_FRAMEWORKS]:
                found.append((str(path.relative_to(REPO)), names))
    assert found == [("deeplearning4j_tpu_torch/imports/graphrunner.py",
                      ["tensorflow"])]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*PKG.rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_no_import_statement_names_jax(path):
    """Static check, so an import inside a function body counts too."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not [n for n in names if _top(n) in FORBIDDEN], \
            f"{path}:{node.lineno} imports {names}"


def test_entry_points_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(TransformerLMConfig(vocabSize=16, nLayers=1,
                                          nHeads=1, headSize=4, maxLen=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVCache.create(1, 1, 8, 4)
    conf = ResNet50(numClasses=4, inputShape=(3, 32, 32)).graphBuilder() \
        .build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ComputationGraph(conf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResNet50().init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LeNet().init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SameDiff.create()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Bert(BertConfig(vocabSize=16, hiddenSize=8, numLayers=1, numHeads=2,
                        intermediateSize=8, maxSeqLength=4))
    assert resolve_device("cpu") == torch.device("cpu")


def test_training_loop_entry_points_default_to_cuda(tmp_path):
    """``ModelSerializer.restore*``, ``EarlyStoppingTrainer`` given a
    configuration and ``TransferLearning`` builders place their model on
    ``cuda`` unless told otherwise, and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from deeplearning4j_tpu_torch.models import TransferLearning
    from deeplearning4j_tpu_torch.optimize import (
        EarlyStoppingConfiguration, EarlyStoppingTrainer)
    from deeplearning4j_tpu_torch.utils import ModelSerializer
    net = LeNet().init(device="cpu")
    path = str(tmp_path / "lenet.zip")
    ModelSerializer.writeModel(net, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelSerializer.restoreMultiLayerNetwork(path)
    assert ModelSerializer.restoreMultiLayerNetwork(
        path, device="cpu").device == torch.device("cpu")
    graph = ComputationGraph(ResNet50(numClasses=4, inputShape=(3, 32, 32))
                             .graphBuilder().build(), device="cpu").init()
    ModelSerializer.writeModel(graph, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ModelSerializer.restoreComputationGraph(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EarlyStoppingTrainer(EarlyStoppingConfiguration.builder().build(),
                             net.conf, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransferLearning.Builder(net).setFeatureExtractor(1).build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransferLearning.GraphBuilder(graph).build()


def test_importer_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from deeplearning4j_tpu_torch.imports import GraphRunner, TFGraphMapper
    skeleton = str(REPO / "tests" / "fixtures"
                   / "tf_bert_base_b32_t128_skeleton.pb")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TFGraphMapper.importGraph(skeleton)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphRunner(skeleton, backend="samediff")


C7_NAMES = [("models", "GraphBuilder"),
            ("models", "ComputationGraphConfiguration"),
            ("models", "MergeVertex"), ("models", "ElementWiseVertex"),
            ("parallel", "dot_product_attention"),
            ("parallel", "flash_attention"),
            ("parallel", "blockwise_attention"),
            ("nn.conf", "WorkspaceMode"),
            ("imports", "TFGraphMapper"), ("imports", "GraphRunner")]


@pytest.mark.parametrize("module,name", C7_NAMES)
def test_reference_public_names_import_from_both_packages(module, name):
    """ROADMAP C7: ``from <package>.<module> import <name>`` works for the
    reference and the port alike."""
    import importlib
    ref = getattr(importlib.import_module(f"deeplearning4j_tpu.{module}"),
                  name)
    port = getattr(importlib.import_module(
        f"deeplearning4j_tpu_torch.{module}"), name)
    assert callable(ref) and callable(port)
    if name == "WorkspaceMode":
        assert {k: v for k, v in vars(port).items() if k.isupper()} == \
            {k: v for k, v in vars(ref).items() if k.isupper()}


_IMPORT_ONE = """
import importlib, sys
importlib.import_module({name!r})
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {forbidden!r})
print("leaked:", bad)
sys.exit(1 if bad else 0)
"""


@pytest.mark.parametrize("sub", ["remote", "telemetry", "fault"])
def test_serving_subpackages_import_no_jax_alone(sub):
    """The serving tier's subpackages, each imported on its own, load
    neither ``jax`` nor the JAX package (their telemetry and fault hooks
    are the port's own copies)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ONE.format(
            name=f"deeplearning4j_tpu_torch.{sub}",
            forbidden=set(FORBIDDEN))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


SERVING_NAMES = [
    *(("remote", n) for n in (
        "ContinuousBatcher", "KVCachePool", "ReplicaSet", "JsonModelServer",
        "JsonRemoteInference", "SameDiffJsonModelServer",
        "AdmissionControl", "BucketedExecutor", "BucketLadder",
        "ForwardServing", "GenerativeServing", "InferenceServer",
        "ModelRegistry", "ServiceOverloaded")),
    *(("remote.serving", n) for n in (
        "DeadlineExceeded", "NoHealthyReplicas", "histogram_quantile")),
    *(("remote.server", n) for n in ("reply_safely", "stream_ndjson",
                                     "KEEPALIVE")),
    *(("telemetry", n) for n in (
        "RequestContext", "TimelineStore", "current_context",
        "parse_traceparent", "request_context", "set_timeline_store",
        "timeline_store", "FlightRecorder", "flight_recorder",
        "set_flight_recorder", "AlertRule", "HealthMonitor",
        "ThresholdRule", "health_summary", "ServingMetrics",
        "clear_exemplars", "exemplar_for", "latency_exemplars",
        "observe_exemplar", "serving_metrics", "DEFAULT_BUCKETS",
        "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
        "set_registry", "MetricsRetention", "ensure_retention",
        "retention", "set_retention", "Tracer", "device_trace_active",
        "set_device_trace_active", "set_tracer", "tracer")),
    ("telemetry.http", "observability_route"),
    *(("fault", n) for n in (
        "InjectedReplicaCrash", "arm_replica_crash", "check_replica_crash",
        "replica_dead", "revive_replica", "set_replica_slowdown",
        "replica_slowdown", "clear_serving_faults")),
    ("nn.conf.attention", "paged_attention"),
]


@pytest.mark.parametrize("module,name", SERVING_NAMES)
def test_serving_tier_names_import_from_both_packages(module, name):
    """The reference's public names of the serving tier, its telemetry and
    its fault hooks resolve in the port under the same paths."""
    import importlib
    ref = getattr(importlib.import_module(f"deeplearning4j_tpu.{module}"),
                  name)
    port = getattr(importlib.import_module(
        f"deeplearning4j_tpu_torch.{module}"), name)
    if callable(ref):
        assert callable(port)
    else:
        assert port == ref or type(port).__name__ == type(ref).__name__


# The reference's fault and telemetry names that wait for the parallel
# layer (ROADMAP A10): the device-loss, partition, heartbeat, leader-crash
# and barrier-kill faults, the elastic, coordination and chaos layers, and
# the mesh, elastic, coordination and AOT-cache instruments.
A10_FAULT_NAMES = {
    "DelayedHeartbeat", "DeviceLossAtStep", "InjectedDeviceLoss",
    "KillAtBarrier", "LeaderCrashMidBarrier", "PartitionedHost",
    "RestoreCapacityAtStep", "StragglerReplica", "arm_barrier_kill",
    "arm_leader_crash", "clear_barrier_kills", "clear_heartbeat_delays",
    "clear_leader_crashes", "clear_lost_devices", "clear_partitioned_hosts",
    "consume_barrier_kill", "consume_leader_crash", "heal_host",
    "heartbeat_delay", "lose_devices", "lost_device_ids", "partition_host",
    "partitioned_host_ids", "restore_devices", "set_heartbeat_delay",
    "DeviceHealthProbe", "ElasticCapacityError", "ElasticSupervisor",
    "is_device_loss_error", "CoordinationError", "GenerationFence",
    "HeartbeatLease", "PodCoordinator", "PodEvictedError",
    "ReadmissionPolicy", "StaleGenerationError", "ChaosSoak",
    "ServingChaosSoak", "build_schedule", "build_serving_schedule"}
A10_TELEMETRY_NAMES = {
    "AotCacheMetrics", "CoordMetrics", "ElasticMetrics", "MeshMetrics",
    "ReplicaTimingListener", "aot_metrics", "coord_metrics",
    "elastic_metrics", "mesh_metrics", "replica_step_gauge"}
FAULT_TELEMETRY_MODULES = [
    "fault", "fault.injection", "fault.supervisor", "telemetry",
    "telemetry.runlog", "telemetry.federation", "telemetry.export",
    "telemetry.otlp", "telemetry.health", "telemetry.instrument",
    "utils.sharded_checkpoint"]


@pytest.mark.parametrize("module", FAULT_TELEMETRY_MODULES)
def test_fault_and_telemetry_public_names_import_from_both_packages(module):
    """Every public name of the reference's fault supervisor, its
    injection harness and its telemetry resolves in the port under the
    same path, but the names that wait for A10, which the port lacks."""
    import importlib
    import types
    ref = importlib.import_module(f"deeplearning4j_tpu.{module}")
    port = importlib.import_module(f"deeplearning4j_tpu_torch.{module}")
    names = getattr(ref, "__all__", None) or [
        n for n in dir(ref) if not n.startswith("_")
        and not isinstance(getattr(ref, n), types.ModuleType)]
    waiting = A10_FAULT_NAMES | A10_TELEMETRY_NAMES
    missing = [n for n in names if n not in waiting and not hasattr(port, n)]
    assert not missing, missing
    assert not [n for n in names if n in waiting and hasattr(port, n)]
    for n in names:
        if n not in waiting and callable(getattr(ref, n)):
            assert callable(getattr(port, n)), n


def test_serving_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from deeplearning4j_tpu_torch.remote import ContinuousBatcher, KVCachePool
    from deeplearning4j_tpu_torch.remote.scheduler import place_replica
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KVCachePool(1, 1, 4)
    lm = TransformerLM(TransformerLMConfig(vocabSize=16, nLayers=1,
                                           nHeads=1, headSize=4, maxLen=16),
                       device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        place_replica(lm, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatcher(lm, device="cuda", maxSlots=1)
    cb = ContinuousBatcher(lm, maxSlots=1)          # follows the model
    assert cb.pool.k.device.type == "cpu"


ONNX_MODULES = ["onnx_import", "onnx_import_ext", "onnx_import_ext2",
                "onnx_import_ext3"]


@pytest.mark.parametrize("mod", ONNX_MODULES)
def test_onnx_importer_modules_import_no_jax_alone(mod):
    """Each module of the ONNX importer, imported on its own, loads
    neither ``jax``, the JAX package nor the ``onnx`` package (the
    ModelProto reader is the port's own)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ONE.format(
            name=f"deeplearning4j_tpu_torch.imports.{mod}",
            forbidden=set(FORBIDDEN) | {"onnx"})],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name", ["OnnxImporter", "importOnnxModel"])
def test_onnx_importer_names_import_from_both_packages(name):
    import importlib
    for pkg in ("deeplearning4j_tpu", "deeplearning4j_tpu_torch"):
        assert callable(getattr(importlib.import_module(f"{pkg}.imports"),
                                name))
    from deeplearning4j_tpu_torch.imports import onnx_import
    assert getattr(onnx_import, name) is getattr(
        importlib.import_module("deeplearning4j_tpu_torch.imports"), name)


def test_onnx_rule_table_is_the_references():
    from deeplearning4j_tpu.imports.onnx_import import _ONNX_OPS as ref
    from deeplearning4j_tpu_torch.imports.onnx_import import _ONNX_OPS
    assert len(ref) == 142 and sorted(_ONNX_OPS) == sorted(ref)


def test_op_registry_holds_the_onnx_rules_ops():
    """The ONNX slice took the registry from 251 ops to 282: the 14
    ``onnx_*`` helper ops and the 17 core ops the rules emit, each a name
    of the reference's registry; the control-flow slice (A12b) took it to
    the reference's 522."""
    import deeplearning4j_tpu.imports  # noqa: F401  (registers onnx_*)
    import deeplearning4j_tpu_torch.imports  # noqa: F401
    from deeplearning4j_tpu.autodiff.samediff import OP_IMPLS as REF
    from deeplearning4j_tpu_torch.autodiff.samediff import OP_IMPLS
    assert len(OP_IMPLS) == 522 == len(REF)
    assert sorted(set(OP_IMPLS) ^ set(REF)) == []
    assert len([n for n in OP_IMPLS if n.startswith("onnx_")]) == 14


def test_onnx_importer_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from deeplearning4j_tpu_torch.imports import (OnnxImporter,
                                                  importOnnxModel)
    model = str(REPO / "tests" / "fixtures" / "torch_tiny_mlp.onnx")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OnnxImporter.importModel(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importOnnxModel(model)
    sd, _, _ = importOnnxModel(model, device="cpu")
    assert sd.device.type == "cpu"


ZOO_SLICE_MODULES = ["nn.conf.layers", "nn.conf.convolutional",
                     "nn.conf.convolutional3d", "nn.conf.misc",
                     "models.graph_conf", "models.graph",
                     "datasets.dataset", "zoo.models", "zoo.models2",
                     "zoo.models3", "zoo.models4", "zoo.pretrained"]


@pytest.mark.parametrize("mod", ZOO_SLICE_MODULES)
def test_zoo_slice_modules_import_no_jax_alone(mod):
    """Each module the zoo slice added or grew, imported on its own, loads
    neither ``jax`` nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ONE.format(
            name=f"deeplearning4j_tpu_torch.{mod}",
            forbidden=set(FORBIDDEN))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_zoo_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """Every zoo model's ``init`` and ``initPretrained`` place their model
    on ``cuda`` unless told otherwise, and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    import deeplearning4j_tpu_torch.zoo as tz
    from deeplearning4j_tpu_torch.utils import ModelSerializer
    small = dict(inputShape=(3, 32, 32), numClasses=3)
    for name in ("SimpleCNN", "AlexNet", "VGG16", "VGG19", "SqueezeNet",
                 "Darknet19", "TinyYOLO", "UNet", "Xception",
                 "InceptionResNetV1", "NASNet", "FaceNetNN4Small2", "YOLO2"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(tz, name)(**small).init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tz.TextGenerationLSTM().init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tz.C3D().init()
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    (tmp_path / "pretrained").mkdir()
    net = tz.SimpleCNN(**small).init(device="cpu")
    ModelSerializer.writeModel(net, str(tmp_path / "pretrained"
                                        / "SimpleCNN_IMAGENET.zip"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tz.SimpleCNN(**small).initPretrained()
    assert tz.SimpleCNN(**small).initPretrained(
        device="cpu").device == torch.device("cpu")


def _reference_names(module):
    """The classes and functions a reference module offers that are its
    package's own (not typing helpers, not submodules)."""
    import importlib
    ref = importlib.import_module(f"deeplearning4j_tpu.{module}")
    return sorted(n for n, v in vars(ref).items()
                  if not n.startswith("_") and callable(v)
                  and getattr(v, "__module__", "").startswith(
                      "deeplearning4j_tpu"))


ZOO_SLICE_NAMES = [(m, n) for m in ("nn.conf", "nn.conf.convolutional",
                                    "models", "zoo")
                   for n in _reference_names(m)]


@pytest.mark.parametrize("module,name", ZOO_SLICE_NAMES)
def test_zoo_slice_public_names_import_from_both_packages(module, name):
    """Every public name of the reference's ``nn.conf``,
    ``nn.conf.convolutional``, ``models`` and ``zoo`` imports from the port
    under the same path; the recommender tier's models (A11) and the
    SameDiff layers and SRGAN (A12b), once unported, build as the
    reference's."""
    import importlib
    port = getattr(importlib.import_module(
        f"deeplearning4j_tpu_torch.{module}"), name)
    assert callable(port)
    if name in ("SRGAN", "PixelShuffleLayer", "SDLayerParams",
                "SameDiffLambdaLayer", "SameDiffLayer"):
        ref = getattr(importlib.import_module(f"deeplearning4j_tpu.{module}"),
                      name)
        built = port()
        assert type(built).__name__ == ref.__name__
        if name == "SRGAN":
            assert (built.numResidualBlocks, built.upscaleFactor) == \
                (ref().numResidualBlocks, ref().upscaleFactor)
        if name == "PixelShuffleLayer":
            assert built.blockSize == ref().blockSize
    elif name in ("TwoTowerRecommender", "DLRM"):
        ref = getattr(importlib.import_module(f"deeplearning4j_tpu.{module}"),
                      name)
        assert port().numEmbeddings == ref().numEmbeddings


KERAS_SLICE_MODULES = ["nn.conf.attention", "nn.conf.autoencoder",
                       "nn.conf.variational", "imports.keras_import",
                       "imports.hdf5"]


@pytest.mark.parametrize("mod", KERAS_SLICE_MODULES)
def test_keras_slice_modules_import_nothing_they_must_not_alone(mod):
    """Each module the Keras slice added or grew, imported on its own,
    loads neither ``jax``, the JAX package, nor h5py, keras or
    tensorflow."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ONE.format(
            name=f"deeplearning4j_tpu_torch.{mod}",
            forbidden=set(FORBIDDEN) | set(OTHER_FRAMEWORKS))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


KERAS_SLICE_NAMES = [(m, n) for m in ("nn.conf.attention",
                                      "nn.conf.autoencoder",
                                      "nn.conf.variational",
                                      "imports.keras_import", "imports")
                     for n in _reference_names(m)]


@pytest.mark.parametrize("module,name", KERAS_SLICE_NAMES)
def test_keras_slice_public_names_import_from_both_packages(module, name):
    """Every public name of the reference's ``nn.conf.attention``,
    ``nn.conf.autoencoder``, ``nn.conf.variational``,
    ``imports.keras_import`` and ``imports`` imports from the port under
    the same path, and none is a stand-in (ROADMAP C19)."""
    import importlib
    port = getattr(importlib.import_module(
        f"deeplearning4j_tpu_torch.{module}"), name)
    assert callable(port)
    assert "is not ported yet" not in (port.__doc__ or "")


def _new_layers():
    import importlib
    out = []
    for mod in ("nn.conf.attention", "nn.conf.autoencoder",
                "nn.conf.variational"):
        ref = importlib.import_module(f"deeplearning4j_tpu.{mod}")
        out += [n for n, v in vars(ref).items() if isinstance(v, type)
                and v.__module__ == ref.__name__
                and hasattr(v, "toJson") and not n.startswith("_")]
    return out


@pytest.mark.parametrize("name", _new_layers())
def test_layer_from_json_loads_every_layer_the_slice_defines(name):
    """The reference's JSON of each layer class of the new modules loads
    in the port and writes back the same JSON."""
    import importlib
    import json
    ref_mod = next(importlib.import_module(f"deeplearning4j_tpu.{m}")
                   for m in ("nn.conf.attention", "nn.conf.autoencoder",
                             "nn.conf.variational")
                   if hasattr(importlib.import_module(
                       f"deeplearning4j_tpu.{m}"), name))
    layer = getattr(ref_mod, name)(nIn=4, nOut=4)
    from deeplearning4j_tpu_torch.nn.conf.layers import layer_from_json
    js = json.loads(json.dumps(layer.toJson(), default=str))
    port = layer_from_json(js)
    assert type(port).__name__ == name
    assert json.dumps(port.toJson(), default=str) == \
        json.dumps(layer.toJson(), default=str)


def test_keras_importer_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from deeplearning4j_tpu_torch.imports import KerasModelImport
    path = str(REPO / "tests" / "fixtures" / "keras_narrow_v3.keras")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KerasModelImport.importKerasModelAndWeights(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KerasModelImport.importKerasSequentialModelAndWeights(path)
    net = KerasModelImport.importKerasModelAndWeights(path, device="cpu")
    assert net.device == torch.device("cpu")


# a package imports every module in it, so ``ops`` and ``datavec`` stand
# for their modules
DATAVEC_SLICE_MODULES = ["config", "native", "ops", "datavec",
                         "datasets.dataset", "telemetry.instrument"]


@pytest.mark.parametrize("mod", DATAVEC_SLICE_MODULES)
def test_datavec_slice_modules_import_no_jax_alone(mod):
    """Each module the DataVec slice added or grew (each package with all
    its modules), imported on its own, loads neither ``jax`` nor the JAX
    package (nor PIL: the port decodes PNG itself and imports PIL only
    inside the call that needs it)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ONE.format(
            name=f"deeplearning4j_tpu_torch.{mod}",
            forbidden=set(FORBIDDEN) | {"PIL"})],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_FORMAT_NAMES = {"AudioFeatureRecordReader", "WavFileRecordReader",
                 "mel_filterbank", "mfcc",
                 "read_wav", "spectrogram", "CodecRecordReader",
                 "ArrowConverter", "ArrowRecordReader", "ExcelRecordReader",
                 "writeXlsx", "ColumnarConverter", "JDBCRecordReader"}

def _own_names(module):
    """The public callables a reference module defines itself."""
    import importlib
    ref = importlib.import_module(f"deeplearning4j_tpu.{module}")
    return [n for n in _reference_names(module)
            if getattr(vars(ref)[n], "__module__", "") == ref.__name__]


DATAVEC_SLICE_NAMES = [(m, n) for m in (
    "config", "native", "ops", "ops.dtype", "ops.ndarray", "ops.factory",
    "ops.random", "ops.serde", "datavec", "datavec.writable",
    "datavec.records", "datavec.schema", "datavec.transform",
    "datavec.join", "datavec.reduce", "datavec.image", "datavec.iterators",
    "datavec.pipeline") for n in _reference_names(m)] + \
    [(f"datavec.{m}", n) for m in ("audio", "codec", "excel", "columnar")
     for n in _own_names(f"datavec.{m}")] + \
    [("datavec.arrow", n) for n in ("ArrowConverter", "ArrowRecordReader")] \
    + [("telemetry", n) for n in ("EtlMetrics", "etl_metrics",
                                  "note_etl_wait")]


@pytest.mark.parametrize("module,name", DATAVEC_SLICE_NAMES)
def test_datavec_slice_public_names_import_from_both_packages(module, name):
    """Every public name of the reference's ``ops``, ``config``, ``native``
    and ``datavec`` (and the ETL names of ``telemetry``) imports from the
    port under the same path and is the port's own: the format readers
    ("A12 datavec formats") and the recommender's ragged reader (A11) are
    ported, defined in the port's module of the same name."""
    import importlib
    port = getattr(importlib.import_module(
        f"deeplearning4j_tpu_torch.{module}"), name)
    assert callable(port)
    assert "is not ported yet" not in (port.__doc__ or "")
    if name in _FORMAT_NAMES or name == "RaggedFeatureReader":
        ref = getattr(importlib.import_module(
            f"deeplearning4j_tpu.{module}"), name)
        assert port.__module__ == ref.__module__.replace(
            "deeplearning4j_tpu.", "deeplearning4j_tpu_torch.")


RECSYS_SLICE_NAMES = [(m, n) for m in ("nn.conf.embedding", "models.recsys")
                      for n in _own_names(m)] + \
    [("zoo", "TwoTowerRecommender"), ("zoo", "DLRM"),
     ("datavec.pipeline", "RaggedFeatureReader"),
     ("datavec.pipeline", "hash_feature"),
     ("telemetry", "RecsysMetrics"), ("telemetry", "recsys_metrics"),
     ("telemetry", "recsys_hash_collision_rule"),
     ("telemetry.health", "recsys_hash_collision_rule")]


@pytest.mark.parametrize("module,name", RECSYS_SLICE_NAMES)
def test_recsys_slice_public_names_import_from_both_packages(module, name):
    """Every public name of the reference's recommender tier imports from
    the port under the same path and is ported; the one exception,
    ``embedding_lookup_table_parallel`` (a ``shard_map`` over a mesh),
    raises naming ROADMAP A10."""
    import importlib
    port = getattr(importlib.import_module(
        f"deeplearning4j_tpu_torch.{module}"), name)
    ref = getattr(importlib.import_module(f"deeplearning4j_tpu.{module}"),
                  name)
    assert callable(port) and callable(ref)
    assert "is not ported yet" not in (port.__doc__ or "")
    if name == "embedding_lookup_table_parallel":
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            port(None, None, None)
    if name == "recsys_metrics":
        assert sorted(n for n in vars(type(port())) if not n.startswith(
            "_")) == sorted(n for n in vars(type(ref()))
                            if not n.startswith("_"))


_NO_PIL_NO_ARROW = """
import importlib, json, sys
for name in {names!r}:
    importlib.import_module(name)
from deeplearning4j_tpu_torch.datavec import ArrowRecordReader
from deeplearning4j_tpu_torch.datavec.gif import read_gif
rr = ArrowRecordReader().initialize({feather!r})
n = sum(1 for _ in rr)
frames = read_gif({gif!r})
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("PIL", "pyarrow", "jax",
                                    "deeplearning4j_tpu"))
print(n, frames.shape, "leaked:", bad)
sys.exit(1 if bad else 0)
"""


def test_format_and_recsys_modules_load_neither_pil_nor_pyarrow():
    """The new modules, imported together, then an LZ4 Feather file and
    a composited GIF read through them (the committed fixtures), load
    neither PIL nor pyarrow (the card's machine has neither) nor JAX."""
    names = [f"deeplearning4j_tpu_torch.{m}" for m in (
        "datavec.excel", "datavec.columnar", "datavec.audio",
        "datavec.gif", "datavec.codec", "datavec.arrowipc", "datavec.arrow",
        "datavec.pipeline", "nn.conf.embedding", "models.recsys", "zoo",
        "telemetry")]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    fx = REPO / "tests" / "fixtures"
    proc = subprocess.run(
        [sys.executable, "-c", _NO_PIL_NO_ARROW.format(
            names=names, feather=str(fx / "arrow_lz4.feather"),
            gif=str(fx / "gif_composited.gif"))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "160 (5, 32, 32, 3) leaked: []" in proc.stdout


def test_nd4j_creation_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from deeplearning4j_tpu_torch.ops import Nd4j
    from deeplearning4j_tpu_torch.ops.ndarray import (host_only_arrays,
                                                      set_host_only_arrays)
    assert not host_only_arrays()
    for make in (lambda: Nd4j.zeros(2), lambda: Nd4j.ones(2, 2),
                 lambda: Nd4j.create([1.0, 2.0]), lambda: Nd4j.rand(3),
                 lambda: Nd4j.randn(3), lambda: Nd4j.arange(4),
                 lambda: Nd4j.linspace(0, 1, 3), lambda: Nd4j.eye(2),
                 lambda: Nd4j.scalar(1.0), lambda: Nd4j.valueArrayOf(2, 3.0),
                 lambda: Nd4j.empty(), lambda: Nd4j.randomBernoulli(0.5, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert Nd4j.zeros(2, device="cpu").torch.device.type == "cpu"
    set_host_only_arrays(True)
    try:
        assert Nd4j.zeros(2).torch.device.type == "cpu"
    finally:
        set_host_only_arrays(False)


def test_native_never_builds_xla_ffi():
    from deeplearning4j_tpu_torch import native
    src = (PKG / "native" / "__init__.py").read_text()
    assert "xla_ffi.cpp" not in native.SOURCES
    assert "*.cpp" not in src               # no glob over native/src
    assert native.available()
    built = native.BUILD_DIR
    assert not [p for p in built.glob("*") if "xla" in p.name]
    assert native.library_path().startswith(str(PKG / "_build"))


SAMEDIFF_SLICE_MODULES = ["autodiff.samediff", "autodiff.gradcheck",
                          "autodiff.validation", "autodiff.op_cases",
                          "nn.conf.samediff_layer"]


_IMPORT_IN_TURN = """
import importlib, json, sys
leaked = {{}}
for name in {names!r}:
    importlib.import_module("deeplearning4j_tpu_torch." + name)
    leaked[name] = sorted(m for m in sys.modules
                          if m.split(".")[0] in {forbidden!r})
print(json.dumps(leaked))
"""


@pytest.fixture(scope="module")
def samediff_slice_leaks():
    """What each of SAMEDIFF_SLICE_MODULES had loaded of FORBIDDEN once
    it was imported, the modules imported in turn in one fresh
    interpreter: a module that loads jax shows it first at its own
    import."""
    import json
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_IN_TURN.format(
            names=SAMEDIFF_SLICE_MODULES, forbidden=set(FORBIDDEN))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mod", SAMEDIFF_SLICE_MODULES)
def test_samediff_slice_modules_import_no_jax(mod, samediff_slice_leaks):
    """Each module the control-flow slice added or grew (A12b), imported in
    a fresh interpreter, loads neither ``jax`` nor the JAX package."""
    assert samediff_slice_leaks[mod] == []


SAMEDIFF_SLICE_NAMES = [("autodiff", n) for n in
                        _reference_names("autodiff")] + [
    (m, n) for m in ("autodiff.samediff", "autodiff.gradcheck",
                     "autodiff.validation", "autodiff.listeners",
                     "autodiff.ops_ext", "autodiff.ops_ext2",
                     "nn.conf.samediff_layer")
    for n in _own_names(m)]


@pytest.mark.parametrize("module,name", SAMEDIFF_SLICE_NAMES)
def test_samediff_slice_public_names_import_from_both_packages(module,
                                                               name):
    """Every public name of the reference's ``autodiff`` modules and
    ``nn.conf.samediff_layer`` imports from the port under the same path
    and is ported (A12b): none is a stand-in that refuses to build."""
    import importlib
    port = getattr(importlib.import_module(
        f"deeplearning4j_tpu_torch.{module}"), name)
    assert callable(port)
    assert "is not ported yet" not in (port.__doc__ or "")
    assert "A12b" not in (port.__doc__ or "")
