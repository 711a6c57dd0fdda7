"""The port's AOT cache (``deeplearning4j_tpu_torch/compile``, ROADMAP
A12h) held to the reference's ``deeplearning4j_tpu/compile/aotcache.py``.

The port's entries are compiled libraries, not executables (ROADMAP C42):
on the CPU the one library the port really compiles is the native host
library (``g++``), so the port's side of each scenario is an
``AotDispatch`` over a function that calls ``dl4j::bitmap_encode`` on a
CPU tensor — the library the cache bakes — and the reference's side a
tiny ``jax.jit`` function, as in the reference's own green ``TestKeying``
tests.  The outcomes are compared: which calls hit, what is quarantined,
how many entries are evicted, what the ladder lists, and the metric names
and labels.  The reference's five red ``test_aotcache.py`` tests have
analogues here under the same names, each checking its property directly
(``test_mesh_warm_resume_donation_safety`` has no port, C43: it checks
that a restore's tensors never alias the checkpoint's instead).

A "fresh process" inside one test is the library registry forgotten
(``_fresh_process``): the loaded native and kernel libraries and the
record of installed entries, which is all a new interpreter would lack.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.utils._pytree

import deeplearning4j_tpu_torch.compile.aotcache as taot
from deeplearning4j_tpu_torch import kernels, native
from deeplearning4j_tpu_torch.native import ffi
from deeplearning4j_tpu_torch.telemetry import (MetricsRegistry,
                                                get_registry, set_registry)

pytestmark = [pytest.mark.torch_port, pytest.mark.aot]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAU = 0.5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests' small CPU ops run on one intra-op thread: beside the
    suite's other workers, a thread pool per op mostly waits."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def registry():
    prev = set_registry(MetricsRegistry())
    yield get_registry()
    set_registry(prev)


@pytest.fixture
def port_cache(tmp_path, registry, monkeypatch):
    """A fresh process-global cache in ``tmp_path / "aot"``; restored to
    unconfigured afterwards."""
    monkeypatch.setattr(taot, "_CACHE", None)
    monkeypatch.setattr(taot, "_CACHE_EXPLICIT", False)
    d = str(tmp_path / "aot")
    taot.set_aot_cache(d)
    _fresh_process(monkeypatch)
    return taot.aot_cache()


def _fresh_process(monkeypatch):
    monkeypatch.setattr(native, "_state", None)
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(taot, "_INSTALLED", {})


def _val(name, **labels):
    c = get_registry().get(name)
    if c is None:
        return 0.0
    try:
        return c.value(**labels)
    except ValueError:
        return 0.0


def _encode(x):
    """The port side's boot-path function: one call of the native op."""
    return ffi.bitmap_encode(x, TAU)


def _residual(n=1001, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(n).astype(np.float32))


def _seed_entries(baked, directory):
    """Copy the baked cache's entries (not its ladders) into a new cache
    directory: a warm library store whose ladders are yet to be
    recorded."""
    os.makedirs(directory, exist_ok=True)
    for fn in os.listdir(baked):
        if fn.endswith(".aotx"):
            shutil.copy(os.path.join(baked, fn), directory)


# ---------------------------------------------------------------------------
# one subprocess pair: a cold boot bakes the native library, a second boot
# (no compiler reachable) loads it.  The cold boot's directory seeds the
# warm starts of the other tests.
# ---------------------------------------------------------------------------

_BOOT = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from deeplearning4j_tpu_torch import kernels, native
from deeplearning4j_tpu_torch.compile.aotcache import AotDispatch, wrap_jit
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.learning import Adam
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.native import ffi
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.telemetry import get_registry

def encode(x):
    return ffi.bitmap_encode(x, 0.5)

disp = wrap_jit(encode, kind="train_step")
preloaded = disp.loadedCount()
x = torch.from_numpy(np.random.RandomState(0).randn(1001).astype(np.float32))
r, w, c = disp(x)
conf = (NeuralNetConfiguration.builder().seed(3).updater(Adam(0.01)).list()
        .layer(DenseLayer.builder().nIn(8).nOut(16).activation("relu").build())
        .layer(OutputLayer.builder("mcxent").nOut(4).activation("softmax")
               .build())
        .setInputType(InputType.feedForward(8)).build())
net = MultiLayerNetwork(conf, device="cpu").init()
rng = np.random.RandomState(0)
for _ in range(2):
    net.fit(DataSet(rng.randn(16, 8).astype(np.float32),
                    np.eye(4, dtype=np.float32)[rng.randint(0, 4, 16)]))
reg = get_registry()
def val(name, **labels):
    m = reg.get(name)
    try:
        return 0.0 if m is None else m.value(**labels)
    except ValueError:
        return 0.0
step = net.__dict__.get("_trainStep")
print(json.dumps({
    "preloaded": preloaded,
    "cache_size": disp._cache_size(),
    "compiler_runs": kernels.compiler_runs.count + native.compiler_runs.count,
    "hits": val("dl4j_tpu_aot_cache_hits_total", kind="train_step"),
    "misses": val("dl4j_tpu_aot_cache_misses_total", kind="train_step"),
    "step_is_dispatch": isinstance(step, AotDispatch),
    "step_cache_size": step._cache_size(),
    "compile_seconds": val("dl4j_tpu_train_compile_seconds_total"),
    "words": w.view(torch.int32).tolist(), "count": int(c),
    "residual": r.tolist(), "loss": float(net.score())}))
"""


def _boot(cache_dir, **env):
    e = dict(os.environ, PYTHONPATH=REPO, DL4J_TPU_AOT_CACHE_DIR=cache_dir,
             **env)
    e.pop("DL4J_TPU_AOT_CACHE", None)
    proc = subprocess.run([sys.executable, "-c", _BOOT], cwd=REPO, env=e,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def baked(tmp_path_factory):
    """The cold boot: a fresh process against an empty cache directory."""
    d = str(tmp_path_factory.mktemp("baked") / "aot")
    return d, _boot(d)


class TestWarmBoot:
    def test_second_boot_compile_seconds_zero(self, baked, tmp_path):
        """The reference's acceptance bar, as a process pair: the second
        boot of the same function and net starts no compiler (``CXX``
        points at nothing, so any build or probe would fail) and loads
        the library off its ladder — ``_cache_size()`` 0, no train
        compile seconds, outputs bit-equal to the cold boot's."""
        d, cold = baked
        assert cold["cache_size"] == 1 and cold["compiler_runs"] == 1
        assert cold["misses"] == 1 and cold["hits"] == 0
        assert cold["preloaded"] == 0
        assert cold["step_is_dispatch"] and cold["step_cache_size"] == 0
        warm_dir = str(tmp_path / "aot")
        shutil.copytree(d, warm_dir)
        warm = _boot(warm_dir, CXX=str(tmp_path / "no-such-compiler"))
        assert warm["compiler_runs"] == 0 and warm["cache_size"] == 0
        assert warm["preloaded"] == 1 and warm["hits"] == 1
        assert warm["misses"] == 0
        assert warm["step_is_dispatch"] and warm["step_cache_size"] == 0
        assert warm["compile_seconds"] == 0
        for k in ("words", "count", "residual", "loss"):
            assert warm[k] == cold[k], k

    def test_disabled_is_the_plain_step(self, registry, monkeypatch):
        """With the cache off (the default) the train step is the net's
        own ``_runTrainStep``, nothing is stored on the net, and the
        step's compile accounting stays unset."""
        monkeypatch.setattr(taot, "_CACHE", None)
        monkeypatch.setattr(taot, "_CACHE_EXPLICIT", False)
        monkeypatch.delenv("DL4J_TPU_AOT_CACHE_DIR", raising=False)
        net = _mlp().init()
        net.fit(_batches(1)[0])
        assert taot.aot_cache() is None
        assert not isinstance(net._trainStep, taot.AotDispatch)
        assert net._trainStep == net._runTrainStep
        assert "_trainStep" not in net.__dict__
        assert get_registry().get("dl4j_tpu_train_compile_seconds_total") \
            is None
        assert taot.preload_model(net) == 0
        assert taot.wrap_serving_model(net) is False


def _mlp(seed=3, nOut=4, dataType=None, cls=None):
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    b = NeuralNetConfiguration.builder().seed(seed).updater(Adam(0.01))
    if dataType:
        b = b.dataType(dataType)
    conf = (b.list()
            .layer(DenseLayer.builder().nIn(8).nOut(16)
                   .activation("relu").build())
            .layer(OutputLayer.builder("mcxent").nOut(nOut)
                   .activation("softmax").build())
            .setInputType(InputType.feedForward(8)).build())
    return (cls or MultiLayerNetwork)(conf, device="cpu")


def _batches(n=2, batch=16, seed=0):
    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.RandomState(seed)
    return [DataSet(rng.randn(batch, 8).astype(np.float32),
                    np.eye(4, dtype=np.float32)[rng.randint(0, 4, batch)])
            for _ in range(n)]


# ---------------------------------------------------------------------------
# keying: the reference's digests, versions, the compiler
# ---------------------------------------------------------------------------

KEYS = [
    {"kind": "train_step", "versions": {"jax": "0.4", "x": (1, 2)}},
    {"b": [3, {"z": None, "a": 1.5}], "a": frozenset({"q", "p"})},
    ("tuple", 1, True, None, "s"),
    {"nested": {"deeper": [{"k": "v"}, [1, 2, [3]]]}, 7: "int key"},
]


@pytest.mark.parametrize("key", KEYS, ids=range(len(KEYS)))
def test_digest_and_canon_equal_the_references(key):
    from deeplearning4j_tpu.compile import aotcache as jaot
    assert taot._canon(key) == jaot._canon(key)
    assert taot._digest(key) == jaot._digest(key)


def test_model_digest_keeps_the_references_relations():
    """Same architecture with weights from two seeds: one digest; another
    ``nOut`` or dtype: another digest — in both packages."""
    import jax
    from deeplearning4j_tpu.compile.aotcache import model_digest as jdigest
    from deeplearning4j_tpu.learning import Adam as JAdam
    from deeplearning4j_tpu.models import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.nn.conf import (InputType as JIT,
                                            NeuralNetConfiguration as JNNC)
    from deeplearning4j_tpu.nn.conf.layers import (DenseLayer as JDense,
                                                   OutputLayer as JOut)

    def jmlp(nOut=4, dataType=None):
        b = JNNC.builder().seed(3).updater(JAdam(0.01))
        if dataType:
            b = b.dataType(dataType)
        return JMLN(b.list()
                    .layer(JDense.builder().nIn(8).nOut(16)
                           .activation("relu").build())
                    .layer(JOut.builder("mcxent").nOut(nOut)
                           .activation("softmax").build())
                    .setInputType(JIT.feedForward(8)).build())

    def weights(net, seed):
        rng = np.random.RandomState(seed)
        return jax.tree.map(
            lambda v: rng.randn(*np.shape(v)).astype(np.asarray(v).dtype),
            jax.tree.map(np.asarray, net.params_))

    j = jmlp().init()
    j_a, j_b = j, jmlp().init()
    j_b.params_ = weights(j, 2)
    j_a.params_ = weights(j, 1)
    p_a = _mlp().init(params=weights(j, 1))
    p_b = _mlp().init(params=weights(j, 2))
    assert jdigest(j_a) == jdigest(j_b)
    assert taot.model_digest(p_a) == taot.model_digest(p_b)
    assert jdigest(jmlp(nOut=5).init()) != jdigest(j_a)
    assert taot.model_digest(_mlp(nOut=5).init()) != taot.model_digest(p_a)
    assert jdigest(jmlp(dataType="BFLOAT16").init()) != jdigest(j_a)
    assert taot.model_digest(_mlp(dataType="BFLOAT16").init()) != \
        taot.model_digest(p_a)


def test_model_digest_ignores_the_order_of_parameter_keys():
    """A checkpoint restore hands back the parameter tree with its keys in
    another order; the topology, and so the ladder, is the same (JAX
    flattens dict keys sorted, so the reference's digest has this
    property too)."""
    net = _mlp().init()
    want = taot.model_digest(net)
    net.params_ = {k: dict(reversed(list(lp.items())))
                   for k, lp in reversed(list(net.params_.items()))}
    assert list(net.params_) == ["1", "0"]
    assert taot.model_digest(net) == want


def test_entry_key_follows_the_compiler_and_the_cuda_runtime(monkeypatch):
    """A changed compiler ``--version`` line or ``torch.version.cuda``
    gives another entry key; the bare ``_build/`` store keeps its own
    naming (the content hash alone)."""
    target = native._target().name
    kernel_target = kernels._target(kernels.CSRC / "flash_attn_fwd.cu").name
    monkeypatch.setattr(taot, "compiler_line", lambda exe: "g++ (A) 13.2.0")
    base, key = native.entry_key()
    assert key["kind"] == "native" and key["content"] == \
        native.content_hash()
    monkeypatch.setattr(taot, "compiler_line", lambda exe: "g++ (B) 14.1.0")
    other, _ = native.entry_key()
    monkeypatch.setattr(torch.version, "cuda", "99.9")
    cuda, _ = native.entry_key()
    assert len({base, other, cuda}) == 3
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    k1, kkey = kernels.entry_key("flash_attn_fwd")
    monkeypatch.setattr(taot, "compiler_line",
                        lambda exe: "Cuda compilation tools, release 12.4")
    k2, _ = kernels.entry_key("flash_attn_fwd")
    assert k1 != k2 and kkey["versions"]["cuda"] == "99.9"
    assert native._target().name == target
    assert kernels._target(kernels.CSRC / "flash_attn_fwd.cu").name == \
        kernel_target
    assert target.startswith("libdl4j_native-") and \
        target[len("libdl4j_native-"):-3] == native.content_hash()[:12]


def test_the_cache_turned_on_after_the_first_native_call_keeps_the_library(
        tmp_path, registry, monkeypatch):
    """A library is resolved once per process: a process that turns the
    cache on after its first native call keeps the ``_build/`` library it
    loaded (no compiler run, no entry baked), and its ladder records list
    no entry, since no library came from the cache."""
    monkeypatch.setattr(taot, "_CACHE", None)
    monkeypatch.setattr(taot, "_CACHE_EXPLICIT", False)
    monkeypatch.delenv("DL4J_TPU_AOT_CACHE_DIR", raising=False)
    _fresh_process(monkeypatch)
    first = _encode(_residual())
    path = native.library_path()
    assert path is not None and path.startswith(str(native.BUILD_DIR))
    runs = native.compiler_runs.count
    taot.set_aot_cache(str(tmp_path / "aot"))
    d = taot.wrap_jit(_encode, kind="train_step")
    for got, want in zip(d(_residual()), first):
        assert torch.equal(got, want)
    assert native.library_path() == path
    assert native.compiler_runs.count == runs and d._cache_size() == 0
    assert taot.aot_cache().entries() == []
    assert [r["digests"] for r in taot.aot_cache().ladder(d.group)] == [[]]


def test_the_ladder_lists_the_kernel_library_that_launched(port_cache):
    """A kernel library is never swapped once resolved: a second entry for
    the same source is refused, and a call's ladder record lists the entry
    its checked launches used (on the CPU no kernel builds, so the entries
    stand in for loaded libraries)."""
    def entry(digest):
        return taot.CachedLibrary(
            digest, {"kind": "kernel", "name": "flash_attn_fwd"},
            "unused.so", object(), port_cache.directory)

    first, other = entry("a" * 64), entry("b" * 64)
    assert kernels._install(first) is True
    assert kernels._install(other) is False
    assert kernels._install(first) is True
    assert kernels._libs["flash_attn_fwd"].digest == first.digest

    def launch(x):
        kernels.check("flash_attn_fwd", 0, "flash forward")
        return x + 1

    d = taot.wrap_jit(launch, kind="output")
    d(torch.zeros(2))
    assert [r["digests"] for r in port_cache.ladder(d.group)] == \
        [[first.digest]]


def test_kernel_build_bakes_each_library_once(port_cache, baked,
                                              monkeypatch, capsys):
    """``aotc bake`` for ``--device cuda`` (its default) runs
    ``kernels.build()`` through the cache: every ``csrc/*.cu`` without an
    entry is compiled once and published as a ``kernel`` entry, and a
    second bake finds them all and compiles nothing; ``--device cpu``
    bakes no kernel library.  There is no nvcc here: a compile that writes
    each library's bytes stands in for it."""
    from deeplearning4j_tpu_torch.compile import aotc
    d = port_cache.directory
    _seed_entries(baked[0], d)
    runs = taot.CompilerRuns()
    monkeypatch.setattr(kernels, "compiler_runs", runs)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    line = taot.compiler_line
    monkeypatch.setattr(taot, "compiler_line", lambda exe: (
        "Cuda compilation tools, release 12.4" if exe == "nvcc"
        else line(exe)))

    def compile_(todo):
        for src, out in todo:
            out.write_bytes(b"library of " + src.stem.encode())
        runs.add([src.stem for src, _out in todo], 0.0)
        return {src.stem: "" for src, _out in todo}

    monkeypatch.setattr(kernels, "_compile", compile_)

    def bake(*extra):
        assert aotc.main(["bake", "--cache-dir", d, *extra]) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    names = sorted(p.stem for p in kernels.CSRC.glob("*.cu"))
    cpu = bake("--device", "cpu")
    assert "kernels_built" not in cpu and runs.count == 0
    cold = bake()
    assert cold["kernels_built"] == names and sorted(runs.names) == names
    assert cold["entries_baked"] == len(names)
    keys = [port_cache.entryKey(e[0]) for e in port_cache.entries()]
    assert sorted(k["name"] for k in keys if k["kind"] == "kernel") == names
    warm = bake()
    assert warm["kernels_built"] == [] and warm["compiler_runs"] == 0
    assert warm["entries_baked"] == 0 and runs.count == len(names)


def test_version_mismatch_misses(port_cache, baked, monkeypatch):
    """A group keyed under other versions finds no ladder, and an entry
    whose stored versions differ from this process's is a miss, never a
    load."""
    _seed_entries(baked[0], port_cache.directory)
    d1 = taot.wrap_jit(_encode, kind="train_step")
    d1(_residual())
    assert d1._cache_size() == 0 and d1.loadedCount() == 1
    monkeypatch.setattr(taot, "version_fingerprint",
                        lambda: {"torch": "0.0.0-other"})
    _fresh_process(monkeypatch)
    d2 = taot.wrap_jit(_encode, kind="train_step")
    assert d2.group != d1.group
    assert d2.preload() == 0
    (digest,) = [e[0] for e in port_cache.entries()]
    miss0 = _val("dl4j_tpu_aot_cache_misses_total", kind="native")
    assert port_cache.get(digest, kind="native") is None
    assert _val("dl4j_tpu_aot_cache_misses_total", kind="native") == \
        miss0 + 1
    assert os.path.exists(port_cache.entryPath(digest))   # not quarantined


def test_remesh_never_loads_pre_remesh_executable(port_cache, baked,
                                                  monkeypatch):
    """The port's analogue of the reference's re-mesh test (the mesh
    itself waits for A10): another device set hashes to another group, so
    nothing recorded for the old set preloads — ``preload()`` returns 0
    and no hit is counted; back on the old set the ladder loads again.
    A plan raises naming A10 and leaves the callable unwrapped."""
    _seed_entries(baked[0], port_cache.directory)
    d1 = taot.wrap_jit(_encode, kind="train_step")
    d1(_residual())
    assert d1.loadedCount() == 1
    hits0 = _val("dl4j_tpu_aot_cache_hits_total", kind="train_step")
    monkeypatch.setattr(taot, "device_fingerprint",
                        lambda devices=None: [[0, "NVIDIA H100", "9.0"]])
    _fresh_process(monkeypatch)
    d2 = taot.wrap_jit(_encode, kind="train_step")
    assert d2.group != d1.group
    assert d2.preload() == 0
    assert _val("dl4j_tpu_aot_cache_hits_total", kind="train_step") == hits0
    monkeypatch.setattr(taot, "device_fingerprint",
                        lambda devices=None: [["cpu"]])
    _fresh_process(monkeypatch)
    d3 = taot.wrap_jit(_encode, kind="train_step")
    assert d3.group == d1.group and d3.loadedCount() == 1
    assert _val("dl4j_tpu_aot_cache_hits_total", kind="train_step") == \
        hits0 + 1
    with pytest.raises(NotImplementedError, match="A10"):
        taot.plan_digest(object())
    assert taot.wrap_jit(_encode, kind="mesh_step", plan=object()) is _encode


# ---------------------------------------------------------------------------
# one scenario through both packages
# ---------------------------------------------------------------------------

_AOT_NAMES = ("dl4j_tpu_aot_cache_hits_total",
              "dl4j_tpu_aot_cache_misses_total",
              "dl4j_tpu_aot_cache_quarantined_total")


def _counts(get_registry_fn):
    reg = get_registry_fn()
    out = {}
    for name in _AOT_NAMES:
        m = reg.get(name)
        out[name] = {} if m is None else {
            json.dumps(k): v for k, v in m.data()["cells"]}
    return out


def _flip(path):
    blob = open(path, "rb").read()
    mid = len(blob) // 2
    with open(path, "wb") as fh:              # flip bytes mid-payload
        fh.write(blob[:mid] + bytes(b ^ 0xFF for b in blob[mid:mid + 7])
                 + blob[mid + 7:])


def _boots(pkg, wrap, fresh, make, x, cache, call_warm=True):
    """Cold boot, warm boot, then a boot after a flipped entry: per boot
    the preload count, the fresh compiles, the entries on the group's
    ladder and the output; the metric cells after each.  The reference's
    warm boot only preloads: a deserialized executable does not run on
    this CPU's eight virtual devices (the reason its warm-boot tests are
    red), and its call would count nothing either way."""
    out = []
    for boot in range(3):
        if boot == 2:
            (entry,) = cache.entries()
            _flip(cache.entryPath(entry[0]))
        fresh()
        d = wrap(make(), kind="train_step")
        pre = d.loadedCount()
        y = d(x) if boot != 1 or call_warm else None
        ladder = cache.ladder(d.group)
        out.append({"preloaded": pre, "fresh": d._cache_size(),
                    "ladder": len(ladder), "y": y,
                    "quarantine": len(os.listdir(os.path.join(
                        cache.directory, "quarantine")))
                    if os.path.isdir(os.path.join(cache.directory,
                                                  "quarantine")) else 0,
                    "metrics": _counts(pkg)})
    return out


def test_hits_quarantine_and_ladder_outcomes_equal_the_references(
        port_cache, tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.compile import aotcache as jaot
    from deeplearning4j_tpu.telemetry import (MetricsRegistry as JReg,
                                              get_registry as jget,
                                              set_registry as jset)
    prev = jset(JReg())
    jaot.set_aot_cache(str(tmp_path / "ref"))
    try:
        ref = _boots(jget, jaot.wrap_jit, lambda: None,
                     lambda: jax.jit(lambda v: v + 1), jnp.ones(4),
                     jaot.aot_cache(), call_warm=False)
    finally:
        jaot.set_aot_cache(None)
        jset(prev)
    port = _boots(get_registry, taot.wrap_jit,
                  lambda: _fresh_process(monkeypatch), lambda: _encode,
                  _residual(), port_cache)
    for r, p in zip(ref, port):
        assert {k: v for k, v in r.items() if k != "y"} == \
            {k: v for k, v in p.items() if k != "y"}
    assert [b["fresh"] for b in port] == [1, 0, 1]
    assert [b["preloaded"] for b in port] == [0, 1, 0]
    for b in port[1:]:
        for got, want in zip(b["y"], port[0]["y"]):
            assert torch.equal(got, want)
    np.testing.assert_array_equal(np.asarray(ref[2]["y"]),
                                  np.asarray(ref[0]["y"]))
    assert native.compiler_runs.count >= 2


def test_lru_eviction_outcome_equals_the_references(port_cache, tmp_path):
    """Three entries, the oldest first, bounded to twice the largest: both
    packages evict exactly the oldest, drop the ladder records that list
    it, count one eviction, and a fresh dispatch preloads exactly the
    survivors."""
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.compile import aotcache as jaot
    from deeplearning4j_tpu.telemetry import (MetricsRegistry as JReg,
                                              get_registry as jget,
                                              set_registry as jset)

    def evict(cache, ladder_digests):
        order = sorted(cache.entries(), key=lambda e: e[2])
        for i, (d, _s, _m) in enumerate(order):
            os.utime(cache.entryPath(d), (1e9 + i, 1e9 + i))
        before = [d for d, _s, _m in order]
        cache.maxBytes = max(s for _d, s, _m in cache.entries()) * 2
        cache._evict()
        after = {d for d, _s, _m in cache.entries()}
        return {"evicted": [i for i, d in enumerate(before)
                            if d not in after],
                "ladder": sorted(before.index(d) for d in
                                 ladder_digests(cache) if d in before)}

    prev = jset(JReg())
    jaot.set_aot_cache(str(tmp_path / "ref"))
    try:
        d = jaot.wrap_jit(jax.jit(lambda v: v * 3), kind="train_step")
        for n in (4, 8, 16):
            d(jnp.ones(n))
        ref = evict(jaot.aot_cache(), lambda c: [
            e["digest"] for e in c.ladder(d.group)])
        ref["evictions"] = jget().get(
            "dl4j_tpu_aot_cache_evictions_total").value()
    finally:
        jaot.set_aot_cache(None)
        jset(prev)
    group = "g" * 64
    rng = np.random.RandomState(0)
    for i in range(3):
        key = {"kind": "native", "name": f"lib{i}", "content": str(i)}
        digest = taot._digest(key)
        port_cache.put(digest, rng.bytes(4096), key)
        port_cache.recordLadder(group, f"sig{i}", [digest])
    port = evict(port_cache, lambda c: [
        e["digests"][0] for e in c.ladder(group)])
    port["evictions"] = _val("dl4j_tpu_aot_cache_evictions_total")
    assert port == ref == {"evicted": [0], "ladder": [1, 2],
                           "evictions": 1.0}


def test_tmp_sweep_removes_only_aged_orphans(port_cache):
    cache = port_cache
    os.makedirs(os.path.join(cache.directory, "lib"), exist_ok=True)
    cache.recordLadder("g" * 64, "sig", [])
    dirs = [cache.directory, os.path.join(cache.directory, "lib"),
            cache._ladderDir("g" * 64)]
    for d in dirs:
        for age, name in ((7200, "old.123.4.tmp"), (0, "live.123.5.tmp")):
            p = os.path.join(d, name)
            open(p, "wb").write(b"x")
            t = os.path.getmtime(p) - age
            os.utime(p, (t, t))
    cache._evict()
    for d in dirs:
        assert not os.path.exists(os.path.join(d, "old.123.4.tmp"))
        assert os.path.exists(os.path.join(d, "live.123.5.tmp"))


def test_metric_names_labels_and_buckets_equal_the_references():
    from deeplearning4j_tpu.telemetry import (MetricsRegistry as JReg,
                                              set_registry as jset)
    from deeplearning4j_tpu.telemetry.instrument import \
        AotCacheMetrics as JMetrics
    from deeplearning4j_tpu_torch.telemetry.instrument import \
        AotCacheMetrics as TMetrics

    def shape(m):
        out = {}
        for attr in ("hits", "misses", "load_seconds", "bake_seconds",
                     "evictions", "quarantined"):
            metric = getattr(m, attr)()
            out[attr] = (metric.name, type(metric).__name__,
                         tuple(getattr(metric, "labelnames", ())),
                         tuple(getattr(metric, "buckets", ()) or ()))
        return out

    prev = jset(JReg())
    try:
        ref = shape(JMetrics())
    finally:
        jset(prev)
    old = set_registry(MetricsRegistry())
    try:
        port = shape(TMetrics())
    finally:
        set_registry(old)
    assert port == ref


# ---------------------------------------------------------------------------
# the boot paths: serving warm-up, resume, and the checkpoint's buffers
# ---------------------------------------------------------------------------

class _CodecNet:
    """A forward model whose output runs a native op: on the CPU the
    port's kernels never build (their plain versions run), so this model
    gives the serving path a compiled library to cache."""

    def output(self, x, featuresMask=None):
        return self._output(x, featuresMask)

    def _output(self, x, featuresMask=None):
        t = torch.as_tensor(np.asarray(x, np.float32))
        return _encode(t.reshape(-1))[0].reshape(t.shape)


def test_ladder_loads_instead_of_compiling(port_cache, monkeypatch):
    """Serving boot 2 preloads the ladder in ``warm()``: no warm-up
    compile, a cache hit, the same answers, and both warm-ups timed."""
    from deeplearning4j_tpu_torch.remote import (BucketedExecutor,
                                                 BucketLadder,
                                                 ForwardServing)
    ladder = BucketLadder(batchSizes=(1, 2), seqLens=())
    x = np.random.RandomState(1).randn(2, 8).astype(np.float32)

    def boot(name):
        ex = BucketedExecutor(ForwardServing(_CodecNet(), ladder,
                                             inputShape=(8,)),
                              name=name).start()
        try:
            return ex.submit(x.tolist()), ex.serving.compileCacheSize()
        finally:
            ex.shutdown()

    out1, size1 = boot("cold")
    assert _val("dl4j_tpu_serving_warmup_compiles_total",
                model="cold") == 1 and size1 == 1
    _fresh_process(monkeypatch)
    out2, size2 = boot("warm")
    assert _val("dl4j_tpu_serving_warmup_compiles_total",
                model="warm") == 0 and size2 == 0
    assert _val("dl4j_tpu_aot_cache_hits_total", kind="output") >= 1
    np.testing.assert_array_equal(np.asarray(out2), np.asarray(out1))
    assert _val("dl4j_tpu_serving_compile_cache_hits_total",
                model="warm") == 1
    hist = get_registry().get("dl4j_tpu_serving_warmup_seconds")
    assert hist.count(model="cold") == 1 and hist.count(model="warm") == 1


def _codec_mlp():
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork

    class CodecMLN(MultiLayerNetwork):
        """A net whose step also encodes its first weight matrix with the
        native op, as the parallel layer's gradient sharing will: on the
        CPU that is the step's compiled library."""

        def _runTrainStep(self, *args, **kwargs):
            out = super()._runTrainStep(*args, **kwargs)
            ffi.threshold_count(self.params_["0"]["W"], TAU)
            return out

    return _mlp(cls=CodecMLN)


def test_kill_resume_no_recompile(port_cache, baked, tmp_path, monkeypatch):
    """The kill/resume loop on a warm cache: the resumed process restores
    the checkpoint and preloads the step's library before its first step
    — no compiler run on resume, a hit, the reference's step count."""
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    from deeplearning4j_tpu_torch.fault import (FaultTolerantTrainer,
                                                PreemptAtStep,
                                                SimulatedPreemption, inject)
    _seed_entries(baked[0], port_cache.directory)
    batches = _batches(4, batch=8)

    def boot():
        net = _codec_mlp().init()
        return net, FaultTolerantTrainer(net, str(tmp_path / "run"),
                                         checkpointEveryN=2, keepLast=10,
                                         durableExport=False)

    net, trainer = boot()
    with inject(PreemptAtStep(3)):
        with pytest.raises(SimulatedPreemption):
            trainer.fit(ListDataSetIterator(batches, 8), epochs=1)
    trainer.close()
    assert net._trainStep._cache_size() == 0
    _fresh_process(monkeypatch)
    cs0 = _val("dl4j_tpu_train_compile_seconds_total")
    hits0 = _val("dl4j_tpu_aot_cache_hits_total", kind="train_step")
    runs0 = native.compiler_runs.count
    net2, trainer2 = boot()
    trainer2.fit(ListDataSetIterator(batches, 8), epochs=1)
    trainer2.close()
    assert trainer2.stats["resumedFromStep"] is not None
    assert net2.iterationCount == 4
    assert net2._trainStep._cache_size() == 0
    assert native.compiler_runs.count == runs0
    assert _val("dl4j_tpu_train_compile_seconds_total") == cs0
    assert _val("dl4j_tpu_aot_cache_hits_total", kind="train_step") == \
        hits0 + 1


def test_mesh_warm_resume_donation_safety(tmp_path):
    """No port (ROADMAP C43): the reference copies restored buffers
    because XLA's donation would delete them; torch donates nothing.  What
    the property protects holds directly: a restore's tensors never alias
    the checkpointer's staging buffer, and stepping the restored net
    leaves the checkpoint's bytes as saved."""
    from deeplearning4j_tpu_torch.utils.sharded_checkpoint import \
        ShardedCheckpointer
    net = _mlp().init()
    net.fit(_batches(1)[0])
    ck = ShardedCheckpointer(str(tmp_path / "ck"))
    ck.save(net, step=1)
    ck.waitUntilFinished()
    saved = {k: v.clone() for k, v in net.params_["0"].items()}
    net2 = ck.restore(_mlp().init(), step=1)
    lo = ck._staging.data_ptr()
    hi = lo + ck._staging.numel()
    for tree in (net2.params_, net2.optState_):
        for leaf in torch.utils._pytree.tree_leaves(tree):
            if isinstance(leaf, torch.Tensor) and leaf.numel():
                assert not lo <= leaf.data_ptr() < hi
    net2.fit(_batches(1, seed=5)[0])
    assert not torch.equal(net2.params_["0"]["W"], saved["W"])
    net3 = ck.restore(_mlp().init(), step=1)
    for k, v in saved.items():
        assert torch.equal(net3.params_["0"][k], v)
    ck.close()


def test_aotc_bake_ls_gc(port_cache, baked, capsys):
    """The port's ``aotc``: a bake of an MLP's forward ladder and train
    step prints one JSON line and records their ladders; ``ls`` names the
    entry's kind; ``gc`` to zero empties the store; ``--mesh-data`` raises
    naming A10."""
    from deeplearning4j_tpu_torch.compile import aotc
    d = port_cache.directory
    _seed_entries(baked[0], d)
    assert aotc.main(["bake", "--cache-dir", d, "--mlp", "8,16,4",
                      "--batches", "2", "--train", "--device", "cpu"]) == 0
    bake = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert bake["native"] and bake["entries_total"] == 1
    assert bake["compiler_runs"] == 0 and bake["ladder_count"] == 2
    aotc.main(["ls", "--cache-dir", d])
    ls = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [e["kind"] for e in ls["entries"]] == ["native"]
    aotc.main(["gc", "--cache-dir", d, "--max-bytes", "0"])
    gc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert gc["bytes_before"] > 0 and gc["bytes_after"] == 0
    with pytest.raises(NotImplementedError, match="A10"):
        aotc.main(["bake", "--cache-dir", d, "--mlp", "8,16,4",
                   "--mesh-data", "2"])


def test_unkeyable_model_falls_back_to_the_plain_callable(port_cache,
                                                          caplog):
    class Odd:
        @property
        def conf(self):
            raise RuntimeError("no conf")

    assert taot.wrap_jit(_encode, kind="output", model=Odd()) is _encode
    assert "could not key" in caplog.text


def test_a_shallow_copy_steps_itself_not_its_original(port_cache):
    """``copy.copy`` of a net (early stopping's ``getBestModel`` hands one
    out) carries the original's dispatch in its ``__dict__``; the copy's
    step must get a dispatch of its own, or it would train the
    original."""
    import copy
    net = _mlp().init()
    net.fit(_batches(1)[0])
    first = taot.bound_dispatch(net, "_trainStep")
    assert first is not None
    twin = copy.copy(net)
    twin.params_ = {k: {kk: v.clone() for kk, v in lp.items()}
                    for k, lp in net.params_.items()}
    before = net.params_["0"]["W"].clone()
    twin.fit(_batches(1, seed=3)[0])
    assert torch.equal(net.params_["0"]["W"], before)
    assert not torch.equal(twin.params_["0"]["W"], before)
    assert taot.bound_dispatch(twin, "_trainStep") not in (None, first)
    assert taot.bound_dispatch(net, "_trainStep") is first
