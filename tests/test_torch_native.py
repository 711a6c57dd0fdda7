"""The port's host runtime (``deeplearning4j_tpu_torch/native``): the C++
library built from the repository's ``native/src`` into the port's own
git-ignored ``_build/native``, never ``xla_ffi.cpp``; the reference's
``tests/test_native.py`` run against it; and its outputs held to the
reference's build of the same sources (bit for bit: one C++ code)."""
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu_torch import native
from tests._torch_parity import _reference_tests, _run_reference_test

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parent.parent

# left out: the C++ test binary under sanitizers builds the reference's
# CMake target in native/build (the port builds one g++ library); the
# three XLA-FFI tests drive xla_ffi.cpp, which the port never builds (it
# includes XLA's headers)
_EXCLUDE = ("test_native_cpp_test_binary_under_sanitizers",
            "test_xla_ffi_custom_calls",
            "test_xla_ffi_bitmap_encode_decode_roundtrip",
            "test_accumulator_bitmap_path_via_ffi")
_MOD, _CASES = _reference_tests("test_native.py", exclude=_EXCLUDE)


@pytest.mark.parametrize("case", [c for _, c in _CASES],
                         ids=[i for i, _ in _CASES])
def test_reference_native_tests_pass_on_the_port(case, tmp_path,
                                                 monkeypatch):
    _run_reference_test(case, tmp_path, monkeypatch)


def test_library_is_the_ports_own_build_of_five_sources():
    assert native.available() and native.backend() == "native"
    path = Path(native.library_path())
    assert path.parent == REPO / "deeplearning4j_tpu_torch" / "_build" \
        / "native"
    assert path.name.startswith("libdl4j_native-") and path.suffix == ".so"
    assert native.SOURCES == ("csv.cpp", "threads.cpp", "random.cpp",
                              "compression.cpp", "workspace.cpp")
    assert "xla_ffi.cpp" not in native.SOURCES
    # no XLA-FFI handler in the library's symbols
    lib = ctypes.CDLL(str(path))
    for sym in ("dl4j_xla_threshold_count", "dl4j_xla_bitmap_encode",
                "dl4j_xla_bitmap_decode", "dl4j_xla_philox_uniform"):
        assert not hasattr(lib, sym)
    assert hasattr(lib, "dl4j_csv_parse_f32")
    ignored = (REPO / ".gitignore").read_text().split()
    assert "deeplearning4j_tpu_torch/_build/" in ignored


def test_build_is_keyed_by_the_sources(tmp_path, monkeypatch):
    """An edited source names another library, so a stale build is never
    loaded: the hash covers the sources, the header and the flags."""
    first = native._target()
    assert first == Path(native.library_path())
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native._target() != first


def test_disable_env_falls_back_to_numpy():
    code = ("from deeplearning4j_tpu_torch import native as n\n"
            "import numpy as np\n"
            "assert not n.available() and n.backend() == 'numpy'\n"
            "m = n.csv_parse('1,2\\n3,4\\n')\n"
            "assert m.tolist() == [[1.0, 2.0], [3.0, 4.0]]\n"
            "assert n.num_threads() == 1\n")
    env = dict(os.environ, PYTHONPATH=str(REPO),
               DL4J_TPU_DISABLE_NATIVE="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


CSV_CASES = {
    "ints": "\n".join(f"{i},{i * 2},{i * 3}" for i in range(100)),
    "floats_header": "a;b\n" + "\n".join(
        f"{i * 0.25};{-i / 7}" for i in range(50)),
    "crlf_blank_lines": "1,2\r\n\r\n3.5,4e-3\r\n  \n5,6\n",
    "exponents": "1e10,-2.5E-7,0\n3,4,5\n",
}


@pytest.mark.parametrize("name", sorted(CSV_CASES))
def test_csv_parse_equals_the_reference(name):
    text = CSV_CASES[name]
    delim = ";" if "header" in name else ","
    skip = 1 if "header" in name else 0
    got = native.csv_parse(text, delim=delim, skip_rows=skip)
    want = jnative.csv_parse(text, delim=delim, skip_rows=skip)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["philox_uniform", "philox_gaussian"])
def test_philox_streams_equal_the_reference(fn):
    if not jnative.available():
        pytest.skip("the reference's native library is not built here")
    for seed, offset, n in ((0, 0, 1000), (42, 17, 333), (2 ** 40, 5, 64)):
        np.testing.assert_array_equal(
            getattr(native, fn)(seed, offset, n),
            getattr(jnative, fn)(seed, offset, n))


def test_codecs_equal_the_reference():
    rng = np.random.RandomState(3)
    g = (rng.randn(4099) * 0.02).astype(np.float32)
    a, b = g.copy(), g.copy()
    np.testing.assert_array_equal(native.threshold_encode(a, 0.015),
                                  jnative.threshold_encode(b, 0.015))
    np.testing.assert_array_equal(a, b)
    a, b = g.copy(), g.copy()
    wa, na = native.bitmap_encode(a, 0.01)
    wb, nb = jnative.bitmap_encode(b, 0.01)
    assert na == nb
    np.testing.assert_array_equal(wa, wb)
    ta = native.bitmap_decode(wa, g.size, 0.01, np.zeros_like(g))
    tb = jnative.bitmap_decode(wb, g.size, 0.01, np.zeros_like(g))
    np.testing.assert_array_equal(ta, tb)


def test_parallel_for_runs_every_index_once_on_the_pool():
    n = 10_000
    hits = np.zeros(n, np.int64)

    def work(lo, hi):
        hits[lo:hi] += 1

    native.parallel_for(work, 0, n, 128)
    assert (hits == 1).all()


def test_environment_steers_the_native_pool():
    from deeplearning4j_tpu_torch.config import Environment
    env = Environment.getInstance()
    import torch
    prev_n, prev_t = native.num_threads(), torch.get_num_threads()
    try:
        env.setMaxThreads(3)
        assert native.num_threads() == env.maxThreads() == 3
        assert torch.get_num_threads() == 3
    finally:
        native.set_num_threads(prev_n)
        torch.set_num_threads(prev_t)
