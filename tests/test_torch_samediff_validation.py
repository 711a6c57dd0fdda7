"""Port parity: the reference's own SameDiff validation suites run against
the port — ``tests/test_ops_ext_validation.py``,
``test_ops_ext2_validation.py``, ``test_ops_ext5_validation.py`` and
``test_samediff_validation.py`` — through ``_reference_tests``, which
swaps each ``deeplearning4j_tpu`` import for the port's.  Their bodies
build graphs with the public API and check numpy goldens; each runs on the
CPU (the entry points' default device is set to the CPU for the run).

Left out, each for its reason (named in ``EXCLUDED``): the tests whose
bodies call ``jax`` themselves (a gradient by ``jax.grad`` of an op's
function, the updater ops against jax arrays) — those ops' gradients and
updater steps are held to the reference in
``tests/test_torch_samediff_ops.py`` and ``test_torch_control_flow.py`` —
the coverage gate, which counts the ops the whole reference suite
validated in one process, and ``test_unique_listdiff``, which pins
``jnp.unique``'s sorted order where the port keeps first-occurrence order
on purpose (ROADMAP C10; held in ``tests/test_torch_tf_ops.py``).
"""
import pytest

from _torch_parity import _cpu_default, _reference_tests

pytestmark = pytest.mark.torch_port

EXCLUDED = {
    "test_ops_ext2_validation.py": (
        "test_gradients_new_families",       # jax.grad of op functions
        "test_updater_ops",                  # updaters fed jax arrays
        "test_gradients_sprint34_families",  # jax.grad of op functions
        "test_unique_listdiff",   # unique's order departs on purpose: C10
    ),
    "test_samediff_validation.py": (
        "test_for_loop_differentiable",      # jax.grad of the staged fn
        "test_samediff_bf16_training_keeps_f32_masters",  # jnp dtypes
        "test_registered_op_coverage",       # the whole suite's coverage
    ),
}
_FILES = ("test_ops_ext_validation.py", "test_ops_ext2_validation.py",
          "test_ops_ext5_validation.py", "test_samediff_validation.py")


def _expand(cid, case):
    """A reference test with its ``pytest.mark.parametrize`` marks
    expanded: one (id, callable, kwargs) per parameter set."""
    fn = getattr(case[0], case[1]) if isinstance(case, tuple) else case
    out = [(cid, case, {})]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        names = [n.strip() for n in names.split(",")] \
            if isinstance(names, str) else list(names)
        ids = mark.kwargs.get("ids")
        grown = []
        for i, v in enumerate(values):
            v = v.values if hasattr(v, "values") and hasattr(v, "marks") \
                else v
            v = v if len(names) > 1 else (v,)
            tag = ids[i] if isinstance(ids, (list, tuple)) else (
                v[0] if isinstance(v[0], str) else str(i))
            for oid, c, kw in out:
                grown.append((f"{oid}[{tag}]", c, {**kw,
                                                    **dict(zip(names, v))}))
        out = grown
    return out


_CASES = [(f, eid, c, kw) for f in _FILES
          for cid, case in _reference_tests(f, EXCLUDED.get(f, ()))[1]
          for eid, c, kw in _expand(cid, case)]


@pytest.fixture
def on_cpu(monkeypatch):
    _cpu_default(monkeypatch)


@pytest.mark.parametrize("case,kw", [(c, kw) for _, _, c, kw in _CASES],
                         ids=[f"{f[5:-3]}::{eid}" for f, eid, _, _ in _CASES])
def test_reference_validation_suite(case, kw, tmp_path, capsys, on_cpu):
    import inspect
    fn = getattr(case[0](), case[1]) if isinstance(case, tuple) else case
    fixtures = {"tmp_path": tmp_path, "capsys": capsys, **kw}
    fn(**{p: fixtures[p] for p in inspect.signature(fn).parameters})
