"""Port parity: the 240 SameDiff ops ported with the control flow
(``deeplearning4j_tpu_torch/autodiff/ops_ext*.py`` and the control-flow
ops of ``samediff.py``) against the JAX package's same ops.

Every case of ``autodiff/op_cases.py`` (one or more per op, where attrs
matter; the second half of the table in ``test_torch_samediff_ops2.py``)
builds a one-op graph in both packages, feeds the same seeded
numpy inputs and holds the port's outputs to the reference's as the case
says: float32 at rtol 1e-4 / atol 1e-5, integer and boolean outputs
exactly, the linear algebra at rtol 1e-3 or by its identities, the random
ops by shape, dtype, determinism and moments.  Then the updater ops
against the port's ``learning`` updaters, the departures the ops record
(ROADMAP C27, C30, C31) and the torch pitfalls the port steps around.
"""
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.autodiff.samediff as jsd
from deeplearning4j_tpu.autodiff import SameDiff as JSameDiff
from deeplearning4j_tpu_torch.autodiff import SameDiff
from deeplearning4j_tpu_torch.autodiff.op_cases import (CASES, build_case,
                                                        compare)
from deeplearning4j_tpu_torch.autodiff.samediff import OP_IMPLS

from _torch_parity import _np

pytestmark = pytest.mark.torch_port


def _run_ref(case):
    sd = JSameDiff.create()
    names = build_case(sd, case)
    out = sd.output(case.feeds(), *names)
    return [np.asarray(out[n].numpy()) for n in names]


def _run_port(case, device="cpu"):
    sd = SameDiff.create(device)
    names = build_case(sd, case)
    out = sd.output(case.feeds(), *names)
    return [_np(out[n]) for n in names]


def test_the_case_table_names_every_op_and_the_registries_agree():
    """The table holds each of the 240 ops once or more; with the
    importers loaded, the port registers the reference's 522 names, no
    more and no fewer."""
    import deeplearning4j_tpu.imports.onnx_import  # noqa: F401
    import deeplearning4j_tpu.imports.tf_import  # noqa: F401
    import deeplearning4j_tpu_torch.imports.onnx_import  # noqa: F401
    import deeplearning4j_tpu_torch.imports.tf_import  # noqa: F401
    ops = {c.op for c in CASES}
    assert len(ops) == 240
    assert ops <= set(jsd.OP_IMPLS)
    assert set(OP_IMPLS) == set(jsd.OP_IMPLS)
    assert len(OP_IMPLS) == 522
    assert len({c.id for c in CASES}) == len(CASES)


def _hold(case):
    want = _run_ref(case)
    got = _run_port(case)
    err = compare(case, got, want)
    assert err is None, err
    if case.check in ("random", "shuffle", "crop"):
        # seeded per node: the same draw on every run
        again = _run_port(case)
        assert all(np.array_equal(a, b) for a, b in zip(got, again))


# the table's first half here, the second in test_torch_samediff_ops2.py
# (two files, so that the suite's workers share them)
HALF = len(CASES) // 2


@pytest.mark.parametrize("case", CASES[:HALF],
                         ids=[c.id for c in CASES[:HALF]])
def test_op_against_the_reference(case, capsys):
    _hold(case)


_UPDATERS = [c for c in CASES if c.op.endswith("Updater")]


@pytest.mark.parametrize("case", _UPDATERS, ids=[c.op for c in _UPDATERS])
def test_updater_op_is_the_learning_updater(case):
    """Each updater op's step is its ``learning.config`` updater's
    ``apply``, bit for bit (one implementation), and the reference's op
    within float32 (held above too)."""
    from deeplearning4j_tpu_torch.learning import config as tlc
    cls = {"sgd": tlc.Sgd, "adam": tlc.Adam, "adaMax": tlc.AdaMax,
           "nadam": tlc.Nadam, "amsGrad": tlc.AMSGrad,
           "adaGrad": tlc.AdaGrad, "adaDelta": tlc.AdaDelta,
           "rmsProp": tlc.RmsProp, "nesterovs": tlc.Nesterovs}[
        case.op[:-len("Updater")]]
    attrs = dict(case.attrs)
    lr, it = attrs.pop("lr"), attrs.pop("iteration")
    up = cls(**attrs)
    p, g, *st = (torch.tensor(a) for a in case.inputs)
    keys = list(up.init(p))
    upd, new = up.apply(g, dict(zip(keys, st)), lr, it, 0, param=p)
    got = _run_port(case)
    np.testing.assert_array_equal(got[0], _np(p - upd))
    for k, arr in zip(keys, got[1:]):
        np.testing.assert_array_equal(arr, _np(new[k]))


# ---------------------------------------------------------------------------
# the departures and kept reference faults (ROADMAP C), and the torch
# pitfalls the port steps around
# ---------------------------------------------------------------------------
def _one(op, *inputs, **attrs):
    from deeplearning4j_tpu_torch.autodiff.op_cases import _c
    return _run_port(_c(op, *inputs, **attrs))


def test_c27_assert_never_raises_and_passes_its_input(capsys):
    """C27: ``Assert`` on a false condition prints and passes the
    condition through, as the reference's (a compiled program cannot
    raise); it does not raise."""
    cond = np.array([1.0, 0.0, 1.0], np.float32)
    out = _one("Assert", cond, message="must hold")
    np.testing.assert_array_equal(out[0], cond)
    assert "Assert: False (must hold)" in capsys.readouterr().out


def test_median_averages_the_middle_pair():
    """``median`` of an even count is the mean of the two middle
    values (``jnp.median``), not ``torch.median``'s lower one."""
    x = np.array([[4.0, 1.0, 3.0, 2.0]], np.float32)
    out = _one("median", x, dims=[1])
    np.testing.assert_allclose(out[0], [2.5])
    assert float(torch.median(torch.tensor(x))) == 2.0


def test_lu_pivots_are_zero_based_int32():
    """``lu``'s pivots are ``lax.linalg.lu``'s 0-based int32 rows,
    where LAPACK's (torch's) are 1-based."""
    a = np.array([[0.0, 1.0], [2.0, 3.0]], np.float32)
    lu, piv = _one("lu", a, n_out=2)
    assert piv.dtype == np.int32 and piv.tolist() == [1, 1]


def test_c30_eig_is_held_by_its_identity():
    """C30: ``eig``'s eigenpairs are complex, their order and phase those
    of the library that computes them (JAX computes them on the host
    only); they satisfy A v = w v."""
    a = np.random.RandomState(3).randn(4, 4).astype(np.float32)
    w, v = _one("eig", a, n_out=2)
    assert np.iscomplexobj(w) and np.iscomplexobj(v)
    np.testing.assert_allclose(a @ v, v * w[None, :], atol=1e-4)


def test_bitcast_adds_and_drops_a_trailing_axis():
    """``bitcast`` follows ``lax.bitcast_convert_type``: to a
    narrower type it adds a trailing axis, to a wider one it consumes
    it (``Tensor.view(dtype)`` would resize the last axis)."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert _one("bitcast", x, dtype="uint8")[0].shape == (2, 3, 4)
    b = np.arange(8, dtype=np.int8).reshape(2, 4)
    assert _one("bitcast", b, dtype="int32")[0].shape == (2,)


def test_cyclic_shifts_are_logical_at_every_width():
    """The rotations' right shift is logical, so a negative int32
    rotates its sign bit (torch's ``>>`` is arithmetic), and a shift of the
    width or more wraps modulo the width."""
    x = np.array([-8, 1, -1, 2 ** 30], np.int32)
    s = np.array([1, 33, 7, 64], np.int32)
    got = _one("cyclicShiftRight", x, s)[0]
    u = x.astype(np.uint32)
    r = (s % 32).astype(np.uint32)
    want = ((u >> r) | (u << ((32 - r) % 32))).astype(np.int32)
    np.testing.assert_array_equal(got, want)


def test_percentile_beyond_torch_quantile_limit():
    """``percentile`` sorts instead of calling ``torch.quantile``, which
    refuses inputs beyond 2**24 elements."""
    x = np.arange(2 ** 24 + 8, dtype=np.float32)
    out = _one("percentile", x, percentile=50.0)
    np.testing.assert_allclose(out[0], np.percentile(x, 50.0), rtol=1e-6)


def test_hash_code_is_the_sequential_polynomial():
    """``hashCode`` equals Java's ``Arrays.hashCode`` loop over int64 with
    wraparound, computed without a loop over the elements."""
    x = np.random.RandomState(9).randint(-2 ** 31, 2 ** 31 - 1, 500) \
        .astype(np.int32)
    h = 1
    for v in x.tolist():
        h = (h * 31 + v) & ((1 << 64) - 1)
    want = h - (1 << 64) if h >= 1 << 63 else h
    assert int(_one("hashCode", x)[0]) == want


def test_c31_random_ops_draw_torch_bits_seeded_per_node():
    """C31: the random ops draw from a generator on the graph's device
    seeded by the node's ``seed``: the same draw on every run, torch's
    bits, not ``jax.random``'s; the moments agree (held in the table's
    cases)."""
    from deeplearning4j_tpu_torch.autodiff.op_cases import _c
    case = _c("random_gamma", check="random", shape=(64, 64), seed=5,
              alpha=2.0)
    a, b, ref = _run_port(case), _run_port(case), _run_ref(case)
    np.testing.assert_array_equal(a[0], b[0])
    assert not np.array_equal(a[0], ref[0])
    assert compare(case, a, ref) is None
