"""Why the YOLO2 step checks hold parameters at Adam's bound: the float32
gradient of YOLO2's backbone carries the BatchNorm backward's
cancellation noise (23 BatchNorm layers subtract batch means), in both
packages.

The narrow YOLO2 (64x64, 4 classes, batch 8; the port's parameters
carried into the reference) in float32 against the port's same gradient
in float64: per weight tensor of the backbone, the relative L2 error of
the port's float32 gradient stays under 2 %, and the reference's float32
gradient is farther from float64 than the port's.  Adam's first step moves
a parameter by lr·sign(g), so a gradient inside that noise may take
either sign (``tests/test_torch_zoo.py``, ``chip_smoke.py`` yolo2_step).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models.multilayer import (_detached_leaves,
                                                        _grads_of, _tree_map)

from _torch_parity import _carried, _yolo_labels

pytestmark = pytest.mark.torch_port

BACKBONE = ("c1", "c2", "c9", "c14", "c19")


def _rel(a, ref):
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def test_float32_gradient_noise_of_yolo2_against_float64():
    net, jnet = _carried("YOLO2", dict(inputShape=(3, 64, 64), numClasses=4))
    rng = np.random.RandomState(2)
    x = rng.randn(8, 3, 64, 64).astype(np.float32)
    y = _yolo_labels(rng, 8, 4, 2)

    def port_grads(dtype):
        p = _tree_map(lambda t: t.to(dtype), net.params_)
        net.state_ = _tree_map(lambda t: t.to(dtype), net.state_)
        leaves, params = _detached_leaves(p, set())
        loss, _, _ = net._lossFn(params, (torch.from_numpy(x).to(dtype),),
                                 (torch.from_numpy(y).to(dtype),), None,
                                 True, None, None)
        return _grads_of(loss, leaves)

    g64 = port_grads(torch.float64)
    g32 = port_grads(torch.float32)
    ref = jax.jit(jax.grad(lambda p: jnet._lossFn(
        p, jnet.state_, (jnp.asarray(x),), (jnp.asarray(y),), None,
        jax.random.PRNGKey(0))[0]))(jnet.params_)
    port_err = {k: _rel(g32[k]["W"].double().numpy(), g64[k]["W"].numpy())
                for k in BACKBONE}
    ref_err = {k: _rel(np.asarray(ref[k]["W"], np.float64),
                       g64[k]["W"].numpy()) for k in BACKBONE}
    assert max(port_err.values()) < 0.02, port_err
    assert all(ref_err[k] > port_err[k] for k in BACKBONE), \
        (port_err, ref_err)
