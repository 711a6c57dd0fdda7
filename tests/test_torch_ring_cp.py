"""Ring attention over the mesh's seq axis (ROADMAP A10a) against the JAX
package.

One world of four ranks as a (data 2, seq 2) mesh (``_torch_dist.World``:
``gloo``, ``file://`` rendezvous, 60 s collective timeout, joined with a
deadline) starts with the module; the JAX side runs in this process on
``DeviceMesh(data=2, seq=2, devices=jax.devices()[:4])``.

- ``context_parallel_attention``, causal and not, masked and not: each
  rank's rows of the output and of dq, dk, dv against the JAX function's
  and its VJP's.  Unmasked, every block a rank holds goes through the
  flash entry points (B1 forward, B2/B3 backward: their plain versions
  here, the kernels on CUDA), a causal block wholly in the future is
  skipped; masked, the reference's plain block update runs;
- ``ring_attention`` on the seq group against dense causal attention;
- the ``SelfAttentionLayer`` net's ``ParallelWrapper`` step on the mesh,
  its attention layers routed to the ring, against the JAX mesh step.

Tolerances: float32 on both sides, the online softmax merged in another
order (log-sum-exp of per-block flash results against the reference's
running max and sum), so outputs and gradients hold to 1e-5; the net's
parameters after one Adam step to ``tests/test_parallel.py:86``'s
``rtol=2e-4, atol=2e-6``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as D
from deeplearning4j_tpu.parallel.ring import \
    context_parallel_attention as jcp

pytestmark = pytest.mark.torch_port

ATT = dict(rtol=1e-5, atol=1e-5)
REF_TOL = dict(rtol=2e-4, atol=2e-6)      # tests/test_parallel.py:86
B, H, T_, DH = 4, 2, 16, 8
J, T = D.pkg(D.REF), D.pkg(D.PORT)


def _jmesh():
    return J.parallel.DeviceMesh(data=2, seq=2, devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(11)
    q, k, v, w = (rng.randn(B, H, T_, DH).astype(np.float32)
                  for _ in range(4))
    mask = (rng.rand(B, T_) > 0.3).astype(np.float32)
    mask[:, :3] = 1.0          # every query keeps a visible key
    x = rng.randn(4, 8, T_).astype(np.float32)
    y = rng.randn(4, 3, T_).astype(np.float32)
    net = D.attention_net(T, T_, device="cpu").init()
    att = {"q": q, "k": k, "v": v, "w": w, "mask": mask}
    return {"cp": att, "ring": att,
            "seq_net": {"x": x, "y": y,
                        "params": D.numpy_tree(net.params_)}}


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory, inputs):
    w = D.World(4, tmp_path_factory.mktemp("world"),
                ("cp", "ring", "seq_net"), inputs)
    yield w
    w.results()


def _rows(a, data_rank):
    return a[2 * data_rank:2 * data_rank + 2]


@pytest.mark.parametrize("causal,masked", D.CP_VARIANTS,
                         ids=[f"{'causal' if c else 'full'}-"
                              f"{'masked' if m else 'unmasked'}"
                              for c, m in D.CP_VARIANTS])
def test_context_parallel_attention_matches_the_reference(
        world, inputs, causal, masked):
    inp = inputs["cp"]
    mask = jnp.asarray(inp["mask"]) if masked else None

    mesh = _jmesh()

    @jax.jit
    def f(q, k, v, w):
        out, vjp = jax.vjp(lambda a, b, c: jcp(mesh, a, b, c, mask=mask,
                                                causal=causal), q, k, v)
        return out, vjp(w)
    out, grads = f(*(jnp.asarray(inp[n]) for n in "qkvw"))
    want = dict(out=out, dq=grads[0], dk=grads[1], dv=grads[2])
    for r in world.case("cp"):
        got = r[(causal, masked)]
        d, s = r["coords"]["data"], r["coords"]["seq"]
        for key in ("out", "dq", "dk", "dv"):
            np.testing.assert_allclose(got[key], _rows(np.asarray(
                want[key]), d), **ATT, err_msg=key)
        # blocks through the flash entry points: unmasked, each held
        # block but a causal one wholly in the future; masked, none
        n = 0 if masked else (s + 1 if causal else 2)
        assert got["calls"] == {k: n for k in D.BLOCK_FNS}, got["calls"]


def test_ring_attention_on_the_seq_group_is_exact(world, inputs):
    from deeplearning4j_tpu_torch.parallel.ring import dot_product_attention
    inp = inputs["ring"]
    dense = dot_product_attention(*(torch.from_numpy(inp[n]) for n in "qkv"),
                                  causal=True, impl="dense").numpy()
    t = T_ // 2
    for r in world.case("ring"):
        d, s = r["coords"]["data"], r["coords"]["seq"]
        np.testing.assert_allclose(
            r["out"], _rows(dense, d)[:, :, s * t:(s + 1) * t], **ATT)


def test_seq_axis_training_step_matches_the_reference_mesh(world, inputs):
    inp = inputs["seq_net"]
    jnet = D.attention_net(J, T_).init(
        params=jax.tree.map(jnp.asarray, inp["params"]))
    J.parallel.ParallelWrapper(jnet, mesh=_jmesh()).fit(
        J.ds.ListDataSetIterator([J.ds.DataSet(inp["x"], inp["y"])]),
        epochs=1)
    res = world.case("seq_net")
    for r in res:
        np.testing.assert_array_equal(r["params"], res[0]["params"])
        # two attention layers, two blocks each: B1 forward, B2/B3 back
        assert r["calls"] == {k: 4 for k in D.BLOCK_FNS}, r["calls"]
    np.testing.assert_allclose(res[0]["params"],
                               np.asarray(jnet.params().jax), **REF_TOL)
    np.testing.assert_allclose(res[0]["score"], jnet.score(), rtol=1e-5)


def test_the_ring_needs_an_active_mesh():
    from deeplearning4j_tpu_torch.parallel.ring import dot_product_attention
    q = torch.zeros(1, 1, 4, 2)
    with pytest.raises(ValueError, match="active mesh"):
        dot_product_attention(q, q, q, impl="ring")
