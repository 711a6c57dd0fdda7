"""Shared pieces of the serving tier's parity tests: the tiny LM both
packages build from one seeded draw, the near-tie rule that token
comparisons follow, and small HTTP helpers.

The near-tie rule.  The reference computes its logits in float64 (ROADMAP
C1) and the port in float32, so greedy tokens may part where the
reference's two best logits lie closer than float32 can resolve.  Tokens
are held equal up to the first generated position whose reference top-two
logits lie within ``NEAR_TIE`` (1e-4) of each other; that position and the
tokens after it are not compared.  ``assert_tokens`` also requires that
most tokens were compared, so the rule cannot hollow a test out.
"""
import dataclasses
import json
import urllib.error
import urllib.request

import jax
import numpy as np

from deeplearning4j_tpu.nlp.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu.nlp.transformer import \
    TransformerLMConfig as JaxConfig
from deeplearning4j_tpu_torch.nlp.transformer import (TransformerLM,
                                                      TransformerLMConfig)

NEAR_TIE = 1e-4
# 2 layers, 2 heads x 8, vocab 64, maxLen 64; a wider initialiser than the
# default 0.02 keeps greedy decoding from collapsing onto one token
LM_CFG = dict(vocabSize=64, nLayers=2, nHeads=2, headSize=8, maxLen=64,
              initializerRange=0.3, seed=3)
DRAFT_CFG = dict(LM_CFG, nLayers=1, seed=4)


def lm_pair(**over):
    """(reference LM, port LM on the CPU) with the same parameters."""
    jlm = JaxLM(JaxConfig(**dict(LM_CFG, **over)))
    cfg = TransformerLMConfig(**dataclasses.asdict(jlm.config))
    tlm = TransformerLM(cfg, device="cpu").loadParams(
        jax.tree.map(np.asarray, jlm.params))
    return jlm, tlm


def prompts(n, lo, hi, seed, vocab=LM_CFG["vocabSize"]):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (int(rng.randint(lo, hi + 1)),)
                        ).astype(np.int32) for _ in range(n)]


def near_tie_cuts(jlm, prompt_list, ref_list, eps=NEAR_TIE):
    """For each (prompt, reference tokens): the index of the first
    generated token whose reference top-two logits lie within ``eps``, or
    the token count.  One reference forward over the right-padded batch
    (causal attention: padding after a position never reaches it)."""
    L = jlm.config.maxLen
    rows = np.zeros((len(prompt_list), L), np.int32)
    for i, (p, r) in enumerate(zip(prompt_list, ref_list)):
        seq = np.concatenate([np.asarray(p).ravel(),
                              np.asarray(r).ravel()[:-1]])
        rows[i, :len(seq)] = seq
    logits = np.asarray(jlm.forward(rows))
    cuts = []
    for i, (p, r) in enumerate(zip(prompt_list, ref_list)):
        t, n = np.asarray(p).size, np.asarray(r).size
        top2 = np.sort(logits[i, t - 1:t - 1 + n], axis=-1)[:, -2:]
        close = np.nonzero(top2[:, 1] - top2[:, 0] < eps)[0]
        cuts.append(int(close[0]) if close.size else n)
    return cuts


def assert_tokens(jlm, prompt_list, got_list, ref_list, min_share=0.5):
    """``got`` equals ``ref`` (the reference's tokens) row by row up to
    each row's first near tie; at least ``min_share`` of all tokens must
    lie before their row's cut."""
    cuts = near_tie_cuts(jlm, prompt_list, ref_list)
    compared = total = 0
    for i, (got, ref, cut) in enumerate(zip(got_list, ref_list, cuts)):
        got, ref = np.asarray(got).ravel(), np.asarray(ref).ravel()
        assert got.shape == ref.shape, (i, got.shape, ref.shape)
        np.testing.assert_array_equal(got[:cut], ref[:cut],
                                      err_msg=f"row {i}, cut {cut}")
        compared += cut
        total += ref.size
    assert compared >= min_share * total, (compared, total, cuts)


# -- HTTP ---------------------------------------------------------------

def post(port, path, obj, timeout=60, headers=None):
    """(status, JSON body, headers) of one POST; HTTP errors included."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(obj).encode("utf-8"),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def post_stream(port, path, obj, timeout=60):
    """(status, [JSON lines], headers) of one NDJSON streaming POST;
    keep-alive comment lines are skipped."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(dict(obj, stream=True)).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        lines = [json.loads(ln) for ln in resp.read().splitlines()
                 if ln.startswith(b"{")]
        return resp.status, lines, dict(resp.headers)


def get(port, path, timeout=30):
    """(status, body bytes, headers) of one GET."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)
