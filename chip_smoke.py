#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``deeplearning4j_tpu_torch``) on one
NVIDIA H100.  Run from the repository root::

    python3 chip_smoke.py [--record PATH]

It imports nothing of JAX and nothing of the JAX package.  Phases, each of
which must pass or the script exits non-zero without a result line:

1. build every kernel (``deeplearning4j_tpu_torch/csrc/*.cu``: the flash
   forward B1 and the flash backward's dq and dk/dv passes B2, B3) with
   nvcc for sm_90a, all sources in parallel, timed as set-up;
2. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes, a ragged shape and small shapes (tolerances below),
   and the flash gradient (``FlashAttention``: B1 forward, B2 and B3
   backward) against autograd through dense attention;
3. serving path, through the entry points a user calls:
   ``TransformerLM.generate`` at GPT-2 small widths (768 = 12 heads x 64,
   12 layers, FFN 3072, vocab 50257; ``maxLen`` 2048 so a 1024-token
   prompt plus its generation fits) on 4 unpadded 1024-token prompts for
   32 new tokens, with seeded random weights.  The kernel counters are set
   to 0 just before and read just after: prefill must launch the flash
   kernel once per layer and no backward kernel.  Then one left-padded
   request (``lengths=``) must take the dense masked path (no launch);
4. check the serving outputs: prefill logits against the same model with
   dense attention forced, the padded request against unpadded prefills
   of its rows, and one KV-cached decode step against a prefill of the
   extended prompt;
5. time B1 at the serving shape beside its bound, its plain version and
   ``torch.nn.functional.scaled_dot_product_attention`` (a yardstick only:
   the port never calls it), and the model's prefill and decode rates;
   profile one prefill and four decode steps for device time by kernel
   and the device's idle share;
6. training path: the repo's long-context attention net (``bench.py``
   ``bench_long_context``: two ``SelfAttentionLayer(nHeads=8,
   headSize=16, nOut=128)`` and an ``RnnOutputLayer("mse", nOut=8,
   identity)`` over ``InputType.recurrent(128, 2048)``, ``Adam(1e-3)``,
   ``dataType("BFLOAT16")``, seed 5) built with the config DSL and
   trained by ``MultiLayerNetwork.fit`` on a ``ListDataSetIterator`` of
   two seeded batches of 4 for 2 epochs.  Counters set to 0 just before
   and read just after: every step must launch B1, B2 and B3 twice each
   (once per attention layer); the loss must be finite;
7. check the training step: the same net in FLOAT from the same copied
   parameters, one step with the flash kernels against one step with
   dense attention forced (loss and updated parameters);
8. time B1, B2 and B3 at the training shape beside their bounds, their
   plain versions and SDPA's forward and backward, and the training rate
   (tokens/s as ``bench.py`` counts them: b·t·steps / wall); profile one
   training step.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``.  With ``--record PATH`` it also
writes the full record (every check, timing and profile row) as JSON.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (dense): HBM bandwidth, FP32 on the CUDA
# cores, bf16 on the tensor cores.  Exponentials run on the special-function
# units: 16 results per clock per SM (4 per SM sub-partition), 132 SMs,
# 1.98 GHz boost clock (Hopper architecture white paper).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_EXPS = 16 * 132 * 1.98e9

# Main path of this slice: GPT-2 small widths (openai-community/gpt2
# config.json), cache capacity raised to 2048.
GPT2_SMALL = dict(vocabSize=50257, nLayers=12, nHeads=12, headSize=64,
                  ffnMult=4, maxLen=2048, seed=0)
BATCH, PROMPT, NEW_TOKENS = 4, 1024, 32

# Kernel checks: f32 against f32 differs only by summation order.  bf16
# outputs are the same f32 values rounded to bf16 (8 bits of mantissa), so
# a value near a rounding boundary may land one bf16 ulp apart; lse stays
# f32 in both dtypes.
TOL = {"float32": dict(atol=1e-4, rtol=1e-5),
       "bfloat16": dict(atol=1e-2, rtol=1e-2)}
LSE_TOL = dict(atol=1e-4, rtol=1e-5)
# Model checks: 12 float32 layers, flash against dense attention (or a
# KV-cached step against a full prefill), differ by summation order only.
LOGIT_ATOL = 1e-3

# Training path: bench.py bench_long_context at its widths.
LONG_CONTEXT = dict(nIn=128, nHeads=8, headSize=16, nOut=8, t=2048, batch=4,
                    seed=5, lr=1e-3)
TRAIN_EPOCHS, TRAIN_TIMED_STEPS = 2, 6
TRAIN_SHAPE = (LONG_CONTEXT["batch"], LONG_CONTEXT["nHeads"],
               LONG_CONTEXT["t"], LONG_CONTEXT["t"], LONG_CONTEXT["headSize"])
# Training-step check, FLOAT net: flash against dense attention differ by
# float32 summation order (gradients ~1e-6 apart on the card).  The loss
# holds to 1e-5.  One Adam step amplifies a gradient difference by up to
# lr / (eps / sqrt(1 - beta2)) ~ 3e3, so the updated parameters hold to
# 1e-4, a tenth of the step size lr.
TRAIN_LOSS_ATOL, TRAIN_PARAM_ATOL = 1e-5, 1e-4

SERVE_SHAPE = (BATCH, GPT2_SMALL["nHeads"], PROMPT, PROMPT,
               GPT2_SMALL["headSize"])
SMALL_SHAPES = [  # (b, h, tq, tk, d)
    (2, 3, 1000, 1000, 64),     # ragged q and k tiles
    (1, 2, 333, 515, 128),      # tq != tk, widest head
    (1, 2, 16, 16, 8),          # smaller than one tile
]
KERNEL_SHAPES = [SERVE_SHAPE, TRAIN_SHAPE, *SMALL_SHAPES]
BWD_SHAPES = [TRAIN_SHAPE, *SMALL_SHAPES]
# Gradient check: FlashAttention's dq, dk, dv against autograd through
# dense attention, float32 (summation order only).
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


class PhaseFailed(Exception):
    pass


def _require(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def _max_err(a, b, atol, rtol):
    """(max |a-b|, whether every |a-b| <= atol + rtol*|b|)."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    ok = bool((diff <= atol + rtol * b.abs()).all()) and \
        bool(a.isfinite().all())
    return float(diff.max()), ok


def _time_ms(torch, fn, iters=20, warmup=3):
    """Median device time of one call, from CUDA events around each call
    (warm: inputs are left in the 50 MB L2 as the producing layer would
    leave them)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _bound(flops, exps, nbytes, dtype_name):
    """Least time for work of ``flops`` matrix-product FLOPs in
    ``dtype_name`` and ``exps`` exponentials that must move ``nbytes``:
    the larger of the bytes over HBM bandwidth and the operations over
    their units' peak rates (products and exponentials run on different
    units, so the slower of the two).  Returns (ms, "bytes"|"operations")."""
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / PEAK_FLOPS[dtype_name], exps / PEAK_EXPS)
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem > t_ops else "operations")


def _pairs(tq, tk, causal):
    return sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk


def _attention_bound(b, h, tq, tk, d, causal, dtype_name, elem):
    """Least time for one attention forward (B1): q, k, v read once, O and
    the f32 lse written once; 2 FLOPs per multiply-add in QKᵀ and in PV and
    one exponential per score, visible pairs only when causal.  Returns
    (ms, "bytes"|"operations", flops, bytes)."""
    pairs = _pairs(tq, tk, causal)
    flops = 4.0 * b * h * d * pairs
    nbytes = (2 * b * h * tq * d + 2 * b * h * tk * d) * elem + b * h * tq * 4
    return (*_bound(flops, b * h * pairs, nbytes, dtype_name), flops,
            nbytes)


def _bwd_bound(kernel, b, h, tq, tk, d, causal, dtype_name, elem):
    """Least time for one flash-backward pass: q, dO (b·h·tq·d), k, v
    (b·h·tk·d) and the f32 lse and delta rows read once, the pass's outputs
    (dq, or dk and dv) written once; 2 FLOPs per multiply-add in each of
    the pass's products (3 for dq: QKᵀ, dO·Vᵀ, dS·K; 4 for dk/dv: QKᵀ,
    dO·Vᵀ, Pᵀ·dO, dSᵀ·Q) and one exponential per score, visible pairs
    only when causal.  Returns (ms, "bytes"|"operations", flops, bytes)."""
    pairs = _pairs(tq, tk, causal)
    products, out_elems = {"dq": (3, b * h * tq * d),
                           "dkv": (4, 2 * b * h * tk * d)}[kernel]
    flops = 2.0 * products * b * h * d * pairs
    nbytes = ((2 * b * h * tq * d + 2 * b * h * tk * d + out_elems) * elem
              + 2 * b * h * tq * 4)
    return (*_bound(flops, b * h * pairs, nbytes, dtype_name), flops,
            nbytes)


def phase_build(rec):
    from deeplearning4j_tpu_torch import kernels
    t0 = time.perf_counter()
    logs = kernels.build()
    rec["build_s"] = time.perf_counter() - t0
    rec["ptxas"] = {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, log in logs.items()}
    print(f"build: {sorted(logs)} in {rec['build_s']:.1f} s")
    for name, lines in rec["ptxas"].items():
        for ln in lines:
            print(f"  ptxas {name}: {ln}")


def phase_kernels(torch, rec):
    from deeplearning4j_tpu_torch.parallel.ring import (
        flash_attention_reference, flash_forward)
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks, failed = [], []
    for (b, h, tq, tk, d) in KERNEL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            q = torch.randn((b, h, tq, d), generator=gen, device="cuda"
                            ).to(dtype)
            k = torch.randn((b, h, tk, d), generator=gen, device="cuda"
                            ).to(dtype)
            v = torch.randn((b, h, tk, d), generator=gen, device="cuda"
                            ).to(dtype)
            for causal in (False, True):
                out, lse = flash_forward(q, k, v, causal)
                ref_out, ref_lse = flash_attention_reference(q, k, v, causal)
                torch.cuda.synchronize()
                e_o, ok_o = _max_err(out, ref_out, **TOL[dn])
                e_l, ok_l = _max_err(lse, ref_lse, **LSE_TOL)
                c = dict(shape=[b, h, tq, tk, d], dtype=dn, causal=causal,
                         out_err=e_o, lse_err=e_l, ok=ok_o and ok_l)
                checks.append(c)
                print(f"flash {c['shape']} {dn:8s} causal={causal!s:5s} "
                      f"|dO|max={e_o:.3g} |dlse|max={e_l:.3g} "
                      f"{'ok' if c['ok'] else 'MISMATCH'}")
                if not c["ok"]:
                    failed.append(c)
    print(f"tolerances: float32 O {TOL['float32']}, bfloat16 O "
          f"{TOL['bfloat16']} (both round one f32 value to bf16; a "
          f"rounding-boundary flip is one bf16 ulp), lse {LSE_TOL}")
    rec["kernel_checks"] = checks
    _require(not failed, f"flash kernel disagrees with its plain version: "
                         f"{failed}")


def phase_bwd_kernels(torch, rec):
    """B2 (dq) and B3 (dk/dv) against their plain versions on the same
    inputs, lse from B1 and delta = rowsum(dO⊙O) as the backward computes
    it.  Tolerances as B1's: float32 differs by summation order only; in
    bf16 p and ds are rounded at the same points in both, and the outputs
    are f32 sums rounded to bf16 (a rounding-boundary flip is one ulp)."""
    from deeplearning4j_tpu_torch.parallel.ring import (
        flash_bwd_dkv, flash_bwd_dkv_reference, flash_bwd_dq,
        flash_bwd_dq_reference, flash_forward)
    gen = torch.Generator(device="cuda").manual_seed(2)
    checks, failed = [], []
    for (b, h, tq, tk, d) in BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            q, do = (torch.randn((b, h, tq, d), generator=gen,
                                 device="cuda").to(dtype) for _ in range(2))
            k, v = (torch.randn((b, h, tk, d), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            for causal in (False, True):
                out, lse = flash_forward(q, k, v, causal)
                delta = (do.float() * out.float()).sum(-1).reshape(
                    b * h, tq)
                args = (q, k, v, do, lse, delta, causal)
                got = (flash_bwd_dq(*args), *flash_bwd_dkv(*args))
                ref = (flash_bwd_dq_reference(*args),
                       *flash_bwd_dkv_reference(*args))
                torch.cuda.synchronize()
                errs = [_max_err(g, r, **TOL[dn]) for g, r in zip(got, ref)]
                c = dict(shape=[b, h, tq, tk, d], dtype=dn, causal=causal,
                         dq_err=errs[0][0], dk_err=errs[1][0],
                         dv_err=errs[2][0], ok=all(ok for _, ok in errs))
                checks.append(c)
                print(f"flash bwd {c['shape']} {dn:8s} causal={causal!s:5s}"
                      f" |ddq|max={c['dq_err']:.3g} |ddk|max="
                      f"{c['dk_err']:.3g} |ddv|max={c['dv_err']:.3g} "
                      f"{'ok' if c['ok'] else 'MISMATCH'}")
                if not c["ok"]:
                    failed.append(c)
    print(f"tolerances: float32 {TOL['float32']}, bfloat16 "
          f"{TOL['bfloat16']}")
    rec["bwd_kernel_checks"] = checks
    _require(not failed, f"a flash backward kernel disagrees with its plain"
                         f" version: {failed}")


def phase_grad(torch, rec):
    """FlashAttention's gradients (B1 forward, B2 and B3 backward) against
    torch.autograd through dense attention, float32."""
    from deeplearning4j_tpu_torch.parallel.ring import (
        dot_product_attention, flash_attention)
    gen = torch.Generator(device="cuda").manual_seed(3)
    errs, ok = {}, True
    for (b, h, tq, tk, d), causal in ((TRAIN_SHAPE, False),
                                      (SMALL_SHAPES[0], True)):
        q = torch.randn((b, h, tq, d), generator=gen, device="cuda")
        k, v = (torch.randn((b, h, tk, d), generator=gen, device="cuda")
                for _ in range(2))
        g = torch.randn((b, h, tq, d), generator=gen, device="cuda")
        qkv = [x.requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(flash_attention(*qkv, causal=causal), qkv,
                                  g)
        ref = torch.autograd.grad(dot_product_attention(
            *qkv, causal=causal, impl="dense"), qkv, g)
        res = [_max_err(x, y, **GRAD_TOL) for x, y in zip(got, ref)]
        key = f"{[b, h, tq, tk, d]} causal={causal}"
        errs[key] = [e for e, _ in res]
        ok = ok and all(o for _, o in res)
        print(f"flash grad vs dense {key}: |d(dq,dk,dv)|max = "
              f"{', '.join(f'{e:.3g}' for e, _ in res)} ({GRAD_TOL}, "
              f"float32 summation order)")
    rec["grad_vs_dense"] = errs
    _require(ok, f"flash gradients disagree with dense autograd: {errs}")


def _gpt2_model(torch):
    from deeplearning4j_tpu_torch.nlp.transformer import (
        TransformerLM, TransformerLMConfig)
    import numpy as np
    lm = TransformerLM(TransformerLMConfig(**GPT2_SMALL))
    rng = np.random.RandomState(1)
    prompts = rng.randint(0, GPT2_SMALL["vocabSize"],
                          (BATCH, PROMPT)).astype(np.int32)
    return lm, prompts


def _counters():
    from deeplearning4j_tpu_torch.parallel.ring import (
        flash_attention, flash_bwd_dkv, flash_bwd_dq)
    return {"flash_attn_fwd": flash_attention.launches,
            "flash_attn_bwd_dq": flash_bwd_dq.launches,
            "flash_attn_bwd_dkv": flash_bwd_dkv.launches}


def _reset_counters():
    from deeplearning4j_tpu_torch.parallel.ring import (
        flash_attention, flash_bwd_dkv, flash_bwd_dq)
    flash_attention.launches = flash_bwd_dq.launches = \
        flash_bwd_dkv.launches = 0


def phase_main_path(torch, rec, lm, prompts):
    from deeplearning4j_tpu_torch.parallel.ring import flash_attention
    import numpy as np
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    out = lm.generate(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    rec["generate_s"] = time.perf_counter() - t0
    rec["launches"] = counts = _counters()
    launches = counts["flash_attn_fwd"]
    print(f"generate {BATCH}x{PROMPT} -> {out.shape} in "
          f"{rec['generate_s']:.3f} s; launches {counts}")
    _require(out.shape == (BATCH, NEW_TOKENS),
             f"generate returned shape {out.shape}")
    _require(bool(((out >= 0) & (out < GPT2_SMALL["vocabSize"])).all()),
             "generated token ids out of range")
    _require(launches == GPT2_SMALL["nLayers"],
             f"prefill launched the flash kernel {launches} times, expected "
             f"{GPT2_SMALL['nLayers']} (one per layer)")
    _require(counts["flash_attn_bwd_dq"] == counts["flash_attn_bwd_dkv"]
             == 0, f"serving launched a backward kernel: {counts}")

    lengths = np.array([PROMPT, 1000, 900, 512])
    padded = prompts.copy()
    for i, n in enumerate(lengths):
        padded[i, :PROMPT - n] = 0                  # left padding
    before = flash_attention.launches
    out_p = lm.generate(padded, 8, lengths=lengths)
    torch.cuda.synchronize()
    _require(flash_attention.launches == before,
             "a padded (masked) request reached the flash kernel")
    _require(out_p.shape == (BATCH, 8), f"padded generate shape "
                                        f"{out_p.shape}")
    n = min(8, NEW_TOKENS)
    rec["padded_row0_tokens_match_unpadded"] = bool(
        (out_p[0, :n] == out[0, :n]).all())
    print(f"padded request lengths={lengths.tolist()}: dense path "
          f"(flash launches unchanged at {before})")
    return padded, lengths


def _forced_dense(dpa):
    """``dot_product_attention`` with ``impl="dense"`` whatever the caller
    passes (a caller's explicit ``impl="auto"`` would override a partial)."""
    return lambda *a, **kw: dpa(*a, **{**kw, "impl": "dense"})


def phase_outputs(torch, rec, lm, prompts, padded, lengths):
    import deeplearning4j_tpu_torch.nlp.transformer as tmod
    import numpy as np
    errs = {}
    logits, caches = lm.prefill(prompts)
    _require(tuple(logits.shape) == (BATCH, GPT2_SMALL["vocabSize"]) and
             bool(logits.isfinite().all()), "prefill logits not finite or "
                                            "of the wrong shape")
    orig = tmod.dot_product_attention
    tmod.dot_product_attention = _forced_dense(orig)
    try:
        dense_logits, _ = lm.prefill(prompts)
    finally:
        tmod.dot_product_attention = orig
    errs["prefill_flash_vs_dense"] = float((logits - dense_logits).abs().max())

    # the padded request's rows against unpadded prefills of their tokens
    plog, _ = lm.prefill(padded, lengths)
    e = 0.0
    for i, n in enumerate(lengths):
        row, _ = lm.prefill(prompts[i:i + 1, PROMPT - n:])
        e = max(e, float((plog[i] - row[0]).abs().max()))
    errs["padded_vs_unpadded_rows"] = e

    # one KV-cached decode step against a prefill of the extended prompt
    tok = torch.argmax(logits, dim=-1)
    step_logits, _ = lm.decodeStep(tok, caches)
    ext = np.concatenate([prompts, tok.cpu().numpy()[:, None]], axis=1)
    ext_logits, _ = lm.prefill(ext)
    errs["decode_vs_prefill"] = float((step_logits - ext_logits).abs().max())
    rec["logit_errors"] = errs
    for name, err in errs.items():
        print(f"logits {name}: max |d| = {err:.3g} (atol {LOGIT_ATOL}, "
              f"float32 summation order)")
    _require(all(e <= LOGIT_ATOL for e in errs.values()),
             f"model outputs disagree: {errs}")


def phase_timing(torch, rec, lm, prompts):
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.parallel.ring import (
        flash_attention_reference, flash_forward)
    b, h, tq, tk, d = KERNEL_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((b, h, t, d), generator=gen, device="cuda")
               for t in (tq, tk, tk))
    ms = _time_ms(torch, lambda: flash_forward(q, k, v, True))
    plain_ms = _time_ms(torch, lambda: flash_attention_reference(
        q, k, v, True))
    lib_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    bound_ms, bound_by, flops, nbytes = _attention_bound(
        b, h, tq, tk, d, True, "float32", 4)
    out, _ = flash_forward(q, k, v, True)
    ref, _ = flash_attention_reference(q, k, v, True)
    err = float((out - ref).abs().max())
    rec["flash_timing"] = dict(shape=[b, h, tq, tk, d], dtype="float32",
                               causal=True, ms=ms, plain_ms=plain_ms,
                               library_ms=lib_ms, bound_ms=bound_ms,
                               bound_by=bound_by, flops=flops, bytes=nbytes,
                               max_abs_err=err,
                               achieved_tflops=flops / ms / 1e9)
    print(f"flash f32 causal {[b, h, tq, tk, d]}: {ms:.4f} ms "
          f"({flops / ms / 1e9:.2f} TFLOP/s), bound {bound_ms:.4f} ms "
          f"({bound_by}), plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms")

    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    rec["flash_timing_bf16"] = dict(
        ms=_time_ms(torch, lambda: flash_forward(qb, kb, vb, True)),
        library_ms=_time_ms(torch, lambda: F.scaled_dot_product_attention(
            qb, kb, vb, is_causal=True)),
        bound_ms=_attention_bound(b, h, tq, tk, d, True, "bfloat16", 2)[0])
    print(f"flash bf16 causal: {rec['flash_timing_bf16']}")

    def prefill():
        lm.prefill(prompts)
    t_prefill = _time_ms(torch, prefill, iters=5, warmup=1)
    _, caches = lm.prefill(prompts)
    tok = torch.zeros((BATCH,), dtype=torch.long, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(NEW_TOKENS):
        logits, caches = lm.decodeStep(tok, caches)
        tok = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    rec["prefill_ms"] = t_prefill
    rec["prefill_tokens_per_s"] = BATCH * PROMPT / (t_prefill / 1e3)
    rec["decode_tokens_per_s"] = BATCH * NEW_TOKENS / t_decode
    print(f"prefill {BATCH}x{PROMPT}: {t_prefill:.2f} ms, "
          f"{rec['prefill_tokens_per_s']:.0f} tokens/s; decode "
          f"{NEW_TOKENS} steps x {BATCH}: "
          f"{rec['decode_tokens_per_s']:.1f} tokens/s")


def _device_breakdown(torch, fn, top=8):
    """One call of ``fn`` under torch.profiler: wall ms (host clock to a
    synchronise), device busy ms (the sum of kernel and copy self times),
    the number of device kernels and copies, and the ``top`` kernels by
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    rows = sorted(((e.key, e.self_device_time_total / 1e3) for e in dev),
                  key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    return {"wall_ms": wall, "device_busy_ms": busy if rows else None,
            "idle_share": 1 - busy / wall if rows else None,
            "device_ops": sum(e.count for e in dev) if rows else None,
            "top": [[name[:90], ms] for name, ms in rows[:top]]}


def phase_profile(torch, rec, lm, prompts):
    _, caches = lm.prefill(prompts)
    tok = torch.zeros((BATCH,), dtype=torch.long, device="cuda")

    def decode4():
        c = caches
        for _ in range(4):
            _, c = lm.decodeStep(tok, c)
    rec["profile"] = {"prefill": _device_breakdown(
        torch, lambda: lm.prefill(prompts)),
        "decode_4_steps": _device_breakdown(torch, decode4)}
    for name, p in rec["profile"].items():
        if p["device_busy_ms"] is None:
            print(f"profile {name}: no device time in the trace "
                  f"(not measured)")
            continue
        print(f"profile {name}: wall {p['wall_ms']:.2f} ms, device busy "
              f"{p['device_busy_ms']:.2f} ms, idle share "
              f"{p['idle_share']:.3f}")
        for kname, ms in p["top"]:
            print(f"  {ms:9.3f} ms  {kname}")


def _long_context_conf(data_type):
    """bench.py bench_long_context's configuration, built with the port's
    config DSL."""
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.attention import SelfAttentionLayer
    from deeplearning4j_tpu_torch.nn.conf.recurrent import RnnOutputLayer
    c = LONG_CONTEXT
    return (NeuralNetConfiguration.builder().seed(c["seed"])
            .updater(Adam(c["lr"])).dataType(data_type).list()
            .layer(SelfAttentionLayer(nHeads=c["nHeads"],
                                      headSize=c["headSize"], nOut=c["nIn"]))
            .layer(SelfAttentionLayer(nHeads=c["nHeads"],
                                      headSize=c["headSize"], nOut=c["nIn"]))
            .layer(RnnOutputLayer.builder("mse").nOut(c["nOut"])
                   .activation("identity").build())
            .setInputType(InputType.recurrent(c["nIn"], c["t"])).build())


def _train_model(torch):
    """The BFLOAT16 net on the card (the entry point's default device), a
    copy of its initial parameters, and bench.py's two seeded batches."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    c = LONG_CONTEXT
    net = MultiLayerNetwork(_long_context_conf("BFLOAT16")).init()
    _require(net.device.type == "cuda", f"the net runs on {net.device}")
    params0 = {li: {k: v.clone() for k, v in lp.items()}
               for li, lp in net.params_.items()}
    rng = np.random.RandomState(1)
    pool = [DataSet(rng.randn(c["batch"], c["nIn"], c["t"]).astype(
        np.float32), rng.randn(c["batch"], c["nOut"], c["t"]).astype(
        np.float32)) for _ in range(2)]
    print(f"long-context net: {net.numParams()} params, "
          f"{TRAIN_SHAPE[0]}x{c['nIn']}x{c['t']} batches, BFLOAT16 compute "
          f"over float32 masters")
    return net, params0, pool


def phase_train(torch, rec, net, params0, pool):
    import math
    from deeplearning4j_tpu_torch.datasets import ListDataSetIterator
    it = ListDataSetIterator(pool)
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    net.fit(it, epochs=TRAIN_EPOCHS)
    loss = net.score()
    rec["train_fit_s"] = time.perf_counter() - t0
    rec["launches_train"] = counts = _counters()
    steps = net.getIterationCount()
    rec["train_steps"], rec["train_loss"] = steps, loss
    print(f"fit {TRAIN_EPOCHS} epochs x {len(pool)} batches: {steps} steps "
          f"in {rec['train_fit_s']:.3f} s, last loss {loss:.6g}, "
          f"launches {counts}")
    _require(steps == TRAIN_EPOCHS * len(pool) and
             net.getEpochCount() == TRAIN_EPOCHS,
             f"{steps} steps, {net.getEpochCount()} epochs")
    want = 2 * steps    # two attention layers, one launch each per step
    _require(all(n == want for n in counts.values()),
             f"expected {want} launches of each flash kernel (B1, B2, B3 "
             f"twice per step), got {counts}")
    _require(math.isfinite(loss), f"training loss {loss}")
    out = net.output(pool[0].features)
    _require(tuple(out.shape) == (TRAIN_SHAPE[0], LONG_CONTEXT["nOut"],
                                  LONG_CONTEXT["t"])
             and bool(out.isfinite().all()),
             f"output of shape {tuple(out.shape)} or not finite")


def phase_train_outputs(torch, rec, params0, pool):
    """One FLOAT step from the same copied parameters, flash kernels
    against dense attention forced in the attention layers."""
    import deeplearning4j_tpu_torch.nn.conf.attention as amod
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork

    def one_step():
        net = MultiLayerNetwork(_long_context_conf("FLOAT")).init(
            params=params0)
        net.fit(pool[0])
        return net.score(), net.params()

    _reset_counters()
    loss_f, p_f = one_step()
    counts = _counters()
    orig = amod.dot_product_attention
    amod.dot_product_attention = _forced_dense(orig)
    try:
        _reset_counters()
        loss_d, p_d = one_step()
        dense_counts = _counters()
    finally:
        amod.dot_product_attention = orig
    errs = {"loss": abs(loss_f - loss_d),
            "params": float((p_f - p_d).abs().max())}
    rec["train_step_flash_vs_dense"] = dict(errs, loss_flash=loss_f,
                                           loss_dense=loss_d,
                                           launches=counts)
    print(f"FLOAT step flash vs dense: loss {loss_f:.7g} vs {loss_d:.7g} "
          f"(|d| {errs['loss']:.3g}, atol {TRAIN_LOSS_ATOL}), params "
          f"|d|max {errs['params']:.3g} (atol {TRAIN_PARAM_ATOL}); flash "
          f"launches {counts}")
    _require(all(n == 2 for n in counts.values()),
             f"the FLOAT step launched {counts}, expected 2 of each")
    _require(not any(dense_counts.values()),
             f"the dense step launched a flash kernel: {dense_counts}")
    _require(errs["loss"] <= TRAIN_LOSS_ATOL and
             errs["params"] <= TRAIN_PARAM_ATOL,
             f"flash and dense training steps disagree: {errs}")


def phase_train_timing(torch, rec, net, pool):
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.parallel.ring import (
        flash_attention_reference, flash_bwd_dkv, flash_bwd_dkv_reference,
        flash_bwd_dq, flash_bwd_dq_reference, flash_forward)
    b, h, tq, tk, d = TRAIN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(4)
    timing = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn, elem = str(dtype).split(".")[-1], dtype.itemsize
        q, do = (torch.randn((b, h, tq, d), generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((b, h, tk, d), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        out, lse = flash_forward(q, k, v)
        delta = (do.float() * out.float()).sum(-1).reshape(b * h, tq)
        args = (q, k, v, do, lse, delta, False)
        qkv = [x.detach().requires_grad_() for x in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*qkv)
        sdpa_bwd = _time_ms(torch, lambda: torch.autograd.grad(
            sdpa_out, qkv, do, retain_graph=True))
        rows = {
            "flash_attn_fwd": (
                lambda: flash_forward(q, k, v),
                lambda: flash_attention_reference(q, k, v),
                lambda: F.scaled_dot_product_attention(q, k, v),
                _attention_bound(b, h, tq, tk, d, False, dn, elem),
                float((out - flash_attention_reference(q, k, v)[0])
                      .abs().max())),
            "flash_attn_bwd_dq": (
                lambda: flash_bwd_dq(*args),
                lambda: flash_bwd_dq_reference(*args), None,
                _bwd_bound("dq", b, h, tq, tk, d, False, dn, elem),
                float((flash_bwd_dq(*args).float()
                       - flash_bwd_dq_reference(*args).float()).abs().max())),
            "flash_attn_bwd_dkv": (
                lambda: flash_bwd_dkv(*args),
                lambda: flash_bwd_dkv_reference(*args), None,
                _bwd_bound("dkv", b, h, tq, tk, d, False, dn, elem),
                max(float((x.float() - y.float()).abs().max())
                    for x, y in zip(flash_bwd_dkv(*args),
                                    flash_bwd_dkv_reference(*args)))),
        }
        for name, (fn, plain, lib, (bound_ms, bound_by, flops, nbytes),
                   err) in rows.items():
            ms = _time_ms(torch, fn)
            r = dict(shape=list(TRAIN_SHAPE), dtype=dn, causal=False, ms=ms,
                     plain_ms=_time_ms(torch, plain, iters=5, warmup=1),
                     library_ms=_time_ms(torch, lib) if lib else sdpa_bwd,
                     bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                     bytes=nbytes, max_abs_err=err,
                     achieved_tflops=flops / ms / 1e9)
            timing.setdefault(name, {})[dn] = r
            print(f"{name} {dn} {list(TRAIN_SHAPE)}: {ms:.4f} ms "
                  f"({r['achieved_tflops']:.2f} TFLOP/s), bound "
                  f"{bound_ms:.4f} ms ({bound_by}), plain "
                  f"{r['plain_ms']:.4f} ms, SDPA "
                  f"{'forward' if lib else 'backward (dq, dk, dv)'} "
                  f"{r['library_ms']:.4f} ms, max |d| {err:.3g}")
    rec["train_kernel_timing"] = timing

    for i in range(2):          # warm, as bench.py does
        net.fit(pool[i % 2])
    net.score()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_TIMED_STEPS):
        net.fit(pool[i % 2])
    net.score()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec["train_ms_per_step"] = wall / TRAIN_TIMED_STEPS * 1e3
    rec["train_tokens_per_s"] = (TRAIN_SHAPE[0] * LONG_CONTEXT["t"]
                                 * TRAIN_TIMED_STEPS / wall)
    print(f"training: {rec['train_ms_per_step']:.3f} ms/step, "
          f"{rec['train_tokens_per_s']:.0f} tokens/s "
          f"({TRAIN_TIMED_STEPS} steps after 2 warm)")


def phase_train_profile(torch, rec, net, pool):
    p = rec.setdefault("profile", {})["train_step"] = _device_breakdown(
        torch, lambda: (net.fit(pool[0]), net.score()), top=10)
    if p["device_busy_ms"] is None:
        print("profile train_step: no device time in the trace "
              "(not measured)")
        return
    print(f"profile train_step: wall {p['wall_ms']:.2f} ms, device busy "
          f"{p['device_busy_ms']:.2f} ms, idle share {p['idle_share']:.3f}, "
          f"{p['device_ops']} device kernels and copies")
    for kname, ms in p["top"]:
        print(f"  {ms:9.3f} ms  {kname}")


def _kernel_entry(name, replaces, launches, t):
    return {"name": name, "route": "cuda",
            "source": f"deeplearning4j_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}


def main(argv) -> int:
    record = argv[argv.index("--record") + 1] if "--record" in argv \
        else None
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import deeplearning4j_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    rec, failed = {}, []

    def run(name, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
            rec.setdefault("phase_s", {})[name] = time.perf_counter() - t0
            return out
        except Exception:           # report every phase, then fail
            traceback.print_exc()
            failed.append(name)
            return None

    run("build", phase_build, rec)
    if not failed:
        run("kernels", phase_kernels, torch, rec)
        run("bwd_kernels", phase_bwd_kernels, torch, rec)
        run("grad", phase_grad, torch, rec)
        model = run("model_init", _gpt2_model, torch)
        if model is not None:
            res = run("main_path", phase_main_path, torch, rec, *model)
            if res is not None:
                run("outputs", phase_outputs, torch, rec, *model, *res)
            run("timing", phase_timing, torch, rec, *model)
            run("profile", phase_profile, torch, rec, *model)
        del model
        train = run("train_init", _train_model, torch)
        if train is not None:
            net, params0, pool = train
            run("train_path", phase_train, torch, rec, *train)
            run("train_outputs", phase_train_outputs, torch, rec, params0,
                pool)
            run("train_timing", phase_train_timing, torch, rec, net, pool)
            run("train_profile", phase_train_profile, torch, rec, net, pool)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else None
    rec["card"] = card
    rec["failed"] = failed
    if record:
        os.makedirs(os.path.dirname(os.path.abspath(record)), exist_ok=True)
        with open(record, "w") as f:
            json.dump(rec, f, indent=1)
    if card is None:
        failed.append("nvidia-smi")
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1

    # launches: the serving run's and the training run's counts together
    # (B1 runs on both paths; B2 and B3 on the training path only).  B1's
    # times are at the serving shape (f32, causal), B2's and B3's at the
    # training shape in its dtype (bf16, not causal); the record holds B1
    # at the training shape too.
    serve, train_t = rec["launches"], rec["train_kernel_timing"]
    launches = {k: serve[k] + rec["launches_train"][k] for k in serve}
    kernels_line = {"kernels": [
        _kernel_entry("flash_attn_fwd",
                      "deeplearning4j_tpu/parallel/ring.py:127",
                      launches["flash_attn_fwd"], rec["flash_timing"]),
        _kernel_entry("flash_attn_bwd_dq",
                      "deeplearning4j_tpu/parallel/ring.py:188",
                      launches["flash_attn_bwd_dq"],
                      train_t["flash_attn_bwd_dq"]["bfloat16"]),
        _kernel_entry("flash_attn_bwd_dkv",
                      "deeplearning4j_tpu/parallel/ring.py:228",
                      launches["flash_attn_bwd_dkv"],
                      train_t["flash_attn_bwd_dkv"]["bfloat16"])]}
    print(card)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
