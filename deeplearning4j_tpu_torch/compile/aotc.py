"""aotc — pre-bake the port's compiled libraries and ladders into the
persistent AOT cache (the port of ``tools/aotc.py``).

One bake job builds the compiled libraries — the native host library
always, and for ``--device cuda`` (the default) every ``csrc/*.cu``
kernel library, B4 included, which no model dispatches — drives a
model's serving bucket ladder and / or its train step through the
cache's dispatches so their ladders are recorded, and every later
process on the same (model, device set, torch / CUDA / port version)
boots by LOADING those libraries instead of running ``nvcc`` / ``g++``
again.

Usage::

    # serving ladder for an MLP forward model + its train step
    python -m deeplearning4j_tpu_torch.compile.aotc bake \\
        --cache-dir /ckpts/aot --mlp 32,64,10 --batches 1,2,4,8 --train

    # the libraries alone, and a TransformerLM's generative ladder
    python -m deeplearning4j_tpu_torch.compile.aotc bake --cache-dir /ckpts/aot
    python -m deeplearning4j_tpu_torch.compile.aotc bake \\
        --cache-dir /ckpts/aot --lm 128,2,4,16,128 --gen-batches 1,2,4 \\
        --seqs 16,32

    python -m deeplearning4j_tpu_torch.compile.aotc ls --cache-dir /ckpts/aot
    python -m deeplearning4j_tpu_torch.compile.aotc gc \\
        --cache-dir /ckpts/aot --max-bytes 1000000

Models are built on ``--device`` (default ``cuda``, the port's default);
``--device cpu`` bakes no kernel library, since nothing on the CPU
launches one.  ``--mesh-data`` (a sharded train step) waits for the
AOT cache's mesh half and raises naming ROADMAP A10b.  Prints one JSON line per
subcommand.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _ints(spec: str):
    return [int(s) for s in spec.split(",") if s != ""]


def _build_mlp(dims, device=None):
    from deeplearning4j_tpu_torch.learning import Adam
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.conf import (InputType,
                                                  NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.layers import (DenseLayer,
                                                         OutputLayer)
    nIn, hidden, nOut = dims
    conf = (NeuralNetConfiguration.builder().seed(0).updater(Adam(1e-3))
            .list()
            .layer(DenseLayer.builder().nIn(nIn).nOut(hidden)
                   .activation("relu").build())
            .layer(OutputLayer.builder("mcxent").nOut(nOut)
                   .activation("softmax").build())
            .setInputType(InputType.feedForward(nIn)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _bake_forward_ladder(net, nIn, batches, stats) -> None:
    from deeplearning4j_tpu_torch.compile.aotcache import wrap_serving_model
    from deeplearning4j_tpu_torch.remote import BucketLadder, ForwardServing
    serving = ForwardServing(net, BucketLadder(batchSizes=batches,
                                               seqLens=()),
                             inputShape=(nIn,))
    wrap_serving_model(net)
    t0 = time.perf_counter()
    for key in serving.warmKeys():
        serving.warm(key)
    stats["forward_ladder_seconds"] = round(time.perf_counter() - t0, 3)
    stats["forward_buckets"] = list(batches)


def _bake_train_step(net, nIn, nOut, batches, stats) -> None:
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    for b in batches:
        x = rng.randn(b, nIn).astype(np.float32)
        y = np.eye(nOut, dtype=np.float32)[rng.randint(0, nOut, b)]
        net.fit(DataSet(x, y))
    net.score()
    stats["train_step_seconds"] = round(time.perf_counter() - t0, 3)
    stats["train_batches"] = list(batches)


def _bake_lm_ladder(dims, genBatches, seqs, device, stats) -> None:
    from deeplearning4j_tpu_torch.compile.aotcache import wrap_serving_model
    from deeplearning4j_tpu_torch.nlp.transformer import (TransformerLM,
                                                          TransformerLMConfig)
    from deeplearning4j_tpu_torch.remote import (BucketLadder,
                                                 GenerativeServing)
    vocab, nLayers, nHeads, headSize, maxLen = dims
    lm = TransformerLM(TransformerLMConfig(
        vocabSize=vocab, nLayers=nLayers, nHeads=nHeads, headSize=headSize,
        maxLen=maxLen, seed=0), device=device)
    wrap_serving_model(lm)
    serving = GenerativeServing(lm, BucketLadder(batchSizes=genBatches,
                                                 seqLens=seqs))
    t0 = time.perf_counter()
    for key in serving.warmKeys():
        serving.warm(key)
    stats["lm_ladder_seconds"] = round(time.perf_counter() - t0, 3)
    stats["lm_buckets"] = {"batches": list(genBatches),
                           "seqs": list(seqs)}


def cmd_bake(args) -> dict:
    import torch

    from deeplearning4j_tpu_torch import kernels, native
    from deeplearning4j_tpu_torch.compile.aotcache import (aot_cache,
                                                           set_aot_cache)
    from deeplearning4j_tpu_torch.telemetry import get_registry
    if args.mesh_data:
        raise NotImplementedError(
            "aotc: --mesh-data bakes a sharded train step, which waits for "
            "the AOT cache's mesh half (ROADMAP A10b)")
    set_aot_cache(args.cache_dir)
    cache = aot_cache()
    if cache is None:
        raise SystemExit("aotc: cache disabled (DL4J_TPU_AOT_CACHE=0?)")
    before = len(cache.entries())
    runs0 = kernels.compiler_runs.count + native.compiler_runs.count
    stats: dict = {"command": "bake", "cache_dir": cache.directory}
    stats["native"] = native.available()
    if torch.device(args.device or "cuda").type == "cuda":
        t0 = time.perf_counter()
        stats["kernels_built"] = sorted(kernels.build())
        stats["kernels_seconds"] = round(time.perf_counter() - t0, 3)
    batches = _ints(args.batches)
    if args.mlp:
        dims = _ints(args.mlp)
        if len(dims) != 3:
            raise SystemExit("aotc: --mlp wants nIn,hidden,nOut")
        net = _build_mlp(dims, args.device)
        _bake_forward_ladder(net, dims[0], batches, stats)
        if args.train:
            _bake_train_step(net, dims[0], dims[2], batches, stats)
    if args.lm:
        dims = _ints(args.lm)
        if len(dims) != 5:
            raise SystemExit(
                "aotc: --lm wants vocab,layers,heads,headSize,maxLen")
        _bake_lm_ladder(dims, _ints(args.gen_batches), _ints(args.seqs),
                        args.device, stats)
    reg = get_registry()
    h = reg.get("dl4j_tpu_aot_cache_hits_total")
    stats["entries_baked"] = len(cache.entries()) - before
    stats["entries_total"] = len(cache.entries())
    stats["cache_bytes"] = cache.totalBytes()
    stats["ladder_count"] = len(cache._ladderDirs())
    stats["compiler_runs"] = kernels.compiler_runs.count + \
        native.compiler_runs.count - runs0
    stats["already_cached_hits"] = \
        sum(v for _k, v in h.data().get("cells", [])) if h else 0
    return stats


def cmd_ls(args) -> dict:
    from deeplearning4j_tpu_torch.compile.aotcache import AotCache
    cache = AotCache(args.cache_dir)
    entries = sorted(cache.entries(), key=lambda e: -e[2])
    out = []
    for d, size, mtime in entries:
        key = cache.entryKey(d) or {}
        out.append({"digest": d[:16], "kind": key.get("kind"),
                    "name": key.get("name"), "bytes": size,
                    "age_seconds": round(time.time() - mtime, 1)})
    return {"command": "ls", "cache_dir": cache.directory,
            "entries": out, "entry_count": len(entries),
            "ladder_count": len(cache._ladderDirs()),
            "total_bytes": cache.totalBytes()}


def cmd_gc(args) -> dict:
    from deeplearning4j_tpu_torch.compile.aotcache import AotCache
    cache = AotCache(args.cache_dir, maxBytes=args.max_bytes)
    before = cache.totalBytes()
    cache._evict()
    return {"command": "gc", "cache_dir": cache.directory,
            "max_bytes": cache.maxBytes, "bytes_before": before,
            "bytes_after": cache.totalBytes()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="aotc", description="pre-bake compiled libraries into the "
                                 "persistent AOT cache")
    sub = ap.add_subparsers(dest="command", required=True)

    bake = sub.add_parser("bake", help="build libraries, record ladders")
    bake.add_argument("--cache-dir", required=True)
    bake.add_argument("--device", default=None,
                      help="device the models are built on (default: "
                           "cuda, which also bakes every csrc/*.cu "
                           "kernel library)")
    bake.add_argument("--mlp", help="nIn,hidden,nOut forward model")
    bake.add_argument("--batches", default="1,2,4,8,16,32",
                      help="batch buckets for the forward/train ladder")
    bake.add_argument("--train", action="store_true",
                      help="also drive the train step per batch")
    bake.add_argument("--mesh-data", type=int, default=0,
                      help="a sharded train step: waits for ROADMAP A10b")
    bake.add_argument("--lm", help="vocab,layers,heads,headSize,maxLen "
                                   "TransformerLM")
    bake.add_argument("--gen-batches", default="1,2,4",
                      help="batch buckets for the generative ladder")
    bake.add_argument("--seqs", default="16,32,64",
                      help="prompt-length buckets for the generative "
                           "ladder")

    ls = sub.add_parser("ls", help="list cache entries")
    ls.add_argument("--cache-dir", required=True)

    gc = sub.add_parser("gc", help="enforce a size bound now")
    gc.add_argument("--cache-dir", required=True)
    gc.add_argument("--max-bytes", type=int, required=True)

    args = ap.parse_args(argv)
    out = {"bake": cmd_bake, "ls": cmd_ls, "gc": cmd_gc}[args.command](args)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
