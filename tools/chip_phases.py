#!/usr/bin/env python3
"""Time chosen phases of a checkout's ``chip_smoke.py`` on the card.

    python3 tools/chip_phases.py ROOT TAG PHASE [PHASE ...]

imports ``ROOT/chip_smoke.py`` (so ROOT's copy of the port) and runs each
named ``phase_<PHASE>(torch, rec, card)`` in turn, in one process, then
prints one line ``AB TAG {phase: seconds, ...} <card>``: every phase's
wall time, the card synchronised after it.  To compare two trees on one
card, unpack the parent with ``git archive`` into a git-ignored
directory and run both in one command, in turns (parent, change, change,
parent).  Only phases that take ``(torch, rec, card)`` can be named.
"""
import importlib
import json
import os
import sys
import time


def main(argv) -> int:
    root, tag, phases = os.path.abspath(argv[0]), argv[1], argv[2:]
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device is available", file=sys.stderr)
        return 1
    cs = importlib.import_module("chip_smoke")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs._card()
    rec, out = {}, {}
    for name in phases:
        t0 = time.perf_counter()
        getattr(cs, "phase_" + name)(torch, rec, card)
        torch.cuda.synchronize()
        out[name] = round(time.perf_counter() - t0, 3)
    print("AB", tag, json.dumps(out), card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
