#!/usr/bin/env python
"""Run ``chip_smoke.py``'s multi-device phases alone on one GPU.

    python3 tools/chip_multi_device.py

Builds the kernels (``chip_smoke.py`` phase 1), times one classic+nl-fast
frame on RubberWhale 584x388, then runs phase 16 (``estimate_flow(mesh=)``
for classic+nl-fast and ``ba``), phase 17 (``hs`` and the stable
``classic-c-a`` row-sharded, the meshed batches, the pipeline) and phase
18 (two ranks on card 0 over gloo: classic+nl-fast row-sharded under the
three PCG recurrences and the batch across the processes, against phases
16 and 17's frames) with the same checks and prints.  Each phase's failure is printed and the next runs;
the exit code is non-zero if any failed.  A quick loop for multi-device
work; ``chip_smoke.py`` remains the whole check.
"""
import os
import sys
import time
import traceback

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from optical_flow_tpu_torch.io.flo import read_flow_file  # noqa: E402


def main():
    card = cs.phase_setup(torch)
    dev = torch.device("cuda", 0)
    print(f"cards: {torch.cuda.device_count()}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    rgb1, rgb2, tu, tv = read_flow_file("RubberWhale", 10)
    pairs = [(seq, *read_flow_file(seq, 10)) for seq in cs.BATCH_SEQS]
    frame_ms, runs, host_ms = cs.frame_latency(torch, dev, "classic+nl-fast", cs.PARAMS, rgb1, rgb2)
    print(f"single frame {frame_ms:.2f} ms (CUDA events; runs {runs}), {host_ms:.2f} ms host  [{card}]")
    ok, kept = True, {}
    for name, run in (("phase 16", lambda: cs.phase_sharded(torch, dev, card, rgb1, rgb2, tu, tv)),
                      ("phase 17 sharded", lambda: cs.phase_sharded_families(torch, dev, card, rgb1, rgb2, tu, tv)),
                      ("phase 17 meshed batches", lambda: cs.phase_mesh_batches(torch, dev, card, pairs)),
                      ("phase 17 pipeline", lambda: cs.phase_pipeline(torch, dev, card, pairs, frame_ms)),
                      ("phase 18", lambda: cs.phase_multiprocess(torch, card, tu, tv, kept["phase 16"][2],
                                                                  kept["phase 17 meshed batches"][1]))):
        t0 = time.perf_counter()
        try:
            kept[name] = run()
            print(f"{name}: {_summary(kept[name])}")
        except (cs.CheckFailed, KeyError):  # KeyError: phase 18 without a reference phase
            ok = False
            traceback.print_exc()
        print(f"{name}: {time.perf_counter() - t0:.1f} s (host clock)", flush=True)
    return 0 if ok else 1


def _summary(result):
    """A phase's result with its arrays (the references of phase 18) left out."""
    parts = result if isinstance(result, tuple) else (result,)
    return tuple(p for p in parts if not hasattr(p, "shape"))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("chip_multi_device: no CUDA device")
    sys.exit(main())
