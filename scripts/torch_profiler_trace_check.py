#!/usr/bin/env python3
"""How often does a torch.profiler session on a CUDA card come back without
any kernel's device time, and does the same window, run again at once,
come back with one?

``chip_smoke.py`` takes every kernel's device time from such sessions, a few
hundred in one run. This script opens ``--sessions`` sessions of ``--launches``
elementwise kernels each, back to back and then with a pause before each, and
prints one JSON line: sessions, empty ones, how many of the empty ones were
still empty on an immediate second try, how many further sessions (0.2 s
apart) it took until one held a kernel, and what an empty session held.

    python3 scripts/torch_profiler_trace_check.py [--sessions 400] [--launches 100]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _dev_us(evt) -> float:
    v = getattr(evt, "self_device_time_total", None)
    return float(v if v is not None else getattr(evt, "self_cuda_time_total", 0.0))


def session(fn):
    """(kernels with device time, events of any kind) of one session."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evts = prof.key_averages()
    return sum(1 for e in evts if _dev_us(e) > 0), len(evts)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sessions", type=int, default=400)
    ap.add_argument("--launches", type=int, default=100)
    ap.add_argument("--pause-ms", type=float, default=20.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    x = torch.randn(1 << 22, device="cuda")
    fn = lambda: [x.add_(1.0) for _ in range(args.launches)]  # noqa: E731
    out = {"card": card, "torch": torch.__version__, "sessions": args.sessions,
           "launches": args.launches}
    for name, pause in (("back_to_back", 0.0), ("paused", args.pause_ms / 1e3)):
        empty, still_empty, held, first, bursts = 0, 0, [], None, []
        for i in range(args.sessions):
            time.sleep(pause)
            n_dev, n_evt = session(fn)
            if n_dev:
                continue
            empty += 1
            first = i if first is None else first
            held.append(n_evt)
            # how long the fault lasts: the same window again at once, then
            # every 0.2 s, until a session holds a kernel (20 tries at most)
            t0, tries = time.perf_counter(), 1
            while session(fn)[0] == 0 and tries < 20:
                tries += 1
                time.sleep(0.2)
            still_empty += tries > 1
            bursts.append({"more_sessions_needed": tries,
                           "seconds": round(time.perf_counter() - t0, 3)})
        out[name] = {"empty": empty, "still_empty_on_second_try": still_empty,
                     "first_empty_at": first, "events_in_empty_sessions": held[:10],
                     "bursts": bursts}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
