#!/usr/bin/env python3
"""Does ``torch.profiler`` on this card keep the first records of a session?

Profiles one window (2000 launches of ``F.layer_norm`` on one bf16 row of
2048) in four ways: bare, after one spin kernel (``torch.cuda._sleep``),
after two, and after 50 ms of host sleep; once in a fresh process, then
three times after running ``chip_smoke.py``'s phase-3 kernel checks in the
same process (as a whole smoke run has by its phase 4). Prints, for each,
the kernel records the profiler kept by name. A bare window that reads
fewer than 2000 layer-norm records lost records at the session's start;
the lead-in of ``chip_smoke.profile_window`` is sized from what such
windows lose.

    python3 scripts/profiler_lead_in_check.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

LEADS = ("none", "spin", "spin2", "sleep")


def window(fn, lead: str) -> list:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if lead in ("spin", "spin2"):
            torch.cuda._sleep(cs.LEAD_IN_CYCLES)
            torch.cuda.synchronize()
        if lead == "spin2":
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        if lead == "sleep":
            time.sleep(0.05)
        fn()
        torch.cuda.synchronize()
    return sorted(((e.key[:70], e.count) for e in prof.key_averages() if cs._dev_us(e) > 0),
                  key=lambda t: -t[1])


def main() -> int:
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import _build

    _build.load()
    card = cs.card_line()
    print(torch.__version__, card, flush=True)
    x = torch.randn(1, 2048, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(2048, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(2048, device="cuda", dtype=torch.bfloat16)

    def fn():
        for _ in range(2000):
            F.layer_norm(x, (2048,), w, b, 1e-5)

    print("fresh:", {lead: window(fn, lead) for lead in LEADS}, flush=True)
    cs.phase_kernels(cs.SEED, card)
    cs.phase_flash(cs.SEED, card)
    cs.phase_rows_kernels(cs.SEED, card)
    cs.phase_paged_sm90(cs.SEED, card)
    cs.phase_ln_quant_kernels(cs.SEED, card)
    for _ in range(3):
        print("after phase 3:", {lead: window(fn, lead) for lead in LEADS}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
