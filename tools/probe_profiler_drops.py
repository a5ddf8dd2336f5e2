#!/usr/bin/env python3
"""Count torch.profiler passes that come back without their device records.

Each pass profiles CALLS tiny kernels (an in-place add on one float, ~2 us
on the device, about as long as one CAN update of kernel W) and counts the
device records the profiler returns. Passes alternate between PADS: the
seconds the pass idles on the host before the first kernel and after the
last one. A pass is "empty" with no device record, "partial" with fewer
than CALLS, "full" otherwise. chip_smoke.py's and tools/time_ekf_update.py's
profiled passes idle PROFILE_PAD_S at both ends because of what this shows.

    python3 tools/probe_profiler_drops.py [--passes N]

Prints one line per round and then one JSON line, with the card's name and
power limit. Exits 1 without a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time

import torch

CALLS = 5
PADS = (0.0, 0.05)
ROUNDS = 2


def one_pass(pad):
    """Device records of one profiled pass of CALLS kernels."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(CALLS):
            x.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(pad)
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--passes", type=int, default=200, help="passes a pad a round")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_profiler_drops: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    out = {"card": smi, "torch": torch.__version__, "calls_a_pass": CALLS, "pads": {}}
    for rnd in range(ROUNDS):
        for pad in PADS:
            counts = [one_pass(pad) for _ in range(args.passes)]
            r = out["pads"].setdefault(str(pad), {"passes": 0, "empty": 0, "partial": 0,
                                                   "full": 0})
            r["passes"] += len(counts)
            r["empty"] += sum(c == 0 for c in counts)
            r["partial"] += sum(0 < c < CALLS for c in counts)
            r["full"] += sum(c >= CALLS for c in counts)
            print(f"round {rnd} pad {pad} s: {r}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
