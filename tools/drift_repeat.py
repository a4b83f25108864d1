"""Repeat chip_smoke.py's float32 ``[watchdog_drift]`` phase on the card
and report what the session's watchdog and the host's clock saw.

    python tools/drift_repeat.py [--arch falcon-mamba-7b-smoke] [--runs 20]

Each run is ``chip_smoke.exact_watchdog_drift`` on the smoke config
(float32, batch 2, 6 requests): a drift injected after the decode slot
commits must be found, reopen the slot and re-commit, with no other
drift, and the tokens must equal the plain path's.  Per run one phase
line (or the failure), whose ``host_steps_over_ratio`` lists the steps
outside the fault whose host time passed the watchdog's ratio times
the baseline; then a summary line (runs, failures, such steps and the
longest run of them in a row) and the card's name and power limit.
Needs a CUDA card and ``nvcc``.
"""
import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "src"))

import chip_smoke  # noqa: E402


def longest_run(steps):
    """The longest run of consecutive step numbers in ``steps``."""
    best = run = 0
    prev = None
    for st in steps:
        run = run + 1 if prev is not None and st == prev + 1 else 1
        best, prev = max(best, run), st
    return best


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="falcon-mamba-7b-smoke")
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("drift_repeat: needs a CUDA card")
    from repro_torch.kernels import _build
    _build.load()
    dev = torch.device("cuda")
    failures, over, longest = [], [], 0
    for i in range(args.runs):
        lines = []
        real = chip_smoke.phase

        def keep(tag, /, **fields):
            lines.append(fields)
            real(tag, run=i, **fields)

        chip_smoke.phase = keep
        try:
            chip_smoke.exact_watchdog_drift(torch, dev, args.arch)
        except SystemExit as e:
            failures.append(str(e))
            print(f"[drift_repeat] run={i} failed: {e}", flush=True)
        finally:
            chip_smoke.phase = real
        for fields in lines:
            steps = [st for st, _ in json.loads(
                fields.get("host_steps_over_ratio", "[]"))]
            over += steps
            longest = max(longest, longest_run(steps))
        chip_smoke.free_card(torch)
    print(json.dumps({"arch": args.arch, "runs": args.runs,
                      "failures": len(failures),
                      "host_steps_over_ratio": len(over),
                      "longest_run_over_ratio": longest}), flush=True)
    print(chip_smoke.nvidia_smi_line())
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
