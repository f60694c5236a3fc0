"""The control of a cell's comparison: the plain reference with delivery
broken (``drop``: the message on replica 0's first receive slot is lost
every round while its sender clears its buffer all the same), put in the
program's place and judged as a run's answer is, at the cell's own size.
Every seed has to come out not correct; its numbers are the upper
readings the limits are set below.

    python3 crdtbench/control.py --workload <cell> --seeds 11,12,13

One JSON line a seed; the last line sums them up. Needs the cards the cell
asks for.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

DROP = (0, 0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()

    import torch

    from crdtbench import check, harness, traffic

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell, config, mix = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"control: {args.workload} needs {cell['chips']} card(s)",
              file=sys.stderr)
        return 2
    devices = [torch.device(f"cuda:{i}") for i in range(cell["chips"])]
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        entry = traffic.generate(dict(mix, pool=1), config, seed)[0]
        ans = check.reference_answer(config, mix, entry, devices, drop=DROP)
        got = check.judge(config, mix, entry, ans, devices)
        del ans
        torch.cuda.empty_cache()
        rows.append(got)
        print(json.dumps({"seed": seed, "numbers": got,
                          "seconds": time.perf_counter() - t}), flush=True)
    print(json.dumps({
        "workload": args.workload, "kind": torch.cuda.get_device_name(0),
        "control": {k: [r[k] for r in rows] for k in check.LIMITS},
        "control_fails": [any(r[k] > check.LIMITS[k] for k in check.LIMITS)
                          for r in rows]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
