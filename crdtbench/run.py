"""Run one cell of the benchmark once and print its result line.

    python3 crdtbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last the ``checks``: every number compared beside its
limit); the checks are also the last lines of standard error. Without the
cards, without the program beside the benchmark, or with JAX or the JAX
package loaded, it prints no result and exits non-zero.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "crdtbench"

# Every cache the program or PyTorch may write stays at a fixed place in
# this checkout; the kernels themselves build into build/repro_torch/.
os.environ["REPRO_AUTOTUNE_CACHE"] = str(BUILD / "autotune.json")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from crdtbench import guard  # noqa: E402


def main() -> int:
    guard.check("at start-up")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"crdtbench: no program beside the benchmark (no "
              f"{ROOT / 'src' / 'repro_torch'})", file=sys.stderr)
        return 2
    if args.seed < 0:
        print("crdtbench: --seed must be non-negative", file=sys.stderr)
        return 2

    import torch

    from crdtbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"crdtbench: no cell {args.workload!r}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"crdtbench: cell {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    devices = [torch.device(f"cuda:{i}") for i in range(chips)]
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), devices, T_PROCESS, BUILD)
    out["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0), **out["device"]}
    guard.check("before the result")
    checks = out.pop("checks")
    out["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
