"""One run of one benchmark cell on the card it is started on.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (``src/repro_torch`` beside this folder).
Prints the run's checks as the last lines of standard error and one JSON
object as the last line of standard output. Exits 1 without the port
beside it, 2 without enough CUDA cards, 3 if the JAX package or JAX was
loaded into the process.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"perfbench: no src/repro_torch beside {ROOT / 'perfbench'}: "
              f"the benchmark drives the port from a checkout of the "
              f"repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from perfbench import bench, registry

    bj = registry.load_benchmark(ROOT)
    chips = registry.cell(bj, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line = bench.execute(bj, args.workload, args.seed, args.seconds,
                         bool(args.trace), device, T_START,
                         log=lambda msg: print(msg, file=sys.stderr))
    found = bench.forbidden_modules()
    if found:
        print(f"perfbench: the process loaded {found}: the benchmark "
              f"measures the port alone", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
