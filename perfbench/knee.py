"""Find the highest arrival rate an open-loop cell sustains: one sweep on
the card, run once when the cell's rate is set.

    python3 -m perfbench.knee --workload <cell> --rates 2,3,4,5 \\
        --seconds 40 --seed <n>

For each rate, one run of the cell as ``perfbench.run`` makes it, at that
rate instead of the traffic file's, with a grace of nothing: what is not
done when the window closes stays undone. Prints per rate the requests
due, done and still waiting at the close, the TTFT median and 95th
percentile of those answered, and how the TTFT of the window's last
quarter compares with its first (a backlog that grows makes it climb).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from perfbench import registry

    device = torch.device("cuda", 0)
    bj = registry.load_benchmark(ROOT)
    for rate in (float(x) for x in args.rates.split(",")):
        b = registry.resolve(args.workload, args.seed, args.seconds, False,
                             device, bj)
        b = dataclasses.replace(b, traffic=dict(b.traffic, rate=rate,
                                                grace_seconds=0.0))
        out = registry.generator(b.traffic).run(b)
        s = out.session
        w1 = s.window[1]
        due = sorted((r for r in s.reqs.values() if r.due is not None),
                     key=lambda r: r.due)
        ans = [1e3 * (r.tokens[0] - r.due) for r in due
               if r.tokens and r.tokens[0] <= w1]
        q = max(1, len(due) // 4)
        first = [1e3 * (r.tokens[0] - r.due) for r in due[:q] if r.tokens]
        last = [1e3 * ((r.tokens[0] if r.tokens and r.tokens[0] <= w1 else w1)
                       - r.due) for r in due[-q:]]
        print(json.dumps({
            "rate": rate, "due": len(due),
            "done": sum(r.finished is not None and r.finished <= w1
                        for r in due),
            "waiting_at_close": sum(r.admitted is None or r.admitted > w1
                                    for r in due),
            "ttft_p50_ms": float(np.percentile(ans, 50)) if ans else None,
            "ttft_p95_ms": float(np.percentile(ans, 95)) if ans else None,
            "ttft_first_quarter_ms": float(np.mean(first)) if first else None,
            "ttft_last_quarter_ms": float(np.mean(last))}), flush=True)
        s.release()
        del out, s
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
