"""The readings a cell's limits are set from: the port's and the control's,
several seeds in one process, each judged by the cell's limits.

    python3 -m perfbench.control --workload <cell> --seeds 11,12,13 \\
        --seconds <s> [--out perfbench/out/control.jsonl]

For each seed: one run of the cell as ``perfbench.run`` makes it (set-up,
the window, the port's state freed), then, on the sample the check
judges, the port's numbers and the control's: the reference put in the
port's place and computed in bfloat16, one precision below the float32
the configuration states. A serving cell's control reports, at each
position of the same prompts and served tokens, the log-probabilities
of the tokens it puts first, and these are read against the f32
reference's as the port's are; the pass cell's control is the bf16
pass, its containers read against the f32 pass's. Each side's numbers go
through ``checks.verdict`` with ``limits/<cell>.json``: the record's
``port_correct`` and ``control_correct``. The benchmark's own runs never
run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def pass_readings(session, done):
    """The pass cell's (port, control) numbers: the port's containers and
    the bf16 pass's, each against the f32 pass."""
    import torch
    from perfbench import checks

    port, _ = checks.judge_pass(session, done)
    want = checks.pass_reference(session, done)
    low = checks.pass_reference(session, done, torch.bfloat16)
    return port, checks.pass_numbers(low, want)


def serving_readings(session, done, seed: int):
    """The serving cell's (port, control) numbers on the sample the check
    draws: the control's first tokens and their log-probabilities, from
    the bf16 reference, read against the f32 reference's."""
    import torch
    from perfbench import checks, registry

    cfg, sc = session.bench.config, session.sc
    pick = checks.sample_requests(done, session.bench.traffic["check"]
                                  ["requests"], seed)
    ref = registry.reference(cfg)
    seqs = [(r.prompt, r.served) for r in pick]
    chunk = sc.prefill_len or sc.max_len
    k = checks.reported(pick[0])[0].shape[1]
    low = ref.score(session.raw, cfg, seqs, chunk=chunk, dtype=torch.bfloat16,
                    topk=k)
    full = ref.score(session.raw, cfg, seqs, chunk=chunk,
                     ids=[x["top_ids"] for x in low])
    port, _ = checks.judge(session, pick)
    return port, checks.logprob_errors([x["at_ids"] for x in full],
                                       [x["top_lsm"] for x in low])


def readings(session, done, seed: int, limits):
    """One record: each side's numbers and its verdict under ``limits``."""
    from perfbench import checks
    from perfbench.serving import Session

    port, ctrl = (serving_readings(session, done, seed)
                  if isinstance(session, Session)
                  else pass_readings(session, done))
    out = {f"port_{key}": v for key, v in port.items()}
    out.update({f"control_{key}": v for key, v in ctrl.items()})
    out["port_correct"] = checks.verdict(port, limits)[0]
    out["control_correct"] = checks.verdict(ctrl, limits)[0]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from perfbench import registry

    if not torch.cuda.is_available():
        print("perfbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    bj = registry.load_benchmark(ROOT)
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        bench = registry.resolve(args.workload, seed, args.seconds, False,
                                 device, bj)
        outcome = registry.generator(bench.traffic).run(bench)
        s = outcome.session
        s.release()
        rec = {"workload": args.workload, "seed": seed,
               **readings(s, outcome.done, seed, bench.limits),
               "seconds": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
        del outcome, s
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
