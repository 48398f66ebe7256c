"""Which finished requests the reference judges, what it reads on them,
and the verdict on each number against the cell's limits
(``limits/<cell>.json``: ``{name: {"max": x}}``; the file names the
numbers compared, the rest are read beside them).

Every request of a serving cell asks for the log-probabilities of its
tokens (the traffic file's ``logprobs``: its own token's and the top
few), so the served tokens and the numbers the timed path reported for
them are judged against the plain reference run over each prompt with
its served tokens. At each position, the error is the largest gap
between a log-probability the port reported and the reference's for the
same token:

``logprob_err_max``: the largest over every judged position.
``logprob_err_p99``: its 99th percentile over the positions.
``first_logprob_err_max``: the largest over each request's first token,
the one its admission prefill produced.

The serving cells' limits compare the last two. The first is read
beside them: on a few seeds a single decoded position of random weights
reads some 8 in the port and in the bf16 reference alike, while every
other position reads 1e-5 (PERF.md), so it swings by its nature; the
first tokens, which the 99th percentile could leave out, are held at
their largest.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def sample_requests(done: List, n: int, seed: int) -> List:
    """The longest finished request (most served tokens) and ``n - 1``
    others drawn from the seed."""
    if not done:
        raise RuntimeError("no request finished in the window: nothing for "
                           "the reference to judge")
    order = sorted(done, key=lambda r: (-len(r.served), r.uid))
    rest = order[1:]
    rng = np.random.default_rng([seed, 3])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [order[0]] + [rest[i] for i in sorted(pick)]


def reported(r) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids (n, k) int64, log-probabilities (n, k) f32) the engine
    reported for request ``r``'s n tokens."""
    return (torch.tensor([ids for ids, _ in r.lp], dtype=torch.int64),
            torch.tensor([lps for _, lps in r.lp], dtype=torch.float32))


def logprob_errors(a: List[torch.Tensor], b: List[torch.Tensor]
                   ) -> Dict[str, float]:
    """The serving numbers of one side's log-probabilities ``b`` against
    the reference's ``a`` (one (n, k) tensor a request each)."""
    rows = [(x.float().cpu() - y.float().cpu()).abs().amax(-1)
            for x, y in zip(a, b)]
    err = torch.cat(rows)
    return {"logprob_err_max": float(err.max()),
            "logprob_err_p99": float(np.percentile(err.numpy(), 99)),
            "first_logprob_err_max": float(max(r[0] for r in rows))}


def judge(session, pick: List) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(the serving numbers, ``served_tokens``: how many positions were
    judged) for the sampled requests."""
    from perfbench import registry
    cfg, sc = session.bench.config, session.sc
    rep = [reported(r) for r in pick]
    readings = registry.reference(cfg).score(
        session.raw, cfg, [(r.prompt, r.served) for r in pick],
        chunk=sc.prefill_len or sc.max_len, ids=[ids for ids, _ in rep])
    return (logprob_errors([x["at_ids"] for x in readings],
                           [lps for _, lps in rep]),
            {"served_tokens": float(sum(len(r.served) for r in pick))})


def verdict(readings: Dict[str, float], limits: Optional[Dict]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {"value", "limit"}}) over the numbers the limits
    name; no limits, or a limit whose number the run did not read, is
    not correct."""
    out: Dict[str, Dict[str, float]] = {}
    ok = bool(limits)
    for name, lim in (limits or {}).items():
        value = readings.get(name)
        out[name] = {"value": value, "limit": lim["max"]}
        ok = ok and value is not None and value <= lim["max"]
    return ok, out


def pass_numbers(got: List[Dict], want: List[Dict]) -> Dict[str, float]:
    """``code_mismatch_pct`` (the largest share of a matrix's codes that
    differ), ``lr_rel_err`` (the largest ‖LR − L'R'‖ / ‖L'R'‖) and
    ``k_mismatch`` (matrices whose k* differs), of ``got`` against
    ``want``."""
    codes, lr, k = 0.0, 0.0, 0
    for g, w in zip(got, want):
        codes = max(codes, 100.0 * float((g["codes"] != w["codes"]).float()
                                         .mean()))
        ref = w["l"] @ w["r"]
        lr = max(lr, float(torch.linalg.norm(g["l"] @ g["r"] - ref)
                           / torch.linalg.norm(ref)))
        k += int(g["k"] != w["k"])
    return {"code_mismatch_pct": codes, "lr_rel_err": lr,
            "k_mismatch": float(k)}


def pass_reference(session, done: List, dtype=torch.float32) -> List[Dict]:
    """The plain reference's pass of each sampled matrix, from the raw
    weights and moments and the matrix's own generator seed."""
    from perfbench.generators.srr_pass import GROUPS
    from perfbench.reference import srr
    q, dev = session.bench.config["quant"], session.bench.device
    out = []
    for d in done:
        mom = session.moments[d.block][GROUPS[d.name]]
        s, s_inv = srr.scaling(mom[2], session.count)
        gen = torch.Generator(device=dev).manual_seed(
            int(session.bench.seed) * 1_000_003 + d.index)
        out.append(srr.srr(session.blocks[d.block][d.name], s, s_inv,
                           q["rank"], q["bits"], q["block"], gen, dtype))
    return out


def judge_pass(session, done: List) -> Tuple[Dict[str, float],
                                             Dict[str, float]]:
    """The pass cell's numbers: the port's containers against the plain
    reference's (``code_mismatch_pct``, ``lr_rel_err``, ``k_mismatch``;
    ``matrices``: how many were judged)."""
    got = [dict(k=d.k, codes=d.codes, l=d.l, r=d.r) for d in done]
    return (pass_numbers(got, pass_reference(session, done)),
            {"matrices": float(len(done))})
