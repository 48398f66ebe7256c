"""Quickstart: SRR on a single weight matrix (port of
``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cpu]

Walks the paper's Algorithm 1 end to end on one matrix: calibration →
scaling S → rank split k* → preserve / quantize / reconstruct → compare
against the plain-QER baseline under the same rank budget. W, the
calibration rows and the rank probe are drawn on the CPU from fixed
seeds and moved to the device, so the card and the CPU see the same
inputs.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from repro_torch.core import (make_scaling, qer_decompose, scaled_error,
                              select_rank, srr_decompose)
from repro_torch.device import resolve_device
from repro_torch.quant import MXIntQuantizer

M, N, RANK, CALIB_ROWS = 512, 512, 64, 2048
PROBE_SEED = 7


def planted(m: int, n: int, gen: torch.Generator) -> torch.Tensor:
    """A weight with dominant low-rank structure (what transformers
    have): a rank-8 product scaled to 6/√(mn) plus 0.02 noise, drawn
    where ``gen`` lives."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)
    return randn(m, 8) @ randn(8, n) * (6.0 / (m * n) ** 0.5) \
        + randn(m, n) * 0.02


def probe_gen() -> torch.Generator:
    """The probe's generator: on the CPU, so every device draws the same
    probe (``sample_probe`` moves it)."""
    return torch.Generator().manual_seed(PROBE_SEED)


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    # --- a weight and calibration activations, drawn on the CPU --------
    gen = torch.Generator().manual_seed(0)
    w = planted(M, N, gen).to(dev)
    x = torch.randn((CALIB_ROWS, M), generator=gen).to(dev)

    # --- calibration activations → activation-aware scaling S ----------
    scaling = make_scaling("qera-exact", x)

    # --- the quantizer (paper's main setting: 3-bit MXINT, block 32) ----
    quantizer = MXIntQuantizer(bits=3, block_size=32)

    # --- rank selection (Eq. 5): how much budget to preserve ------------
    sel = select_rank(w, RANK, probe_gen(), exact=True, scaling=scaling)
    print(f"rank budget r={RANK}, selected split k*={sel.k_star} "
          f"(preserve {sel.k_star}, reconstruct {RANK - sel.k_star})")

    # --- full SRR vs the QER baseline under the same budget -------------
    qer = qer_decompose(w, quantizer, RANK, exact=True, scaling=scaling)
    srr = srr_decompose(w, quantizer, RANK, probe_gen(), exact=True,
                        scaling=scaling).decomposition

    e_qer = float(scaled_error(w, qer, scaling))
    e_srr = float(scaled_error(w, srr, scaling))
    print(f"scaled reconstruction error  QER: {e_qer:.4f}")
    print(f"scaled reconstruction error  SRR: {e_srr:.4f} "
          f"({100 * (1 - e_srr / e_qer):.1f}% lower)")

    # --- the deployed form: y = x·Q + (x·L)·R ---------------------------
    y_full = x[:4] @ w
    y_srr = x[:4] @ srr.q + (x[:4] @ srr.l) @ srr.r
    rel = float(torch.linalg.norm(y_full - y_srr) / torch.linalg.norm(y_full))
    print(f"output-space relative error of the served Q+LR: {rel:.4f}")
    return {"rank": RANK, "k_star": sel.k_star, "srr_k": srr.k,
            "scaled_err_qer": e_qer, "scaled_err_srr": e_srr,
            "output_rel_err": rel}


if __name__ == "__main__":
    main()
