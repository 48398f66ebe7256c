"""Training CLI: ``python -m repro_torch.launch.train --arch <id> [...]``
(port of ``repro.launch.train``, its flags and defaults).

Runs on the card by default (``--device cuda``, which raises without
one; ``--device cpu`` on request), in bf16 there and f32 on the CPU.
The default is the family's ``.reduced()`` config; ``--full-size``
trains the published one.

Modes:
  full   — ordinary LM training (AdamW, cosine schedule) of every weight
  qpeft  — the paper's §4.4 flow: calibrate (2 batches) → SRR-quantize
           (qera-exact, rank ``--rank``, ``--bits``-bit MXINT in blocks of
           32, through K7 on the card) → freeze the backbone → train the
           rank-r adapters with γ-scaled gradients. ``--gamma`` is parsed
           and not read, as in the JAX CLI: every preserved rank takes
           the pass's γ = 0.1.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable, List, Optional

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import LayerReport, PTQConfig
from repro_torch.data import (DataConfig, batches, capture_calibration,
                              data_config_for)
from repro_torch.device import resolve_device
from repro_torch.models import init_lm, lm_loss
from repro_torch.models.quantize import quantize_model_params, split_qpeft
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.quant import QuantizerConfig
from repro_torch.train import (CheckpointManager, StepConfig, Trainer,
                               init_qpeft_state, init_train_state,
                               make_qpeft_step, make_train_step)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="phi3-mini-3.8b", choices=sorted(ARCHS))
    p.add_argument("--mode", default="full", choices=["full", "qpeft"])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--rank", type=int, default=16)
    p.add_argument("--bits", type=int, default=3)
    p.add_argument("--gamma", type=float, default=0.1,
                   help="parsed and not read, as in the JAX CLI")
    p.add_argument("--microbatch", type=int, default=0)
    p.add_argument("--remat", default="none", choices=["none", "full"])
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--full-size", action="store_true",
                   help="train the published config instead of .reduced()")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


@dataclasses.dataclass
class Run:
    """What :func:`build` sets up: the step and its state, ready for a
    :class:`~repro_torch.train.Trainer` (or a caller's own loop)."""

    cfg: ModelConfig
    dcfg: DataConfig
    device: torch.device
    opt: AdamW
    sc: StepConfig
    state: Any
    step: Callable
    reports: List[LayerReport]


def build(args: argparse.Namespace,
          log: Callable[[str], None] = print) -> Run:
    """Config → init → (qpeft: calibrate → SRR pass → split) → state and
    step, as ``repro.launch.train`` builds them."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = cfg.reduced()
    log(f"[train] arch={args.arch} mode={args.mode} device={dev.type} "
        f"params≈{cfg.n_params() / 1e6:.1f}M")
    dcfg = data_config_for(cfg, seq_len=args.seq, global_batch=args.batch,
                           seed=args.seed)
    opt = AdamW(learning_rate=cosine_schedule(args.lr, 10, args.steps),
                weight_decay=0.01)
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    sc = StepConfig(remat=args.remat, microbatch=args.microbatch,
                    compute_dtype=dtype)
    model = init_lm(cfg, args.seed, device=dev)
    reports: List[LayerReport] = []
    if args.mode == "qpeft":
        log("[train] calibrating + quantizing (SRR)…")
        stats = capture_calibration(model, dcfg, lm_loss, n_batches=2,
                                    device=dev)
        ptq = PTQConfig(method="srr", scaling="qera-exact",
                        quantizer=QuantizerConfig(kind="mxint",
                                                  bits=args.bits,
                                                  block_size=32),
                        rank=args.rank, seed=args.seed)
        model, reports = quantize_model_params(model, ptq, stats=stats,
                                               device=dev)
        mean_k = sum(r.k_star for r in reports) / max(len(reports), 1)
        log(f"[train] quantized {len(reports)} matrices, "
            f"mean k*={mean_k:.1f}")
        trainable, frozen = split_qpeft(model)
        state = init_qpeft_state(trainable, frozen, opt)
        step = make_qpeft_step(cfg, opt, sc)
    else:
        state = init_train_state(model, opt)
        step = make_train_step(cfg, opt, sc)
    return Run(cfg, dcfg, dev, opt, sc, state, step, reports)


def main(argv: Optional[List[str]] = None) -> int:
    args = parser().parse_args(argv)
    run = build(args)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    trainer = Trainer(run.step,
                      lambda s: batches(run.dcfg, s, device=run.device),
                      ckpt=ckpt, ckpt_every=args.ckpt_every, log_every=10,
                      meta={"arch": args.arch, "mode": args.mode})
    _, history = trainer.run(run.state, args.steps)
    if history:
        print(f"[train] final loss {history[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
