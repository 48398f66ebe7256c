"""End to end: pretrain a small LM with checkpoint/restart, then
QPEFT-adapt its SRR-quantized form (port of ``examples/train_e2e.py``).

    python -m repro_torch.examples.train_e2e [--steps 300] [--small]
        [--device cpu]

Phase A — pretraining: a 12-layer, d=256 transformer at the phi3
vocabulary (``--small`` takes phi3's ``.reduced()`` config instead) on
the deterministic synthetic corpus, with the production trainer: AdamW
+ cosine, checkpoint-every-N, and an intentional "preemption" at 60 % of
the run that the resume path recovers from.

Phase B — the paper: calibrate, SRR-quantize (W ≈ Q + LR, through K7 on
the card), fine-tune the adapters only with γ-scaled gradients, and
compare with the QER init. The steps run at ``fused="off"``, as JAX's
do; the eval losses go through the kernels.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import shutil
import tempfile
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import PTQConfig
from repro_torch.data import (DataConfig, batches, capture_calibration,
                              data_config_for, host_batch)
from repro_torch.device import resolve_device
from repro_torch.models import Ctx, init_lm, lm_loss
from repro_torch.models.quantize import (merge_qpeft, quantize_model_params,
                                         set_qpeft_scaling, split_qpeft)
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.quant import QuantizerConfig
from repro_torch.train import (CheckpointManager, StepConfig, Trainer,
                               init_qpeft_state, init_train_state,
                               make_qpeft_step, make_train_step)

QPEFT_STEPS = 60


def model_config(small: bool) -> ModelConfig:
    base = get_config("phi3-mini-3.8b").reduced()
    if small:
        return base
    return dataclasses.replace(base, n_layers=12, d_model=256, n_heads=8,
                               n_kv_heads=8, head_dim=32, d_ff=1024,
                               vocab=32064)


def pretraining(cfg: ModelConfig, steps: int, dev
                ) -> tuple[DataConfig, AdamW, object]:
    """Phase A's data, optimizer and step."""
    dcfg = data_config_for(cfg, seq_len=128, global_batch=8)
    opt = AdamW(learning_rate=cosine_schedule(1e-3, 30, steps),
                weight_decay=0.01)
    step = make_train_step(cfg, opt, StepConfig(compute_dtype=torch.float32,
                                                remat="none"))
    return dcfg, opt, step


def eval_loss(model, batch) -> float:
    with torch.no_grad():
        return float(lm_loss(Ctx(), model, batch))


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--small", action="store_true",
                   help="tiny model for a fast demo")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model_config(args.small)
    print(f"[phase A] pretraining {cfg.n_params() / 1e6:.0f}M params for "
          f"{args.steps} steps")
    dcfg, opt, step = pretraining(cfg, args.steps, dev)
    state = init_train_state(init_lm(cfg, 0, device=dev), opt)

    lines: List[str] = []

    def log(line: str) -> None:
        lines.append(line)
        print(line)

    ckpt_dir = tempfile.mkdtemp(prefix="srr_e2e_")
    mgr = CheckpointManager(ckpt_dir, keep=2)
    trainer = Trainer(step, lambda s: batches(dcfg, s, device=dev), ckpt=mgr,
                      ckpt_every=50, log_every=25, log_fn=log)

    # simulate a preemption at 60% of the run, then resume
    mid = max(args.steps * 3 // 5, 1)
    state, hist_a = trainer.run(state, mid)
    saved = mgr.latest_step()
    print(f"[phase A] -- simulated preemption at step {mid}; relaunching --")
    fresh = init_train_state(init_lm(cfg, 0, device=dev), opt)
    state, hist_b = trainer.run(fresh, args.steps)  # resumes from checkpoint
    resumed = [int(ln.rsplit(" ", 1)[1]) for ln in lines
               if ln.startswith("[trainer] resumed from step ")]
    params = state.params
    losses = [h["loss"] for h in hist_a + hist_b]
    print(f"[phase A] done, final loss {losses[-1]:.4f}")

    print("[phase B] calibrate → SRR quantize → QPEFT")
    stats = capture_calibration(params, dcfg, lm_loss, n_batches=2,
                                device=dev)
    qz = QuantizerConfig("mxint", 3, 32)
    dcfg_ft = dataclasses.replace(dcfg, seed=1)  # a shifted "task"
    eval_b = host_batch(dcfg_ft, 9_999, device=dev)

    rows = []
    for method, label, scale_mode in (("qer", "QERA-exact init", "none"),
                                      ("srr", "SRR init + γ=0.1", "gamma")):
        qp, _ = quantize_model_params(
            copy.deepcopy(params),
            PTQConfig(method=method, scaling="qera-exact", rank=16,
                      quantizer=qz),
            stats=dict(stats), device=dev)
        qp = set_qpeft_scaling(qp, mode=scale_mode, gamma=0.1)
        trainable, frozen = split_qpeft(qp)
        opt_ft = AdamW(learning_rate=cosine_schedule(1e-3, 5, QPEFT_STEPS))
        st = init_qpeft_state(trainable, frozen, opt_ft)
        qstep = make_qpeft_step(cfg, opt_ft,
                                StepConfig(compute_dtype=torch.float32))
        l0 = eval_loss(merge_qpeft(st.trainable, st.frozen), eval_b)
        step_losses = []
        for s in range(QPEFT_STEPS):
            st, m = qstep(st, host_batch(dcfg_ft, s, device=dev))
            step_losses.append(m["loss"])
        l1 = eval_loss(merge_qpeft(st.trainable, st.frozen), eval_b)
        rows.append(dict(method=method, label=label, eval_before=l0,
                         eval_after=l1,
                         step_losses=[float(v) for v in step_losses]))
        print(f"   {label:20s}: eval loss {l0:.4f} → {l1:.4f}")
        del qp, trainable, frozen, st

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    better = rows[1]["eval_after"] <= rows[0]["eval_after"]
    print(f"[phase B] SRR init {'≤' if better else '>'} QER init after QPEFT")
    return {"n_params": cfg.n_params(), "steps": args.steps,
            "preempted_at": mid, "checkpoint_step": saved,
            "resumed_from": resumed, "losses": losses,
            "final_loss": losses[-1], "qpeft": rows,
            "srr_le_qer": better, "model": params}


if __name__ == "__main__":
    main()
