"""Multi-pod dry run: build and count every (arch × shape × mesh) cell
(port of ``repro/launch/dryrun.py``).

For each cell this driver, inside a fake world of the mesh's chips
(:func:`repro_torch.launch.mesh.fake_world`: no device, nothing
allocated):

  1. builds abstract inputs (fake tensors, :mod:`repro_torch.launch.specs`);
  2. distributes the model (and the Adam moments for train, the cache for
     prefill and decode, and the batch) over the production mesh
     ((16,16) single-pod / (2,16,16) multi-pod) by the sharding rules —
     a sharded dim that does not divide its axes fails the cell, as JAX's
     ``.compile()`` fails it;
  3. records ``peak_mem_bytes``: the per-chip bytes of those local
     shapes. Activations are not included (the port has no
     ``memory_analysis()``);
  4. runs the step once under :func:`repro_torch.launch.cost.count` on one
     device and writes the roofline record (:mod:`repro_torch.launch.roofline`):
     per-chip FLOPs and bytes are that count over the chips
     (``"partition": "ideal"``: the port has no SPMD partitioner), and the
     sharded step's collective bytes are not counted.

:func:`run_cell` also takes ``mesh=make_host_mesh()``: the cards that
exist (one H100: a 1×1 mesh), where the counts are exact.

Usage:
    python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
from typing import Dict

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.launch import cost
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.roofline import analyze
from repro_torch.launch.specs import DryrunOptions, build_lowering
from repro_torch.sharding.rules import (batch_spec, distribute,
                                        tree_cache_specs, tree_param_specs)

NOTES = {"partition": "ideal",
         "collectives": "not counted: the port has no SPMD partitioner to "
                        "place the sharded step's collectives",
         "peak_mem": "per-chip bytes of the distributed parameters, Adam "
                     "moments, cache and batch; activations not included"}


def _local_bytes(name: str, t: torch.Tensor, spec, mesh) -> int:
    local = distribute(name, t, spec, mesh).to_local()
    return local.numel() * local.element_size()


def resident_bytes(kind: str, args, mesh, cfg,
                   global_batch: int) -> Dict[str, int]:
    """Per-chip bytes of a cell's inputs distributed by the rules, by
    part: ``params`` (the model), ``opt_state`` (train: the Adam moments
    and step counts), ``cache`` and ``batch`` (or the decode token).
    Raises where a sharded dim does not divide its axes."""
    out = {"params": 0, "opt_state": 0, "cache": 0, "batch": 0}
    if kind == "train":
        state, rest = args
        model, cache = state.params, []
        for name, spec in tree_param_specs(model, mesh).items():
            for moments in (state.opt.mu, state.opt.nu):
                out["opt_state"] += _local_bytes(name, moments[name], spec,
                                                 mesh)
        out["opt_state"] += (state.opt.step.element_size()
                             + state.step.element_size())
    else:
        model, rest, cache = args
    for name, spec in tree_param_specs(model, mesh).items():
        out["params"] += _local_bytes(name, model.get_buffer(name), spec, mesh)
    for layer, specs in zip(cache, tree_cache_specs(cache, mesh,
                                                    global_batch, cfg)):
        for key, spec in specs.items():
            out["cache"] += _local_bytes(key, layer[key], spec, mesh)
    tensors = rest.items() if isinstance(rest, dict) else [("token", rest)]
    for key, t in tensors:
        out["batch"] += _local_bytes(key, t, batch_spec(mesh, global_batch,
                                                        t.ndim - 1), mesh)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opts: DryrunOptions, out_dir: str, verbose: bool = True,
             mesh=None):
    """One cell: its record dict (``status`` ok / skip / fail). ``mesh``:
    count over this mesh of real ranks instead of the production mesh in
    a fake world."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if mesh is not None:
        mesh_name = "host" + "x".join(str(n) for n in mesh.shape)
    else:
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{arch}__{shape_name}__{mesh_name}"
    if not ok:
        if verbose:
            print(f"[dryrun] SKIP {tag}: {why}")
        return {"cell": tag, "status": "skip", "reason": why}

    chips = math.prod(mesh.shape) if mesh is not None else \
        (512 if multi_pod else 256)
    world = contextlib.nullcontext() if mesh is not None else fake_world(chips)
    t0 = time.perf_counter()
    try:
        with world:
            if mesh is None:
                mesh = make_production_mesh(multi_pod=multi_pod,
                                            device_type="cpu")
            fn, args = build_lowering(cfg, shape, mesh, opts)
            mem = resident_bytes(shape.kind, args, mesh, cfg,
                                 shape.global_batch)
            t1 = time.perf_counter()
            counted = cost.count(fn, *args)
            t2 = time.perf_counter()
    except Exception as e:
        traceback.print_exc()
        rec = {"cell": tag, "status": "fail",
               "error": f"{type(e).__name__}: {e}"}
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
        return rec

    r = analyze(counted, cfg, shape, mesh_name, chips, arch,
                peak_mem_bytes=float(sum(mem.values())))
    if verbose:
        print(f"[dryrun] {tag}: build + distribute {t1 - t0:.1f}s "
              f"count {t2 - t1:.1f}s")
        print(f"  per-chip resident bytes: {r.peak_mem_bytes / 2 ** 30:.3f} "
              f"GiB (" + ", ".join(f"{k} {v / 2 ** 30:.3f}"
                                   for k, v in mem.items() if v)
              + "; activations not included)")
        print(f"  count (one device): flops {counted['flops']:.4e} bytes "
              f"{counted['bytes']:.4e}")
        print("  by kernel: " + ", ".join(
            f"{k} ×{v['calls']}" for k, v in counted["by_kernel"].items()))
        print(f"  roofline: compute {r.t_compute * 1e3:.2f} ms | "
              f"memory {r.t_memory * 1e3:.2f} ms | "
              f"collective {r.t_collective * 1e3:.2f} ms "
              f"→ {r.bottleneck}-bound; useful-FLOPs "
              f"{100 * r.useful_flops_frac:.1f}%, roofline frac "
              f"{100 * r.roofline_frac:.1f}%")
    rec = r.to_dict()
    rec.update(NOTES, resident_bytes=mem, by_kernel=counted["by_kernel"])
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    rec.update(cell=tag, status="ok", build_s=t1 - t0, count_s=t2 - t1)
    return rec


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None, help="architecture id (or --all)")
    p.add_argument("--shape", default=None,
                   help="shape name (default: all applicable)")
    p.add_argument("--mesh", default="single",
                   choices=["single", "multi", "both"])
    p.add_argument("--all", action="store_true", help="every arch")
    p.add_argument("--out", default="experiments/dryrun")
    p.add_argument("--remat", default="none", choices=["none", "full"])
    p.add_argument("--microbatch", type=int, default=0)
    p.add_argument("--kv", default="int8",
                   choices=["int8", "bf16", "int4"])
    p.add_argument("--rank", type=int, default=64)
    # JAX's flags, parsed and unread: the port's steps update in place
    # and K4 has its own tiles
    p.add_argument("--no-donate", action="store_true")
    p.add_argument("--qchunk", type=int, default=512)
    p.add_argument("--kvchunk", type=int, default=1024)
    args = p.parse_args(argv)

    opts = DryrunOptions(remat=args.remat, microbatch=args.microbatch,
                         kv_dtype=args.kv, rank=args.rank)
    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    results = []
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                results.append(run_cell(arch, shape, multi, opts, args.out))
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skip")
    n_fail = sum(1 for r in results if r["status"] == "fail")
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip, {n_fail} FAIL")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
