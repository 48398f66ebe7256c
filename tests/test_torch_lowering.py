"""Port parity: the lowering tools (``repro_torch.configs`` shapes,
``launch.specs``, ``launch.cost``, ``launch.roofline``, ``launch.dryrun``)
against the JAX package's on the CPU.

  * ``SHAPES`` / ``shape_applicable`` and ``model_flops_for`` equal JAX's
    exactly, for every architecture and shape;
  * the abstract model (fake tensors) and its abstract quantized container
    have the shapes and dtypes of JAX's ``eval_shape(init_lm)`` /
    ``quantized_abstract`` leaf for leaf (a stacked leaf with its group
    axis dropped);
  * ``cost.count``: a loop of T matmuls counts T× one; one K1, K2 and K7
    call counts its formula and nothing else; a decode step, a prefill, a
    paged decode step and a prefill chunk count the same FLOPs, bytes and
    kernel calls at ``fused="auto"`` and ``"off"``, abstract for four
    families (GQA with the paged cache and chunks, MLA over the MoE, the
    hybrid's ring, the encoder-decoder's cross memory) and with real weights for phi3;
  * each kernel function's formula against ``torch.utils.flop_counter``
    of the ops its route runs (the hook passing the call through): K1,
    K2, K3 (and its latent instance), K5, K6 and non-causal K4 exactly,
    at ``fused="auto"`` (the kernels' plain versions here) and ``"off"``
    (less the MXINT-padded rows the ``"off"`` route skips);
  * a whole step's count against JAX's ``hlo_cost`` of the same reduced
    lowering: the dot FLOPs exactly, once every (query, key) pair is
    counted as JAX's blockwise attention computes them; the total within
    JAX's elementwise FLOPs (below);
  * the dry-run CLI's smallest cell, as JAX's ``test_dryrun_cli_smallest_cell``.

Counts are exact: no tolerance, except JAX's total against the port's,
where JAX also counts one FLOP an element of every elementwise op and
reduction and ``flop_counter`` counts none: 3–15 % of a step at these
widths, held to ``ELEMENTWISE_TOL``.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import shape_applicable as jshape_applicable
from repro.launch.roofline import model_flops_for as jmodel_flops_for
from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.core.api import PTQConfig
from repro_torch.launch import cost
from repro_torch.launch.roofline import model_flops_for
from repro_torch.launch.specs import (DryrunOptions, abstract_cache,
                                      abstract_mode, abstract_params,
                                      build_lowering, quantized_abstract)
from repro_torch.models import Ctx, decode_step, init_lm
from repro_torch.models.linear import QLinear, linear
from repro_torch.models.quantize import quantize_model_params
from repro_torch.models.transformer import init_cache, prefill, prefill_chunk
from repro_torch.quant import QuantizerConfig
from repro_torch.quant.mxint import MXIntQuantizer
from repro_torch.sharding.rules import reference_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTE_ARCHS = ["phi3-mini-3.8b", "deepseek-v2-lite-16b", "recurrentgemma-9b",
               "whisper-large-v3"]


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Many small ops: two intra-op threads, as in
    ``tests/test_torch_train.py``; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_shapes_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for arch in ARCHS:
        for name in SHAPES:
            assert shape_applicable(get_config(arch), SHAPES[name]) == \
                jshape_applicable(jget_config(arch), JSHAPES[name])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_for_matches_jax(arch):
    for name in SHAPES:
        assert model_flops_for(get_config(arch), SHAPES[name]) == \
            jmodel_flops_for(jget_config(arch), JSHAPES[name]), name


@pytest.mark.parametrize("container", ["fp", "quant"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_params_match_jax(arch, container):
    import jax
    import jax.numpy as jnp
    from repro.models import init_lm as jinit_lm
    from repro.models.quantize import quantized_abstract as jquantized

    jcfg = jget_config(arch).reduced()
    jtree = jax.eval_shape(lambda k: jinit_lm(k, jcfg, dtype=jnp.bfloat16),
                           jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    mode = abstract_mode()
    model = abstract_params(cfg, mode=mode)
    if container == "quant":
        jtree = jquantized(jtree, rank=64)
        model = quantized_abstract(model, 64, mode=mode)
    want = {tuple(e.key if hasattr(e, "key") else e.idx for e in path): x
            for path, x in jax.tree_util.tree_leaves_with_path(jtree)}
    seen = set()
    for name, t in model.named_buffers():
        assert cost.fake_mode_of(t) is mode, name
        path, stacked = reference_path(cfg, name)
        x = want[path]
        assert tuple(t.shape) == tuple(x.shape[1:] if stacked else x.shape), \
            name
        assert str(t.dtype) == f"torch.{x.dtype}", name
        seen.add(path)
    assert seen == set(want)


# ---------------------------------------------------------------------------
# cost.count
# ---------------------------------------------------------------------------
def test_count_scales_with_a_loop_of_matmuls():
    a, b = torch.randn(16, 32), torch.randn(32, 8)

    def loop(t):
        for _ in range(t):
            a @ b

    one, five = cost.count(loop, 1), cost.count(loop, 5)
    assert one["flops"] == 2 * 16 * 32 * 8
    assert five["flops"] == 5 * one["flops"]
    assert one["bytes"] == 4 * (16 * 32 + 32 * 8 + 16 * 8)
    assert five["bytes"] == 5 * one["bytes"]
    assert one["by_kernel"] == {} and one["collective_bytes"] == 0


def _qlinear(k, n, rank, packed=False, seed=0):
    from repro_torch.quant.mxint import pack_codes_4bit
    gen = torch.Generator().manual_seed(seed)
    qz = MXIntQuantizer(bits=3).quantize(torch.randn(k, n, generator=gen))
    codes = pack_codes_4bit(qz.codes) if packed else qz.codes
    store = {"packed": codes} if packed else {"codes": codes}
    return QLinear(torch.exp2(qz.exponents.float()),
                   torch.randn(k, rank, generator=gen),
                   torch.randn(rank, n, generator=gen),
                   gscale=torch.ones(rank), **store)


@pytest.mark.parametrize("rows,packed", [(8, False), (8, True), (256, False)])
@pytest.mark.parametrize("fused", ["auto", "off"])
def test_count_one_qlr_call_is_its_formula(rows, packed, fused):
    k, n, rank = 96, 64, 8
    p = _qlinear(k, n, rank, packed)
    x = torch.randn(rows, k)
    got = cost.count(linear, Ctx(fused=fused), p, x)
    want = cost.qlr_work(rows, k, n, rank, packed=packed)
    assert want.name == ("K1 qlr_fused_matmul" if rows <= 128
                         else "K2 qlr_xl_matmul")
    assert got["by_kernel"] == {want.name: {"calls": 1, "flops": want.flops,
                                            "bytes": want.bytes}}
    assert (got["flops"], got["bytes"]) == (want.flops, want.bytes)


def test_count_one_quantize_call_is_its_formula():
    w = torch.randn(64, 48)
    got = cost.count(MXIntQuantizer(bits=3).quantize, w)
    want = cost.mxint_quantize_work(64, 48)
    assert got["by_kernel"] == {want.name: {"calls": 1, "flops": want.flops,
                                            "bytes": want.bytes}}
    # the padding copy before the kernel is an aten op of its own
    assert got["flops"] == want.flops and got["bytes"] > want.bytes


def test_attention_pairs():
    brute = lambda sq, sk, causal, window, start: sum(  # noqa: E731
        1 for i in range(sq) for j in range(sk if not causal else start + i + 1)
        if not causal or not window or start + i - j < window)
    for sq, sk, causal, window, start in [(7, 7, True, 0, 0), (7, 7, True, 3, 0),
                                          (5, 9, False, 0, 0),
                                          (4, 12, True, 0, 5),
                                          (6, 20, True, 4, 9),
                                          (6, 20, True, 20, 9)]:
        assert cost.attention_pairs(sq, sk, causal=causal, window=window,
                                    start=start) == \
            brute(sq, sk, causal, window, start)


def _step_counts(cfg, model, kind, fused, count=cost.count):
    """``count`` of one step of ``kind`` through ``model``: a decode step
    (slot or ``paged`` cache), a prefill chunk, a prefill of 2 × 12
    tokens (K1), or ``prefill_long``, 2 × 80 tokens (K2)."""
    ctx = Ctx(fused=fused)
    mode = cost.fake_mode_of(model)
    rows = 80 if kind == "prefill_long" else 12
    with mode if mode is not None else torch.no_grad():
        if kind == "paged":
            cache = init_cache(cfg, 2, 32, torch.int8, "cpu", pages=8,
                               page_size=8)
        elif kind in ("decode", "chunk"):
            cache = init_cache(cfg, 2, 32, torch.int8, "cpu")
        else:
            cache = init_cache(cfg, 2, rows + 4, torch.bfloat16, "cpu")
        tok = torch.zeros((2, 1), dtype=torch.int64)
        toks = torch.ones((2, rows), dtype=torch.int64)
        chunk = torch.ones((1, 8), dtype=torch.int64)
    if kind in ("decode", "paged"):
        return count(decode_step, ctx, model, tok, cache)
    if kind == "chunk":
        return count(prefill_chunk, ctx, model, chunk, cache, 1, 6, 8)
    return count(prefill, ctx, model, toks, cache)


def _kinds(cfg):
    paged = cfg.attn_kind == "gqa" and set(cfg.block_pattern) == {"attn"} \
        and not cfg.is_encoder_decoder
    return ["decode", "prefill"] + (["paged", "chunk"] if paged else [])


@pytest.mark.parametrize("arch", ROUTE_ARCHS)
def test_count_is_the_same_by_either_route(arch):
    """Abstract (fake) quantized model: each step kind counts the same at
    ``fused="auto"`` (the wrappers, plain versions here) and ``"off"``."""
    cfg = get_config(arch).reduced()
    mode = abstract_mode()
    model = quantized_abstract(abstract_params(cfg, torch.float32, mode),
                               16, mode=mode)
    for kind in _kinds(cfg):
        auto, off = (_step_counts(cfg, model, kind, f) for f in ("auto", "off"))
        assert auto["by_kernel"], kind
        assert auto == off, kind


def test_count_is_the_same_by_either_route_real_weights():
    """Reduced phi3 quantized by SRR (identity scaling): the decode step
    and the prefill count the same by either route, and K1/K3 (K2/K4)
    once a projection (layer)."""
    cfg = get_config("phi3-mini-3.8b").reduced()
    ptq = PTQConfig(method="srr", scaling="identity",
                    quantizer=QuantizerConfig(kind="mxint", bits=3,
                                              block_size=32), rank=8, seed=0)
    model, _ = quantize_model_params(init_lm(cfg, 0, device="cpu"), ptq,
                                     container="int8", device="cpu")
    counts = {kind: [_step_counts(cfg, model, kind, f) for f in ("auto", "off")]
              for kind in ("decode", "prefill")}
    for kind, (auto, off) in counts.items():
        assert auto == off, kind
    layers, proj = cfg.n_layers, 7 * cfg.n_layers
    assert {k: v["calls"] for k, v in counts["decode"][0]["by_kernel"].items()} \
        == {"K1 qlr_fused_matmul": proj, "K3 flash_decode": layers}
    assert {k: v["calls"] for k, v in counts["prefill"][0]["by_kernel"].items()} \
        == {"K1 qlr_fused_matmul": proj, "K4 flash_attention": layers}


class _FlopsInside:
    """A ``kernels.work`` recorder: each kernel function's formula FLOPs
    beside ``FlopCounterMode``'s FLOPs of the ops its route runs, and the
    FLOPs of the MXINT-padded rows of a Q + LR call's weight (zero rows
    the kernel and its plain version multiply, and ``fused="off"``'s
    dequantized weight leaves out), read from the call's own arguments."""

    def __init__(self, counter):
        self.counter = counter
        self.by_kernel = {}
        self.inside = 0

    def kernel(self, w, fn, args, kw):
        if self.inside:
            return fn(*args, **kw)
        before = self.counter.get_total_flops()
        self.inside += 1
        try:
            out = fn(*args, **kw)
        finally:
            self.inside -= 1
        key = w.name
        if w.name == "K4 flash_attention" and kw.get("causal", True):
            key += " causal"
        rec = self.by_kernel.setdefault(key, dict(formula=0, ops=0, pad=0))
        rec["formula"] += w.flops
        rec["ops"] += self.counter.get_total_flops() - before
        if w.name.startswith(("K1", "K2", "K6")):
            p, x = args[1], args[2]
            rows = p.packed.shape[-2] * 2 if p.packed is not None \
                else p.codes.shape[-2]
            m = x.numel() // x.shape[-1]
            rec["pad"] += 2 * m * (rows - x.shape[-1]) * (p.scale.shape[-1]
                                                          + p.r.shape[-2])
        return out


def _flops_inside(cfg, model, kind, fused):
    """``_FlopsInside``'s table for one step of ``kind``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import work
    with cost.fake_mode_of(model), torch.no_grad(), \
            FlopCounterMode(display=False) as counter:
        rec = _FlopsInside(counter)
        work.RECORDER = rec
        try:
            _step_counts(cfg, model, kind, fused, count=lambda fn, *a: fn(*a))
        finally:
            work.RECORDER = None
    return rec.by_kernel


FLOPS_INSIDE = [("phi3-mini-3.8b", k) for k in ("decode", "prefill",
                                                "prefill_long", "paged",
                                                "chunk")] + \
    [(a, k) for a in ("deepseek-moe-16b", "deepseek-v2-lite-16b",
                      "whisper-large-v3", "recurrentgemma-9b")
     for k in ("decode", "prefill", "prefill_long")]


@pytest.mark.parametrize("fused", ["auto", "off"])
@pytest.mark.parametrize("arch,kind", FLOPS_INSIDE)
def test_each_kernel_formula_is_the_flops_its_route_runs(arch, kind, fused):
    """Abstract quantized models: every K1/K2/K3/K5/K6 call's formula
    equals ``flop_counter``'s FLOPs of the ops that compute it — the
    kernels' plain versions at ``"auto"``, the model's own ops at
    ``"off"`` (there less the padded rows, which it skips) — and so does
    every non-causal K4 call's; a causal K4 counts only the pairs it
    attends, below the masked rectangle its plain version computes."""
    cfg = get_config(arch).reduced()
    mode = abstract_mode()
    model = quantized_abstract(abstract_params(cfg, torch.float32, mode),
                               16, mode=mode)
    table = _flops_inside(cfg, model, kind, fused)
    assert table, kind
    for name, rec in table.items():
        pad = rec["pad"] if fused == "off" else 0
        if name == "K4 flash_attention causal":
            assert 0 < rec["formula"] < rec["ops"], (name, rec)
        else:
            assert rec["formula"] == rec["ops"] + pad, (name, rec)


# JAX's hlo_cost counts one FLOP an element of every elementwise op and
# reduction; flop_counter counts matmuls and attention only. At the
# reduced widths below that is 3–15 % of a step (measured 1.03–1.15×).
ELEMENTWISE_TOL = 0.2

# every step kind of phi3; the decode step of the MoE (K6), of MLA (the
# latent K3) and of the encoder-decoder (K3 over the cross memory)
HLO_CELLS = [("phi3-mini-3.8b", "decode_32k"), ("phi3-mini-3.8b", "prefill_32k"),
             ("phi3-mini-3.8b", "train_4k"),
             ("deepseek-moe-16b", "decode_32k"),
             ("deepseek-v2-lite-16b", "decode_32k"),
             ("whisper-large-v3", "decode_32k")]


@pytest.mark.parametrize("arch,name", HLO_CELLS)
def test_step_count_matches_jax_hlo_cost(arch, name, monkeypatch):
    """The same reduced cell lowered by JAX (``repro.launch.specs`` on a
    1×1 mesh, compiled, ``hlo_cost``) and built by the port: JAX's dot
    FLOPs equal the port's count exactly once every (query, key) pair is
    counted (JAX's blockwise attention computes the masked ones too); its
    total lies within ``ELEMENTWISE_TOL`` above the port's own count.
    (Left out: MLA's prefill and training, where JAX zero-pads V to the
    query's width, and xlstm, whose recurrences the two write
    differently.)"""
    from repro.configs import get_config as jcfg
    from repro.launch import hlo_cost
    from repro.launch.mesh import make_mesh
    from repro.launch.specs import DryrunOptions as JDryrunOptions
    from repro.launch.specs import build_lowering as jbuild_lowering
    from repro_torch.kernels import work

    class DotFlops(hlo_cost.HloCost):
        """hlo_cost's walk with the FLOPs of dots alone."""

        def op_cost(self, op, comp):
            c = super().op_cost(op, comp)
            if op.opcode not in ("dot", "while", "fusion", "call",
                                 "custom-call", "conditional"):
                c.flops = 0.0
            return c

    small = dict(seq_len=64, global_batch=4)
    mesh = make_mesh((1, 1), ("data", "model"))
    with mesh:
        text = jbuild_lowering(jcfg(arch).reduced(), dataclasses.replace(
            JSHAPES[name], **small), mesh, JDryrunOptions()).compile().as_text()
    jax_total = hlo_cost.analyze_text(text)["flops"]
    jax_dots = DotFlops(text).total().flops

    cfg = get_config(arch).reduced()
    shape = dataclasses.replace(SHAPES[name], **small)
    own = cost.count(*_built(cfg, shape))["flops"]
    assert own <= jax_total <= (1 + ELEMENTWISE_TOL) * own, (own, jax_total)
    monkeypatch.setattr(work, "attention_pairs",
                        lambda sq, sk, **kw: sq * sk)
    assert cost.count(*_built(cfg, shape))["flops"] == jax_dots


def _built(cfg, shape):
    fn, args = build_lowering(cfg, shape, None, DryrunOptions())
    return (fn, *args)


def test_builders_count_each_step_kind():
    """Every step kind of the reduced phi3 cell at a small shape: the
    builders' step runs under ``count`` on fake inputs, and its kernel
    functions are JAX's lowering's."""
    cfg = get_config("phi3-mini-3.8b").reduced()
    calls = {}
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = dataclasses.replace(SHAPES[name], seq_len=32, global_batch=4)
        fn, args = build_lowering(cfg, shape, None, DryrunOptions())
        got = cost.count(fn, *args)
        assert got["flops"] > model_flops_for(cfg, shape) * 0.5, name
        calls[name] = {k: v["calls"] for k, v in got["by_kernel"].items()}
    assert calls == {"train_4k": {"K4 flash_attention": 2},
                     "prefill_32k": {"K1 qlr_fused_matmul": 14,
                                     "K4 flash_attention": 2},
                     "decode_32k": {"K1 qlr_fused_matmul": 14,
                                    "K3 flash_decode": 2}}
    cache = abstract_cache(cfg, SHAPES["decode_32k"],
                           DryrunOptions(kv_dtype="int4"))
    assert cache[0]["k"].dtype == torch.uint8
    assert tuple(cache[0]["k"].shape) == (128, 4, 32_768 // 2, 16)


def test_dryrun_cli_smallest_cell():
    """The dry-run driver end-to-end on the cheapest (arch × shape)."""
    with tempfile.TemporaryDirectory() as out:
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "xlstm-125m", "--shape", "decode_32k", "--mesh", "single",
             "--out", out],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="2"),
            cwd=REPO)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "1 ok, 0 skip, 0 FAIL" in r.stdout
        import json
        with open(os.path.join(
                out, "xlstm-125m__decode_32k__pod16x16.json")) as fh:
            rec = json.load(fh)
    assert rec["partition"] == "ideal" and rec["chips"] == 256
    assert rec["by_kernel"]["K1 qlr_fused_matmul"]["calls"] == 66
    assert rec["flops"] > 0 and rec["peak_mem_bytes"] > 0
