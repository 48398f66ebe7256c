"""Port parity: training and QPEFT (``repro_torch.optim``, ``core.qpeft``,
the QPEFT half of ``models.quantize``, ``train`` and ``launch.train``)
against the JAX package on the CPU.

Inputs and weights are made from numpy seeds: the weights in the JAX
init's tree and shapes (``jinit``), converted to the port; the QPEFT
container is the port's SRR pass over them, written back into JAX's tree
(``jax_container``), so both packages start from one container. Batches
are the synthetic stream, the same tokens on both sides. Both packages
compute in f32 in these tests.

Tolerances (f32):
  * AdamW: 1e-7 absolute (parameters of unit scale, so a few ulp); the
    optimiser's arithmetic is JAX's, written out; the schedules: 5e-7
    relative (four f32 ulp: the cosine comes from another library);
  * ``gscale`` vectors: 2.5e-7 absolute (two ulp of 1: SGP's 1 − λ);
  * global norm, clipping, gradient scaling and ``core.qpeft``: 1e-6
    relative (sums over leaves in another order);
  * training steps: losses 1e-5 relative, gradients 1e-4 of their largest
    magnitude (the same model summed in another order). After 3 steps the
    trained tensors differ by at most ``PARAM_TOL`` = 3e-3 · lr of the
    update's own scale, element for element, except where an element's
    gradient sits near Adam's ``eps``: there ``(m/c1)/(sqrt(v/c2)+eps)``
    swings between 0 and ±1 with ulp changes of ``m`` and ``v``, so such
    an element may differ by up to about ``lr``. Where the element-wise
    bound fails only on such elements, the norm of the difference is
    bounded instead, at ``NORM_TOL`` = 1e-2 of the norm of the update
    (the trained tensor minus the initial one);
  * the port against itself: kill-and-resume bit for bit; ``remat``
    bit for bit; ``microbatch=2`` against 0 at the loss and gradient
    tolerances above.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.qer import Decomposition as JDecomposition
from repro.core.qpeft import adapter_matmul as jadapter_matmul
from repro.core.qpeft import fixed_gamma_scale as jfixed_gamma_scale
from repro.core.qpeft import init_adapter as jinit_adapter
from repro.core.qpeft import scale_adapter_grads as jscale_adapter_grads
from repro.core.qpeft import sgp_scale as jsgp_scale
from repro.core.qpeft import tree_scale_grads as jtree_scale_grads
from repro.data import data_config_for as jdata_config_for
from repro.data import host_batch as jhost_batch
from repro.models import Ctx as JCtx
from repro.models import init_lm as jinit_lm
from repro.models import lm_loss as jlm_loss
from repro.models.quantize import merge_qpeft as jmerge_qpeft
from repro.models.quantize import qpeft_grad_scales as jqpeft_grad_scales
from repro.models.quantize import set_qpeft_scaling as jset_qpeft_scaling
from repro.models.quantize import split_qpeft as jsplit_qpeft
from repro.optim import AdamW as JAdamW
from repro.optim import apply_updates as japply_updates
from repro.optim import clip_by_global_norm as jclip
from repro.optim import constant_schedule as jconstant_schedule
from repro.optim import cosine_schedule as jcosine_schedule
from repro.optim import global_norm as jglobal_norm
from repro.optim import scale_lr_grads_by_key as jscale_lr_grads_by_key
from repro.optim import srr_grad_transform as jsrr_grad_transform
from repro.optim.adamw import _decay_mask as jdecay_mask
from repro.train import StepConfig as JStepConfig
from repro.train import init_qpeft_state as jinit_qpeft_state
from repro.train import init_train_state as jinit_train_state
from repro.train import make_qpeft_step as jmake_qpeft_step
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import (_merge_adapters, convert_params,
                                 convert_qpeft_state, convert_train_state)
from repro_torch.core.api import PTQConfig
from repro_torch.core.qer import Decomposition
from repro_torch.core.qpeft import (AdapterParams, adapter_matmul,
                                    fixed_gamma_scale, init_adapter,
                                    scale_adapter_grads, sgp_scale,
                                    tree_scale_grads)
from repro_torch.data import batches, data_config_for, host_batch
from repro_torch.kernels.decode_attention import decode_attention_op
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mxint_matmul import qlr_matmul, qlr_matmul_batched
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Ctx, forward, init_lm, linear, lm_loss
from repro_torch.models.linear import QLinear
from repro_torch.models.quantize import (merge_qpeft, qlinears,
                                         qpeft_grad_scales,
                                         quantize_model_params,
                                         set_qpeft_scaling, split_qpeft)
from repro_torch.models.transformer import (AUX_WEIGHT, layer_layout,
                                            reference_lead)
from repro_torch.optim.tree import tree_leaves_with_path
from repro_torch.optim import (AdamW, apply_updates, clip_by_global_norm,
                               constant_schedule, cosine_schedule,
                               decay_mask, global_norm, scale_lr_grads_by_key,
                               srr_grad_transform)
from repro_torch.train import (CheckpointManager, StepConfig, Trainer,
                               TrainState, init_qpeft_state, init_train_state,
                               make_qpeft_step, make_train_step,
                               trainable_params)
from repro_torch.train.steps import _grads_of

ARCH = "phi3-mini-3.8b"
ADAM_TOL = 1e-7
SCHED_TOL = 5e-7
GSCALE_TOL = 2.5e-7
REL_TOL = 1e-6
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 3e-3
NORM_TOL = 1e-2
LR = 3e-3
SEQ, BATCH = 16, 4
# the port's own containers for port-only tests: SRR's split is not what
# they test, so QER with exact SVDs (the quickest pass on the CPU)
QUICK_PTQ = PTQConfig(method="qer", scaling="identity", rank=4,
                      exact_svd=True)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """These tests run many small ops (training steps, optimiser updates
    leaf by leaf); two intra-op threads take as long as eight in a
    process of its own and far less beside the other test workers. The
    process's setting is restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def jt(a):
    return jnp.asarray(np.asarray(a, dtype=np.float32))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


# ---------------------------------------------------------------------------
# fixtures: reduced phi3 in both packages, its JAX SRR container, the steps
# ---------------------------------------------------------------------------
def jinit(jcfg, seed=0):
    """Seeded numpy weights in the JAX init's tree and shapes (unit norms,
    zero shifts, the embedding at 0.02, a projection at 1/√fan-in), as
    JAX arrays: compiling JAX's own init costs 2–4 s a config on the
    CPU."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jinit_lm(k, jcfg),
                            jax.random.PRNGKey(0))

    def fill(path, sd):
        names = [str(getattr(k, "key", "")) for k in path]
        if names[-1] in ("g", "b"):
            return jnp.full(sd.shape, names[-1] == "g", jnp.float32)
        std = 0.02 if names[0] == "embed" else sd.shape[-2] ** -0.5
        return jnp.asarray((rng.standard_normal(sd.shape) * std)
                           .astype(np.float32))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def phi3():
    jcfg = jget_config(ARCH).reduced()
    return jcfg, get_config(ARCH).reduced(), jinit(jcfg)


def jax_container(qmodel, jparams, cfg):
    """The JAX parameter tree of a quantized port model converted from
    ``jparams``: each projection of ``jparams``' layers replaced by the
    port's ``QLinear`` buffers (stacked over a scanned group), everything
    else kept."""
    def layer(jblock, i, path=()):
        if isinstance(jblock, dict) and "w" in jblock:
            m = qmodel.get_submodule(".".join(("blocks", str(i)) + path))
            if isinstance(m, QLinear):
                return {k: jnp.asarray(v.numpy())
                        for k, v in m.named_buffers()}
            return jblock
        if isinstance(jblock, dict):
            return {k: layer(v, i, path + (k,)) for k, v in jblock.items()}
        return jblock

    n_prefix, n_groups, _ = layer_layout(cfg)
    period = len(cfg.block_pattern)
    out = dict(jparams)
    out["prefix"] = [layer(b, i) for i, b in enumerate(jparams["prefix"])]
    out["groups"] = {f"p{pos}": jax.tree_util.tree_map(
        lambda *a: jnp.stack(a), *(layer(jax.tree_util.tree_map(
            lambda a: a[g], jparams["groups"][f"p{pos}"]),
            n_prefix + g * period + pos) for g in range(n_groups)))
        for pos in range(period)}
    base = n_prefix + n_groups * period
    out["suffix"] = [layer(b, base + i)
                     for i, b in enumerate(jparams["suffix"])]
    return out


@pytest.fixture(scope="module")
def jax_qparams(phi3):
    """An SRR container in JAX's tree (rank 8, 3-bit MXINT in blocks of
    32), made by the port's pass under the identity scaling with exact
    SVDs from the converted JAX init (JAX's own pass takes about 20 s on
    the CPU; the parity below starts from whatever container both
    packages hold)."""
    jcfg, cfg, params = phi3
    model, _ = quantize_model_params(
        convert_params(np_tree(params), cfg, device="cpu"),
        PTQConfig(method="srr", scaling="identity", rank=8, exact_svd=True),
        device="cpu")
    return jax_container(model, params, cfg)


JCTX = JCtx(compute_dtype=jnp.float32, fused="off")


@pytest.fixture(scope="module")
def jopt():
    return JAdamW(learning_rate=jcosine_schedule(LR, 2, 10),
                  weight_decay=0.01)


@pytest.fixture(scope="module")
def opt():
    return AdamW(learning_rate=cosine_schedule(LR, 2, 10), weight_decay=0.01)


@pytest.fixture(scope="module")
def jsteps(phi3, jopt):
    """JAX's jitted steps, f32. The full and QPEFT ones return
    ``((state, metrics), grads)``, the gradients of the state they start
    from computed in the same program (one compile for both)."""
    jcfg = phi3[0]
    sc = JStepConfig(compute_dtype=jnp.float32)
    full = jmake_train_step(jcfg, jopt, sc)
    qpeft = jmake_qpeft_step(jcfg, jopt, sc)

    def full_and_grads(state, b):
        return full(state, b), jax.grad(
            lambda p: jlm_loss(JCTX, p, b, jcfg))(state.params)

    def qpeft_and_grads(state, b):
        return qpeft(state, b), jax.grad(lambda tr: jlm_loss(
            JCTX, jmerge_qpeft(tr, state.frozen), b, jcfg))(state.trainable)

    return {"full": jax.jit(full_and_grads),
            "qpeft": jax.jit(qpeft_and_grads),
            "qpeft2": jax.jit(jmake_qpeft_step(
                jcfg, jopt, dataclasses.replace(sc, microbatch=2)))}


def batches_of(cfg, n, start=0):
    dcfg = data_config_for(cfg, seq_len=SEQ, global_batch=BATCH, seed=0)
    return [host_batch(dcfg, start + i, device="cpu") for i in range(n)]


def jbatches_of(jcfg, n, start=0):
    dcfg = jdata_config_for(jcfg, seq_len=SEQ, global_batch=BATCH, seed=0)
    return [jhost_batch(dcfg, start + i) for i in range(n)]


def port_adapters(tree, frozen_np, cfg):
    """A JAX tree shaped like the trainable adapters (grads, moments) read
    into the port's ``{path: {"l", "r"}}`` by the converter's walk."""
    return split_qpeft(convert_params(_merge_adapters(np_tree(tree),
                                                      frozen_np), cfg,
                                      device="cpu"))[0]


def flat_adapters(tr):
    return {f"{p}.{k}": v for p, d in tr.items() for k, v in d.items()}


def assert_trained_close(got, want, init, what):
    """The stated bound on trained tensors: element-wise within
    ``PARAM_TOL`` · lr-scale of the update, else (only where some
    element's gradient sits near eps) the difference's norm within
    ``NORM_TOL`` of the update's."""
    got, want, init = (np.asarray(a, np.float64) for a in (got, want, init))
    diff = np.abs(got - want)
    if diff.max() <= PARAM_TOL * LR:
        return
    upd = np.linalg.norm(want - init)
    assert np.linalg.norm(got - want) <= NORM_TOL * upd, \
        f"{what}: max |Δ| {diff.max():.3e}, ‖Δ‖ {np.linalg.norm(got - want):.3e}" \
        f" vs update norm {upd:.3e}"


# ---------------------------------------------------------------------------
# optim: AdamW, the decay mask, the schedules, the transforms
# ---------------------------------------------------------------------------
def _tree(rng):
    return {"w": rng.standard_normal((8, 6)), "b": rng.standard_normal(6),
            "g": rng.standard_normal(6), "s": rng.standard_normal(3),
            "blk": {"m": rng.standard_normal((2, 3, 4)),
                    "l": rng.standard_normal((5, 2))}}


@pytest.mark.parametrize("lr,wd", [("cosine", 0.01), ("cosine", 0.0),
                                   ("constant", 0.01), ("float", 0.1)])
def test_adamw_matches_jax(lr, wd):
    rng = np.random.default_rng(1)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    sched = {"cosine": (cosine_schedule(0.05, 2, 10),
                        jcosine_schedule(0.05, 2, 10)),
             "constant": (constant_schedule(0.02), jconstant_schedule(0.02)),
             "float": (0.02, 0.02)}[lr]
    popt = AdamW(learning_rate=sched[0], weight_decay=wd)
    jo = JAdamW(learning_rate=sched[1], weight_decay=wd)
    pp = jax.tree_util.tree_map(t, params)
    jp = jax.tree_util.tree_map(jt, params)
    ps, js = popt.init(pp), jo.init(jp)
    for g in grads:
        upd, ps = popt.update(jax.tree_util.tree_map(t, g), ps, pp)
        pp = apply_updates(pp, upd)
        jupd, js = jo.update(jax.tree_util.tree_map(jt, g), js, jp)
        jp = japply_updates(jp, jupd)
    assert int(ps.step) == int(js.step) == 3
    for name, a, b in [("params", pp, jp), ("mu", ps.mu, js.mu),
                       ("nu", ps.nu, js.nu)]:
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                       atol=ADAM_TOL, err_msg=name)


def test_adamw_reads_lr_at_the_new_step():
    """Step 1 of ``cosine_schedule(peak, 10, T)`` runs at peak/10, not 0."""
    p = {"w": torch.ones((2, 2))}
    o = AdamW(learning_rate=cosine_schedule(1.0, 10, 100))
    upd, st = o.update({"w": torch.ones((2, 2))}, o.init(p), p)
    # first step: m̂ = g, v̂ = g², so u ≈ 1 (up to f32 rounding of the bias
    # corrections) and the update is about -lr
    np.testing.assert_allclose(upd["w"].numpy(), -0.1, rtol=1e-4)
    assert int(st.step) == 1


@pytest.mark.parametrize("arch", [ARCH, "recurrentgemma-9b",
                                  "deepseek-moe-16b", "whisper-large-v3",
                                  "xlstm-125m"])
def test_decay_mask_matches_jax(arch):
    """JAX's ``_decay_mask`` leaf for leaf on the port's unstacked layers:
    the prefix/suffix layers' 1-D leaves are not decayed, a scanned
    layer's are (they carry the stacked axis), ``g``/``b`` never."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    if arch == "recurrentgemma-9b":
        # one scanned (rglru, rglru, local) group and a suffix of two
        # unstacked rglru layers
        jcfg, cfg = (dataclasses.replace(c, n_layers=5) for c in (jcfg, cfg))
    shapes = jax.eval_shape(lambda k: jinit_lm(k, jcfg),
                            jax.random.PRNGKey(0))
    mask = jdecay_mask(shapes, ("g", "b"))
    expanded = jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, m, np.float32), mask, shapes)
    want = trainable_params(convert_params(expanded, cfg, device="cpu"))
    got = decay_mask(want, lead=lambda n: reference_lead(cfg, n))
    assert got.keys() == want.keys()
    for name, m in got.items():
        assert np.all(want[name].numpy() == m), name
    if arch == "recurrentgemma-9b":
        # conv_b / lam: 1-D in the port, decayed only inside a scanned group
        seen = {got[n] for n in got if n.endswith((".conv_b", ".lam"))}
        assert seen == {0.0, 1.0}


@pytest.mark.parametrize("kind", ["cosine", "cosine_floor", "constant"])
def test_schedules_match_jax(kind):
    total = 12
    port, ref = {
        "cosine": (cosine_schedule(3e-3, 4, total),
                   jcosine_schedule(3e-3, 4, total)),
        "cosine_floor": (cosine_schedule(1e-2, 3, total, floor=1e-4),
                         jcosine_schedule(1e-2, 3, total, floor=1e-4)),
        "constant": (constant_schedule(5e-4), jconstant_schedule(5e-4))}[kind]
    for s in range(total + 3):
        got = float(port(torch.tensor(s, dtype=torch.int32)))
        want = float(ref(jnp.asarray(s, jnp.int32)))
        assert abs(got - want) <= SCHED_TOL * abs(want), (s, got, want)


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_global_norm_and_clip_match_jax(max_norm):
    tree = _tree(np.random.default_rng(2))
    gn = global_norm(jax.tree_util.tree_map(t, tree))
    jgn = jglobal_norm(jax.tree_util.tree_map(jt, tree))
    assert rel_err(gn, jgn) <= REL_TOL
    clipped, norm = clip_by_global_norm(jax.tree_util.tree_map(t, tree),
                                        max_norm)
    jclipped, jnorm = jclip(jax.tree_util.tree_map(jt, tree), max_norm)
    assert rel_err(norm, jnorm) <= REL_TOL
    for a, b in zip(jax.tree_util.tree_leaves(clipped),
                    jax.tree_util.tree_leaves(jclipped)):
        assert rel_err(a, b) <= REL_TOL
    if max_norm < float(jnorm):
        assert abs(float(global_norm(clipped)) - max_norm) <= 1e-5 * max_norm


def test_scale_lr_grads_by_key_matches_jax():
    """Dense and expert-stacked adapters, an adapter with no scale, a list
    and a leaf that is no adapter."""
    rng = np.random.default_rng(3)
    grads = {"a": {"l": rng.standard_normal((6, 4)),
                   "r": rng.standard_normal((4, 5))},
             "experts": {"up": {"l": rng.standard_normal((3, 6, 4)),
                                "r": rng.standard_normal((3, 4, 5))}},
             "blocks": [{"wq": {"l": rng.standard_normal((6, 4)),
                                "r": rng.standard_normal((4, 6))}},
                        {"wq": {"l": rng.standard_normal((6, 4)),
                                "r": rng.standard_normal((4, 6))}}],
             "other": rng.standard_normal(3)}
    scales = {"a": {"gscale": np.array([0.1, 0.1, 1.0, 1.0])},
              "experts": {"up": {"gscale": rng.uniform(0, 1, (3, 4))}},
              "blocks": [{"wq": {"gscale": rng.uniform(0, 1, 4)}},
                         {"wq": {}}]}
    got = scale_lr_grads_by_key(jax.tree_util.tree_map(t, grads),
                                jax.tree_util.tree_map(t, scales))
    want = jscale_lr_grads_by_key(jax.tree_util.tree_map(jt, grads),
                                  jax.tree_util.tree_map(jt, scales))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert rel_err(a, b) <= REL_TOL
    np.testing.assert_array_equal(got["blocks"][1]["wq"]["l"].numpy(),
                                  np.float32(grads["blocks"][1]["wq"]["l"]))


# ---------------------------------------------------------------------------
# core/qpeft.py
# ---------------------------------------------------------------------------
def _decs(k=3, m=12, n=10, rank=6):
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal((m, n)), rng.standard_normal((m, rank)),
            rng.standard_normal((rank, n)) * np.linspace(3, 0.5, rank)[:, None]]
    return (Decomposition(*(t(a) for a in arrs), k),
            JDecomposition(*(jt(a) for a in arrs), k))


@pytest.mark.parametrize("k", [0, 3, 6])
def test_qpeft_scales_match_jax(k):
    dec, jdec = _decs(k)
    np.testing.assert_array_equal(fixed_gamma_scale(6, k, 0.25).numpy(),
                                  np.asarray(jfixed_gamma_scale(6, k, 0.25)))
    assert rel_err(sgp_scale(dec, 5.0), jsgp_scale(jdec, 5.0)) <= REL_TOL
    for mode in ("gamma", "sgp", "none"):
        (pa, st), (jpa, jst) = init_adapter(dec, mode, 0.2, 3.0), \
            jinit_adapter(jdec, mode, 0.2, 3.0)
        assert st.k == jst.k == k
        assert rel_err(st.grad_scale, jst.grad_scale) <= REL_TOL
        np.testing.assert_array_equal(pa.l.numpy(), np.asarray(jpa.l))
    with pytest.raises(ValueError):
        init_adapter(dec, "bogus")


def test_adapter_matmul_and_grad_scaling_match_jax():
    """The forward, Q getting no gradient, the per-rank scaling, and the
    tree and transform forms of it."""
    dec, jdec = _decs()
    (pa, st), (jpa, jst) = init_adapter(dec, "sgp"), jinit_adapter(jdec, "sgp")
    x = np.random.default_rng(5).standard_normal((4, 12))
    q = st.q.clone().requires_grad_()
    l, r = pa.l.clone().requires_grad_(), pa.r.clone().requires_grad_()
    y = adapter_matmul(t(x), AdapterParams(l, r), st._replace(q=q))
    assert rel_err(y.detach(), jadapter_matmul(jt(x), jpa, jst)) <= REL_TOL
    (y ** 2).sum().backward()
    assert q.grad is None
    jg = jax.grad(lambda p: jnp.sum(jadapter_matmul(jt(x), p, jst) ** 2))(jpa)
    assert rel_err(l.grad, jg.l) <= REL_TOL and rel_err(r.grad, jg.r) <= REL_TOL
    g = AdapterParams(l.grad, r.grad)
    want = jscale_adapter_grads(jg, jst)
    for got in (scale_adapter_grads(g, st),
                tree_scale_grads({"a": [g]}, {"a": [st]})["a"][0],
                srr_grad_transform({"a": st, "b": None})(
                    {"a": g, "b": t(np.ones(2))})["a"]):
        assert rel_err(got.l, want.l) <= REL_TOL
        assert rel_err(got.r, want.r) <= REL_TOL
    jtree = jtree_scale_grads({"a": [jg]}, {"a": [jst]})["a"][0]
    jtr = jsrr_grad_transform({"a": jst})({"a": jg})["a"]
    assert rel_err(jtree.l, want.l) == 0 and rel_err(jtr.r, want.r) == 0


# ---------------------------------------------------------------------------
# the QPEFT half of models/quantize.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["gamma", "sgp", "none"])
def test_set_qpeft_scaling_matches_jax(phi3, jax_qparams, mode):
    cfg = phi3[1]
    want = port_gscales(convert_params(
        np_tree(jset_qpeft_scaling(jax_qparams, mode, 0.3, 4.0)), cfg,
        device="cpu"))
    model = set_qpeft_scaling(convert_params(np_tree(jax_qparams), cfg,
                                             device="cpu"), mode, 0.3, 4.0)
    got = port_gscales(model)
    assert got.keys() == want.keys()
    for path in got:
        assert float((got[path] - want[path]).abs().max()) <= GSCALE_TOL, \
            path
    with pytest.raises(ValueError):
        set_qpeft_scaling(model, "bogus")


def port_gscales(model):
    return {p: m.gscale for p, m in qlinears(model)}


def test_set_qpeft_scaling_expert_stack_matches_jax():
    """Vectorised over a leading expert axis, each entry with its own k."""
    rng = np.random.default_rng(6)
    e, m, n, r = 3, 64, 8, 4
    gs = np.where(np.arange(r)[None, :] < np.array([[0], [2], [4]]), 0.1,
                  1.0).astype(np.float32)
    node = {"codes": rng.integers(-3, 4, (e, m, n)).astype(np.int8),
            "scale": np.ones((e, m // 32, n), np.float32),
            "l": rng.standard_normal((e, m, r)).astype(np.float32),
            "r": rng.standard_normal((e, r, n)).astype(np.float32),
            "gscale": gs}
    stack = torch.nn.ModuleDict({"up": QLinear(
        t(node["scale"]), t(node["l"]), t(node["r"]),
        codes=torch.from_numpy(node["codes"]), gscale=t(gs))})
    for mode in ("sgp", "gamma"):
        want = jset_qpeft_scaling({"up": jax.tree_util.tree_map(
            jnp.asarray, node)}, mode, 0.2, 5.0)["up"]["gscale"]
        got = set_qpeft_scaling(stack, mode, 0.2, 5.0).up.gscale
        assert got.shape == (e, r)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= GSCALE_TOL
        stack.up.gscale = t(gs)


def test_split_merge_roundtrip(phi3, jax_qparams):
    """split → trainable (the model's own l/r) and frozen; merge binds a
    new adapter set in and the layout the engine and converter see stays;
    as many adapters as JAX's split has."""
    cfg = phi3[1]
    model = convert_params(np_tree(jax_qparams), cfg, device="cpu")
    before = {k: v.clone() for k, v in model.named_buffers()}
    trainable, frozen = split_qpeft(model)
    jtrain, _ = jsplit_qpeft(jax_qparams)
    assert sum(v.numel() for v in flat_adapters(trainable).values()) == \
        sum(a.size for a in jax.tree_util.tree_leaves(jtrain))
    assert frozen is model
    assert all(d["l"] is frozen.get_submodule(p).l
               for p, d in trainable.items())
    new = {p: {k: v + 1.0 for k, v in d.items()} for p, d in trainable.items()}
    merged = merge_qpeft(new, frozen)
    assert merged is model
    after = dict(merged.named_buffers())
    assert list(after) == list(before)
    for k, v in after.items():
        if k.endswith((".l", ".r")):
            np.testing.assert_array_equal(v.numpy(), before[k].numpy() + 1.0)
        else:
            assert torch.equal(v, before[k]), k
    merge_qpeft(trainable, frozen)
    assert all(torch.equal(v, before[k]) for k, v in model.named_buffers())
    scales = qpeft_grad_scales(trainable, frozen)
    assert scales.keys() == trainable.keys()
    with pytest.raises(TypeError):
        merge_qpeft({"final_norm": {"l": None, "r": None}}, frozen)


# ---------------------------------------------------------------------------
# the training steps against JAX
# ---------------------------------------------------------------------------
def test_train_step_matches_jax(phi3, jopt, opt, jsteps):
    """3 full steps from one converted state: the first step's gradients,
    each step's loss and grad norm, then the parameters."""
    jcfg, cfg, params = phi3
    jstate = jinit_train_state(params, jopt)
    state = convert_train_state(np_tree(jstate), cfg, device="cpu")
    leaves = trainable_params(state.params)
    init = {k: v.clone() for k, v in leaves.items()}
    step = make_train_step(cfg, opt, StepConfig(compute_dtype=torch.float32))
    for i, (b, jb) in enumerate(zip(batches_of(cfg, 3), jbatches_of(jcfg, 3))):
        (jstate, jm), jg = jsteps["full"](jstate, jb)
        if i == 0:
            _, grads = _grads_of(lambda bb: lm_loss(Ctx(fused="off"),
                                                    state.params, bb),
                                 leaves, b, 0)
            want = trainable_params(convert_params(np_tree(jg), cfg,
                                                   device="cpu"))
            for name, g in grads.items():
                assert rel_err(g, want[name]) <= GRAD_TOL, name
        state, m = step(state, b)
        assert rel_err(m["loss"], jm["loss"]) <= LOSS_TOL
        assert rel_err(m["grad_norm"], jm["grad_norm"]) <= GRAD_TOL
        assert int(m["step"]) == int(jm["step"])
    assert not any(p.requires_grad for p in leaves.values())
    want = trainable_params(convert_params(np_tree(jstate.params), cfg,
                                           device="cpu"))
    for name, p in trainable_params(state.params).items():
        assert_trained_close(p, want[name], init[name], name)
    assert int(state.opt.step) == 3 == int(state.step)


def test_train_step_follows_jax_through_the_peak_lr(phi3, jopt, opt, jsteps):
    """10 full steps from one converted state, through the schedule's
    peak of JAX's default lr 3e-3 (step 2) and its decay to 0 (step 10):
    the port's loss is JAX's at every step, and the parameters after.
    The port's full step at that lr is JAX's, so a loss that climbs at
    3e-3 climbs in both packages."""
    jcfg, cfg, params = phi3
    jstate = jinit_train_state(params, jopt)
    state = convert_train_state(np_tree(jstate), cfg, device="cpu")
    init = {k: v.clone() for k, v in trainable_params(state.params).items()}
    step = make_train_step(cfg, opt, StepConfig(compute_dtype=torch.float32))
    for b, jb in zip(batches_of(cfg, 10), jbatches_of(jcfg, 10)):
        (jstate, jm), _ = jsteps["full"](jstate, jb)
        state, m = step(state, b)
        assert rel_err(m["loss"], jm["loss"]) <= LOSS_TOL, int(m["step"])
    want = trainable_params(convert_params(np_tree(jstate.params), cfg,
                                           device="cpu"))
    for name, p in trainable_params(state.params).items():
        assert_trained_close(p, want[name], init[name], name)


def jax_qpeft_state(jax_qparams, jopt):
    trainable, frozen = jsplit_qpeft(jax_qparams)
    return jinit_qpeft_state(trainable, frozen, jopt)


def frozen_snapshot(model):
    return {k: v.clone() for k, v in model.named_buffers()
            if not k.endswith((".l", ".r"))}


def test_qpeft_step_matches_jax(phi3, jax_qparams, jopt, opt, jsteps):
    """3 QPEFT steps from one converted state: the first step's adapter
    gradients before and after the γ scaling, each step's loss and grad
    norm, then the trained adapters and moments; the frozen part bit for
    bit unchanged."""
    jcfg, cfg, _ = phi3
    jstate = jax_qpeft_state(jax_qparams, jopt)
    fnp = np_tree(jstate.frozen)
    state = convert_qpeft_state(np_tree(jstate), cfg, device="cpu")
    frozen0 = frozen_snapshot(state.frozen)
    init = {k: v.clone() for k, v in flat_adapters(state.trainable).items()}
    step = make_qpeft_step(cfg, opt, StepConfig(compute_dtype=torch.float32))
    for i, (b, jb) in enumerate(zip(batches_of(cfg, 3), jbatches_of(jcfg, 3))):
        jscales = jqpeft_grad_scales(jstate.trainable, jstate.frozen)
        (jstate, jm), jg = jsteps["qpeft"](jstate, jb)
        if i == 0:
            _, g = _grads_of(lambda bb: lm_loss(Ctx(fused="off"),
                                                state.frozen, bb),
                             state.trainable, b, 0)
            scaled = scale_lr_grads_by_key(
                g, qpeft_grad_scales(state.trainable, state.frozen))
            want = port_adapters(jg, fnp, cfg)
            jscaled = port_adapters(jscale_lr_grads_by_key(jg, jscales),
                                    fnp, cfg)
            for path in g:
                for k in ("l", "r"):
                    assert rel_err(g[path][k], want[path][k]) <= GRAD_TOL
                    assert rel_err(scaled[path][k], jscaled[path][k]) \
                        <= GRAD_TOL, path
        state, m = step(state, b)
        assert rel_err(m["loss"], jm["loss"]) <= LOSS_TOL
        assert rel_err(m["grad_norm"], jm["grad_norm"]) <= GRAD_TOL
    want = flat_adapters(port_adapters(jstate.trainable, fnp, cfg))
    for name, p in flat_adapters(state.trainable).items():
        assert_trained_close(p, want[name], init[name], name)
    for name, v in frozen_snapshot(state.frozen).items():
        assert torch.equal(v, frozen0[name]), name
    mu = flat_adapters(port_adapters(jstate.opt.mu, fnp, cfg))
    for name, v in flat_adapters(state.opt.mu).items():
        assert rel_err(v, mu[name]) <= GRAD_TOL, name


def test_qpeft_microbatch_matches_plain_and_jax(phi3, jax_qparams, jopt, opt,
                                                jsteps):
    """``microbatch=2`` against 0 in the port (loss and gradients), and
    its step against JAX's microbatched step."""
    jcfg, cfg, _ = phi3
    b = batches_of(cfg, 1)[0]
    tr, fr = split_qpeft(convert_params(np_tree(jax_qparams), cfg,
                                        device="cpu"))
    lm = lambda bb: lm_loss(Ctx(fused="off"), fr, bb)  # noqa: E731
    l0, g0 = _grads_of(lm, tr, b, 0)
    l2, g2 = _grads_of(lm, tr, b, 2)
    assert rel_err(l2, l0) <= LOSS_TOL
    gmax = max(float(v.abs().max()) for v in flat_adapters(g0).values())
    for name, v in flat_adapters(g2).items():
        assert float((v - flat_adapters(g0)[name]).abs().max()) \
            <= GRAD_TOL * gmax, name
    jstate = jax_qpeft_state(jax_qparams, jopt)
    state = convert_qpeft_state(np_tree(jstate), cfg, device="cpu")
    step = make_qpeft_step(cfg, opt, StepConfig(compute_dtype=torch.float32,
                                                microbatch=2))
    jstate, jm = jsteps["qpeft2"](jstate, jbatches_of(jcfg, 1)[0])
    state, m = step(state, b)
    assert rel_err(m["loss"], jm["loss"]) <= LOSS_TOL
    assert rel_err(m["grad_norm"], jm["grad_norm"]) <= GRAD_TOL
    with pytest.raises(ValueError, match="divisible"):
        _grads_of(lm, tr, b, 3)


@pytest.mark.parametrize("kw", ["compress_pods", "mesh"])
def test_step_config_refuses_what_needs_the_sharding_rules(kw, opt):
    """Once refused (they waited for the sharding rules), ``compress_pods``
    and ``mesh`` are now accepted as JAX's ``StepConfig`` takes them, and
    change no number: a full step with ``StepConfig(compress_pods=True)``
    or ``StepConfig(mesh=make_host_mesh())`` (a world of one, gloo) gives
    the defaults' loss, grad norm and parameters bit for bit."""
    cfg = get_config(ARCH).reduced()
    b = batches_of(cfg, 1)[0]
    out = {}
    for case in ("default", kw):
        extra = {}
        if case == "compress_pods":
            extra["compress_pods"] = True
        elif case == "mesh":
            extra["mesh"] = make_host_mesh(device_type="cpu")
        try:
            sc = StepConfig(compute_dtype=torch.float32, **extra)
            state = init_train_state(init_lm(cfg, 0, device="cpu"), opt)
            state, m = make_train_step(cfg, opt, sc)(state, b)
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
        out[case] = (m, trainable_params(state.params))
    (m0, p0), (m1, p1) = out["default"], out[kw]
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    for name, p in p0.items():
        assert torch.equal(p, p1[name]), name


@pytest.mark.parametrize("arch", [ARCH, "recurrentgemma-9b"])
def test_remat_full_gives_the_same_gradients(arch):
    cfg = get_config(arch).reduced()
    model = init_lm(cfg, 0, device="cpu")
    leaves = trainable_params(model)
    b = batches_of(cfg, 1)[0]
    out = {}
    for remat in ("none", "full"):
        out[remat] = _grads_of(lambda bb: lm_loss(Ctx(fused="off"), model, bb,
                                                  remat=remat), leaves, b, 0)
    assert torch.equal(out["none"][0], out["full"][0])
    for name, g in out["none"][1].items():
        assert torch.equal(g, out["full"][1][name]), name


def test_moe_step_matches_jax_with_aux():
    """One step's loss (cross-entropy plus the MoE load-balance term) and
    gradients on reduced deepseek-moe-16b against JAX."""
    arch = "deepseek-moe-16b"
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    params = jinit(jcfg)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda q, bb: jlm_loss(JCTX, q, bb, jcfg)))(params,
                                                    jbatches_of(jcfg, 1)[0])
    model = convert_params(np_tree(params), cfg, device="cpu")
    leaves = trainable_params(model)
    b = batches_of(cfg, 1)[0]
    loss, grads = _grads_of(lambda bb: lm_loss(Ctx(fused="off"), model, bb),
                            leaves, b, 0)
    assert rel_err(loss, jloss) <= LOSS_TOL
    # the load-balance term moves the loss well past that tolerance, so
    # the match holds it too
    aux = []
    forward(Ctx(fused="off", aux_log=aux), model, b["tokens"])
    assert AUX_WEIGHT * float(sum(aux)) > 100 * LOSS_TOL * float(loss)
    want = trainable_params(convert_params(np_tree(jg), cfg, device="cpu"))
    router = [n for n in grads if n.endswith("router.w")]
    assert router and all(float(grads[n].abs().max()) > 0 for n in router)
    for name, g in grads.items():
        assert rel_err(g, want[name]) <= GRAD_TOL, name


OTHER_FAMILIES = sorted(set(ARCHS) - {ARCH, "deepseek-moe-16b"})


@pytest.mark.parametrize("arch", OTHER_FAMILIES)
def test_qpeft_step_reaches_every_adapter(arch):
    """Port only: one QPEFT step at reduced size gives every adapter a
    finite, nonzero gradient and changes it, and leaves the rest as it
    was."""
    cfg = get_config(arch).reduced()
    model, _ = quantize_model_params(init_lm(cfg, 0, device="cpu"),
                                     QUICK_PTQ, device="cpu")
    tr, fr = split_qpeft(model)
    b = batches_of(cfg, 1)[0]
    _, g = _grads_of(lambda bb: lm_loss(Ctx(fused="off"), fr, bb), tr, b, 0)
    for name, v in flat_adapters(g).items():
        assert torch.isfinite(v).all() and float(v.abs().max()) > 0, name
    frozen0 = frozen_snapshot(fr)
    init = {k: v.clone() for k, v in flat_adapters(tr).items()}
    o = AdamW(learning_rate=1e-3)
    state, m = make_qpeft_step(cfg, o, StepConfig(
        compute_dtype=torch.float32))(init_qpeft_state(tr, fr, o), b)
    assert torch.isfinite(m["loss"])
    for name, v in flat_adapters(state.trainable).items():
        assert not torch.equal(v, init[name]), name
    for name, v in frozen_snapshot(state.frozen).items():
        assert torch.equal(v, frozen0[name]), name


# ---------------------------------------------------------------------------
# a JAX run carried across; the trainer's kill and resume
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["full", "qpeft"])
def test_carried_state_follows_jax(phi3, jax_qparams, jopt, opt, jsteps,
                                   mode):
    """JAX trains 2 steps; the state comes across; the port's next 2 steps
    follow JAX's 4-step trajectory."""
    jcfg, cfg, params = phi3
    if mode == "full":
        jstate, conv = jinit_train_state(params, jopt), convert_train_state
        step = make_train_step(cfg, opt,
                               StepConfig(compute_dtype=torch.float32))
    else:
        jstate, conv = jax_qpeft_state(jax_qparams, jopt), convert_qpeft_state
        step = make_qpeft_step(cfg, opt,
                               StepConfig(compute_dtype=torch.float32))
    jb = jbatches_of(jcfg, 4)
    for i in range(2):
        (jstate, _), _ = jsteps[mode](jstate, jb[i])
    state = conv(np_tree(jstate), cfg, device="cpu")
    assert int(state.step) == 2 == int(state.opt.step)
    if mode == "full":
        read = lambda s: trainable_params(s.params)  # noqa: E731
        jread = lambda s: trainable_params(convert_params(  # noqa: E731
            np_tree(s.params), cfg, device="cpu"))
    else:
        fnp = np_tree(jstate.frozen)
        read = lambda s: flat_adapters(s.trainable)  # noqa: E731
        jread = lambda s: flat_adapters(  # noqa: E731
            port_adapters(s.trainable, fnp, cfg))
    init = {k: v.clone() for k, v in read(state).items()}
    for i, b in enumerate(batches_of(cfg, 2, start=2)):
        (jstate, jm), _ = jsteps[mode](jstate, jb[2 + i])
        state, m = step(state, b)
        assert rel_err(m["loss"], jm["loss"]) <= LOSS_TOL
    want = jread(jstate)
    for name, p in read(state).items():
        assert_trained_close(p, want[name], init[name], name)


def _fresh_state(cfg, mode, opt):
    model = init_lm(cfg, 0, device="cpu")
    if mode == "full":
        return init_train_state(model, opt), make_train_step(
            cfg, opt, StepConfig(compute_dtype=torch.float32))
    model, _ = quantize_model_params(model, QUICK_PTQ, device="cpu")
    tr, fr = split_qpeft(model)
    return init_qpeft_state(tr, fr, opt), make_qpeft_step(
        cfg, opt, StepConfig(compute_dtype=torch.float32))


@pytest.mark.parametrize("mode", ["full", "qpeft"])
def test_trainer_kill_and_resume_bitexact(mode):
    """10 straight steps ≡ 5, a restart from the checkpoint into a fresh
    state, then 5 more: every tensor of the state bit for bit."""
    cfg = get_config(ARCH).reduced()
    opt = AdamW(learning_rate=cosine_schedule(1e-3, 2, 10), weight_decay=0.01)
    dcfg = data_config_for(cfg, seq_len=SEQ, global_batch=BATCH)
    data = lambda s: batches(dcfg, s, device="cpu")  # noqa: E731
    quiet = lambda *_: None  # noqa: E731
    state, step = _fresh_state(cfg, mode, opt)
    straight, hist = Trainer(step, data, log_fn=quiet, log_every=5).run(
        state, 10)
    assert [h["step"] for h in hist] == [5.0, 10.0]
    assert all(h["step_time"] > 0 for h in hist)
    logs = []
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        Trainer(step, data, ckpt=mgr, ckpt_every=5, log_fn=quiet).run(
            _fresh_state(cfg, mode, opt)[0], 5)
        resumed, _ = Trainer(step, data, ckpt=mgr, ckpt_every=5,
                             log_fn=logs.append).run(
            _fresh_state(cfg, mode, opt)[0], 10)
        assert mgr.latest_step() == 10
    assert logs[0] == "[trainer] resumed from step 5"
    a, b = dict(tree_leaves_with_path(straight)), \
        dict(tree_leaves_with_path(resumed))
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


# ---------------------------------------------------------------------------
# the checkpoint protocol
# ---------------------------------------------------------------------------
def _small_state():
    o = AdamW()
    p = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "codes": torch.tensor([1, -2], dtype=torch.int8)}
    return TrainState(p, o.init({"w": p["w"]}),
                      torch.tensor(7, dtype=torch.int32))


def test_checkpoint_roundtrip_keep_and_latest_fallback():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        state = _small_state()
        for s in (1, 2, 3):
            state.params["w"].add_(1.0)
            mgr.save(s, state, meta={"arch": "x"})
        names = sorted(os.listdir(d))
        assert names == ["LATEST", "step_00000002", "step_00000003"]
        os.makedirs(os.path.join(d, ".tmp.4.orphan"))      # a torn write
        os.remove(os.path.join(d, "LATEST"))
        assert mgr.latest_step() == 3
        fresh = _small_state()
        restored, manifest = mgr.restore(fresh)
        assert restored is fresh and manifest["step"] == 3
        assert manifest["arch"] == "x"
        assert torch.equal(restored.params["w"], state.params["w"])
        assert restored.params["codes"].dtype == torch.int8
        assert int(restored.step) == 7
        with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
            assert "['params']['w']" in f.read()


def test_checkpoint_restore_names_missing_and_misshapen_leaves():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        with pytest.raises(FileNotFoundError):
            mgr.restore(_small_state())
        mgr.save(1, _small_state())
        bigger = _small_state()
        bigger.params["extra"] = torch.zeros(2)
        with pytest.raises(KeyError, match="extra"):
            mgr.restore(bigger)
        wrong = _small_state()
        wrong.params["w"] = torch.zeros((3, 2))
        with pytest.raises(ValueError, match="shape mismatch"):
            mgr.restore(wrong)


# ---------------------------------------------------------------------------
# the kernel wrappers refuse to drop a gradient
# ---------------------------------------------------------------------------
def _wrapper_case(name):
    """(wrapper, operands) on the CPU; the first operand is the one made
    to require grad."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    if name == "qlr_matmul":
        codes = torch.randint(-3, 4, (64, 16), generator=g, dtype=torch.int8)
        return qlr_matmul, (r(4, 64), codes, torch.ones(2, 16), r(64, 4),
                            r(4, 16))
    if name == "qlr_matmul_batched":
        codes = torch.randint(-3, 4, (2, 64, 16), generator=g,
                              dtype=torch.int8)
        return qlr_matmul_batched, (r(2, 4, 64), codes, torch.ones(2, 2, 16),
                                    r(2, 64, 4), r(2, 4, 16))
    if name == "flash_attention":
        pos = torch.arange(8, dtype=torch.int32)
        return flash_attention, (r(1, 8, 2, 1, 8), r(1, 8, 2, 8),
                                 r(1, 8, 2, 8), pos, pos)
    pos = torch.arange(8, dtype=torch.int32).expand(2, 8).contiguous()
    return decode_attention_op, (r(2, 2, 1, 8), r(2, 2, 8, 8), r(2, 2, 8, 8),
                                 torch.full((2,), 7, dtype=torch.int32),
                                 pos)


@pytest.mark.parametrize("name", ["qlr_matmul", "qlr_matmul_batched",
                                  "flash_attention", "decode_attention_op"])
def test_kernel_wrappers_refuse_grad(name):
    """On the CPU the wrapper runs its plain version: it raises for an
    operand that requires grad (grad mode on), and runs on a detached
    one or under ``no_grad``."""
    fn, args = _wrapper_case(name)
    want = fn(*args)
    live = list(args)
    live[0] = args[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*live)
    with torch.no_grad():
        assert torch.equal(fn(*live), want)
    live[0] = live[0].detach()
    assert torch.equal(fn(*live), want)


def test_linear_refuses_grad_through_the_kernel_path():
    """A QLinear under ``fused="auto"`` with adapters that require grad
    raises; ``fused="off"`` differentiates."""
    g = torch.Generator().manual_seed(1)
    p = QLinear(torch.ones(2, 8), torch.randn((64, 4), generator=g),
                torch.randn((4, 8), generator=g),
                codes=torch.randint(-3, 4, (64, 8), generator=g,
                                    dtype=torch.int8))
    p.l.requires_grad_()
    x = torch.randn((3, 64), generator=g)
    with pytest.raises(RuntimeError, match="fused='off'"):
        linear(Ctx(fused="auto"), p, x)
    linear(Ctx(fused="off"), p, x).sum().backward()
    assert p.l.grad is not None and float(p.l.grad.abs().max()) > 0


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
CLI_ARGS = ["--device", "cpu", "--arch", "xlstm-125m", "--steps", "4",
            "--batch", "2", "--seq", "16", "--rank", "8"]


@pytest.mark.parametrize("mode", ["full", "qpeft"])
def test_train_cli_on_the_cpu(capsys, mode):
    """``python -m repro_torch.launch.train``'s entry point (its ``main``)
    in this process, a second interpreter costing more than the run."""
    assert port_train.main(["--mode", mode] + CLI_ARGS) == 0
    out = capsys.readouterr().out
    assert f"mode={mode} device=cpu" in out and "final loss" in out
    if mode == "qpeft":
        assert "quantized 22 matrices, mean k*=" in out


def test_train_cli_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_train.main(["--steps", "1"])


def test_train_cli_gamma_is_parsed_and_not_read():
    """As in JAX (``repro/launch/train.py:48``): every preserved rank
    takes the pass's γ = 0.1 whatever ``--gamma`` says."""
    run = port_train.build(port_train.parser().parse_args(
        ["--device", "cpu", "--mode", "qpeft", "--gamma", "0.5", "--steps",
         "2", "--batch", "2", "--seq", "16", "--rank", "8"]),
        log=lambda *_: None)
    seen = set()
    for _, m in qlinears(run.state.frozen):
        seen |= set(np.unique(m.gscale.numpy()).tolist())
    assert seen == {np.float32(0.1), 1.0}
    assert len(run.reports) == 14 and run.sc.compute_dtype == torch.float32
