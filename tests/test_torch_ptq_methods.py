"""Port parity: the scaled PTQ methods — ``qer``, ``w-only`` and SRR
(split and joint) under every scaling — per matrix and over a model,
and the calibrated pipeline end to end.

Per matrix, the same numpy weights and activations go through the JAX
package and the port with a forced k and exact SVDs. The MXINT codes and
exponents are bit-exact: Q = 𝒬(W) for w-only and qer, and for SRR
Q = 𝒬(W − preserved), whose preserved part agrees to f32 noise; the
reconstruction Q + LR is held to 1e-4 of max|W| (observed ≤ 5.5e-6 per
matrix, ≤ 2.1e-5 over the model: qera-exact's S⁻¹ comes from an f32
eigendecomposition in each framework, see ``test_torch_scaling.py``).

Over a model the port looks up each matrix's statistics by its own layer
(``L<i>.<role>``); the JAX pass hands every scanned layer layer 0's
(``_stats_for`` with an empty hint), so layer 0 is held against JAX's
``quantize_model_params`` and layer 1 against JAX's per-matrix function
called with layer 1's own statistics. There a code may differ by one
step where JAX's quantizer input sits on a rounding tie (within 1e-3 of
a half step), since the preserved part agrees only to f32 noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.api import CalibStats as JCalibStats
from repro.core.api import PTQConfig as JPTQConfig
from repro.core.api import quantize_tree as jquantize_tree
from repro.core.qer import qer_decompose as jqer
from repro.core.qer import scaled_error as jscaled_error
from repro.core.qer import w_only as jw_only
from repro.core.scaling import make_scaling as jmake_scaling
from repro.core.srr import srr_decompose as jsrr
from repro.data import capture_calibration as jcapture
from repro.data import data_config_for as jdata_config_for
from repro.models import init_lm as jinit_lm
from repro.models import lm_loss as jlm_loss
from repro.models.quantize import _quantize_matrix as jquantize_matrix
from repro.models.quantize import _stats_for as jstats_for
from repro.models.quantize import quantize_model_params as jquantize
from repro.quant import MXIntQuantizer as JMX
from repro.quant.base import QuantizerConfig
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import convert_params
from repro_torch.core.api import (CalibStats, PTQConfig, quantize_layer,
                                  quantize_tree, report_summary)
from repro_torch.core.qer import qer_decompose, scaled_error, w_only
from repro_torch.core.scaling import SCALING_KINDS, make_scaling
from repro_torch.core.srr import preserved_singular_values, srr_decompose
from repro_torch.data import capture_calibration, data_config_for
from repro_torch.kernels.mxint_matmul import dequant_blockwise
from repro_torch.launch import serve as serve_cli
from repro_torch.models import init_lm, lm_loss
from repro_torch.models.quantize import quantize_model_params
from repro_torch.quant.mxint import MXIntQuantizer
from repro_torch.serve import Engine, Request, ServeConfig

REC_TOL = 1e-4
ROLES = {"wq": "attn.wq", "wk": "attn.wk", "wv": "attn.wv", "wo": "attn.wo",
         "up": ".up", "gate": ".gate", "down": ".down"}
MODS = {"mixer": ("wq", "wk", "wv", "wo"), "mlp": ("up", "gate", "down")}


def _jptq(method, k=3, rank=8, scaling="qera-exact", exact=True):
    return JPTQConfig(method=method, scaling=scaling, rank=rank,
                      exact_svd=exact, forced_k=k,
                      quantizer=QuantizerConfig(kind="mxint", bits=3,
                                                block_size=32))


def _planted(m=64, n=96, seed=0):
    """A rank-6 signal under noise: SRR has structure to preserve."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((m, 6))
    v = rng.standard_normal((6, n))
    return (u @ v * 0.2 + rng.standard_normal((m, n)) * 0.02).astype(np.float32)


def _acts(n=300, m=64, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m)) * np.exp(rng.standard_normal(m) * 0.5)
    x[:, 3] *= 8.0
    return x.astype(np.float32)


def _scalings(kind):
    x = _acts()
    return jmake_scaling(kind, jnp.asarray(x)), \
        make_scaling(kind, torch.from_numpy(x))


def _q_lr_close(codes, jcodes, scale, lr, jlr, w, jpreserved, k):
    """The port's MXINT codes and Q + LR against JAX's. The codes are
    equal, but that with k > 0 one may be a step off where JAX's quantizer
    input W − preserved sits on a rounding tie (within 1e-3 of a half
    step: the preserved parts agree only to f32 noise). Q + LR then moves
    by that step plus the reconstruction's answer to it, and is held to
    twice the step in Frobenius norm; else to REC_TOL · max|W|."""
    m = w.shape[0]
    diff = codes != jcodes
    step = np.repeat(scale, 32, axis=0)[:m]
    rec = _dequant(codes, scale, m) + lr
    jrec = _dequant(jcodes, scale, m) + jlr
    if not diff.any():
        np.testing.assert_allclose(rec, jrec, rtol=0,
                                   atol=REC_TOL * float(np.abs(w).max()))
        return
    assert k > 0, "codes of Q = 𝒬(W) differ"
    assert diff.sum() <= 2
    assert np.abs(codes.astype(int) - jcodes)[diff].max() == 1
    v = (w - jpreserved) / step
    assert np.all(np.abs(np.abs(v[diff[:m]]) % 1 - 0.5) < 1e-3), \
        "a code differs away from a rounding tie"
    assert np.linalg.norm(rec - jrec) <= 2 * np.linalg.norm(step[diff[:m]])


def _dequant(codes, scale, m):
    return dequant_blockwise(torch.as_tensor(np.array(codes)),
                             torch.as_tensor(np.array(scale)),
                             torch.float32)[:m].numpy()


def _decomposition_close(td, jd, w, jpreserved):
    """Exponents equal; codes and Q + LR as :func:`_q_lr_close`."""
    jc, tc = JMX(bits=3).quantize(jd.q), MXIntQuantizer(bits=3).quantize(td.q)
    assert np.array_equal(tc.exponents.numpy(), np.asarray(jc.exponents))
    _q_lr_close(tc.codes.numpy(), np.asarray(jc.codes),
                np.exp2(np.asarray(jc.exponents, np.float32)),
                (td.l @ td.r).numpy(), np.asarray(jd.l) @ np.asarray(jd.r),
                w, jpreserved, jd.k)


def _jax_stats(x):
    return JCalibStats.init(x.shape[1]).update(jnp.asarray(x))


def _port_stats_one(js) -> CalibStats:
    return CalibStats(int(float(js.count)), torch.from_numpy(np.array(js.sum_abs)),
                      torch.from_numpy(np.array(js.sum_sq)),
                      torch.from_numpy(np.array(js.autocorr)))


def _jax_stats_one(st: CalibStats):
    return JCalibStats(jnp.float32(st.count), jnp.asarray(st.sum_abs.numpy()),
                       jnp.asarray(st.sum_sq.numpy()),
                       jnp.asarray(st.autocorr.numpy()))


def _port_stats(jstats) -> dict:
    """JAX's statistics as the port's, so a model-level comparison sees
    one calibration."""
    return {k: _port_stats_one(v) for k, v in jstats.items()}


# ---------------------------------------------------------------------------
# per matrix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", SCALING_KINDS)
def test_w_only_and_qer_match_jax(kind):
    js, ts = _scalings(kind)
    w = _planted(seed=11)
    jq = jqer(jnp.asarray(w), js, JMX(bits=3), 8, exact=True)
    tq = qer_decompose(torch.from_numpy(w), MXIntQuantizer(bits=3), 8,
                       exact=True, scaling=ts)
    jw = jw_only(jnp.asarray(w), JMX(bits=3), 8)
    tw = w_only(torch.from_numpy(w), MXIntQuantizer(bits=3), 8)
    for td, jd in ((tq, jq), (tw, jw)):
        assert td.k == jd.k == 0 and td.l.shape == jd.l.shape == (64, 8)
        _decomposition_close(td, jd, w, 0.0)
    assert float(tw.l.abs().max()) == 0.0
    np.testing.assert_allclose(float(scaled_error(torch.from_numpy(w), tq, ts)),
                               float(jscaled_error(jnp.asarray(w), jq, js)),
                               rtol=1e-5)


@pytest.mark.parametrize("kind", SCALING_KINDS)
@pytest.mark.parametrize("variant", ["split", "joint"])
@pytest.mark.parametrize("k", [0, 3, 8])
def test_srr_forced_k_matches_jax(kind, variant, k):
    js, ts = _scalings(kind)
    w = _planted(seed=k)
    jd, split = (jsrr(jnp.asarray(w), js, JMX(bits=3), 8, jax.random.PRNGKey(0),
                      k=k, exact=True, variant=v).decomposition
                 for v in (variant, "split"))
    # the quantizer's input W − preserved, from the split variant's
    # leading k ranks (the joint variant quantizes the same residual)
    jpreserved = np.asarray(split.l)[:, :k] @ np.asarray(split.r)[:k]
    res = srr_decompose(torch.from_numpy(w), MXIntQuantizer(bits=3), 8, None,
                        k=k, exact=True, scaling=ts, variant=variant)
    assert res.selection is None and res.k == jd.k == k
    assert res.l.shape == jd.l.shape and res.rank == 8
    _decomposition_close(res.decomposition, jd, w, jpreserved)
    sv = np.linalg.norm(np.asarray(jd.r), axis=1)
    np.testing.assert_allclose(
        preserved_singular_values(res.decomposition).numpy(), sv, rtol=0,
        atol=1e-5 * sv.max())


def test_srr_selection_and_variants_share_k_and_q():
    """k* from the scaled probe (exact spectra); the joint variant draws
    the same probe, so it picks the same k* and quantizes the same
    residual, and its single rank-r SVD of S(W − Q) can only lower the
    scaled error (Eckart–Young)."""
    _, ts = _scalings("qera-exact")
    w = torch.from_numpy(_planted(seed=4))
    out = {}
    for variant in ("split", "joint"):
        gen = torch.Generator().manual_seed(3)
        out[variant] = srr_decompose(w, MXIntQuantizer(bits=3), 8, gen,
                                     exact=True, scaling=ts, variant=variant)
    sel = out["split"].selection
    assert sel.objective.shape == (9,) and 0 <= sel.k_star <= 8
    assert sel.k_star == int(torch.argmin(sel.objective))
    assert out["joint"].k == out["split"].k == sel.k_star > 0
    assert torch.equal(out["joint"].q, out["split"].q)
    err = {v: float(scaled_error(w, r.decomposition, ts))
           for v, r in out.items()}
    assert err["joint"] <= err["split"] * (1 + 1e-5)


def test_quantize_tree_and_report_summary_match_jax():
    js, _ = _scalings("qera-exact")
    x = _acts()
    weights = {f"m{i}": _planted(seed=i) for i in range(3)}
    jst = {"m0": _jax_stats(x), "m2": _jax_stats(x)}
    jdecs, jreps = jquantize_tree({k: jnp.asarray(v) for k, v in weights.items()},
                                  jst, _jptq("srr"))
    decs, reps = quantize_tree({k: torch.from_numpy(v)
                                for k, v in weights.items()},
                               {k: _port_stats_one(v) for k, v in jst.items()},
                               PTQConfig(method="srr", rank=8, exact_svd=True,
                                         forced_k=3))
    assert [r.name for r in reps] == [r.name for r in jreps] == sorted(weights)
    for name in weights:
        jd = jdecs[name]
        _decomposition_close(decs[name], jd, weights[name],
                             np.asarray(jd.l)[:, :3] @ np.asarray(jd.r)[:3])
    for a, b in zip(reps, jreps):
        assert (a.shape, a.rank, a.k_star) == (b.shape, b.rank, b.k_star)
        np.testing.assert_allclose([a.scaled_err, a.weight_err],
                                   [b.scaled_err, b.weight_err], rtol=1e-4)
    summary = report_summary(reps)
    assert summary["layers"] == 3 and summary["mean_k_star"] == 3.0
    np.testing.assert_allclose(summary["mean_scaled_err"],
                               np.mean([r.scaled_err for r in jreps]),
                               rtol=1e-4)
    assert report_summary([]) == {}


# ---------------------------------------------------------------------------
# over a model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Many small ops: two intra-op threads, as in
    ``tests/test_torch_train.py``; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def calibrated():
    """Reduced phi3 (two scanned layers): JAX params, the converted port
    model's config, and JAX's calibration statistics."""
    jcfg = jget_config("phi3-mini-3.8b").reduced()
    params = jinit_lm(jax.random.PRNGKey(0), jcfg)
    stats = jcapture(params, jcfg, jdata_config_for(jcfg, 32, 4, 0),
                     lambda c, p, b, cc: jlm_loss(c, p, b, cc), n_batches=2)
    return jcfg, params, get_config("phi3-mini-3.8b").reduced(), stats


def _container_close(got: dict, want: dict, w: np.ndarray, k: int):
    """The port's buffers against JAX's container (split SRR or qer):
    scales and gscale equal, the preserved part within REC_TOL · max|W|,
    codes and Q + LR as :func:`_q_lr_close`."""
    scale = np.asarray(want["scale"])
    assert np.array_equal(got["scale"].numpy(), scale)
    assert np.array_equal(got["gscale"].numpy(), np.asarray(want["gscale"]))
    l, r = got["l"].numpy(), got["r"].numpy()
    jl, jr = np.asarray(want["l"]), np.asarray(want["r"])
    jpreserved = jl[:, :k] @ jr[:k]
    np.testing.assert_allclose(l[:, :k] @ r[:k], jpreserved, rtol=0,
                               atol=REC_TOL * float(np.abs(w).max()))
    _q_lr_close(got["codes"].numpy(), np.asarray(want["codes"]), scale,
                l @ r, jl @ jr, w, jpreserved, k)


@pytest.mark.parametrize("method,k", [("srr", 3), ("srr", 0), ("qer", None)])
def test_model_quantizes_each_layer_with_its_own_stats(calibrated, method, k):
    jcfg, params, cfg, jstats = calibrated
    tree = jax.tree_util.tree_map(np.asarray, params)
    jq, _ = jquantize(params, jstats, _jptq(method, k))
    want0 = jax.tree_util.tree_map(np.asarray, jq["groups"]["p0"])
    stats = _port_stats(jstats)
    model, reports = quantize_model_params(
        convert_params(tree, cfg, device="cpu"),
        PTQConfig(method=method, rank=8, exact_svd=True, forced_k=k),
        stats=stats, device="cpu")
    assert stats == {}                       # every layer's entries released
    assert len(reports) == 14 and all(r.k_star == (k or 0) for r in reports)
    group = tree["groups"]["p0"]
    for layer, blk in enumerate(model.blocks):
        for mod, names in MODS.items():
            for n in names:
                w = group[mod][n]["w"][layer]
                got = {f: getattr(getattr(blk, mod), n).__getattr__(f)
                       for f in ("codes", "scale", "l", "r", "gscale")}
                got["codes"] = got["codes"].to(torch.int8)
                if layer == 0:
                    want = {f: want0[mod][n][f][0] for f in got}
                else:
                    want, _ = jquantize_matrix(
                        "L1", jnp.asarray(w), jstats[f"L1.{ROLES[n]}"],
                        _jptq(method, k), jax.random.PRNGKey(0), "int8")
                _container_close(got, want, w, k or 0)


def test_jax_pass_reads_layer_zero_stats_for_every_scanned_layer(calibrated):
    """Why the port deviates: JAX's lookup with an empty layer hint falls
    through to a suffix match, which returns the first key in insertion
    order — layer 0's — for the whole scanned stack; on deepseek-moe's
    expert stack it returns the dense lead-in's 128-wide ``down`` and the
    pass raises. (Reads the JAX package, changes nothing in it.)"""
    _, _, _, stats = calibrated
    for leaf, role in ROLES.items():
        mod = "mixer" if leaf.startswith("w") else "mlp"
        got = jstats_for(stats, ["groups", "p0", mod, leaf, "w"], "")
        assert got is stats[f"L0.{role}"]
        assert got is not stats[f"L1.{role}"]
    jcfg = jget_config("deepseek-moe-16b").reduced()
    params = jinit_lm(jax.random.PRNGKey(0), jcfg)
    mstats = jcapture(params, jcfg, jdata_config_for(jcfg, 16, 2, 0),
                      lambda c, p, b, cc: jlm_loss(c, p, b, cc), n_batches=1)
    assert jstats_for(mstats, ["groups", "p0", "moe", "experts", "down", "w"],
                      "") is mstats["L0..down"]
    with pytest.raises(TypeError, match="shape"):
        jquantize(params, mstats, _jptq("w-only", k=None))


def test_moe_model_takes_per_layer_stats_and_identity_for_experts():
    """Reduced deepseek-moe calibrated by the port: the router, shared
    experts and attention of the MoE layer are quantized under their own
    layer's statistics, every routed expert under the identity."""
    jcfg = jget_config("deepseek-moe-16b").reduced()
    cfg = get_config("deepseek-moe-16b").reduced()
    params = jinit_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = convert_params(tree, cfg, device="cpu")
    stats = capture_calibration(model, data_config_for(cfg, 16, 2, 0),
                                lm_loss, n_batches=1, device="cpu")
    keep = dict(stats)
    model, reports = quantize_model_params(
        model, PTQConfig(method="qer", rank=8, exact_svd=True), stats=stats,
        device="cpu")
    assert stats == {} and len(reports) == 7 + 8 + 3 * cfg.n_routed
    moe = model.blocks[1].mlp
    # JAX's tree: the dense lead-in in "prefix", the MoE layer scanned
    moe_tree = jax.tree_util.tree_map(lambda a: a[0],
                                      tree["groups"]["p0"]["moe"])
    cases = [(moe.router, moe_tree["router"]["w"],
              _jax_stats_one(keep["L1.moe.router"])),
             (moe.shared.down, moe_tree["shared"]["down"]["w"],
              _jax_stats_one(keep["L1.moe.shared.down"]))]
    for e in (0, cfg.n_routed - 1):
        got = {f: getattr(moe.experts.gate, f)[e] for f in ("codes", "l", "r")}
        cases.append((got, moe_tree["experts"]["gate"]["w"][e], None))
    for got, w, st in cases:
        want, _ = jquantize_matrix("x", jnp.asarray(w), st, _jptq("qer", None),
                                   jax.random.PRNGKey(0), "int8")
        codes = got["codes"] if isinstance(got, dict) else got.codes
        l, r = (got["l"], got["r"]) if isinstance(got, dict) else (got.l, got.r)
        assert np.array_equal(codes.numpy(), np.asarray(want["codes"]))
        np.testing.assert_allclose((l @ r).numpy(),
                                   np.asarray(want["l"]) @ np.asarray(want["r"]),
                                   rtol=0, atol=REC_TOL * float(np.abs(w).max()))


def test_missing_stats_raise_and_methods_order_on_the_model():
    """A layer without statistics raises (a consumed dict included); on
    the port's own calibrated reduced phi3, per matrix, qer never loses
    to w-only and srr-joint never to srr under qera-exact (the chip's
    phase "ptq" gates)."""
    cfg = get_config("phi3-mini-3.8b").reduced()
    base = init_lm(cfg, 0, device="cpu")
    stats = capture_calibration(base, data_config_for(cfg, 32, 4, 0), lm_loss,
                                n_batches=2, device="cpu")
    errs = {}
    for method in ("w-only", "qer", "srr", "srr-joint"):
        model = init_lm(cfg, 0, device="cpu")
        _, reports = quantize_model_params(
            model, PTQConfig(method=method, rank=8, exact_svd=True),
            stats=dict(stats), device="cpu")
        errs[method] = [r.scaled_err for r in reports]
    for a, b in zip(errs["qer"], errs["w-only"]):
        assert a <= b * (1 + 1e-5)
    for a, b in zip(errs["srr-joint"], errs["srr"]):
        assert a <= b * (1 + 1e-5)
    partial = {k: v for k, v in stats.items() if not k.startswith("L1.")}
    with pytest.raises(KeyError, match="L1.attn.wq"):
        quantize_model_params(init_lm(cfg, 0, device="cpu"), PTQConfig(rank=8),
                              stats=partial, device="cpu")
    with pytest.raises(ValueError, match="unknown PTQ method"):
        quantize_layer("x", torch.ones(64, 64), PTQConfig(method="gptq"), None)


def _jax_per_layer_container(params, stats, ptq):
    """JAX's per-matrix function over reduced phi3's scanned stack, each
    layer with its own statistics — the container the JAX pass means."""
    tree = jax.tree_util.tree_map(np.asarray, params)
    group = tree["groups"]["p0"]
    for mod, names in MODS.items():
        for n in names:
            per = [jquantize_matrix(f"L{i}.{n}", jnp.asarray(w),
                                    stats[f"L{i}.{ROLES[n]}"], ptq,
                                    jax.random.fold_in(jax.random.PRNGKey(0), i),
                                    "int8")[0]
                   for i, w in enumerate(group[mod][n]["w"])]
            group[mod][n] = {f: np.stack([np.asarray(q[f]) for q in per])
                             for f in per[0]}
    return tree


def test_calibrated_container_greedy_tokens_identical_to_jax(calibrated):
    """A calibrated qera-exact SRR container (k* selected, exact SVDs),
    served greedily by both engines: identical tokens."""
    jcfg, params, cfg, stats = calibrated
    tree = _jax_per_layer_container(params, stats, _jptq("srr", k=None))
    qparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = convert_params(tree, cfg, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab, size=4 + 3 * i).astype(np.int32)
               for i in range(5)]
    common = dict(max_len=32, decode_batch=3, prefill_len=16, kv_dtype="bf16")
    want = JEngine(qparams, jcfg, JServeConfig(**common)).generate(
        [JRequest(uid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])
    got = Engine(model, cfg, ServeConfig(**common), device="cpu").generate(
        [Request(uid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])
    assert [g.tokens.tolist() for g in got] == [w.tokens.tolist() for w in want]


@pytest.mark.parametrize("method", ["srr", "qer", "w-only"])
def test_serve_cli_calibrates_and_quantizes_on_the_cpu(method, capsys):
    assert serve_cli.main(["--device", "cpu", "--method", method,
                           "--requests", "2", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] {method} quantized 14 matrices" in out
    assert "2 requests, 6 tokens" in out
