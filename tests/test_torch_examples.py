"""Port parity: the library surface (``repro_torch.core``'s public names,
``configs.list_archs``, the mesh and model exports), the rank-allocation
oracle of Eq. 3 against ``repro.core``, and the three examples on the
CPU.

Tolerances: the oracle and the surrogate agree with JAX within 1e-5
relative (exact SVDs in f32 on both sides, one MXINT pass of the same
matrix); quickstart's k* equal to JAX's library calls' on the same W, X and
probe or tied with it within 1e-5 of the objective, its QER error within
1e-4 relative, its SRR error within 1e-3
and its output error within 5e-3 (``FLIP_TOL``, ``OUT_TOL``: round-off
flips a few MXINT codes of the residual); the resumed training
run equals the uninterrupted one bit for bit (the checkpoint holds the
state's exact f32 bytes).
"""
import ast
import importlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.rank_alloc as jrank_alloc
from repro.configs import list_archs as jlist_archs
from repro.core import (make_scaling as jmake_scaling,
                        qer_decompose as jqer_decompose,
                        scaled_error as jscaled_error,
                        select_rank as jselect_rank,
                        srr_decompose as jsrr_decompose)
from repro.core.rank_alloc import (sample_probe as jsample_probe,
                                   true_reconstruction_error as jtrue_error)
from repro.quant import MXIntQuantizer as JMX
import repro_torch.core as tcore
import repro_torch.core.rank_alloc as trank_alloc
from repro_torch.configs import list_archs
from repro_torch.core import (make_scaling, sample_probe, select_rank,
                              singular_values, topk_singular_values,
                              true_reconstruction_error)
from repro_torch.data import batches
from repro_torch.examples import ptq_serve, quickstart, train_e2e
from repro_torch.models import init_lm
from repro_torch.quant import MXIntQuantizer
from repro_torch.train import Trainer, init_train_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
ORACLE_TOL = 1e-5
QUICKSTART_TOL = 1e-4
KSTAR_TIE = 1e-5
# SRR's error and the served output's (4 rows): SRR quantizes W minus 45
# preserved components, so S's round-off (1.5e-6 between the two
# libraries' eigh, or between two thread counts' Σxxᵀ) flips a few of the
# residual's 262,144 MXINT codes by a step, each ~7e-5 of SRR's error
# and ~4e-4 of the output's; the bounds allow about a dozen
FLIP_TOL = 1e-3
OUT_TOL = 5e-3
# the oracle's comparisons use a planted product whose singular values
# are apart: where two nearly tie, the two libraries' f32 SVDs rotate
# their vectors differently at round-off, the preserved part moves by
# ~1e-5 and one MXINT code of the residual can flip a step (1 of 12,288
# at k = 4 inside quickstart's equal-weight rank-8 cluster, whose 4th and
# 5th singular values lie 0.06 apart: 2e-4 relative); the quantizer
# itself agrees bit for bit on one input
SEPARATED = 0.7


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Torch ops at two intra-op threads, as in the other port files;
    the process's setting is restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_core_names():
    tree = ast.parse((ROOT / "src/repro/core/__init__.py").read_text())
    return [(node.module.rsplit(".", 1)[1], alias.name)
            for node in tree.body if isinstance(node, ast.ImportFrom)
            for alias in node.names]


@pytest.mark.parametrize("module,name", _jax_core_names(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_core_exports_every_jax_name(module, name):
    sub = importlib.import_module(f"repro_torch.core.{module}")
    assert getattr(tcore, name) is getattr(sub, name)


def test_list_archs_matches_jax():
    assert list_archs() == jlist_archs()


def test_mesh_and_model_exports():
    from repro_torch.launch import (make_host_mesh, make_mesh,
                                    make_production_mesh)
    from repro_torch.launch import mesh
    from repro_torch.models import dequant_weight, layer_layout
    from repro_torch.models import linear, transformer  # noqa: F401
    import sys
    assert (make_host_mesh, make_mesh, make_production_mesh) == (
        mesh.make_host_mesh, mesh.make_mesh, mesh.make_production_mesh)
    assert dequant_weight is sys.modules["repro_torch.models.linear"] \
        .dequant_weight
    assert layer_layout is sys.modules["repro_torch.models.transformer"] \
        .layer_layout
    # launch/__init__ must not import the dry run (it builds fake worlds)
    tree = ast.parse((ROOT / "src/repro_torch/launch/__init__.py")
                     .read_text())
    mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert mods == {"repro_torch.launch.mesh"}


def _planted(m, n, seed, rank=8, sig=6.0, noise=0.02, decay=1.0):
    """quickstart's structure from a numpy seed: a rank-8 product scaled
    to 6/√(mn) plus 0.02 noise; ``decay`` < 1 scales the product's i-th
    column by decay^i, which separates its singular values."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((m, rank)) * decay ** np.arange(rank)
    v = rng.standard_normal((rank, n))
    w = u @ v * (sig / (m * n) ** 0.5) + rng.standard_normal((m, n)) * noise
    x = rng.standard_normal((4 * m, m))
    return w.astype(np.float32), x.astype(np.float32)


def _scalings(kind, x):
    if kind == "identity":
        return jmake_scaling("identity"), make_scaling("identity")
    return (jmake_scaling(kind, jnp.asarray(x)),
            make_scaling(kind, torch.from_numpy(x)))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("kind", ["identity", "qera-exact"])
@pytest.mark.parametrize("k", [0, 4, 16])
def test_true_reconstruction_error_matches_jax(kind, k):
    r = 16
    w, x = _planted(128, 96, seed=3, decay=SEPARATED)
    js, ts = _scalings(kind, x)
    want = float(jtrue_error(jnp.asarray(w), js, JMX(bits=3), r, k))
    got = float(true_reconstruction_error(torch.from_numpy(w),
                                          MXIntQuantizer(bits=3), r, k,
                                          scaling=ts))
    assert _rel(got, want) <= ORACLE_TOL, (got, want)


@pytest.mark.parametrize("kind", ["identity", "qera-exact"])
def test_select_rank_matches_jax_under_jax_probe(kind, monkeypatch):
    r = 24
    w, x = _planted(160, 128, seed=5, decay=SEPARATED)
    js, ts = _scalings(kind, x)
    key = jax.random.PRNGKey(11)
    jprobe = np.asarray(jsample_probe(jax.random.split(key)[0], w.shape))
    calls = []

    def probe(gen, shape, device=None):
        calls.append(tuple(shape))
        return torch.from_numpy(jprobe.copy()).to(device)

    monkeypatch.setattr(trank_alloc, "sample_probe", probe)
    want = jselect_rank(jnp.asarray(w), js, r, key, exact=True)
    got = select_rank(torch.from_numpy(w), r, None, exact=True, scaling=ts)
    assert calls == [w.shape]
    np.testing.assert_allclose(got.objective.numpy(),
                               np.asarray(want.objective), rtol=0,
                               atol=ORACLE_TOL)
    assert got.k_star == int(want.k_star)


def test_sample_probe_range_and_devices():
    gen = torch.Generator().manual_seed(3)
    e = sample_probe(gen, (64, 48), torch.device("cpu"))
    assert e.dtype == torch.float32 and e.shape == (64, 48)
    assert float(e.min()) >= -1.0 and float(e.max()) < 1.0
    again = sample_probe(torch.Generator().manual_seed(3), (64, 48), "cpu")
    assert torch.equal(e, again)


def test_surrogate_tracks_true_error_fig2():
    """Fig. 2 on the port alone, as tests/test_core_srr.py holds JAX's:
    the surrogate's k* scores within 10 % of the true curve's minimum."""
    w, x = _planted(384, 256, seed=6)
    s = make_scaling("qera-exact", torch.from_numpy(x))
    w = torch.from_numpy(w)
    qz = MXIntQuantizer(bits=3)
    r = 24
    sel = select_rank(w, r, torch.Generator().manual_seed(0), exact=True,
                      scaling=s)
    true = [float(true_reconstruction_error(w, qz, r, k, scaling=s))
            for k in range(0, r + 1, 4)]
    at_sur = float(true_reconstruction_error(w, qz, r, sel.k_star,
                                             scaling=s))
    assert at_sur <= min(true) * 1.10


def test_topk_singular_values_on_low_rank():
    rng = np.random.default_rng(2)
    a = torch.from_numpy((rng.standard_normal((200, 8))
                          @ rng.standard_normal((8, 150))).astype(np.float32))
    got = topk_singular_values(a, 8, torch.Generator().manual_seed(0))
    want = singular_values(a)[:8]
    assert got.shape == (8,)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)


def test_quickstart_matches_jax_library_calls(monkeypatch):
    got = quickstart.main(["--device", "cpu"])
    gen = torch.Generator().manual_seed(0)
    w = quickstart.planted(quickstart.M, quickstart.N, gen).numpy()
    x = torch.randn((quickstart.CALIB_ROWS, quickstart.M),
                    generator=gen).numpy()
    probe = sample_probe(quickstart.probe_gen(), w.shape, "cpu").numpy()
    monkeypatch.setattr(jrank_alloc, "sample_probe",
                        lambda key, shape: jnp.asarray(probe))
    jw, jx = jnp.asarray(w), jnp.asarray(x)
    s = jmake_scaling("qera-exact", jx)
    qz, r = JMX(bits=3, block_size=32), quickstart.RANK
    key = jax.random.PRNGKey(7)
    sel = jselect_rank(jw, s, r, key, exact=True)
    qer = jqer_decompose(jw, s, qz, r, exact=True)
    # k* equal, or a tie on JAX's objective (quickstart's k = 45 and 46
    # lie 2.75e-6 apart, within what S's round-off moves); SRR compared
    # at the port's split
    objective = np.asarray(sel.objective)
    assert got["k_star"] == got["srr_k"]
    assert objective[got["k_star"]] <= objective.min() * (1 + KSTAR_TIE)
    srr = jsrr_decompose(jw, s, qz, r, key, k=got["k_star"],
                         exact=True).decomposition
    y = jx[:4] @ jw
    y_srr = jx[:4] @ srr.q + (jx[:4] @ srr.l) @ srr.r
    want = {"scaled_err_qer": float(jscaled_error(jw, qer, s)),
            "scaled_err_srr": float(jscaled_error(jw, srr, s)),
            "output_rel_err": float(jnp.linalg.norm(y - y_srr)
                                    / jnp.linalg.norm(y))}
    assert _rel(got["scaled_err_qer"], want["scaled_err_qer"]) \
        <= QUICKSTART_TOL, (got, want)
    assert _rel(got["scaled_err_srr"], want["scaled_err_srr"]) <= FLIP_TOL
    assert _rel(got["output_rel_err"], want["output_rel_err"]) <= OUT_TOL
    assert got["scaled_err_srr"] < got["scaled_err_qer"]


@pytest.mark.parametrize("name", ["quickstart", "ptq_serve", "train_e2e"])
def test_examples_raise_without_cuda(name, monkeypatch):
    mod = {"quickstart": quickstart, "ptq_serve": ptq_serve,
           "train_e2e": train_e2e}[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([])


def test_ptq_serve_runs_all_five_acts():
    out = ptq_serve.main(["--device", "cpu"])
    assert out["arch"] == out["paged_arch"] == "minitron-4b"
    assert set(out["methods"]) == set(ptq_serve.METHODS)
    assert all(np.isfinite(m["loss"]) for m in out["methods"].values())
    assert out["methods"]["w-only"]["mean_k"] == 0
    cont = out["continuous"]
    assert cont["finished"] == cont["submitted"] == 8
    assert set(cont["finish_reasons"]) <= {"length", "stop"}
    assert out["paged"]["finished"] == out["paged"]["submitted"] == 10
    assert out["paged"]["prefix_hit_rate"] > 0
    assert out["speculative"]["identical"] \
        and out["speculative"]["requests"] == 4


def test_ptq_serve_pages_on_phi3_for_a_recurrent_arch():
    out = ptq_serve.main(["--device", "cpu", "--arch", "xlstm-125m",
                          "--layers", "2"])
    assert out["arch"] == "xlstm-125m"
    assert out["paged_arch"] == "phi3-mini-3.8b"
    assert out["continuous"]["finished"] == 8
    assert out["paged"]["prefix_hit_rate"] > 0


@pytest.fixture
def deterministic():
    """The embedding's backward on the CPU accumulates rows in an order
    that depends on the threads past a grain size (two straight runs of
    train_e2e's batches differ in ``embed``); deterministic algorithms fix
    the order, so a resumed run can be held to a straight one bit for
    bit."""
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def test_train_e2e_resume_equals_uninterrupted_run(deterministic):
    out = train_e2e.main(["--device", "cpu", "--small", "--steps", "6"])
    assert out["preempted_at"] == out["checkpoint_step"] == 3
    assert out["resumed_from"] == [3]
    assert all(np.isfinite(v) for v in out["losses"])
    for row in out["qpeft"]:
        assert np.isfinite(row["eval_before"]) and np.isfinite(
            row["eval_after"])
        assert all(np.isfinite(v) for v in row["step_losses"])
    # the same 6 steps with no preemption and no checkpoint
    cfg = train_e2e.model_config(small=True)
    cpu = torch.device("cpu")
    dcfg, opt, step = train_e2e.pretraining(cfg, 6, cpu)
    trainer = Trainer(step, lambda s: batches(dcfg, s, device=cpu),
                      log_every=25, log_fn=lambda _: None)
    state, _ = trainer.run(init_train_state(init_lm(cfg, 0, device=cpu),
                                            opt), 6)
    want = dict(state.params.named_buffers())
    got = dict(out["model"].named_buffers())
    assert sorted(got) == sorted(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
