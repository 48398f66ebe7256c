"""Port parity: the cross-pod int8 error-feedback all-reduce
(``repro_torch.optim.compress``, ``train.steps.make_compressed_sync``)
against the JAX package's ``repro.optim.compress`` on the CPU.

JAX's side runs ``ef_compressed_psum`` under ``jax.vmap(...,
axis_name="pod")`` over 4 stacked per-pod inputs, in this process, op by
op (under ``jax.jit`` XLA rewrites ``summed · scale / n`` and the synced
means move by an ulp: 504 of 512 entries of one leaf); the
port's runs in 4 processes of one gloo group (``torch.distributed``,
over a file store and the loopback device), each holding its pod's
gradient tree, made from the same numpy seed.

Tolerances: ``quantize_int8``'s codes equal JAX's except where XLA's
reciprocal rewrite of ``g / scale`` moves a tie of the rounding — an
entry whose ``g / scale`` lies within an ulp of a half-integer, which
may then differ by one code step (such entries are counted; none occur
in these inputs); scales, synced means and residuals are bit for bit.
JAX's own scenario (``tests/test_serve_train.py::
test_compressed_psum_subprocess``) holds as stated there: the mean 2.5
within 5 %, the two rounds' sum within 0.02 of 5.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.optim import dequantize_int8 as jdequantize_int8
from repro.optim import ef_compressed_psum as jef_compressed_psum
from repro.optim import quantize_int8 as jquantize_int8
from repro_torch.launch import cost
from repro_torch.optim import (dequantize_int8, ef_compressed_psum,
                               init_error_feedback, quantize_int8)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4
# an adapter-like gradient tree: name → per-pod shape, magnitude
LEAVES = {"wq.l": ((64, 8), 1e-3), "wq.r": ((8, 96), 3e-2),
          "down.l": ((96, 8), 1.0), "down.r": ((8, 64), 40.0),
          "gscale": ((8,), 1e-6)}

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(d + "/store", world),
                        rank=rank, world_size=world)
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import ef_compressed_psum, init_error_feedback
from repro_torch.train import make_compressed_sync
data = np.load(d + "/in.npz")
tree = {k: torch.from_numpy(data[k][rank]) for k in data.files}
ef = init_error_feedback(tree)
s1, e1 = ef_compressed_psum(tree, ef)
s2, e2 = ef_compressed_psum(tree, e1)
sync = make_compressed_sync(make_mesh((world,), ("pod",), "cpu"))
m1, n1 = sync(tree, ef)
g = torch.full((8,), float(rank + 1))
t1, f1 = ef_compressed_psum(g, torch.zeros(8))
t2, f2 = ef_compressed_psum(g, f1)
out = {}
for tag, t in (("s1", s1), ("e1", e1), ("s2", s2), ("e2", e2), ("m1", m1),
               ("n1", n1)):
    out.update({tag + ":" + k: v.numpy() for k, v in t.items()})
out.update(t1=t1.numpy(), t2=t2.numpy())
np.savez(d + "/out%d.npz" % rank, **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Many small ops: two intra-op threads, as in
    ``tests/test_torch_train.py``; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def pod_inputs(seed=0):
    """{name: (RANKS, *shape) f32}: each pod's gradient leaf."""
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal((RANKS,) + shape) * mag)
            .astype(np.float32) for k, (shape, mag) in LEAVES.items()}


def near_tie(x, scale):
    """Entries whose x / scale sits within an f32 ulp of a half-integer."""
    q = np.float64(x) / np.float64(scale)
    frac = np.abs(q - np.floor(q) - 0.5)
    return frac <= 2 * np.spacing(np.abs(q).astype(np.float32))


def test_quantize_int8_matches_jax():
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    moved = 0
    for i in range(40):
        x = (rng.standard_normal((48, 80))
             * 10.0 ** rng.uniform(-6, 3)).astype(np.float32)
        if i % 4 == 0:                # exact multiples of the scale: ties
            x = np.round(x / np.abs(x).max() * 254) / 2 * np.abs(x).max() \
                / 127
            x = x.astype(np.float32)
        jc, js = jquantize_int8(jnp.asarray(x))
        tc, ts = quantize_int8(torch.from_numpy(x))
        assert tc.dtype == torch.int8 and ts.dtype == torch.float32
        assert float(ts) == float(js)
        diff = np.asarray(jc) != tc.numpy()
        assert np.all(near_tie(x[diff], float(ts))), x[diff]
        assert np.all(np.abs(np.asarray(jc, np.int32)[diff]
                             - tc.numpy().astype(np.int32)[diff]) == 1)
        moved += int(diff.sum())
        np.testing.assert_array_equal(
            np.asarray(jdequantize_int8(jc, js)),
            dequantize_int8(torch.from_numpy(np.array(jc)), ts).numpy())
    assert moved == 0, f"{moved} ties moved by XLA's reciprocal"


@pytest.fixture(scope="module")
def four_ranks():
    """The port's sync over 4 gloo ranks: each rank's outputs."""
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "in.npz"), **pod_inputs())
        env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1",
                   GLOO_SOCKET_IFNAME="lo")
        procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r),
                                   str(RANKS), d], cwd=REPO, env=env,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(RANKS)]
        errs = [p.communicate(timeout=240)[1] for p in procs]
        assert all(p.returncode == 0 for p in procs), "\n".join(errs)[-3000:]
        outs = []
        for r in range(RANKS):
            with np.load(os.path.join(d, f"out{r}.npz")) as z:
                outs.append({k: z[k] for k in z.files})
    return outs


def jax_rounds(inputs):
    import jax
    import jax.numpy as jnp
    tree = {k: jnp.asarray(v) for k, v in inputs.items()}
    run = jax.vmap(lambda g, e: jef_compressed_psum(g, e, axis="pod"),
                   axis_name="pod")
    s1, e1 = run(tree, jax.tree_util.tree_map(jnp.zeros_like, tree))
    s2, e2 = run(tree, e1)
    return {"s1": s1, "e1": e1, "s2": s2, "e2": e2}


def test_ef_compressed_psum_4_ranks_matches_jax(four_ranks):
    want = jax_rounds(pod_inputs())
    for r, out in enumerate(four_ranks):
        for tag, tree in want.items():
            for k in LEAVES:
                np.testing.assert_array_equal(
                    out[f"{tag}:{k}"], np.asarray(tree[k][r]),
                    err_msg=f"rank {r} {tag} {k}")
        # make_compressed_sync over the mesh's pod group: the same
        for k in LEAVES:
            np.testing.assert_array_equal(out[f"m1:{k}"], out[f"s1:{k}"])
            np.testing.assert_array_equal(out[f"n1:{k}"], out[f"e1:{k}"])


def test_ef_compressed_psum_jax_scenario(four_ranks):
    """Every pod sees the mean (2.5); a second round with the residual
    drives the two rounds' sum to 5."""
    for out in four_ranks:
        np.testing.assert_allclose(out["t1"], 2.5, rtol=0.05)
        assert float(np.mean(np.abs(out["t1"] + out["t2"] - 5.0))) < 0.02


def test_residual_closes_the_books(four_ranks):
    """(g + ef) − ef' is what each rank sent: its codes times the scale."""
    inputs = pod_inputs()
    for r, out in enumerate(four_ranks):
        for k in LEAVES:
            g = inputs[k][r]
            sent = g - out[f"e1:{k}"]
            scale = np.abs(inputs[k]).max() / np.float32(127.0)
            np.testing.assert_allclose(sent / scale, np.round(sent / scale),
                                       atol=1e-3)


def test_count_of_one_sync():
    """``cost.count`` of the sync in a world of one (gloo): per leaf, one
    4-byte MAX and one int32 SUM of its codes — all-reduce bytes,
    counted twice in ``collective_bytes``."""
    tree = {k: torch.from_numpy(v[0]) for k, v in pod_inputs().items()}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        got = cost.count(ef_compressed_psum, tree, init_error_feedback(tree))
        synced, _ = ef_compressed_psum(tree, init_error_feedback(tree))
    finally:
        dist.destroy_process_group()
    want = sum(4 + t.numel() * 4 for t in tree.values())
    assert got["coll_by_kind"]["all-reduce"] == want
    assert got["collective_bytes"] == 2 * want
    for k, t in tree.items():      # one rank: the mean is its own
        scale = t.abs().max() / 127.0
        assert float((synced[k] - t).abs().max()) <= 0.5 * float(scale) \
            * (1 + 1e-6), k
