"""Port parity: the sharding rules (``repro_torch.sharding``) against the
JAX package's ``repro.sharding`` on the CPU, and the mesh helpers.

Every buffer of the port's model stands for one leaf of JAX's parameter
tree (``sharding.rules.reference_path``); its spec must be JAX's
``tree_param_specs`` spec for that leaf with the group axis dropped, over
JAX's ``AbstractMesh`` of the same axes. The same holds for the cache,
where the port's head-major cross memory takes JAX's sequence-major spec
transposed (dims 1 and 2 swapped) and MLA's ``lat`` takes the spec of
both ``ckv`` and ``kpe``. Checked for every architecture at reduced width
(fp and quantized containers, single- and multi-pod meshes) and for
qwen1.5-32b, deepseek-moe-16b and whisper-large-v3 at full width
(abstract: fake tensors on the port's side, ``eval_shape`` on JAX's).
Specs are exact: no tolerance.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro.configs import get_config as jget_config
from repro.models import init_lm as jinit_lm
from repro.models.quantize import quantized_abstract as jquantized_abstract
from repro.models.transformer import init_cache as jinit_cache
from repro.sharding import batch_axes as jbatch_axes
from repro.sharding import batch_spec as jbatch_spec
from repro.sharding import spec_for_cache as jspec_for_cache
from repro.sharding import spec_for_param as jspec_for_param
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.specs import (abstract_params, abstract_mode,
                                      quantized_abstract)
from repro_torch.models import init_lm
from repro_torch.models.transformer import init_cache, layer_layout
from repro_torch.sharding import (batch_axes, batch_spec, distribute_model,
                                  placements, spec_for_cache,
                                  tree_cache_specs, tree_param_specs)
from repro_torch.sharding.rules import reference_path

FULL = ("qwen1.5-32b", "deepseek-moe-16b", "whisper-large-v3")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
RANK = 64
CACHE_BATCH = {"reduced": 32, "full": 128}
CACHE_SLOTS = {"reduced": 64, "full": 32_768}


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Many small ops: two intra-op threads, as in
    ``tests/test_torch_train.py``; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jmesh(kind):
    shape, axes = MESHES[kind]
    return AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))


def tmesh(kind):
    shape, axes = MESHES[kind]
    return dict(zip(axes, shape))


def _key(e):
    return e.key if hasattr(e, "key") else e.idx


def jax_specs(tree, fn):
    """{path tuple: spec tuple} of a JAX tree under ``fn(path, leaf)``."""
    return {tuple(_key(e) for e in path): tuple(fn(path, leaf))
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def jax_params(arch, size, container):
    jcfg = jget_config(arch)
    jcfg = jcfg.reduced() if size == "reduced" else jcfg
    absp = jax.eval_shape(lambda k: jinit_lm(k, jcfg, dtype=jnp.bfloat16),
                          jax.random.PRNGKey(0))
    return jquantized_abstract(absp, rank=RANK) if container == "quant" \
        else absp


def port_params(arch, size, container):
    cfg = get_config(arch)
    cfg = cfg.reduced() if size == "reduced" else cfg
    mode = abstract_mode()
    model = abstract_params(cfg, mode=mode)
    if container == "quant":
        model = quantized_abstract(model, RANK, mode=mode)
    return cfg, model


def check_param_specs(arch, size, container, mesh):
    cfg, model = port_params(arch, size, container)
    jparams = jax_params(arch, size, container)
    want = jax_specs(jparams, lambda path, x: jspec_for_param(
        path, x.shape, jmesh(mesh)))
    got = tree_param_specs(model, tmesh(mesh))
    seen = set()
    for name, spec in got.items():
        path, stacked = reference_path(cfg, name)
        assert path in want, (name, path)
        ref = want[path][1:] if stacked else want[path]
        assert spec == ref, (name, spec, ref)
        seen.add(path)
    assert seen == set(want), set(want) - seen


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("container", ["fp", "quant"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_jax_reduced(arch, container, mesh):
    check_param_specs(arch, "reduced", container, mesh)


@pytest.mark.parametrize("container", ["fp", "quant"])
@pytest.mark.parametrize("arch", FULL)
def test_param_specs_match_jax_full_width(arch, container):
    check_param_specs(arch, "full", container, "single")


def jax_cache_path(cfg, i, key):
    """(path, stacked) of layer ``i``'s cache leaf in JAX's tree."""
    n_prefix, n_groups, _ = layer_layout(cfg)
    period = len(cfg.block_pattern)
    if i < n_prefix:
        return ("prefix", i, key), False
    j = i - n_prefix
    if j < n_groups * period:
        return ("groups", f"p{j % period}", key), True
    return ("suffix", j - n_groups * period, key), False


@pytest.mark.parametrize("size,arch", [("reduced", a) for a in sorted(ARCHS)]
                         + [("full", a) for a in FULL])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_specs_match_jax(arch, size, mesh):
    cfg = get_config(arch)
    jcfg = jget_config(arch)
    if size == "reduced":
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    b, s = CACHE_BATCH[size], CACHE_SLOTS[size]
    with abstract_mode():
        cache = init_cache(cfg, b, s, torch.int8, "cpu")
    jcache = jax.eval_shape(lambda: jinit_cache(jcfg, b, s, dtype=jnp.int8))
    want = jax_specs(jcache, lambda path, x: jspec_for_cache(
        path, x.shape, jmesh(mesh), b))
    got = tree_cache_specs(cache, tmesh(mesh), b, cfg)
    seen = set()
    for i, layer in enumerate(got):
        for key, spec in layer.items():
            for jkey in (("ckv", "kpe") if key == "lat" else (key,)):
                path, stacked = jax_cache_path(cfg, i, jkey)
                ref = want[path][1:] if stacked else want[path]
                if key in ("cross_k", "cross_v"):     # (B, S, KV, hd) in JAX
                    ref = (ref[0], ref[2], ref[1], ref[3])
                assert spec == ref, (i, key, spec, ref)
                seen.add(path)
    assert seen == set(want), set(want) - seen


# ---------------------------------------------------------------------------
# JAX's own rule tests (tests/test_infra.py), on the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FULL)
def test_param_specs_cover_and_divide(arch):
    _, model = port_params(arch, "full", "fp")
    mesh = tmesh("single")
    specs = tree_param_specs(model, mesh)
    assert set(specs) == {n for n, _ in model.named_buffers()}
    for name, t in model.named_buffers():
        spec = specs[name]
        assert len(spec) == t.ndim
        for dim, ax in zip(t.shape, spec):
            if ax is None:
                continue
            n = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n *= mesh[a]
            assert dim % n == 0, (name, tuple(t.shape), spec)


def test_expert_parallelism_claims_model_axis():
    _, model = port_params("deepseek-moe-16b", "full", "fp")
    specs = tree_param_specs(model, tmesh("single"))
    seen = False
    for name, spec in specs.items():
        if "experts" in name.split(".") and name.endswith(".w"):
            assert "model" in spec, (name, spec)
            # within-expert dims must not reuse the model axis
            assert spec.count("model") == 1
            seen = True
    assert seen


def test_batch_spec_adapts_to_small_batches():
    mesh = tmesh("single")
    assert batch_axes(mesh, 256) == ("data",)
    assert batch_axes(mesh, 1) == ()
    assert batch_spec(mesh, 1, 1) == (None, None)
    for kind in MESHES:
        for b in (1, 2, 16, 32, 128, 256):
            assert batch_axes(tmesh(kind), b) == jbatch_axes(jmesh(kind), b)
            assert batch_spec(tmesh(kind), b, 2) == tuple(
                jbatch_spec(jmesh(kind), b, 2))


def test_cache_spec_heads_else_sequence():
    """Divisible KV heads take the model axis; otherwise the SEQUENCE dim
    does. The port's cross memory is head-major (B, KV, S, hd): its KV
    dim (1) takes the axis where JAX's sequence-major memory's KV dim (2)
    does."""
    mesh = tmesh("single")
    spec2 = spec_for_cache("k", (128, 32, 32768, 128), mesh, 128)
    assert spec2[1] == "model" and spec2[2] is None   # heads preferred
    spec = spec_for_cache("k", (128, 40, 32768, 128), mesh, 128)
    assert spec[2] == "model"                         # S fallback (40 ∤ 16)
    assert spec[1] is None and spec[3] is None
    xspec = spec_for_cache("cross_k", (128, 32, 1500, 128), mesh, 128)
    assert xspec[1] == "model" and xspec[2] is None   # KV dim, head-major
    xspec = spec_for_cache("cross_k", (128, 20, 1504, 64), mesh, 128)
    assert xspec[2] == "model" and xspec[1] is None   # S fallback (20 ∤ 16)


# ---------------------------------------------------------------------------
# placements and distribution over a fake 256/512-chip world
# ---------------------------------------------------------------------------
def test_batch_over_pod_and_data_splits_pod_major():
    """A (B, S) batch over ('pod', 'data') on (2, 16, 16): chip (p, d, m)
    holds rows [(16p + d)·B/32, …), pod the major axis, as JAX splits
    P(('pod', 'data'))."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset as local_of
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        pl = placements(batch_spec(mesh, 128, 1), mesh)
    for p, d, m in ((0, 0, 0), (0, 5, 3), (1, 0, 7), (1, 15, 15)):
        shape, offset = local_of((128, 64), (2, 16, 16), [p, d, m], pl)
        assert shape == (4, 64)
        assert offset == ((16 * p + d) * 4, 0)
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        with pytest.raises(ValueError, match="order"):
            placements(((("data", "pod")), None), mesh)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "deepseek-moe-16b",
                                  "whisper-large-v3"])
def test_distribute_model_local_shapes(arch):
    """Every buffer of the reduced model (with ``min_shard`` 16, so its
    narrow dims shard too) as a DTensor on the fake (16, 16) mesh: the
    global shape kept, the local shape the global one over the axis
    sizes, and rank 0's block the leading slice of each sharded dim. The
    abstract model (fake tensors, built from each rank's local block)
    gets the same local shapes."""
    cfg = get_config(arch).reduced()
    model = init_lm(cfg, 0, device="cpu")
    ref = {n: t.clone() for n, t in model.named_buffers()}
    fake = abstract_params(cfg, torch.float32)
    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        specs = tree_param_specs(model, mesh, min_shard=16)
        assert any(a is not None for s in specs.values() for a in s)
        distribute_model(model, mesh, min_shard=16)
        distribute_model(fake, mesh, min_shard=16)
        fakes = dict(fake.named_buffers())
        for name, t in model.named_buffers():
            want = ref[name]
            for d, ax in enumerate(specs[name]):
                if ax is not None:
                    want = want.narrow(d, 0, want.shape[d] // 16)
            assert tuple(t.shape) == tuple(ref[name].shape), name
            assert torch.equal(t.to_local(), want), name
            assert fakes[name].to_local().shape == want.shape, name
            assert fakes[name].shape == t.shape, name
