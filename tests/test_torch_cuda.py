"""Card-only checks of the CUDA kernels (skip without a card): each
kernel against its plain version on the card (K5 on a shuffled block
table, K4 also at the chunk shape and where whole key tiles are dead,
K3/K4 also at head_dim 128, K3/K5 across split boundaries and at groups
of up to 16 query heads a KV head, K3 at MLA's latent head (576 wide, V
its first 512 columns, scale override), K3 and K4 at head dim 256
(recurrentgemma-9b's local layers: one KV head, G = 16; K3 over the four
cache types and a wrapped ring, K4 under a window), K1/K2 at
xlstm-125m's shapes (the 1536×8 ``w_if`` at rank 4, and an N that is not
a multiple of 4, run widened by ``pad_cols``), whisper-large-v3's (K4
non-causal at head dim 64 over 1500 keys, K3 at hd 64 over its self cache
and its 1500-slot cross memory, K1/K2 at its projections up to 1500
rows), K6 over an
expert stack with and without counts, K7 bit for bit), and each wrapper
raising on input the kernel does not take (K1/K2 also on an operand that
requires grad: the kernels have no backward).

Run on a machine with an H100: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``. Tolerances: the kernels sum in another
order than the plain versions (split-K partials, tiled online softmax),
so f32 results agree to 1e-4 relative to the output scale; bf16 outputs
to one bf16 ulp (2^-8) of it.
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import mxint_matmul as mk
from repro_torch.kernels import mxint_quantize as kq
from repro_torch.kernels.constraints import (DECODE_LATENT_BLOCKS_PER_SM,
                                             DECODE_MAX_GROUP,
                                             DECODE_TILE_SLOTS,
                                             QLR_FUSED_MAX_ROWS)
from repro_torch.quant.mxint import MXIntQuantizer, pack_codes_4bit

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, rel):
    scale = max(1.0, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * scale, (err, scale)


def _qlr(dev, m, k, n, r, packed, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev)
    q = MXIntQuantizer(bits=3).quantize(
        torch.randn((k, n), generator=g, device=dev) * 0.05)
    codes = pack_codes_4bit(q.codes) if packed else q.codes
    scale = torch.exp2(q.exponents.float()).contiguous()
    l = torch.randn((k, r), generator=g, device=dev) * 0.1
    rr = torch.randn((r, n), generator=g, device=dev) * 0.1
    return x, codes, scale, l, rr


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m,r", [(8, 16), (3, 0), (100, 16), (256, 16),
                                 (200, 0)])
def test_qlr_kernels_match_plain(dev, packed, m, r):
    x, codes, scale, l, rr = _qlr(dev, m, 1024, 384, r, packed, seed=m + r)
    want = mk.qlr_matmul_plain(x, codes, scale, l, rr)
    _close(mk.qlr_matmul(x, codes, scale, l, rr), want, 1e-4)
    _close(mk.qlr_matmul(x.bfloat16(), codes, scale, l, rr),
           mk.qlr_matmul_plain(x.bfloat16(), codes, scale, l, rr), 2 ** -8)


def test_qlr_wrapper_raises(dev):
    x, codes, scale, l, rr = _qlr(dev, 8, 256, 128, 8, False)
    with pytest.raises(TypeError):
        mk.qlr_fused_matmul(x.double(), codes, scale, l, rr)
    with pytest.raises(ValueError):
        mk.qlr_fused_matmul(x, codes.cpu(), scale, l, rr)
    with pytest.raises(ValueError):
        mk.qlr_fused_matmul(x, codes.t().contiguous().t(), scale, l, rr)
    with pytest.raises(ValueError):
        mk.qlr_fused_matmul(x[:, :128], codes, scale, l, rr)


@pytest.mark.parametrize("m", [8, 256])
def test_qlr_wrapper_raises_on_misaligned_r(dev, m):
    """R 4 bytes off a 16-byte boundary (the decode tiles copy it in 16-byte
    chunks) raises before a launch, and the card runs the next call."""
    x, codes, scale, l, rr = _qlr(dev, m, 256, 128, 8, False)
    r_off = torch.empty(rr.numel() + 1, device=dev)[1:].view(rr.shape)
    r_off.copy_(rr)
    assert r_off.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        mk.qlr_matmul(x, codes, scale, l, r_off)
    _close(mk.qlr_matmul(x, codes, scale, l, rr),
           mk.qlr_matmul_plain(x, codes, scale, l, rr), 1e-4)


def _qlr_kernel(x, codes, scale, l, rr):
    """K1 or K2 as ``qlr_matmul`` picks them, returning the kernel's f32 y
    for either x dtype."""
    if x.shape[0] <= QLR_FUSED_MAX_ROWS:
        return mk.qlr_fused_matmul(x, codes, scale, l, rr)
    return mk.qlr_xl_matmul(x, codes, scale, x.float() @ l, rr)


# K = 1056: 33 MXINT blocks, a short last K split; N = 200: a partial
# column tile whose code rows are not 16-byte aligned (4-byte copies)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", [1, 8, 64, 128, 129, 256])
def test_qlr_tensor_core_rows(dev, packed, m):
    x, codes, scale, l, rr = _qlr(dev, m, 1056, 200, 16, packed, seed=m)
    for xx in (x, x.bfloat16()):
        _close(_qlr_kernel(xx, codes, scale, l, rr),
               mk.qlr_matmul_plain(xx, codes, scale, l, rr), 1e-4)


@pytest.mark.parametrize("m,k,n", [(8, 2048, 64), (8, 10944, 256),
                                   (8, 1056, 4112), (256, 3072, 384)])
def test_qlr_serving_shapes(dev, m, k, n):
    """The MoE router (N = 64), deepseek's dense down projection (K =
    10944: 342 MXINT blocks, 8 splits of 43, the last of 41), the
    128-column decode tile (N >= 4096; 4112 leaves a partial tile) and a
    split prefill tile."""
    x, codes, scale, l, rr = _qlr(dev, m, k, n, 16, False, seed=k)
    for xx in (x, x.bfloat16()):
        _close(_qlr_kernel(xx, codes, scale, l, rr),
               mk.qlr_matmul_plain(xx, codes, scale, l, rr), 1e-4)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", [8, 256])
@pytest.mark.parametrize("k,n,r", [(1536, 8, 4), (1536, 1536, 16),
                                   (1024, 768, 16), (96, 85, 16),
                                   (768, 1023, 4)])
def test_qlr_xlstm_shapes(dev, packed, m, k, n, r):
    """xlstm-125m's ``w_if`` (8 columns at rank 4: a partial 16-rank x·L
    tile, 8 live columns of the router tile, 8-byte code rows), two of its
    wider projections, and N = 85 (the reduced sLSTM FFN) and 1023, which
    the launchers run widened to a multiple of 4 and slice back; one
    launch a call either way."""
    x, codes, scale, l, rr = _qlr(dev, m, k, n, r, packed, seed=n + r)
    key = "qlr_fused" if m <= QLR_FUSED_MAX_ROWS else "qlr"
    for xx in (x, x.bfloat16()):
        before = mk.LAUNCHES[key]
        got = mk.qlr_matmul(xx, codes, scale, l, rr)
        assert mk.LAUNCHES[key] == before + 1 and got.shape == (m, n)
        _close(got, mk.qlr_matmul_plain(xx, codes, scale, l, rr),
               1e-4 if xx.dtype == torch.float32 else 2 ** -8)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", [8, 256])
def test_qlr_extreme_exponents(dev, packed, m):
    """Blocks at MXINT's exponent clip ends, with scales made as the port
    makes them (``torch.exp2`` of the exponents on the card); at +127 only
    codes of magnitude <= 1 keep the weight finite, and x is small enough
    for y to stay finite. Held at 1e-4 of each case's own output scale."""
    g = torch.Generator(device=dev).manual_seed(m)
    k, n = 256, 128
    for e in (-127, -126, 127):
        lim = 1 if e > 0 else 4
        c = torch.randint(-lim, lim, (k, n), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int8)
        exps = torch.full((k // 32, n), e, device=dev)
        exps[1::2] = 0 if e < 0 else 100       # a mix with ordinary blocks
        scale = torch.exp2(exps.float()).contiguous()
        codes = pack_codes_4bit(c) if packed else c
        x = torch.randn((m, k), generator=g, device=dev) \
            * (2.0 ** -40 if e > 0 else 1.0)
        l = torch.zeros((k, 0), device=dev)
        rr = torch.zeros((0, n), device=dev)
        want = mk.qlr_matmul_plain(x, codes, scale, l, rr)
        got = _qlr_kernel(x, codes, scale, l, rr)
        assert bool(torch.isfinite(want).all())
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), (e, err)


@pytest.mark.parametrize("m,k,n", [(8, 3072, 1024), (8, 2048, 64),
                                   (8, 2048, 4096), (64, 1056, 200),
                                   (256, 3072, 384)])
def test_qlr_repeat_is_bit_identical(dev, m, k, n):
    """The split-K sum runs in a fixed order: two calls on the same inputs
    give the same bits."""
    x, codes, scale, l, rr = _qlr(dev, m, k, n, 16, False, seed=3)
    a = mk.qlr_matmul(x, codes, scale, l, rr)
    b = mk.qlr_matmul(x, codes, scale, l, rr)
    assert mk.qlr_plan(m, k, n)[1] > 1           # the case is split
    assert torch.equal(a, b)


@pytest.mark.parametrize("m", [8, 256])
def test_qlr_one_launch_per_call(dev, m):
    """Each qlr_matmul call adds one to its LAUNCHES entry and launches
    one K1/K2 kernel (K1's call launches nothing else; K2's wrapper also
    runs the x·L matmul)."""
    from torch.profiler import ProfilerActivity, profile
    x, codes, scale, l, rr = _qlr(dev, m, 1024, 384, 16, False)
    mk.qlr_matmul(x, codes, scale, l, rr)             # built and warm
    torch.cuda.synchronize()
    key = "qlr_fused" if m <= QLR_FUSED_MAX_ROWS else "qlr"
    before = mk.LAUNCHES[key]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mk.qlr_matmul(x, codes, scale, l, rr)
        torch.cuda.synchronize()
    assert mk.LAUNCHES[key] == before + 1
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = [k_ for k_ in kernels if "qlr_tc_kernel" in k_]
    assert len(ours) == 1, kernels
    if key == "qlr_fused":
        assert kernels == ours, kernels


def _cache(dev, kind, b=8, kvh=4, g=2, s=200, hd=96, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, kvh, g, hd), generator=gen, device=dev)
    k = torch.randn((b, kvh, s, hd), generator=gen, device=dev)
    v = torch.randn((b, kvh, s, hd), generator=gen, device=dev)
    ks = vs = None
    if kind in ("int8", "int4"):
        qmax = 127 if kind == "int8" else 7
        ks = k.abs().amax(-1).clamp_min(1e-8) / qmax
        vs = v.abs().amax(-1).clamp_min(1e-8) / qmax
        k = torch.round(k / ks[..., None]).clamp(-qmax, qmax).to(torch.int8)
        v = torch.round(v / vs[..., None]).clamp(-qmax, qmax).to(torch.int8)
        if kind == "int4":
            k, v = pack_codes_4bit(k), pack_codes_4bit(v)
    elif kind == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    q_pos = torch.arange(b, device=dev, dtype=torch.int32) * 20 + 30
    k_pos = torch.arange(s, device=dev, dtype=torch.int32).repeat(b, 1)
    k_pos[1, 100:] = -1
    k_pos[2] = -1                                     # empty row → zeros
    return q, k, v, q_pos, k_pos, ks, vs


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("window", [0, 50])
def test_flash_decode_matches_plain(dev, kind, window):
    q, k, v, q_pos, k_pos, ks, vs = _cache(dev, kind)
    want = dk.decode_attention_plain(q, k, v, q_pos, k_pos, ks, vs, window)
    got = dk.decode_attention_op(q, k, v, q_pos, k_pos, k_scale=ks,
                                 v_scale=vs, window=window)
    _close(got, want, 1e-4)
    assert torch.all(got[2] == 0)


def _paged(dev, kind, b=4, kvh=4, g=2, hd=96, ps=16, nb=8, pages=40, seed=0):
    """Page pools with a shuffled block table and ragged positions."""
    q, k, v, _, _, ks, vs = _cache(dev, kind, b=pages, kvh=kvh, g=g, s=ps,
                                   hd=hd, seed=seed)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    bt = torch.randperm(pages, generator=gen)[:b * nb].reshape(b, nb)
    q_pos = torch.tensor([5, 40, 77, ps * nb - 1][:b], dtype=torch.int32)
    k_pos = torch.arange(nb * ps, dtype=torch.int32).repeat(b, 1)
    return (q[:b], k, v, q_pos.to(dev), k_pos.to(dev),
            bt.to(torch.int32).to(dev), ks, vs)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("g,window", [(1, 0), (2, 0), (2, 30), (3, 0),
                                      (16, 30)])
def test_flash_decode_paged_matches_plain(dev, kind, g, window):
    q, k, v, q_pos, k_pos, bt, ks, vs = _paged(dev, kind, g=g)
    want = dk.decode_attention_paged_plain(q, k, v, q_pos, k_pos, bt, ks, vs,
                                           window)
    before = dk.LAUNCHES["flash_decode_paged"]
    got = dk.decode_attention_op(q, k, v, q_pos, k_pos, k_scale=ks,
                                 v_scale=vs, window=window, block_table=bt)
    assert dk.LAUNCHES["flash_decode_paged"] == before + 1
    _close(got, want, 1e-4)


def test_flash_decode_paged_wrapper_raises(dev):
    q, k, v, q_pos, k_pos, bt, ks, vs = _paged(dev, "int8")
    with pytest.raises(ValueError):
        dk.flash_decode_paged(q, k, v, q_pos, k_pos, bt)      # scales missing
    with pytest.raises(ValueError):
        dk.flash_decode_paged(q, k, v, q_pos, k_pos[:, :-16], bt, ks, vs)
    with pytest.raises(ValueError):
        dk.flash_decode_paged(q, k[:, :, :15], v[:, :, :15], q_pos,
                              k_pos[:, :120], bt, ks[..., :15], vs[..., :15])
    odd = torch.empty(k.numel() + 1, dtype=k.dtype, device=dev)[1:]
    with pytest.raises(ValueError):                     # misaligned pool
        dk.flash_decode_paged(q, odd.view(k.shape), v, q_pos, k_pos, bt, ks,
                              vs)


def test_flash_attention_chunk_shape(dev):
    """K4 in chunk mode: a chunk of Sq queries at positions [start,
    start+Sq) over [stored context ‖ chunk], the context slots at and
    above start masked by k_pos = -1."""
    gen = torch.Generator(device=dev).manual_seed(3)
    sq, ctx, start, h, hd = 64, 128, 80, 4, 96
    q = torch.randn((1, sq, h, 1, hd), generator=gen, device=dev)
    k = torch.randn((1, ctx + sq, h, hd), generator=gen, device=dev)
    v = torch.randn((1, ctx + sq, h, hd), generator=gen, device=dev)
    q_pos = torch.arange(start, start + sq, dtype=torch.int32, device=dev)
    slots = torch.arange(ctx, dtype=torch.int32, device=dev)
    k_pos = torch.cat([torch.where(slots < start, slots, -1), q_pos])
    want = fk.flash_attention_plain(q, k, v, q_pos, k_pos)
    _close(fk.flash_attention(q, k, v, q_pos, k_pos), want, 1e-4)


def test_flash_decode_wrapper_raises(dev):
    q, k, v, q_pos, k_pos, ks, vs = _cache(dev, "int8")
    with pytest.raises(ValueError):
        dk.flash_decode(q, k, v, q_pos, k_pos)           # scales missing
    wide = q[:, :, :1].expand(-1, -1, DECODE_MAX_GROUP + 1, -1).contiguous()
    with pytest.raises(ValueError, match="exceeds"):     # G over the cap
        dk.flash_decode(wide, k, v, q_pos, k_pos, ks, vs)
    with pytest.raises(TypeError):
        dk.flash_decode(q.half(), k, v, q_pos, k_pos, ks, vs)
    with pytest.raises(ValueError):
        dk.flash_decode(q, k.cpu(), v, q_pos, k_pos, ks, vs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,window", [(1, 0), (2, 0), (2, 40)])
def test_flash_attention_matches_plain(dev, dtype, g, window):
    gen = torch.Generator(device=dev).manual_seed(g + window)
    b, s, kvh, hd = 2, 150, 4, 96
    q = torch.randn((b, s, kvh, g, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kvh, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kvh, hd), generator=gen, device=dev).to(dtype)
    pos = torch.arange(s, device=dev, dtype=torch.int32)
    want = fk.flash_attention_plain(q, k, v, pos, pos, True, window)
    got = fk.flash_attention(q, k, v, pos, pos, causal=True, window=window)
    _close(got, want, 1e-4 if dtype == torch.float32 else 2 ** -8)


def test_flash_attention_wrapper_raises(dev):
    q = torch.randn((1, 8, 2, 1, 96), device=dev)
    k = torch.randn((1, 8, 2, 96), device=dev)
    pos = torch.arange(8, device=dev, dtype=torch.int32)
    with pytest.raises(TypeError):
        fk.flash_attention_cuda(q, k.bfloat16(), k, pos, pos)
    with pytest.raises(ValueError):
        fk.flash_attention_cuda(q[..., :90], k[..., :90], k[..., :90], pos, pos)
    with pytest.raises(ValueError):
        fk.flash_attention_cuda(q.transpose(1, 2), k, k, pos, pos)


def _stack(dev, e, m, k, n, r, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((e, m, k), generator=g, device=dev)
    q = MXIntQuantizer(bits=3).quantize(
        torch.randn((e * k, n), generator=g, device=dev) * 0.05)
    codes = q.codes.reshape(e, k, n)
    scale = torch.exp2(q.exponents.float()).reshape(e, k // 32, n)
    l = torch.randn((e, k, r), generator=g, device=dev) * 0.1
    rr = torch.randn((e, r, n), generator=g, device=dev) * 0.1
    return x, codes, scale, l, rr


def _past_counts(x, counts):
    """Row mask (E, M) of the rows at or past each entry's count."""
    rows = torch.arange(x.shape[1], device=x.device)
    return rows[None, :] >= counts.long().clamp(0, x.shape[1])[:, None]


@pytest.mark.parametrize("m,r", [(1, 16), (8, 16), (8, 0), (30, 16), (45, 8)])
def test_qlr_batched_matches_plain(dev, m, r):
    # K = 1088: 34 MXINT blocks, so the last stage is short; N = 200: a
    # narrow last column tile
    x, codes, scale, l, rr = _stack(dev, 6, m, 1088, 200, r, seed=m + r)
    want = mk.qlr_matmul_batched_plain(x, codes, scale, l, rr)
    before = mk.LAUNCHES["qlr_batched"]
    _close(mk.qlr_matmul_batched(x, codes, scale, l, rr), want, 1e-4)
    assert mk.LAUNCHES["qlr_batched"] == before + 1
    _close(mk.qlr_matmul_batched(x.bfloat16(), codes, scale, l, rr),
           mk.qlr_matmul_batched_plain(x.bfloat16(), codes, scale, l, rr),
           2 ** -8)
    # counts: experts with no token, partial queues and full ones
    counts = torch.tensor([0, m, m // 2, 0, max(m - 1, 0), m],
                          dtype=torch.int32, device=dev)
    xz = x.masked_fill(_past_counts(x, counts)[..., None], 0.0)
    want = mk.qlr_matmul_batched_plain(xz, codes, scale, l, rr, counts)
    got = mk.qlr_matmul_batched(xz, codes, scale, l, rr, counts)
    _close(got, want, 1e-4)
    assert not got[_past_counts(x, counts)].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [8, 30])
def test_qlr_batched_counts(dev, dtype, m):
    """K6 with counts on f32 and bf16 x, K = 1088 (a short last stage), N
    = 200 (a narrow tile): one launch a call, rows past the counts exactly
    0 (x there is not zero, so nothing past a count is computed), counts
    out of [0, M] clamped."""
    x, codes, scale, l, rr = _stack(dev, 8, m, 1088, 200, 16, seed=m)
    x = x.to(dtype)
    counts = torch.tensor([0, 1, m // 2, m, 9, -3, m + 5, 0],
                          dtype=torch.int32, device=dev)
    want = mk.qlr_matmul_batched_plain(x, codes, scale, l, rr, counts)
    before = mk.LAUNCHES["qlr_batched"]
    got = mk.qlr_batched_matmul_cuda(x, codes, scale, l, rr, counts)
    assert mk.LAUNCHES["qlr_batched"] == before + 1
    _close(got, want, 1e-4 if dtype == torch.float32 else 2 ** -8)
    past = _past_counts(x, counts)
    assert past.any() and not got[past].any()
    assert got[~past].abs().max() > 0


def test_qlr_batched_wrapper_raises(dev):
    x, codes, scale, l, rr = _stack(dev, 4, 8, 256, 128, 8)
    counts = torch.full((4,), 8, dtype=torch.int32, device=dev)
    packed = pack_codes_4bit(codes.reshape(-1, 128)).reshape(4, 128, 128)
    with pytest.raises(TypeError):                      # packed4 codes
        mk.qlr_batched_matmul_cuda(x, packed, scale, l, rr)
    with pytest.raises(ValueError):                     # wrong stack shape
        mk.qlr_batched_matmul_cuda(x, codes[:3], scale, l, rr)
    with pytest.raises(ValueError):
        mk.qlr_batched_matmul_cuda(x[:, :, :128], codes, scale, l, rr)
    with pytest.raises(ValueError):
        mk.qlr_batched_matmul_cuda(x.transpose(1, 2).contiguous()
                                   .transpose(1, 2), codes, scale, l, rr)
    with pytest.raises(ValueError):
        mk.qlr_batched_matmul_cuda(x, codes.cpu(), scale, l, rr)
    with pytest.raises(ValueError):                     # l of another rank
        mk.qlr_batched_matmul_cuda(x, codes, scale, l[..., :4], rr)
    with pytest.raises(TypeError):                      # counts' dtype
        mk.qlr_batched_matmul_cuda(x, codes, scale, l, rr, counts.long())
    with pytest.raises(ValueError):                     # counts' shape
        mk.qlr_batched_matmul_cuda(x, codes, scale, l, rr, counts[:3])
    with pytest.raises(ValueError):                     # counts' device
        mk.qlr_batched_matmul_cuda(x, codes, scale, l, rr, counts.cpu())
    r_off = torch.empty(rr.numel() + 1, device=dev)[1:].view(rr.shape)
    r_off.copy_(rr)
    assert r_off.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):    # R off 16 bytes
        mk.qlr_batched_matmul_cuda(x, codes, scale, l, r_off, counts)
    # the card runs the next call
    _close(mk.qlr_batched_matmul_cuda(x, codes, scale, l, rr, counts),
           mk.qlr_matmul_batched_plain(x, codes, scale, l, rr, counts), 1e-4)


def _quantize_input(dev, m, n, seed, offset=0):
    """(m, n) f32 weights with K7's hard blocks: all-zero blocks (also in
    the last columns), amax / qmax = 2^-13 at bits 3 and one ulp above,
    subnormal-range blocks; ``offset`` floats into a fresh buffer (1: a
    contiguous view aligned to 4 bytes, not 16)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randn((m * n + offset,), generator=g, device=dev) * 0.05
    w = buf[offset:].view(m, n)
    w[:32, :9] = 0.0                                    # all-zero blocks
    w[-32:, -3:] = 0.0
    b = 32 if m > 32 else 0                             # a second block
    w[b:b + 32, 10 % n] = 0.0
    w[b, 10 % n] = 3.0 * 2.0 ** -13                     # amax / qmax = 2^-13
    w[b:b + 32, 11 % n] = 0.0
    w[b, 11 % n] = torch.nextafter(torch.tensor(3.0 * 2.0 ** -13),
                                   torch.tensor(1.0)).item()
    w[b:, 12 % n] *= 1e-30
    return w


# the SRR pass's shapes (phi3-mini-3.8b, deepseek-moe-16b; the router's
# 2048×64 takes the scalar path), an N below a multiple of 128, N % 4 != 0
# (the scalar path), a narrow matrix
K7_SHAPES = [(3072, 3072), (3072, 8192), (8192, 3072), (2048, 2048),
             (2048, 64), (2048, 1408), (1408, 2048), (2048, 2816),
             (2816, 2048), (2048, 10944), (10944, 2048), (2048, 1000),
             (2048, 1002), (64, 40)]


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m,n,offset", [(m, n, 0) for m, n in K7_SHAPES]
                         + [(2048, 1408, 1), (64, 40, 1)])
def test_mxint_quantize_bit_exact(dev, bits, m, n, offset):
    """K7 equals its plain version bit for bit, in one launch, at every
    pass shape, ragged N and a misaligned (4-byte aligned) view."""
    w = _quantize_input(dev, m, n, bits, offset)
    assert w.is_contiguous() and (w.data_ptr() % 16 != 0) == bool(offset)
    before = kq.LAUNCHES["mxint_quantize"]
    shaped = kq.LAUNCH_SHAPES[(m, n)]
    codes, exps = kq.mxint_quantize(w, bits)
    assert kq.LAUNCHES["mxint_quantize"] == before + 1
    assert kq.LAUNCH_SHAPES[(m, n)] == shaped + 1
    want_c, want_e = kq.mxint_quantize_plain(w, bits)
    assert torch.equal(codes, want_c) and torch.equal(exps, want_e)
    if m * n <= 2048 * 1408:
        cpu_c, cpu_e = kq.mxint_quantize_plain(w.cpu(), bits)
        assert torch.equal(codes.cpu(), cpu_c)
        assert torch.equal(exps.cpu(), cpu_e)


def test_quantizer_runs_k7_on_the_card(dev):
    w = torch.randn((70, 96), device=dev)
    before = kq.LAUNCHES["mxint_quantize"]
    q = MXIntQuantizer(bits=3).quantize(w)
    assert kq.LAUNCHES["mxint_quantize"] == before + 1
    ref = MXIntQuantizer(bits=3).quantize(w.cpu())
    assert torch.equal(q.codes.cpu(), ref.codes)
    assert torch.equal(q.exponents.cpu(), ref.exponents)


def test_mxint_quantize_wrapper_raises(dev):
    w = torch.randn((64, 40), device=dev)
    with pytest.raises(TypeError):
        kq.mxint_quantize_cuda(w.double(), 3)
    with pytest.raises(ValueError):
        kq.mxint_quantize_cuda(w.t(), 3)                # not contiguous
    with pytest.raises(ValueError):
        kq.mxint_quantize_cuda(w[:40], 3)               # rows not padded
    with pytest.raises(ValueError):
        kq.mxint_quantize_cuda(w, 9)
    with pytest.raises(ValueError):
        kq.mxint_quantize(w, 3, block=16)


def test_attention_kernels_at_head_dim_128(dev):
    """deepseek-moe-16b's head_dim (the kernels' limit), G = 1."""
    q, k, v, q_pos, k_pos, _, _ = _cache(dev, "bf16", kvh=16, g=1, hd=128)
    _close(dk.decode_attention_op(q, k, v, q_pos, k_pos),
           dk.decode_attention_plain(q, k, v, q_pos, k_pos), 1e-4)
    gen = torch.Generator(device=dev).manual_seed(128)
    qf = torch.randn((1, 256, 16, 1, 128), generator=gen, device=dev)
    kf = torch.randn((1, 256, 16, 128), generator=gen, device=dev)
    vf = torch.randn((1, 256, 16, 128), generator=gen, device=dev)
    pos = torch.arange(256, device=dev, dtype=torch.int32)
    _close(fk.flash_attention(qf, kf, vf, pos, pos, causal=True),
           fk.flash_attention_plain(qf, kf, vf, pos, pos, True), 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [96, 128])
@pytest.mark.parametrize("case", ["causal", "chunk", "window"])
def test_flash_attention_dead_tiles(dev, dtype, hd, case):
    """K4 where whole key tiles hold no valid pair, at G = 2: a causal
    prefill of 200 rows (not a multiple of the query tile), a chunk of
    100 queries from start 131 (off a tile boundary) over 256 stored
    slots, and a 300-row prefill under a 40-token window (the leading key
    tiles of the late query tiles are dead)."""
    gen = torch.Generator(device=dev).manual_seed(hd)
    kvh, g, window = 2, 2, 0
    if case == "chunk":
        sq, ctx, start = 100, 256, 131
        q_pos = torch.arange(start, start + sq, dtype=torch.int32, device=dev)
        slots = torch.arange(ctx, dtype=torch.int32, device=dev)
        k_pos = torch.cat([torch.where(slots < start, slots, -1), q_pos])
    else:
        sq = 200 if case == "causal" else 300
        window = 40 if case == "window" else 0
        q_pos = k_pos = torch.arange(sq, dtype=torch.int32, device=dev)
    sk = k_pos.shape[0]
    q = torch.randn((1, sq, kvh, g, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((1, sk, kvh, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((1, sk, kvh, hd), generator=gen, device=dev).to(dtype)
    want = fk.flash_attention_plain(q, k, v, q_pos, k_pos, True, window)
    before = fk.LAUNCHES["flash_attention"]
    got = fk.flash_attention(q, k, v, q_pos, k_pos, causal=True,
                             window=window)
    assert fk.LAUNCHES["flash_attention"] == before + 1
    _close(got, want, 1e-4 if dtype == torch.float32 else 2 ** -8)


def _to_pages(x, bt, ps):
    """Scatter a head-major (B, KV, S', ...) tensor into a pool of pages
    (P, KV, ps', ...) along the shuffled table ``bt`` (B, nb)."""
    b, kvh, nb = x.shape[0], x.shape[1], bt.shape[1]
    per = x.shape[2] // nb                       # ps, or ps/2 for packed4
    blocks = x.reshape((b, kvh, nb, per) + x.shape[3:]).transpose(1, 2)
    pool = torch.zeros((int(bt.max()) + 3, kvh, per) + x.shape[3:],
                       dtype=x.dtype, device=x.device)
    pool[bt.flatten().long()] = blocks.reshape((b * nb, kvh, per)
                                               + x.shape[3:])
    return pool


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("g,hd,window", [(1, 96, 0), (8, 128, 0),
                                         (8, 128, 40), (3, 128, 0),
                                         (12, 128, 40), (16, 128, 0)])
def test_flash_decode_split_boundaries(dev, kind, g, hd, window):
    """K3 and K5 with the slot axis split across blocks: rows whose valid
    slots end at a split boundary, one slot past it, a whole tile before
    it, and a row with no valid slot (exact zeros); S = 304 is a multiple
    of neither the tile nor the split; G = 8 (one block's heads) at hd
    128, G = 12 and 16 (DECODE_MAX_GROUP: a KV head's group over two
    blocks, 8 + 4 and 8 + 8 heads), G = 3 (not a power of two), windows,
    int8/int4 scales on rows with skipped tiles."""
    b, kvh, ps, nb = 4, 16, 16, 19
    s = ps * nb
    q, k, v, _, _, ks, vs = _cache(dev, kind, b=b, kvh=kvh, g=g, s=s, hd=hd,
                                   seed=g + hd + window)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, per = dk.decode_splits(b * kvh * dk.group_blocks(g), s, sm)
    assert splits > 1
    edge = per * DECODE_TILE_SLOTS                  # end of split 0
    q_pos = torch.tensor([edge - 1, edge, edge - 1 - DECODE_TILE_SLOTS, s],
                         dtype=torch.int32, device=dev)
    k_pos = torch.arange(s, dtype=torch.int32, device=dev).repeat(b, 1)
    k_pos[3] = -1                                   # empty row → zeros
    want = dk.decode_attention_plain(q, k, v, q_pos, k_pos, ks, vs, window)
    before = dk.LAUNCHES["flash_decode"]
    got = dk.decode_attention_op(q, k, v, q_pos, k_pos, k_scale=ks,
                                 v_scale=vs, window=window)
    assert dk.LAUNCHES["flash_decode"] == before + 1
    _close(got, want, 1e-4)
    assert torch.all(got[3] == 0)

    gen = torch.Generator(device="cpu").manual_seed(g + hd)
    bt = (torch.randperm(b * nb + 8, generator=gen)[:b * nb]
          .reshape(b, nb).to(torch.int32).to(dev))
    kp, vp = _to_pages(k, bt, ps), _to_pages(v, bt, ps)
    ksp = vsp = None
    if ks is not None:
        ksp, vsp = _to_pages(ks, bt, ps), _to_pages(vs, bt, ps)
    want = dk.decode_attention_paged_plain(q, kp, vp, q_pos, k_pos, bt, ksp,
                                           vsp, window)
    before = dk.LAUNCHES["flash_decode_paged"]
    got = dk.decode_attention_op(q, kp, vp, q_pos, k_pos, k_scale=ksp,
                                 v_scale=vsp, window=window, block_table=bt)
    assert dk.LAUNCHES["flash_decode_paged"] == before + 1
    _close(got, want, 1e-4)
    assert torch.all(got[3] == 0)


def _latent(dev, dtype, b, s, seed=0, h=16, r=512, pe=64):
    """MLA's absorbed decode operands: q (B, 1, H, r + pe) f32, the latent
    cache (B, S, r + pe) in ``dtype``, K its (B, 1, S, r + pe) view and V
    the view of its first r columns."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, 1, h, r + pe), generator=gen, device=dev)
    lat = torch.randn((b, s, r + pe), generator=gen, device=dev).to(dtype)
    return q, lat, lat[:, None], lat[:, None, :, :r]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", [(8, 512), (8, 304), (3, 96), (128, 64)])
def test_flash_decode_latent_head_matches_plain(dev, dtype, b, s):
    """K3's latent instance (MLA decode: one KV head, G = 16, head dim 576,
    V = the first 512 columns of K's rows, the score scale 1/√192) against
    its plain version: ragged rows, a row at its last slot, one past it
    (every slot valid, as JAX's dropped write leaves it), one with no
    valid slot (exact zeros); S = 304 is a multiple of neither the tile
    nor the split, and B·4 = 512 blocks at S = 64 fill the card in one
    split (no combine)."""
    q, lat, k, v = _latent(dev, dtype, b, s, seed=b + s)
    q_pos = (torch.arange(b, device=dev, dtype=torch.int32) * 37) % s
    q_pos[0] = s - 1
    q_pos[-1] = s + 3
    k_pos = torch.arange(s, dtype=torch.int32, device=dev).repeat(b, 1)
    empty = 1 if b > 2 else 0
    k_pos[empty] = -1
    scale = 192 ** -0.5
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = dk.decode_splits(b * dk.group_blocks(16, latent=True), s, sm,
                              DECODE_LATENT_BLOCKS_PER_SM)[0]
    assert (splits == 1) == (b == 128)
    want = dk.decode_attention_plain(q, k, v, q_pos, k_pos, scale=scale)
    before = dk.LAUNCHES["flash_decode"]
    got = dk.decode_attention_op(q, k, v, q_pos, k_pos, scale=scale,
                                 latent=True)
    assert dk.LAUNCHES["flash_decode"] == before + 1
    assert got.shape == (b, 1, 16, 512) and got.dtype == torch.float32
    _close(got, want, 1e-4)
    assert torch.all(got[empty] == 0)
    # the same cache with the default scale differs: the override is read
    other = dk.decode_attention_op(q, k, v, q_pos, k_pos, latent=True)
    assert float((other - got).abs().max()) > 1e-3


def test_flash_decode_latent_wrapper_raises(dev):
    """The latent route takes only V = k[..., :dv] (dv <= 512) of an
    f32/bf16 cache, unpaged, at most 576 wide; K5 keeps its 128 cap and
    K4 its 256."""
    q, lat, k, v = _latent(dev, torch.bfloat16, 2, 64)
    q_pos = torch.tensor([10, 63], dtype=torch.int32, device=dev)
    k_pos = torch.arange(64, dtype=torch.int32, device=dev).repeat(2, 1)
    with pytest.raises(ValueError):                  # V a tensor of its own
        dk.flash_decode(q, k, v.contiguous(), q_pos, k_pos, latent=True)
    with pytest.raises(ValueError):                  # dv = 576 > 512
        dk.flash_decode(q, k, k, q_pos, k_pos, latent=True)
    with pytest.raises(ValueError):                  # V not K's first columns
        dk.flash_decode(q, k, k[..., 64:], q_pos, k_pos, latent=True)
    codes = torch.zeros(k.shape, dtype=torch.int8, device=dev)
    sc = torch.ones(k.shape[:3], device=dev)
    with pytest.raises(TypeError):                   # int8 latents
        dk.flash_decode(q, codes, codes[..., :512], q_pos, k_pos, sc, sc,
                        latent=True)
    with pytest.raises(ValueError):                  # wider than 576
        wide = torch.zeros((2, 1, 64, 640), dtype=torch.bfloat16, device=dev)
        dk.flash_decode(torch.zeros((2, 1, 16, 640), device=dev), wide,
                        wide[..., :512], q_pos, k_pos, latent=True)
    bt = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    pool = torch.zeros((4, 1, 16, 576), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):                  # K5 stays at 128
        dk.flash_decode_paged(q, pool, pool, q_pos, k_pos, bt)
    with pytest.raises(ValueError):                  # K4 stops at 256
        x = torch.zeros((1, 8, 1, 1, 264), device=dev)
        pos = torch.arange(8, dtype=torch.int32, device=dev)
        fk.flash_attention(x, x[:, :, :, 0], x[:, :, :, 0], pos, pos)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "int4"])
def test_flash_decode_head_dim_256(dev, kind):
    """K3's wide instance (recurrentgemma-9b's local decode: one KV head,
    G = 16, hd 256, window 2048) over ragged rows of a 512-slot cache,
    a row at its last slot and a row with no valid slot (zeros)."""
    b, s = 8, 512
    q, k, v, _, _, ks, vs = _cache(dev, kind, b=b, kvh=1, g=16, s=s, hd=256,
                                   seed=256)
    q_pos = torch.arange(b, device=dev, dtype=torch.int32) * 19 + 150
    q_pos[0] = s - 1
    k_pos = torch.arange(s, dtype=torch.int32, device=dev).repeat(b, 1)
    k_pos[3] = -1
    want = dk.decode_attention_plain(q, k, v, q_pos, k_pos, ks, vs, 2048)
    before = dk.LAUNCHES["flash_decode"]
    got = dk.decode_attention_op(q, k, v, q_pos, k_pos, k_scale=ks,
                                 v_scale=vs, window=2048)
    assert dk.LAUNCHES["flash_decode"] == before + 1
    assert got.shape == (b, 1, 16, 256)
    _close(got, want, 1e-4)
    assert torch.all(got[3] == 0)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_flash_decode_wrapped_ring(dev, kind):
    """A local layer's 2048-slot ring after it wrapped: slot j holds the
    position p ≡ j (mod 2048) in 952..2999, so valid slots are out of
    position order; every row at q_pos 2999, under the window of 2048
    (every slot valid) and of 700 (most tiles dead, the live ones not in
    slot order)."""
    b, s = 3, 2048
    q, k, v, _, _, ks, vs = _cache(dev, kind, b=b, kvh=1, g=16, s=s, hd=256,
                                   seed=7)
    j = torch.arange(s, dtype=torch.int32, device=dev)
    ring = j + s * ((2999 - j) // s)
    assert int(ring.min()) == 952 and int(ring.max()) == 2999
    k_pos = ring.repeat(b, 1)
    q_pos = torch.full((b,), 2999, dtype=torch.int32, device=dev)
    for window in (2048, 700):
        want = dk.decode_attention_plain(q, k, v, q_pos, k_pos, ks, vs,
                                         window)
        got = dk.decode_attention_op(q, k, v, q_pos, k_pos, k_scale=ks,
                                     v_scale=vs, window=window)
        _close(got, want, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,window", [(256, 0), (2100, 2048), (300, 40)])
def test_flash_attention_head_dim_256(dev, dtype, s, window):
    """K4's wide instance at recurrentgemma-9b's local prefill: 16 query
    heads over one KV head of 256, causal, under its 2048 window past
    the window, and a short window (dead key tiles)."""
    gen = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn((1, s, 1, 16, 256), generator=gen, device=dev).to(dtype)
    k = torch.randn((1, s, 1, 256), generator=gen, device=dev).to(dtype)
    v = torch.randn((1, s, 1, 256), generator=gen, device=dev).to(dtype)
    pos = torch.arange(s, device=dev, dtype=torch.int32)
    want = fk.flash_attention_plain(q, k, v, pos, pos, True, window)
    before = fk.LAUNCHES["flash_attention"]
    got = fk.flash_attention(q, k, v, pos, pos, causal=True, window=window)
    assert fk.LAUNCHES["flash_attention"] == before + 1
    _close(got, want, 1e-4 if dtype == torch.float32 else 2 ** -8)


def test_head_dim_256_wrappers_raise(dev):
    """At hd 256 the latent route asked for needs V to be K's view; K5
    keeps 128; K3's GQA route and K4 stop at 256."""
    q, k, v, q_pos, k_pos, _, _ = _cache(dev, "bf16", b=3, kvh=1, g=16,
                                         s=64, hd=256)
    with pytest.raises(ValueError):
        dk.flash_decode(q, k, v, q_pos, k_pos, latent=True)
    with pytest.raises(ValueError):
        dk.flash_decode(torch.zeros((3, 1, 16, 264), device=dev),
                        torch.zeros((3, 1, 64, 264), device=dev),
                        torch.zeros((3, 1, 64, 264), device=dev), q_pos,
                        k_pos)
    bt = torch.zeros((3, 4), dtype=torch.int32, device=dev)
    pool = torch.zeros((4, 1, 16, 256), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        dk.flash_decode_paged(q, pool, pool, q_pos, k_pos, bt)
    x = torch.zeros((1, 8, 1, 1, 264), device=dev)
    pos = torch.arange(8, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        fk.flash_attention(x, x[:, :, :, 0], x[:, :, :, 0], pos, pos)


def test_flash_decode_one_split(dev):
    """B·KV = 2048 fills the card alone: one split, no combine."""
    q, k, v, q_pos, k_pos, _, _ = _cache(dev, "bf16", b=64, kvh=32, g=1,
                                         s=256, hd=96)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert dk.decode_splits(64 * 32, 256, sm)[0] == 1
    _close(dk.decode_attention_op(q, k, v, q_pos, k_pos),
           dk.decode_attention_plain(q, k, v, q_pos, k_pos), 1e-4)


def test_wide_autocorr_takes_the_range_route(dev, monkeypatch):
    """Past the card's eigh width (lowered here to 96) qera-exact takes R's
    range when R averages fewer samples than its width, and raises when
    it does not; the result matches an f64 eigh of the same R within the
    f32 result's rounding (1e-6 of each matrix's largest entry)."""
    from repro_torch.core import scaling as sc
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((40, 128), generator=gen, device=dev)
    r = x.T @ x / 40
    r64 = 0.5 * (r.double() + r.double().T)
    evals, evecs = torch.linalg.eigh(r64)
    half = torch.maximum(evals, 1e-4 * evals[-1]).sqrt()
    monkeypatch.setattr(sc, "EIGH_MAX_WIDTH", 96)
    got = sc.autocorr_scaling_from_moments(r, rows=40)
    for mine, exact in ((got.dense, (evecs * half) @ evecs.T),
                        (got.dense_inv, (evecs / half) @ evecs.T)):
        scale = float(exact.abs().max())
        assert float((mine.double() - exact).abs().max()) <= 1e-6 * scale
    with pytest.raises(ValueError, match="range route"):
        sc.autocorr_scaling_from_moments(r, rows=128)


# whisper-large-v3: 20 heads over 20 KV heads of 64; the encoder's 1500
# frames (not a multiple of K4's 64-key tile: its last query tile holds
# 28 rows), the decoder's 256-row prefill
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal", [(1500, 1500, False),
                                          (256, 1500, False),
                                          (256, 256, True)])
def test_flash_attention_whisper_shapes(dev, dtype, sq, sk, causal):
    """K4 at head dim 64: the encoder's bidirectional 1500 × 1500, the
    cross attention's prefill (256 queries over the 1500 memory slots,
    no mask) and the decoder's causal 256; every query row written."""
    gen = torch.Generator(device=dev).manual_seed(sq + sk)
    q = torch.randn((1, sq, 20, 1, 64), generator=gen, device=dev).to(dtype)
    k = torch.randn((1, sk, 20, 64), generator=gen, device=dev).to(dtype)
    v = torch.randn((1, sk, 20, 64), generator=gen, device=dev).to(dtype)
    q_pos = torch.arange(sq, device=dev, dtype=torch.int32)
    k_pos = torch.arange(sk, device=dev, dtype=torch.int32)
    want = fk.flash_attention_plain(q, k, v, q_pos, k_pos, causal)
    before = fk.LAUNCHES["flash_attention"]
    got = fk.flash_attention(q, k, v, q_pos, k_pos, causal=causal)
    assert fk.LAUNCHES["flash_attention"] == before + 1
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, 1e-4 if dtype == torch.float32 else 2 ** -8)


@pytest.mark.parametrize("kind,s", [("bf16", 512), ("int8", 512),
                                    ("int4", 512), ("bf16", 1500),
                                    ("f32", 1500)])
def test_flash_decode_whisper_shapes(dev, kind, s):
    """K3 at head dim 64, KV 20, G 1: over the self cache (S = 512, ragged
    rows) and over the cross memory (S = 1500, every slot valid, q_pos
    enc_seq − 1 on every row: 47 tiles of 32, the last partial), as
    ``cross_attention`` calls it."""
    b = 8
    q, k, v, _, _, ks, vs = _cache(dev, kind, b=b, kvh=20, g=1, s=s, hd=64,
                                   seed=s)
    k_pos = torch.arange(s, dtype=torch.int32, device=dev).repeat(b, 1)
    if s == 1500:
        q_pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    else:
        q_pos = torch.arange(b, device=dev, dtype=torch.int32) * 19 + 150
        k_pos = torch.where(k_pos <= q_pos[:, None], k_pos, -1)
    want = dk.decode_attention_plain(q, k, v, q_pos, k_pos, ks, vs)
    before = dk.LAUNCHES["flash_decode"]
    got = dk.decode_attention_op(q, k, v, q_pos, k_pos, k_scale=ks,
                                 v_scale=vs)
    assert dk.LAUNCHES["flash_decode"] == before + 1
    assert got.shape == (b, 20, 1, 64)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("m", [8, 256, 1500])
@pytest.mark.parametrize("k,n", [(1280, 1280), (1280, 5120), (5120, 1280)])
def test_qlr_whisper_shapes(dev, m, k, n):
    """K1 at whisper's decode rows and K2 at its decoder prefill (256) and
    its encoder's and cross memory's 1500 rows, at its three projection
    shapes; one launch a call."""
    x, codes, scale, l, rr = _qlr(dev, m, k, n, 16, False, seed=m + n)
    key = "qlr_fused" if m <= QLR_FUSED_MAX_ROWS else "qlr"
    before = mk.LAUNCHES[key]
    got = mk.qlr_matmul(x, codes, scale, l, rr)
    assert mk.LAUNCHES[key] == before + 1 and got.shape == (m, n)
    _close(got, mk.qlr_matmul_plain(x, codes, scale, l, rr), 1e-4)


@pytest.mark.parametrize("m", [8, 256])
def test_qlr_wrapper_refuses_grad_on_the_card(dev, m):
    """K1 (8 rows) and K2 (256) define no backward: an operand that
    requires grad raises before a launch; detached, the kernel runs."""
    x, codes, scale, l, rr = _qlr(dev, m, 1024, 384, 16, False, seed=m)
    before = dict(mk.LAUNCHES)
    with pytest.raises(RuntimeError, match="no backward"):
        mk.qlr_matmul(x, codes, scale, l.clone().requires_grad_(), rr)
    assert mk.LAUNCHES == before
    with torch.no_grad():
        got = mk.qlr_matmul(x, codes, scale, l.clone().requires_grad_(), rr)
    _close(got, mk.qlr_matmul_plain(x, codes, scale, l, rr), 1e-4)
    assert sum(mk.LAUNCHES.values()) == sum(before.values()) + 1
