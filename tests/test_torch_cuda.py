"""Card-only checks of the CUDA kernels (skip without a card): each
kernel against its plain version on the card, and each wrapper raising
on input the kernel does not take.

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


def test_flash_decode_wrapper_raises(dev):
    q, k, v, q_pos, k_pos, ks, vs = _cache(dev, "int8")
    with pytest.raises(ValueError):
        dk.flash_decode(q, k, v, q_pos, k_pos)           # scales missing
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
