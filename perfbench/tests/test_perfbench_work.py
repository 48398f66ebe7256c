"""The benchmark's frozen copies of the kernel functions' formulas equal
the port's own at several shapes (the only place the port's counts are
imported)."""
from __future__ import annotations

import pytest

from perfbench.work import formulas, model_flops
from repro_torch.kernels import work


@pytest.mark.parametrize("m,k,n,rank,packed", [
    (1, 3072, 3072, 16, False), (64, 3072, 8192, 16, False),
    (512, 8192, 3072, 16, False), (1024, 2048, 64, 16, False),
    (8, 4096, 256, 0, True), (129, 96, 160, 4, True)])
def test_qlr(m, k, n, rank, packed):
    assert formulas.qlr_work(m, k, n, rank, packed=packed) == \
        formulas.Work(**vars(work.qlr_work(m, k, n, rank, packed=packed)))


@pytest.mark.parametrize("e,m,k,n,rank,rows,live", [
    (64, 64, 2048, 1408, 16, 384, None), (64, 120, 1408, 2048, 16, None, 40),
    (8, 4, 64, 32, 4, 8, 8)])
def test_qlr_batched(e, m, k, n, rank, rows, live):
    got = formulas.qlr_batched_work(e, m, k, n, rank, rows=rows, live=live)
    assert got == formulas.Work(**vars(work.qlr_batched_work(
        e, m, k, n, rank, rows=rows, live=live)))


@pytest.mark.parametrize("sq,sk,window,start", [
    (512, 1024, 0, 512), (1024, 1024, 0, 0), (256, 2100, 2048, 1844),
    (4, 516, 0, 512)])
def test_attention(sq, sk, window, start):
    pairs = formulas.attention_pairs(sq, sk, window=window, start=start)
    assert pairs == work.attention_pairs(sq, sk, window=window, start=start)
    got = formulas.flash_attention_work(sq, 32, 32, 96, pairs=pairs,
                                        kv_rows=start + sq, positions=sq + sk)
    assert got == formulas.Work(**vars(work.flash_attention_work(
        sq, 32, 32, 96, pairs=pairs, kv_rows=start + sq, positions=sq + sk)))


@pytest.mark.parametrize("m,n", [(3072, 8192), (8192, 3072), (2048, 1408),
                                 (96, 160)])
def test_quantize(m, n):
    assert formulas.mxint_quantize_work(m, n) == \
        formulas.Work(**vars(work.mxint_quantize_work(m, n)))


def test_model_flops_counts_each_projection():
    model = dict(d_model=64, head_dim=16, n_heads=4, n_kv_heads=2,
                 n_layers=2, d_ff=128, vocab=256)
    per = 4 * 64 * 64 * 0 + 2 * (64 * 64 + 64 * 16 + 16 * 64)
    attn = per + 2 * 2 * (64 * 32 + 64 * 16 + 16 * 32) \
        + 2 * (64 * 64 + 64 * 16 + 16 * 64)
    ffn = 2 * 2 * (64 * 128 + 64 * 16 + 16 * 128) \
        + 2 * (128 * 64 + 128 * 16 + 16 * 64)
    want = 2 * (attn + ffn) + 2 * 64 * 256
    assert model_flops.token_flops(model, 16) == want
