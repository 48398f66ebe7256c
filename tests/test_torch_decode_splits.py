"""The split-slot decode of K3/K5 on the CPU.

On the card K3/K5 split a row's slot axis across blocks; each split
leaves an online-softmax partial (m, l, acc) and a combine kernel merges
them. Here each split's partial comes from plain math, the merge from
``combine_splits_plain``, and the result must equal the port's
``decode_attention_plain`` and the JAX oracle
``repro.kernels.ref.decode_attention_ref`` (f32 math on all sides: 2e-5
absolute on outputs of magnitude ~1 covers summation order). Also the
host-side split plan at the serving shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import decode_attention_ref
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels.constraints import (DECODE_MAX_SPLIT_TILES,
                                             DECODE_TILE_SLOTS)
from repro_torch.quant.mxint import pack_codes_4bit, unpack_codes_4bit

S = 50


def _case(kind, seed, b=3, kvh=2, g=2, hd=16):
    """Row 0 valid up to its last slot, row 1 up to slot 17, row 2 empty."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, kvh, g, hd), np.float32))
    k = torch.from_numpy(rng.standard_normal((b, kvh, S, hd), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, kvh, S, hd), np.float32))
    ks = vs = None
    if kind != "f32":
        qmax = 127 if kind == "int8" else 7
        ks = k.abs().amax(-1).clamp_min(1e-8) / qmax
        vs = v.abs().amax(-1).clamp_min(1e-8) / qmax
        k = torch.round(k / ks[..., None]).clamp(-qmax, qmax).to(torch.int8)
        v = torch.round(v / vs[..., None]).clamp(-qmax, qmax).to(torch.int8)
        if kind == "int4":
            k, v = pack_codes_4bit(k), pack_codes_4bit(v)
    q_pos = torch.tensor([S - 1, 17, 30], dtype=torch.int32)
    k_pos = torch.arange(S, dtype=torch.int32).repeat(b, 1)
    k_pos[2] = -1
    return q, k, v, q_pos, k_pos, ks, vs


def _split_partials(q, k, v, q_pos, k_pos, ks, vs, window, bounds):
    """Each split's (m, l, acc) over slots [a, b) by plain math: m the
    max masked score (NEG_INF when the split has no valid slot), l the
    sum of e^(s − m), acc the sum of e^(s − m)·v_scale·v."""
    if k.dtype == torch.uint8:
        k, v = unpack_codes_4bit(k), unpack_codes_4bit(v)
    s = torch.einsum("bkgd,bksd->bkgs", q, k.float())
    if ks is not None:
        s = s * ks[:, :, None, :]
    s = s / q.shape[-1] ** 0.5
    valid = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    if window > 0:
        valid = valid & (q_pos[:, None] - k_pos < window)
    slot = torch.arange(S)
    ms, ls, accs = [], [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        mask = (valid & (slot >= a) & (slot < b))[:, None, None, :]
        sm = torch.where(mask, s, dk.NEG_INF)
        m = sm.amax(-1)
        p = torch.where(mask, torch.exp(sm - m[..., None]), 0.0)
        pv = p if vs is None else p * vs[:, :, None, :]
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgs,bksd->bkgd", pv, v.float()))
    return torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, -2)


@pytest.mark.parametrize("kind", ["f32", "int8", "int4"])
@pytest.mark.parametrize("bounds", [(0, S), (0, 18, S), (0, 17, S),
                                    (0, 32, 40, S), (0, 10, 20, 30, 40, S),
                                    (0, 2, 48, S)])
@pytest.mark.parametrize("window", [0, 9])
def test_combined_splits_match_plain_and_jax(kind, bounds, window):
    """Boundaries at, one past and one before row 1's last valid slot
    (17), splits with no valid slot, and the empty row 2."""
    q, k, v, q_pos, k_pos, ks, vs = _case(kind, seed=len(bounds) + window)
    m, l, acc = _split_partials(q, k, v, q_pos, k_pos, ks, vs, window,
                                bounds)
    got = dk.combine_splits_plain(m, l, acc)
    want = dk.decode_attention_plain(q, k, v, q_pos, k_pos, ks, vs, window)
    oracle = np.asarray(decode_attention_ref(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), jnp.asarray(q_pos.numpy()),
        jnp.asarray(k_pos.numpy()),
        None if ks is None else jnp.asarray(ks.numpy()),
        None if vs is None else jnp.asarray(vs.numpy()), window=window))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0, atol=2e-5)
    assert torch.all(got[2] == 0)                       # the empty row
    assert torch.all(l[2] == 0) and torch.all(m[2] == dk.NEG_INF)


def test_combine_of_all_empty_splits_is_zero():
    m = torch.full((2, 3, 4), dk.NEG_INF)
    out = dk.combine_splits_plain(m, torch.zeros_like(m),
                                  torch.zeros((2, 3, 4, 8)))
    assert out.shape == (2, 3, 8) and torch.all(out == 0)


@pytest.mark.parametrize("rows,slots,want", [
    (8 * 32, 512, (3, 6)),    # phi3 decode, phases 3/4 (and 4b: 32 × 16)
    (8 * 16, 512, (4, 4)),    # deepseek-moe-16b decode, phases 3/6
    (4 * 32, 320, (5, 2)),    # phase 5: 4 lanes, max_len 320
    (64 * 32, 256, (1, 8)),   # B·KV alone fills the card: one split
    (8, 32768, (64, 16)),     # a long context: capped at 16 tiles a split
    (8 * 20, 512, (4, 4)),    # whisper's self decode (KV 20, hd 64)
    (8 * 20, 1500, (4, 12)),  # whisper's cross memory: 47 tiles, the
])                            # last split 11 of them
def test_decode_splits_at_serving_shapes(rows, slots, want):
    assert dk.decode_splits(rows, slots, 132) == want


def test_decode_splits_never_leave_a_split_shorter_than_a_tile():
    for rows in (1, 7, 64, 256, 1000, 5000):
        for slots in (1, 31, 32, 33, 200, 512, 4097, 40000):
            for sms in (1, 132):
                splits, per = dk.decode_splits(rows, slots, sms)
                tiles = -(-slots // DECODE_TILE_SLOTS)
                assert 1 <= per <= DECODE_MAX_SPLIT_TILES
                assert splits * per >= tiles                 # covers S
                assert (splits - 1) * per < tiles            # none empty
