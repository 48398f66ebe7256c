"""K7's launch plan (``mxint_quantize_plan``), walked on the CPU the way
``csrc/mxint_quantize.cu`` walks it: every (32-row block, column) of
``w`` is quantized exactly once, by the register path or by the scalar
path; every 16-byte load is aligned; every 4-byte code and exponent
store lies inside its row. The SRR pass's shapes all take the register
path but the router's. The wrapper's checks raise on the CPU as they do
on the card, before anything is built or launched.

Tolerance: none, everything here is integer bookkeeping.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mxint_quantize as kq
from repro_torch.kernels.constraints import (MXINT_ALIGN, MXINT_BLOCK,
                                             MXINT_PATH_REGISTERS,
                                             MXINT_PATH_SCALAR, MXINT_THREADS,
                                             MXINT_VEC)

# every distinct matrix shape the SRR pass quantizes (phi3-mini-3.8b and
# deepseek-moe-16b: attention, router, experts, shared experts, the dense
# lead-in layer)
PASS_SHAPES = [(3072, 3072), (3072, 8192), (8192, 3072), (2048, 2048),
               (2048, 64), (2048, 1408), (1408, 2048), (2048, 2816),
               (2816, 2048), (2048, 10944), (10944, 2048)]
# an N below a multiple of 128 (1000 = 7·128 + 104), N not a multiple of
# 4 (the scalar path), narrow matrices, one column
RAGGED_SHAPES = [(2048, 1000), (2048, 1002), (64, 40), (96, 300), (32, 1),
                 (32, 4), (64, 36)]


def _cover(plan, m, n):
    """(32-row block, column) → times quantized, and the register path's
    16-byte loads (source byte offsets) and first columns — the kernel's
    enumeration: thread j of the grid takes items j, j + grid·threads,
    ..."""
    nb = m // MXINT_BLOCK
    seen = np.zeros((nb, n), np.int64)
    items = np.arange(plan.items)
    assert plan.grid * MXINT_THREADS <= plan.items + MXINT_THREADS
    if plan.path == MXINT_PATH_SCALAR:
        assert plan.tail_cols == n and plan.items == nb * n
        rb, col = np.divmod(items, n)
        np.add.at(seen, (rb, col), 1)
        return seen, None
    assert plan.path == MXINT_PATH_REGISTERS and plan.tail_cols == 0
    quads = n // MXINT_VEC
    assert plan.items == nb * quads
    rb, q = np.divmod(items, quads)
    c0 = q * MXINT_VEC
    for c in range(MXINT_VEC):
        np.add.at(seen, (rb, c0 + c), 1)
    rows = np.arange(MXINT_BLOCK)
    src = ((rb[:, None] * MXINT_BLOCK + rows[None, :]) * n
           + c0[:, None]) * 4
    return seen, (src, c0)


def _check(plan, m, n):
    seen, loads = _cover(plan, m, n)
    assert (seen == 1).all(), "a (block, column) quantized 0 or 2+ times"
    if loads is None:
        return
    src, c0 = loads
    assert (src % MXINT_ALIGN == 0).all()           # 16-byte loads
    assert (c0 % MXINT_VEC == 0).all()              # 4-byte code stores
    assert (c0 + MXINT_VEC <= n).all()              # inside the row


@pytest.mark.parametrize("sms", [1, 2, 132])
@pytest.mark.parametrize("m,n", PASS_SHAPES + RAGGED_SHAPES)
def test_plan_covers_every_block_once(m, n, sms):
    """Aligned: the register path where N % 4 == 0 and the quads fill a
    block an SM, else the scalar path; every (32-row block, column) once
    either way."""
    plan = kq.mxint_quantize_plan(m, n, sms)
    quads = m // MXINT_BLOCK * (n // MXINT_VEC)
    want = MXINT_PATH_REGISTERS if n % MXINT_VEC == 0 \
        and quads >= sms * MXINT_THREADS else MXINT_PATH_SCALAR
    assert plan.path == want and plan.grid <= sms * 4
    _check(plan, m, n)


@pytest.mark.parametrize("sms", [1, 2, 132])
@pytest.mark.parametrize("m,n", [(2048, 1408), (2048, 64), (2048, 1000),
                                 (64, 40), (32, 1)])
def test_misaligned_w_takes_the_scalar_path(m, n, sms):
    plan = kq.mxint_quantize_plan(m, n, sms, aligned=False)
    assert plan.path == MXINT_PATH_SCALAR and plan.tail_cols == n
    _check(plan, m, n)


@pytest.mark.parametrize("m,n", PASS_SHAPES)
def test_pass_shapes_take_the_register_path(m, n):
    """On an H100 (132 SMs): no scalar columns, 64-thread blocks, as many
    as the quads need up to four an SM (one quad a thread at the expert
    shapes: 352 blocks for 22,528 quads) — but the router's 2048×64 has
    1,024 quads, 16 blocks' worth, and takes the scalar path's 64 blocks
    of one column a thread."""
    plan = kq.mxint_quantize_plan(m, n, 132)
    if n == 64:
        assert plan.path == MXINT_PATH_SCALAR and plan.grid == 64
        return
    assert plan.path == MXINT_PATH_REGISTERS and plan.tail_cols == 0
    assert plan.grid == min(-(-plan.items // 64), 4 * 132)
    if (m, n) in ((2048, 1408), (1408, 2048)):
        assert plan.items == 22528 and plan.grid == 352


@pytest.mark.parametrize("m,n,kw", [(0, 64, {}), (40, 64, {}), (64, 0, {}),
                                    (2 ** 26, 2 ** 11, {}),
                                    (64, 64, dict(sms=0))])
def test_plan_refuses(m, n, kw):
    with pytest.raises(ValueError):
        kq.mxint_quantize_plan(m, n, **{"sms": 132, **kw})


def test_wrapper_checks_raise_before_any_build():
    """The wrapper's checks, in their order, on CPU tensors: nothing is
    built or launched, and a valid CPU tensor is refused too."""
    w = torch.randn((64, 40))
    before = kq.LAUNCHES["mxint_quantize"]
    with pytest.raises(TypeError):
        kq.mxint_quantize_cuda(w.double(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        kq.mxint_quantize_cuda(w.t(), 3)
    with pytest.raises(ValueError, match="rows"):
        kq.mxint_quantize_cuda(w[:40], 3)
    with pytest.raises(ValueError, match="bits"):
        kq.mxint_quantize_cuda(w, 9)
    with pytest.raises(ValueError, match="CUDA"):
        kq.mxint_quantize_cuda(w, 3)
    assert kq.LAUNCHES["mxint_quantize"] == before
