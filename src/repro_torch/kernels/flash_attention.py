"""K4: forward flash attention for prefill, in the model layout.

Port of ``repro/kernels/flash_attention.py::flash_attention_hsd`` and its
wrapper ``repro/kernels/ops.py::flash_attention``. The CUDA source is
``csrc/flash_attention.cu``; its header says what bounds it and how.

q is ``(B, Sq, KV, G, hd)`` and k, v are ``(B, Sk, KV, hd)``; the kernel
reads the KV head of query head ``(h, g)`` in place, so K/V are never
broadcast over G nor transposed in memory. ``q_pos`` (Sq,) and ``k_pos``
(Sk,) carry explicit positions, ``k_pos = -1`` marking an invalid slot.
A query row with no valid key is undefined, as in the TPU kernel. The
head dim is a multiple of 8 up to 128, or up to 256 through the kernel's
wide instance (``csrc/flash_attention.cu``'s header).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.constraints import (ATTN_WIDE_HEAD_DIM, KV_PTR_ALIGN,
                                             check_head_dim, refuse_grad,
                                             runs_plain)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

# launches of the kernel since the last reset; a plain count per wrapper
LAUNCHES = {"flash_attention": 0}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_pos: torch.Tensor, k_pos: torch.Tensor,
                          causal: bool = True, window: int = 0) -> torch.Tensor:
    """Plain version of K4 (dense masked softmax): → (B, Sq, KV, G, hd)
    in q.dtype."""
    hd = q.shape[-1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) \
        * (1.0 / hd ** 0.5)
    mask = (k_pos[None, :] >= 0).expand(q_pos.shape[0], k_pos.shape[0])
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    if window > 0:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_pos: torch.Tensor, k_pos: torch.Tensor,
                         causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch K4; raises on anything the kernel does not take."""
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must all be float32 or all bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    b, sq, kvh, g, hd = q.shape
    sk = k.shape[1]
    check_head_dim(hd, ATTN_WIDE_HEAD_DIM)
    if k.shape != (b, sk, kvh, hd) or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    if q_pos.shape != (sq,) or k_pos.shape != (sk,):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} / k_pos "
                         f"{tuple(k_pos.shape)} must be ({sq},) / ({sk},)")
    for t in (q, k, v, q_pos, k_pos):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash_attention needs contiguous tensors on "
                             "one device")
    if any(t.data_ptr() % KV_PTR_ALIGN for t in (q, k, v)):
        raise ValueError(f"q/k/v must start {KV_PTR_ALIGN}-byte aligned (the "
                         f"kernel copies rows in 16-byte chunks)")
    out = torch.empty_like(q)
    fn = _build.function("flash_attention", "flash_attention_launch", 6, 9, 1)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             k_pos.data_ptr(), out.data_ptr(), b, sq, sk, kvh, g, hd,
             int(causal), window, int(q.dtype == torch.bfloat16),
             1.0 / hd ** 0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_launch (K4)")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Prefill attention: the plain version for CPU tensors, K4 for CUDA
    tensors. Raises for an operand that requires grad
    (``constraints.refuse_grad``)."""
    refuse_grad("K4 (flash_attention)", q, k, v)
    if runs_plain(q):
        return flash_attention_plain(q, k, v, q_pos, k_pos, causal, window)
    return flash_attention_cuda(q, k, v, q_pos, k_pos, causal, window)
