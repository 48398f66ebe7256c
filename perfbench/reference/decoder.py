"""The plain reference of a GQA decoder, dense or MoE, served as Q + LR.

Written from the equations, in plain ``torch`` operations and float32
(TF32 off), from the raw tensors: each projection's weight is
``codes · scale + L · R``; RMSNorm (eps 1e-6) before attention and the
FFN; RoPE over interleaved pairs (base ``rope_theta``); causal softmax
attention, ``n_heads / n_kv_heads`` query heads a KV head; a SwiGLU FFN,
or the MoE block: a softmax router, the ``top_k`` experts with ties to
the lower index, gates renormalised by their sum, the shared experts on
every token; the final norm and the LM head.

The configuration serves with a bf16 KV cache, so a key or value read
back from the cache is the bf16 rounding of the f32 one, as the
configuration states: a prompt chunk attends to its own keys fresh and
to earlier chunks' through the cache; a decoded token attends to every
key through the cache, its own too. The MoE block is dropless: every
token reaches each of its ``top_k`` experts, as in the published model.

``score`` runs every layer for all the sequences before the next layer,
so that one layer's weights are dequantized once and the whole model is
never expanded at once.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

EPS = 1e-6


def _weight(mt, dtype, e: Optional[int] = None) -> torch.Tensor:
    codes, scale, l, r = mt.codes, mt.scale, mt.l, mt.r
    if e is not None:
        codes, scale, l, r = codes[e], scale[e], l[e], r[e]
    m, n = codes.shape
    w = (codes.float().view(scale.shape[0], m // scale.shape[0], n)
         * scale[:, None, :]).view(m, n)
    return (w + l @ r).to(dtype)


def _rms(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + EPS)
            * g).to(x.dtype)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd), pos (S,): rotate interleaved pairs (2i, 2i+1)."""
    hd = x.shape[-1]
    freq = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd))
    ang = pos.float()[:, None] * freq                     # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _attend(q, k, v, q_pos, k_pos, dtype):
    """q (S, H, hd) over k, v (T, KV, hd), causal by position."""
    h, kvh, hd = q.shape[1], k.shape[1], q.shape[2]
    g = h // kvh
    k = k.to(dtype).repeat_interleave(g, dim=1)
    v = v.to(dtype).repeat_interleave(g, dim=1)
    s = torch.einsum("shd,thd->hst", q.to(dtype), k).float() / math.sqrt(hd)
    mask = k_pos[None, :] <= q_pos[:, None]
    s = s.masked_fill(~mask[None], float("-inf"))
    p = torch.softmax(s, dim=-1).to(dtype)
    return torch.einsum("hst,thd->shd", p, v)


class _Layer:
    """One layer's weights, dequantized once for every sequence."""

    def __init__(self, raw: Dict, model: Dict, i: int, dtype):
        p, mats = f"L{i}.", raw["mats"]
        self.g1, self.g2 = raw["norms"][p + "norm1"], raw["norms"][p + "norm2"]
        self.w = {n: _weight(mats[p + n], dtype) for n in ("wq", "wk", "wv", "wo")}
        self.moe = bool(model.get("moe")) and i >= model.get("first_dense", 0)
        if self.moe:
            self.router = _weight(mats[p + "router"], dtype)
            self.shared = ({n: _weight(mats[p + "shared." + n], dtype)
                            for n in ("up", "gate", "down")}
                           if model.get("n_shared") else None)
            stacks = [mats[p + "experts." + n] for n in ("up", "gate", "down")]
            self.experts = [[_weight(st, dtype, ex) for st in stacks]
                            for ex in range(model["n_routed"])]
        else:
            self.w.update({n: _weight(mats[p + n], dtype)
                           for n in ("up", "gate", "down")})


def _swiglu(x, up, gate, down, dtype):
    xd = x.to(dtype)
    return ((torch.nn.functional.silu(xd @ gate) * (xd @ up)) @ down)


def _moe(layer: _Layer, x: torch.Tensor, model: Dict, dtype):
    """x (T, d) → (T, d): every token's routed experts plus the shared
    experts."""
    t = x.shape[0]
    e, k = model["n_routed"], model["top_k"]
    probs = torch.softmax((x.to(dtype) @ layer.router).float(), dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    gate = probs.gather(-1, idx)
    gate = gate / gate.sum(-1, keepdim=True)
    flat = idx.reshape(-1)
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    out = torch.zeros((t * k, x.shape[1]), dtype=torch.float32, device=x.device)
    for ex, (up, gt, dn) in enumerate(layer.experts):
        sel = torch.nonzero(flat == ex)[:, 0]
        if sel.numel():
            out[sel] = _swiglu(x[tok[sel]], up, gt, dn, dtype).float()
    comb = (out * gate.reshape(-1, 1)).reshape(t, k, -1).sum(1)
    if layer.shared is not None:
        s = layer.shared
        comb = comb + _swiglu(x, s["up"], s["gate"], s["down"], dtype).float()
    return comb.to(x.dtype)


def _ffn(layer: _Layer, x, model, dtype):
    h = _rms(x, layer.g2)
    if layer.moe:
        return _moe(layer, h, model, dtype)
    w = layer.w
    return _swiglu(h, w["up"], w["gate"], w["down"], dtype).to(x.dtype)


def _layer_seq(layer: _Layer, x: torch.Tensor, model: Dict, n_prompt: int,
               chunk: int, dtype) -> torch.Tensor:
    """One layer over one sequence's hidden states x (S, d): the prompt's
    ``n_prompt`` tokens in chunks of ``chunk`` (a chunk reads the earlier
    chunks' keys and values through the cache), then the rest as decode
    steps."""
    s_len, d = x.shape
    h, kvh, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    theta = model.get("rope_theta", 10_000.0)
    pos = torch.arange(s_len, device=x.device)
    hx = _rms(x, layer.g1).to(dtype)
    w = layer.w
    q = _rope((hx @ w["wq"]).view(s_len, h, hd), pos, theta)
    k = _rope((hx @ w["wk"]).view(s_len, kvh, hd), pos, theta)
    v = (hx @ w["wv"]).view(s_len, kvh, hd)
    k_c, v_c = k.to(torch.bfloat16), v.to(torch.bfloat16)  # the cache's
    att = torch.empty((s_len, h, hd), dtype=dtype, device=x.device)
    bounds = [(a, min(a + chunk, n_prompt)) for a in range(0, n_prompt, chunk)]
    for a, b in bounds:
        kk = torch.cat([k_c[:a].to(k.dtype), k[a:b]])
        vv = torch.cat([v_c[:a].to(v.dtype), v[a:b]])
        att[a:b] = _attend(q[a:b], kk, vv, pos[a:b], pos[:b], dtype)
    if s_len > n_prompt:
        att[n_prompt:] = _attend(q[n_prompt:], k_c, v_c, pos[n_prompt:], pos,
                                 dtype)
    x = x + (att.reshape(s_len, h * hd).to(dtype) @ w["wo"]).to(x.dtype)
    return x + _ffn(layer, x, model, dtype)


def score(raw: Dict, config: Dict, seqs: Sequence[tuple], *, chunk: int,
          dtype=torch.float32,
          ids: Optional[List[torch.Tensor]] = None, topk: int = 0
          ) -> List[Dict]:
    """Readings at every position that predicts a served token.

    ``seqs`` holds ``(prompt, served)`` int arrays; the model reads
    ``prompt ‖ served[:-1]`` and position ``len(prompt) - 1 + j`` predicts
    ``served[j]``. Returns per sequence, with ``ids`` (one (n, k) index
    tensor per sequence) ``"at_ids"``: the log-softmax at those tokens,
    and with ``topk`` ``"top_ids"``/``"top_lsm"``: the ``topk`` first
    tokens and their log-softmax."""
    model = config["model"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _score(raw, model, seqs, chunk, dtype, ids, topk)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _score(raw, model, seqs, chunk, dtype, ids, topk):
    dev = raw["embed"].device
    xs, meta = [], []
    for prompt, served in seqs:
        toks = torch.as_tensor(list(prompt) + list(served[:-1]), device=dev,
                               dtype=torch.int64)
        xs.append(raw["embed"][toks].to(dtype))
        meta.append(len(prompt))
    for i in range(model["n_layers"]):
        layer = _Layer(raw, model, i, dtype)
        xs = [_layer_seq(layer, x, model, n_p, chunk, dtype)
              for x, n_p in zip(xs, meta)]
        del layer
    head = raw["head"].to(dtype)
    out = []
    for j, (x, n_p) in enumerate(zip(xs, meta)):
        hid = _rms(x[n_p - 1:], raw["norms"]["final_norm"])
        lsm = torch.log_softmax((hid.to(dtype) @ head).float(), dim=-1)
        rec = {}
        if ids is not None:
            rec["at_ids"] = lsm.gather(-1, ids[j].to(dev))
        if topk:
            rec["top_lsm"], rec["top_ids"] = lsm.topk(topk, dim=-1)
        out.append(rec)
    return out
