"""xLSTM blocks (Beck et al., 2024): mLSTM (parallel prefill, recurrent
decode) and sLSTM (sequential); port of ``repro/models/xlstm.py``.

mLSTM: a matrix memory with exponential gating. Its parallel form is
linear attention under the (t, s) decay ``log D_ts = F_t − F_s + ĩ_s``
(F the cumulative log-sigmoid forget gate), stabilised by a running max
and computed in query chunks against key chunks with an online max, as
JAX computes it (:func:`_mlstm_parallel`). A key chunk wholly after a
query chunk adds exactly nothing there (its decay underflows to 0 and
the max stays), so it is skipped. Decode carries the state ``C`` (B, H,
hd, hd), ``n`` (B, H, hd), ``m`` (B, H) at O(H·hd²) a step
(:func:`mlstm_step`); a prefill folds the prompt into it in closed form
(:func:`_mlstm_fold`).

The two forms are not the same function of the history: the recurrent
state starts at ``m = 0``, so its running max carries an ``F_t + 0``
term that the parallel form's max lacks, and their normalisers
``max(|n·q|, e^{−m})`` differ with it. Each is ported as JAX writes it
and held to its own JAX counterpart.

sLSTM: a scalar memory with recurrent gate weights ``r_gates`` (H, hd,
4·hd), run strictly in sequence (:func:`_slstm_scan`, one batched product
for the recurrent term a token, then the gate arithmetic). The recurrent
product is laid out head-major, (B, H·4hd), then split into z/i/f/o
quarters, as the reference does: at H = 4 z's recurrent input is all of
head 0's output, i's head 1's, and so on (ROADMAP §3). The block then
runs a tanh-GeLU FFN of ``slstm_proj_factor`` × d.

Neither block has an FFN after it in the decoder, and their states are
f32 whatever the KV type (JAX's ``init_mlstm_cache`` and
``init_slstm_cache`` take no dtype). A prefill returns fresh state
tensors (a serving template stays zero); a decode step rebinds every
entry of the layer's dict to a new tensor and writes into none, so
keeping references undoes it (``models.attention.save_step_writes``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import gelu, init_linear
from repro_torch.models.linear import Ctx, linear

NEG = -0.7 * float(torch.finfo(torch.float32).max)
MLSTM_CHUNK = 256

# the projections of each mixer, in the JAX tree's order
MLSTM_PROJECTIONS = ("up", "up_gate", "wq", "wk", "wv", "w_if", "down")
SLSTM_PROJECTIONS = ("w_gates", "w_out", "ffn_up", "ffn_down")


# ==========================================================================
# mLSTM
# ==========================================================================
class MLSTM(nn.Module):
    """``up``/``up_gate`` (d, dp), ``wq``/``wk``/``wv`` (dp, dp),
    ``w_if`` (dp, 2H) with a bias, ``down`` (dp, d); dp =
    ``mlstm_proj_factor`` × d."""

    def __init__(self, up: nn.Module, up_gate: nn.Module, wq: nn.Module,
                 wk: nn.Module, wv: nn.Module, w_if: nn.Module,
                 down: nn.Module):
        super().__init__()
        self.up, self.up_gate, self.down = up, up_gate, down
        self.wq, self.wk, self.wv, self.w_if = wq, wk, wv, w_if


def mlstm_width(cfg: ModelConfig) -> int:
    return int(cfg.d_model * cfg.mlstm_proj_factor)


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, device) -> MLSTM:
    """Random f32 mixer at ``repro/models/xlstm.py::init_mlstm``'s scales
    (``1/√fan_in`` each; ``w_if``'s bias zero)."""
    d, dp, h = cfg.d_model, mlstm_width(cfg), cfg.n_heads

    def lin(m: int, n: int):
        return init_linear(gen, m, n, m ** -0.5, device)

    w_if = lin(dp, 2 * h)
    w_if.b = torch.zeros((2 * h,), device=device)
    return MLSTM(lin(d, dp), lin(d, dp), lin(dp, dp), lin(dp, dp),
                 lin(dp, dp), w_if, lin(dp, d))


def init_mlstm_cache(cfg: ModelConfig, batch: int,
                     device) -> Dict[str, torch.Tensor]:
    """Zeroed f32 state (hd = dp / H, not ``cfg.head_dim``) and
    ``pos``."""
    h = cfg.n_heads
    hd = mlstm_width(cfg) // h
    return {"C": torch.zeros((batch, h, hd, hd), device=device),
            "n": torch.zeros((batch, h, hd), device=device),
            "m": torch.zeros((batch, h), device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _mlstm_qkvif(ctx: Ctx, p: MLSTM, u: torch.Tensor, h: int, prefix: str):
    b, s, dp = u.shape
    hd = dp // h
    q = linear(ctx, p.wq, u, f"{prefix}.wq").reshape(b, s, h, hd)
    k = linear(ctx, p.wk, u, f"{prefix}.wk").reshape(b, s, h, hd)
    v = linear(ctx, p.wv, u, f"{prefix}.wv").reshape(b, s, h, hd)
    gates = linear(ctx, p.w_if, u, f"{prefix}.w_if").float()
    return q, k, v, gates[..., :h], gates[..., h:]          # i, f (B, S, H)


def _mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_pre: torch.Tensor, f_pre: torch.Tensor,
                    chunk: int = MLSTM_CHUNK) -> torch.Tensor:
    """Chunked stabilised parallel mLSTM (JAX's ``_mlstm_parallel``):
    q, k, v (B, S, H, hd), gates (B, S, H) → (B, S, H, hd) f32. Keys
    past S are padded with ``a_k = +inf`` and the causal mask writes
    ``NEG``; each query row keeps an online max over its key chunks; the
    output is ``num / max(|den|, e^{−m})``."""
    b, s, h, hd = q.shape
    scale = 1.0 / hd ** 0.5
    fcum = torch.cumsum(F.logsigmoid(f_pre), dim=1)     # F_t (B, S, H)
    a_q, a_k = fcum, fcum - i_pre                       # F_t; F_s − ĩ_s
    c = min(chunk, s)
    pad = -s % c
    heads = lambda t: t.float().transpose(1, 2)         # noqa: E731
    q, k, v = heads(q), heads(k), heads(v)              # (B, H, S, hd)
    a_q, a_k = a_q.transpose(1, 2), a_k.transpose(1, 2)  # (B, H, S)
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        a_q = F.pad(a_q, (0, pad))
        a_k = F.pad(a_k, (0, pad), value=math.inf)
    causal = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    out = []
    for i in range(0, s + pad, c):
        qi, aqi = q[:, :, i:i + c], a_q[:, :, i:i + c, None]
        m = torch.full((b, h, c), NEG, device=q.device)
        num = torch.zeros((b, h, c, hd), device=q.device)
        den = torch.zeros((b, h, c), device=q.device)
        for j in range(0, i + c, c):                    # key chunks ≤ i
            ld = aqi - a_k[:, :, None, j:j + c]         # (B, H, cq, ck)
            if j == i:
                ld = ld.masked_fill(~causal, NEG)
            m_new = torch.maximum(m, ld.amax(-1))
            w = (qi @ k[:, :, j:j + c].transpose(-1, -2)) * scale \
                * torch.exp(ld - m_new[..., None])
            corr = torch.exp(m - m_new)
            num = num * corr[..., None] + w @ v[:, :, j:j + c]
            den = den * corr + w.sum(-1)
            m = m_new
        out.append(num / torch.maximum(den.abs(), torch.exp(-m))[..., None])
    return torch.cat(out, dim=2)[:, :, :s].transpose(1, 2)


def _mlstm_fold(k: torch.Tensor, v: torch.Tensor, i_pre: torch.Tensor,
                f_pre: torch.Tensor, cache: Dict,
                lengths: Optional[torch.Tensor] = None) -> Dict:
    """Fold a whole sequence into fresh (C, n, m, pos), each row up to its
    ``lengths`` entry: the closed form of JAX's ``_mlstm_fold`` scan,

        m_T = max(G + m_0, max_s(G_s + ĩ_s)),
        C_T = e^{G + m_0 − m_T}·C_0 + Σ_s e^{G_s + ĩ_s − m_T}·k_s v_sᵀ/√hd

    (n_T alike with k_s), where G_s = Σ_{s<u≤T} logσ(f_u) and G = G_{−1};
    G_s is a suffix sum, so the weights of recent steps, which carry the
    state, keep their precision however long the prompt."""
    b, s, h, hd = k.shape
    logf = F.logsigmoid(f_pre)                          # (B, S, H)
    valid = None
    if lengths is not None:
        valid = (torch.arange(s, device=k.device)[None, :]
                 < lengths.to(k.device)[:, None])[..., None]
        logf = torch.where(valid, logf, 0.0)
    suffix = torch.flip(torch.cumsum(torch.flip(logf, [1]), 1), [1])
    total = suffix[:, 0]                                 # G (B, H)
    lw = torch.cat([suffix[:, 1:], torch.zeros_like(total)[:, None]], 1) \
        + i_pre                                          # G_s + ĩ_s
    if valid is not None:
        lw = torch.where(valid, lw, -math.inf)
    m0 = cache["m"]
    m_t = torch.maximum(total + m0, lw.amax(1))          # (B, H)
    w = torch.exp(lw - m_t[:, None])                     # (B, S, H)
    decay = torch.exp(total + m0 - m_t)
    kw = (k.float() * w[..., None]).permute(0, 2, 3, 1)  # (B, H, hd, S)
    vh = v.float().transpose(1, 2)                       # (B, H, S, hd)
    root = hd ** 0.5
    add = lengths.to(torch.int32) if lengths is not None else s
    return {"C": decay[..., None, None] * cache["C"] + (kw @ vh) / root,
            "n": decay[..., None] * cache["n"] + kw.sum(-1) / root,
            "m": m_t, "pos": cache["pos"] + add}


def mlstm_seq(ctx: Ctx, p: MLSTM, x: torch.Tensor, cfg: ModelConfig,
              cache: Optional[Dict] = None, prefix: str = "mlstm",
              lengths: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence block (prefill / calibration); x (B, S, D): up
    (×2) → the parallel mixer → gated down-projection. With a cache: the
    sequence folded into a fresh state (rows to their ``lengths``)."""
    b, s, _ = x.shape
    u = linear(ctx, p.up, x, f"{prefix}.up")
    g = linear(ctx, p.up_gate, x, f"{prefix}.up_gate")
    q, k, v, i_pre, f_pre = _mlstm_qkvif(ctx, p, u, cfg.n_heads, prefix)
    mixed = _mlstm_parallel(q, k, v, i_pre, f_pre)
    y = mixed.reshape(b, s, -1).to(x.dtype) * F.silu(g)
    out = linear(ctx, p.down, y, f"{prefix}.down")
    if cache is not None:
        cache = _mlstm_fold(k, v, i_pre, f_pre, cache, lengths)
    return out, cache


def mlstm_step(ctx: Ctx, p: MLSTM, x: torch.Tensor, cache: Dict,
               cfg: ModelConfig, prefix: str = "mlstm"
               ) -> Tuple[torch.Tensor, Dict]:
    """Recurrent decode step, x (B, 1, D): the cache's four entries are
    rebound to the new state (module docstring)."""
    b = x.shape[0]
    u = linear(ctx, p.up, x, f"{prefix}.up")
    g = linear(ctx, p.up_gate, x, f"{prefix}.up_gate")
    q, k, v, i_pre, f_pre = _mlstm_qkvif(ctx, p, u, cfg.n_heads, prefix)
    hd = q.shape[-1]
    qt, kt, vt = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    it, ft = i_pre[:, 0], f_pre[:, 0]                    # (B, H)
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + cache["m"], it)
    i_s = torch.exp(it - m_new)
    f_s = torch.exp(logf + cache["m"] - m_new)
    C = f_s[..., None, None] * cache["C"] + i_s[..., None, None] * (
        kt[..., :, None] * vt[..., None, :]) / hd ** 0.5
    n = f_s[..., None] * cache["n"] + i_s[..., None] * kt / hd ** 0.5
    num = (qt[:, :, None, :] @ C)[:, :, 0]               # Σ_d q_d C_de
    den = (n * qt).sum(-1).abs()
    mixed = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    y = mixed.reshape(b, 1, -1).to(x.dtype) * F.silu(g)
    out = linear(ctx, p.down, y, f"{prefix}.down")
    cache.update(C=C, n=n, m=m_new, pos=cache["pos"] + 1)
    return out, cache


# ==========================================================================
# sLSTM
# ==========================================================================
class SLSTM(nn.Module):
    """``w_gates`` (d, 4d) with a bias, ``r_gates`` (H, hd, 4·hd) a raw
    f32 tensor (neither quantized nor tapped), ``w_out`` (d, d), the FFN
    ``ffn_up`` (d, dff) and ``ffn_down`` (dff, d)."""

    def __init__(self, w_gates: nn.Module, r_gates: torch.Tensor,
                 w_out: nn.Module, ffn_up: nn.Module, ffn_down: nn.Module):
        super().__init__()
        self.w_gates, self.w_out = w_gates, w_out
        self.ffn_up, self.ffn_down = ffn_up, ffn_down
        self.register_buffer("r_gates", r_gates)


def init_slstm(gen: torch.Generator, cfg: ModelConfig, device) -> SLSTM:
    """Random f32 mixer at ``init_slstm``'s scales: ``1/√fan_in`` each,
    ``r_gates`` N(0, 1/hd), ``w_gates``' bias zero."""
    d, h = cfg.d_model, cfg.n_heads
    hd, dff = d // h, int(d * cfg.slstm_proj_factor)

    def lin(m: int, n: int):
        return init_linear(gen, m, n, m ** -0.5, device)

    w_gates = lin(d, 4 * d)
    w_gates.b = torch.zeros((4 * d,), device=device)
    r_gates = torch.randn((h, hd, 4 * hd), generator=gen,
                          device=device) / hd ** 0.5
    return SLSTM(w_gates, r_gates, lin(d, d), lin(d, dff), lin(dff, d))


def init_slstm_cache(cfg: ModelConfig, batch: int,
                     device) -> Dict[str, torch.Tensor]:
    z = lambda: torch.zeros((batch, cfg.d_model), device=device)  # noqa
    return {"c": z(), "n": z(), "h": z(), "m": z(),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _slstm_scan(p: SLSTM, gates_x: torch.Tensor, state: Dict, heads: int,
                lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """The sLSTM over (B, S, 4d) input gates from ``state``: (hs (B, S, d)
    f32, the new c/n/h/m). A row stops updating its state past its
    ``lengths`` entry (and repeats its last h there), as JAX's scan."""
    b, s, d4 = gates_x.shape
    d = d4 // 4
    hd = d // heads
    r_g = p.r_gates.float()                              # (H, hd, 4hd)
    c, n, hh, m = state["c"], state["n"], state["h"], state["m"]
    live = None if lengths is None else (
        torch.arange(s, device=gates_x.device)[None, :]
        < lengths.to(gates_x.device)[:, None])           # (B, S)
    hs = []
    for t in range(s):
        # the recurrent term head-major, (B, H·4hd), as the reference
        # lays it out; then the z/i/f/o quarters
        gr = torch.bmm(hh.view(b, heads, hd).transpose(0, 1), r_g)
        g = gates_x[:, t].float() + gr.transpose(0, 1).reshape(b, d4)
        z_pre, i_pre, f_pre, o_pre = g.split(d, dim=-1)
        lf = F.logsigmoid(f_pre) + m
        m_new = torch.maximum(lf, i_pre)
        i_s = torch.exp(i_pre - m_new)
        f_s = torch.exp(lf - m_new)
        c_new = f_s * c + i_s * torch.tanh(z_pre)
        n_new = f_s * n + i_s
        h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
        if live is not None:
            lt = live[:, t, None]
            c_new = torch.where(lt, c_new, c)
            n_new = torch.where(lt, n_new, n)
            h_new = torch.where(lt, h_new, hh)
            m_new = torch.where(lt, m_new, m)
        c, n, hh, m = c_new, n_new, h_new, m_new
        hs.append(hh)
    return torch.stack(hs, dim=1), {"c": c, "n": n, "h": hh, "m": m}


def slstm_seq(ctx: Ctx, p: SLSTM, x: torch.Tensor, cfg: ModelConfig,
              cache: Optional[Dict] = None, prefix: str = "slstm",
              lengths: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence block; x (B, S, D): the input gates, the scan from
    the cache's state (zeros without one), ``w_out``, then the GeLU FFN
    added to it. With a cache: a fresh state with ``pos``."""
    state = cache if cache is not None else init_slstm_cache(
        cfg, x.shape[0], x.device)
    gates_x = linear(ctx, p.w_gates, x, f"{prefix}.w_gates")
    hs, new = _slstm_scan(p, gates_x, state, cfg.n_heads, lengths)
    y = linear(ctx, p.w_out, hs.to(x.dtype), f"{prefix}.w_out")
    y = y + linear(ctx, p.ffn_down,
                   gelu(linear(ctx, p.ffn_up, y, f"{prefix}.ffn_up")),
                   f"{prefix}.ffn_down")
    if cache is None:
        return y, None
    new["pos"] = cache["pos"] + (x.shape[1] if lengths is None
                                 else lengths.to(torch.int32))
    return y, new


def slstm_step(ctx: Ctx, p: SLSTM, x: torch.Tensor, cache: Dict,
               cfg: ModelConfig, prefix: str = "slstm"
               ) -> Tuple[torch.Tensor, Dict]:
    """One decode step, x (B, 1, D): the sequence form over one token, the
    cache's five entries rebound to its result."""
    y, new = slstm_seq(ctx, p, x, cfg, cache=cache, prefix=prefix)
    cache.update(new)
    return y, cache
