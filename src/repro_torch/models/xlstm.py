"""xLSTM LM: alternating mLSTM (matrix-memory) and sLSTM (scalar-memory)
blocks, per arXiv:2405.04517 (counterpart of ``repro.models.xlstm``;
family ``"ssm"``, config ``xlstm-125m``).

* sLSTM is a gated recurrence isomorphic to the paper's GRU: per step,
  gate pre-activations are ``x W + h R + b``. ``x W`` is hoisted out of the
  recurrence as one sequence-level product (decoupled W.x); ``h R`` is a
  block-diagonal matvec per head, the paper's row-wise target.
* mLSTM runs chunkwise-parallel over a sequence (quadratic within a chunk,
  recurrent across chunks, exp-gating stabilized); its decode step is the
  same state-update matvec regime.

Both recurrences are plain PyTorch (the JAX package has no kernel for
either: its sLSTM kernels serve the ``slstm-jet`` cell family, not this
block), so the model launches no kernel of the port's. Pairs are stacked
``(pairs, ...)`` as in JAX and run as a Python loop.

Serving. ``prefill`` runs the parallel forward and keeps each block's
final state; ``decode_step`` writes the new state into the cache IN PLACE
(the cache passed in is the cache returned, updated). One repair over
JAX: a prompt shorter than ``conv_width - 1`` keeps a conv tail that is
zero-padded in front (JAX keeps a tail that is too short, and its next
decode step raises), as JAX's own SSM mixer pads; the port's decode then
equals JAX's teacher-forced ``forward``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.params import Spec, init_params, stack_specs
from repro_torch.distributed.sharding import NO_SHARD, ShardCtx, constrain
from repro_torch.models import layers
from repro_torch.models.layers import cdtype, dense_apply, dense_specs
from repro_torch.models.ssm import _causal_conv, conv_step, conv_tail
from repro_torch.models.transformer import chunked_ce, layer_params

M_INIT = -1e30          # the stabilizer's start: exp(m) = 0 before any input


def _mdims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d = cfg.d_model
    di = int(cfg.xlstm.proj_factor * d)
    nh = cfg.num_heads
    return di, nh, di // nh


def _sdims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d = cfg.d_model
    nh = cfg.num_heads
    return d, nh, d // nh


# ---------------------------------------------------------------------------
# mLSTM cell
# ---------------------------------------------------------------------------

def mlstm_recurrent_step(q, k, v, i_gate, f_gate, state):
    """Single-step stabilized mLSTM. q/k/v: (B,NH,DH); i/f: (B,NH);
    state = (C (B,NH,DH,DH), n (B,NH,DH), m (B,NH)), float32."""
    C, n, m = state
    DH = q.shape[-1]
    k = k * (DH ** -0.5)
    logf = F.logsigmoid(f_gate.float())
    logi = i_gate.float()
    m_new = torch.maximum(logf + m, logi)
    fs = torch.exp(logf + m - m_new)[..., None]
    is_ = torch.exp(logi - m_new)[..., None]
    kf, vf, qf = k.float(), v.float(), q.float()
    C_new = (fs[..., None] * C
             + is_[..., None] * (kf[..., :, None] * vf[..., None, :]))
    n_new = fs * n + is_ * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C_new)
    den = torch.abs(torch.einsum("bhd,bhd->bh", qf, n_new))
    den = torch.maximum(den, torch.exp(-m_new))[..., None]
    return num / den, (C_new, n_new, m_new)


def chunk_len(S: int, chunk: int = 64) -> int:
    """The chunk ``mlstm_chunkwise`` runs: the largest length at most
    ``chunk`` that divides S (a prime S runs chunks of 1). It sets the
    summation order, so it is JAX's rule exactly."""
    L = min(chunk, S)
    while S % L:
        L -= 1
    return L


def mlstm_chunkwise(q, k, v, i_gate, f_gate, state, chunk: int = 64):
    """q/k/v: (B,NH,S,DH); i/f: (B,NH,S). Returns (h (B,NH,S,DH) float32,
    state')."""
    B, NH, S, DH = q.shape
    L = chunk_len(S, chunk)
    NC = S // L
    k = k * (DH ** -0.5)
    logf = F.logsigmoid(f_gate.float()).reshape(B, NH, NC, L)
    logi = i_gate.float().reshape(B, NH, NC, L)
    qc = q.reshape(B, NH, NC, L, DH).float()
    kc = k.reshape(B, NH, NC, L, DH).float()
    vc = v.reshape(B, NH, NC, L, DH).float()
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    C, n, m = state
    hs = []
    for c in range(NC):
        qb, kb, vb = qc[:, :, c], kc[:, :, c], vc[:, :, c]  # (B,NH,L,DH)
        lf, li = logf[:, :, c], logi[:, :, c]               # (B,NH,L)
        b = torch.cumsum(lf, dim=-1)                # within-chunk log-decay
        BL = b[..., -1:]
        g = torch.cummax(li - b, dim=-1).values     # max_j<=t (logi_j - b_j)
        m_intra = b + g
        m_inter = b + m[..., None]
        m_t = torch.maximum(m_inter, m_intra)       # (B,NH,L)
        # intra-chunk quadratic part
        dmat = (b[..., :, None] - b[..., None, :] + li[..., None, :]
                - m_t[..., :, None])                # (B,NH,L,L)
        dmat = torch.where(tri[None, None], dmat,
                           torch.full_like(dmat, float("-inf")))
        scores = torch.einsum("bhld,bhmd->bhlm", qb, kb) * torch.exp(dmat)
        num = torch.einsum("bhlm,bhmd->bhld", scores, vb)
        den = scores.sum(-1)
        # inter-chunk (previous state) part
        sc_inter = torch.exp(b + m[..., None] - m_t)  # (B,NH,L)
        num = num + torch.einsum("bhld,bhde->bhle", qb, C) * sc_inter[..., None]
        den = den + torch.einsum("bhld,bhd->bhl", qb, n) * sc_inter
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_t))[..., None])
        # state update to the end of the chunk
        m_new = torch.maximum((BL + m[..., None])[..., 0],
                              (BL + g[..., -1:])[..., 0])
        w = torch.exp(BL - b + li - m_new[..., None])  # (B,NH,L)
        decay = torch.exp(BL[..., 0] + m - m_new)
        C = (decay[..., None, None] * C
             + torch.einsum("bhl,bhld,bhle->bhde", w, kb, vb))
        n = decay[..., None] * n + torch.einsum("bhl,bhld->bhd", w, kb)
        m = m_new
    h = torch.stack(hs, 2).reshape(B, NH, S, DH)
    return h, (C, n, m)


def mlstm_init_state(batch: int, nh: int, dh: int, device="cpu"):
    return (torch.zeros((batch, nh, dh, dh), device=device),
            torch.zeros((batch, nh, dh), device=device),
            torch.full((batch, nh), M_INIT, device=device))


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------

def mlstm_block_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, nh, dh = _mdims(cfg)
    w = cfg.xlstm.conv_width
    return {
        "ln": layers.norm_specs(d, cfg.norm),
        "w_up": dense_specs(d, 2 * di, ("embed", "gates")),
        "conv": Spec((w, di), ("conv", "gates"), init="fan_in"),
        "conv_b": Spec((di,), ("gates",), init="zeros"),
        "wq": dense_specs(di, di, ("gates", "heads")),
        "wk": dense_specs(di, di, ("gates", "heads")),
        "wv": dense_specs(di, di, ("gates", "heads")),
        "w_i": dense_specs(di, nh, ("gates", None), bias=True),
        "w_f": dense_specs(di, nh, ("gates", None), bias=True),
        "out_norm": Spec((nh, dh), (None, "head_dim"), init="ones"),
        "w_down": dense_specs(di, d, ("gates", "embed")),
        "skip": Spec((di,), ("gates",), init="ones"),
    }


def _heads(x, nh):
    B, S, D = x.shape
    return x.reshape(B, S, nh, D // nh).transpose(1, 2)      # (B,NH,S,DH)


def _headnorm(scale, h, eps=1e-6):
    """Per-head RMS norm in float32. h: (B,NH,S,DH) or (B,NH,DH)."""
    hf = h.float()
    var = (hf * hf).mean(-1, keepdim=True)
    s = scale.float()
    s = s[None, :, None, :] if h.dim() == 4 else s[None, :, :]
    return hf * torch.rsqrt(var + eps) * s


def mlstm_block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                      ctx: ShardCtx = NO_SHARD, chunk: int = 64,
                      return_state: bool = False):
    di, nh, dh = _mdims(cfg)
    B, S, _ = x.shape
    hln = layers.norm_apply(p["ln"], x, cfg.norm)
    up = dense_apply(p["w_up"], hln)
    xi, z = torch.chunk(up, 2, dim=-1)
    xc = F.silu(_causal_conv(xi, p["conv"], p["conv_b"]))
    q = _heads(dense_apply(p["wq"], xc), nh)
    k = _heads(dense_apply(p["wk"], xc), nh)
    v = _heads(dense_apply(p["wv"], xi), nh)
    ig = dense_apply(p["w_i"], xc).transpose(1, 2)           # (B,NH,S)
    fg = dense_apply(p["w_f"], xc).transpose(1, 2)
    h, (C, n, m) = mlstm_chunkwise(q, k, v, ig, fg,
                                   mlstm_init_state(B, nh, dh, x.device),
                                   chunk)
    h = _headnorm(p["out_norm"], h)                          # (B,NH,S,DH)
    h = h.transpose(1, 2).reshape(B, S, di).to(x.dtype)
    h = (h + xc * p["skip"].to(x.dtype)[None, None, :]) * F.silu(z)
    out = x + dense_apply(p["w_down"], h)
    if not return_state:
        return out
    return out, {"conv_buf": conv_tail(xi, cfg.xlstm.conv_width),
                 "C": C, "n": n, "mm": m}


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

def slstm_block_specs(cfg: ModelConfig) -> dict:
    d, nh, dh = _sdims(cfg)
    w = cfg.xlstm.conv_width
    ff = -(-int(d * 4 / 3) // 64) * 64
    return {
        "ln": layers.norm_specs(d, cfg.norm),
        "conv": Spec((w, d), ("conv", "embed"), init="fan_in"),
        "conv_b": Spec((d,), ("embed",), init="zeros"),
        # decoupled input projection: one product for all 4 gates
        "w": dense_specs(d, 4 * d, ("embed", "gates")),
        # recurrent block-diagonal matrix: the paper's row-wise target
        "r": Spec((nh, dh, 4 * dh), (None, "hidden", "gates"),
                  init="recurrent"),
        "b": Spec((4 * d,), ("gates",),
                  init="zeros"),                 # raw gate bias, read fp32
        "out_norm": Spec((nh, dh), (None, "head_dim"), init="ones"),
        "up": dense_specs(d, 2 * ff, ("embed", "mlp")),
        "down": dense_specs(ff, d, ("mlp", "embed")),
    }


def slstm_step(p: dict, cfg: ModelConfig, state, xw_t: torch.Tensor):
    """One sLSTM step. xw_t: (B,4D) precomputed x W (decoupled); state =
    (c,n,m,h) each (B,D) float32. Returns (state', h_out (B,D))."""
    d, nh, dh = _sdims(cfg)
    c, n, m, h = state
    B = h.shape[0]
    rg = torch.einsum("bhd,hde->bhe", h.reshape(B, nh, dh).float(),
                      p["r"].float()).reshape(B, 4 * d)
    g = xw_t.float() + rg + p["b"].float()
    zt, it, ft, ot = torch.chunk(g, 4, dim=-1)
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(logf + m - m_new)
    c_new = f_ * c + i_ * torch.tanh(zt)
    n_new = f_ * n + i_
    h_new = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, m_new, h_new), h_new


def slstm_init_state(batch: int, d: int, device="cpu"):
    z = torch.zeros((batch, d), device=device)
    return (z, z, torch.full((batch, d), M_INIT, device=device), z)


def _slstm_out(p: dict, cfg: ModelConfig, x, h):
    """The block after the cell: per-head norm of h (B,S,D), residual, the
    gated GELU MLP."""
    d, nh, dh = _sdims(cfg)
    B, S, _ = h.shape
    h = _headnorm(p["out_norm"], h.reshape(B, S, nh, dh).transpose(1, 2))
    h = h.transpose(1, 2).reshape(B, S, d).to(x.dtype)
    x = x + h
    u, zg = torch.chunk(dense_apply(p["up"], x), 2, dim=-1)
    # jax.nn.gelu's default is the tanh approximation
    return x + dense_apply(p["down"], F.gelu(u, approximate="tanh") * zg)


def slstm_block_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                      ctx: ShardCtx = NO_SHARD, return_state: bool = False):
    d, nh, dh = _sdims(cfg)
    B, S, _ = x.shape
    hln = layers.norm_apply(p["ln"], x, cfg.norm)
    xc = F.silu(_causal_conv(hln, p["conv"], p["conv_b"]))
    xw = dense_apply(p["w"], xc)                           # (B,S,4D) one product
    state = slstm_init_state(B, d, x.device)
    hs = []
    for t in range(S):
        state, h_t = slstm_step(p, cfg, state, xw[:, t])
        hs.append(h_t)
    out = _slstm_out(p, cfg, x, torch.stack(hs, 1))
    if not return_state:
        return out
    c, n, m, hT = state
    return out, {"conv_buf": conv_tail(hln, cfg.xlstm.conv_width),
                 "c": c, "n": n, "sm": m, "h": hT}


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

def lm_specs(cfg: ModelConfig) -> dict:
    pairs = cfg.num_layers // 2
    return {
        "embed": layers.embed_specs(cfg.vocab_size, cfg.d_model),
        "pairs": stack_specs({"m": mlstm_block_specs(cfg),
                              "s": slstm_block_specs(cfg)}, pairs),
        "final_norm": layers.norm_specs(cfg.d_model, cfg.norm),
        "lm_head": Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                        init="fan_in"),
    }


def hidden_states(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                  ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    x = layers.embed_apply(params["embed"], tokens, cdtype(cfg))
    x = constrain(x, ("batch", "act_seq", "act_embed"), ctx)
    for i in range(cfg.num_layers // 2):
        p_pair = layer_params(params["pairs"], i)
        x = mlstm_block_apply(p_pair["m"], cfg, x, ctx=ctx)
        x = slstm_block_apply(p_pair["s"], cfg, x, ctx=ctx)
        x = constrain(x, ("batch", "act_seq", "act_embed"), ctx)
    return layers.norm_apply(params["final_norm"], x, cfg.norm)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """Full logits (B,S,V) in fp32."""
    h = hidden_states(params, cfg, tokens, ctx=ctx)
    return layers.unembed_apply(params["lm_head"], h, tied=False)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            ctx: ShardCtx = NO_SHARD):
    """batch: {tokens, targets, mask optional} -> (ce, {"ce", "aux" = 0})."""
    h = hidden_states(params, cfg, batch["tokens"], ctx=ctx)
    ce = chunked_ce(h, params["lm_head"], batch["targets"], batch.get("mask"),
                    tied=False)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                              device=ce.device)}


def init_prepared(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """The served tree: ``layers.prepare_dense_params(init_params(
    lm_specs(cfg), seed, cfg.param_dtype), cfg, device)`` value for value
    (the dense weights, ``embed`` and ``lm_head`` in the compute dtype,
    every other leaf in the param dtype, as the model reads it), built
    leaf by leaf."""
    return layers.init_prepared_dense(lm_specs(cfg), cfg, seed, device)


# --- serving ------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, capacity: int = 0) -> dict:
    """Recurrent state only: O(1) in context length."""
    pairs = cfg.num_layers // 2
    d = cfg.d_model
    di, nh, dh = _mdims(cfg)
    w = cfg.xlstm.conv_width
    f32 = "float32"
    return {
        "m": {"conv_buf": Spec((pairs, batch, w - 1, di),
                               ("layers", "batch", None, "gates"),
                               init="zeros", dtype=cfg.dtype),
              "C": Spec((pairs, batch, nh, dh, dh),
                        ("layers", "batch", None, "head_dim", None),
                        init="zeros", dtype=f32),
              "n": Spec((pairs, batch, nh, dh),
                        ("layers", "batch", None, "head_dim"), init="zeros",
                        dtype=f32),
              "mm": Spec((pairs, batch, nh), ("layers", "batch", None),
                         init="zeros", dtype=f32)},
        "s": {"conv_buf": Spec((pairs, batch, w - 1, d),
                               ("layers", "batch", None, "embed"),
                               init="zeros", dtype=cfg.dtype),
              "c": Spec((pairs, batch, d), ("layers", "batch", None),
                        init="zeros", dtype=f32),
              "n": Spec((pairs, batch, d), ("layers", "batch", None),
                        init="zeros", dtype=f32),
              "sm": Spec((pairs, batch, d), ("layers", "batch", None),
                         init="zeros", dtype=f32),
              "h": Spec((pairs, batch, d), ("layers", "batch", None),
                        init="zeros", dtype=f32)},
        "pos": Spec((), (), init="zeros", dtype="int32"),
    }


def init_cache(cfg: ModelConfig, batch: int, capacity: int = 0,
               device="cuda") -> dict:
    """An empty cache (JAX's: stabilizers at -1e30, ``pos`` 0)."""
    c = init_params(cache_specs(cfg, batch), device=device)
    c["m"]["mm"] -= 1e30
    c["s"]["sm"] -= 1e30
    return c


def _mlstm_decode(p, cfg, x, cm, i):
    """Pair ``i``'s mLSTM block on one token; its cache slices of ``cm``
    updated in place."""
    di, nh, dh = _mdims(cfg)
    B = x.shape[0]
    hln = layers.norm_apply(p["ln"], x, cfg.norm)[:, 0]     # (B,D)
    up = dense_apply(p["w_up"], hln)
    xi, z = torch.chunk(up, 2, dim=-1)
    conv, window = conv_step(cm["conv_buf"][i], xi, p["conv"], p["conv_b"])
    xc = F.silu(conv)
    q = dense_apply(p["wq"], xc).reshape(B, nh, dh)
    k = dense_apply(p["wk"], xc).reshape(B, nh, dh)
    v = dense_apply(p["wv"], xi).reshape(B, nh, dh)
    ig = dense_apply(p["w_i"], xc)                           # (B,NH)
    fg = dense_apply(p["w_f"], xc)
    h, (C, n, m) = mlstm_recurrent_step(q, k, v, ig, fg,
                                        (cm["C"][i], cm["n"][i], cm["mm"][i]))
    h = _headnorm(p["out_norm"], h).reshape(B, di).to(x.dtype)
    h = (h + xc * p["skip"].to(x.dtype)[None, :]) * F.silu(z)
    for key, val in (("conv_buf", window[:, 1:]), ("C", C), ("n", n),
                     ("mm", m)):
        cm[key][i].copy_(val)
    return x + dense_apply(p["w_down"], h)[:, None, :]


def _slstm_decode(p, cfg, x, cs, i):
    """Pair ``i``'s sLSTM block on one token; its cache slices of ``cs``
    updated in place."""
    hln = layers.norm_apply(p["ln"], x, cfg.norm)[:, 0]
    conv, window = conv_step(cs["conv_buf"][i], hln, p["conv"], p["conv_b"])
    xw = dense_apply(p["w"], F.silu(conv))
    state = (cs["c"][i], cs["n"][i], cs["sm"][i], cs["h"][i])
    (c, n, m, h), h_out = slstm_step(p, cfg, state, xw)
    x = _slstm_out(p, cfg, x, h_out[:, None, :])
    for key, val in (("conv_buf", window[:, 1:]), ("c", c), ("n", n),
                     ("sm", m), ("h", h)):
        cs[key][i].copy_(val)
    return x


def decode_step(params: dict, cfg: ModelConfig, cache: dict,
                tokens: torch.Tensor, *, ctx: ShardCtx = NO_SHARD):
    """tokens (B,) -> (logits (B,V) fp32, the cache updated in place)."""
    x = layers.embed_apply(params["embed"], tokens[:, None], cdtype(cfg))
    for i in range(cfg.num_layers // 2):
        p_pair = layer_params(params["pairs"], i)
        x = _mlstm_decode(p_pair["m"], cfg, x, cache["m"], i)
        x = _slstm_decode(p_pair["s"], cfg, x, cache["s"], i)
    x = layers.norm_apply(params["final_norm"], x, cfg.norm)
    logits = layers.unembed_apply(params["lm_head"], x[:, 0], tied=False)
    return logits, {"m": cache["m"], "s": cache["s"], "pos": cache["pos"] + 1}


def _stack_states(states):
    return {k: torch.stack([s[k] for s in states], 0) for k in states[0]}


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            ctx: ShardCtx = NO_SHARD):
    """Chunkwise-parallel prefill: the sequence runs through the parallel
    forward (mLSTM chunkwise, sLSTM with the decoupled xW product) and the
    decode cache is each block's final state. tokens (B,S) -> (last-token
    logits (B,V) fp32, cache)."""
    B, S = tokens.shape
    x = layers.embed_apply(params["embed"], tokens, cdtype(cfg))
    x = constrain(x, ("batch", "act_seq", "act_embed"), ctx)
    m_states, s_states = [], []
    for i in range(cfg.num_layers // 2):
        p_pair = layer_params(params["pairs"], i)
        x, m_state = mlstm_block_apply(p_pair["m"], cfg, x, ctx=ctx,
                                       return_state=True)
        x, s_state = slstm_block_apply(p_pair["s"], cfg, x, ctx=ctx,
                                       return_state=True)
        m_states.append(m_state)
        s_states.append(s_state)
    x = layers.norm_apply(params["final_norm"], x, cfg.norm)
    logits = layers.unembed_apply(params["lm_head"], x[:, -1], tied=False)
    cache = {"m": _stack_states(m_states), "s": _stack_states(s_states),
             "pos": torch.tensor(S - 1, dtype=torch.int32, device=x.device)}
    return logits, cache


def prefill_sequential(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                       *, ctx: ShardCtx = NO_SHARD):
    """Baseline: per-token prefill through decode steps (re-reads every
    weight each step)."""
    B, S = tokens.shape
    cache = init_cache(cfg, B, device=tokens.device)
    for t in range(S):
        logits, cache = decode_step(params, cfg, cache, tokens[:, t],
                                    ctx=ctx)
    return logits, cache
