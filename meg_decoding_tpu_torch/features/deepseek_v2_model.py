"""DeepSeek-V2 (arXiv:2405.04434) as the text-stimulus encoder: the
decoder stack of transformers' ``DeepseekV2Model`` (the model's own
``modeling_deepseek.py``), without the LM head, for inference.

Per layer (RMSNorm eps ``rms_norm_eps``; ``kv_a_layernorm`` at 1e-6, its
class default there):

* **MLA**, multi-head latent attention without a q LoRA:
  ``q = q_proj(x)`` → per head 128 "nope" + 64 rope dims;
  ``kv_a_proj_with_mqa(x)`` → a 512-d latent ``c`` and one 64-d rope key
  shared by every head; ``kv_b_proj(kv_a_layernorm(c))`` → per head a
  128-d key and a 128-d value.  The rope dims are de-interleaved (pair
  (2i, 2i+1) → (i, i + 32)) before ``rotate_half``, as DeepSeek's
  ``apply_rotary_pos_emb`` does, with YaRN's ``inv_freq``
  (``rope_inv_freq``) and cos/sin scaled by ``rope_mscale``.  Scores are
  scaled by ``softmax_scale``: 192^−½ · m², m = 0.1·``mscale_all_dim``·
  ln(factor) + 1.
* **MLP**: the first ``first_k_dense_replace`` layers a SwiGLU
  (``down(silu(gate(x)) · up(x))``); the others an MoE: a softmax over the
  ``n_routed_experts`` in f32 from f32 router logits, the greedy top
  ``num_experts_per_tok`` as weights (not renormalised), each routed
  expert a SwiGLU of ``moe_intermediate_size``, and the shared experts one
  SwiGLU of ``n_shared_experts · moe_intermediate_size`` added in bf16.

The MoE is an expert-parallel layer on one card: it routes over all
experts with ``ops/kernels/moe.py:moe_route`` (the kernel also sorts the
(token, slot) pairs by expert), gathers the tokens in that order, runs the
routed experts as two grouped GEMMs over the sorted rows
(``torch._grouped_mm``, PyTorch's grouped matrix product: on sm90 one
launch each for all 64 experts, reading each expert's weights once), and
sums each token's six rows and the shared experts' output with
``moe_combine``.  The experts' weights live in two stacked tensors,
``w13`` (E, 2I, H) and ``w2`` (E, H, I), of which each expert's
``gate_proj``, ``up_proj`` and ``down_proj`` weights are views, so the
parameters keep transformers' names and a checkpoint loads in place.  A
dense SwiGLU's gate and up weights are views of one (2I, H) tensor the
same way (one product for both).

**The forward is one chunk.**  ``forward(input_ids, positions)`` takes C
token ids at the last C of ``positions`` (``positions[:L − C]`` are the
document's earlier tokens) and returns the last ``keep`` hidden states of
the chunk (the last with the final norm applied, as transformers'
``output_hidden_states`` gives them).  Each layer writes the chunk's
latent ``kv_a_layernorm(c)`` and rope key into ``latent_cache`` (layers,
positions, 512 + 64) at positions L − C .. L, and attends over the cache's
first L positions, causally (queries are the last C, lower-right
aligned): the prefix's keys and values are expanded through ``kv_b_proj``
every chunk, ~4.2 MFLOP a prefix token a layer, against 1,152 bytes a
token a layer kept (the expanded keys and values would be 10,240).
Every shape of the chunk is static for a given L, so one CUDA graph a
chunk position runs it (``features/text_llm.py``).  The chunk also writes
each MoE layer's routing of its tokens into ``route_ids`` (MoE layers,
positions, k) and adds the experts chosen for the tokens below
``n_valid`` to ``expert_counts`` (MoE layers, E) int32.  ``allocate``
makes these once; a capture holds their addresses.

Scopes (``utils/profiling.py``): ``mla`` (the input norm, projections,
rope, the cache's write and read, the expansion, attention, ``o_proj``),
``moe_route`` (router logits, the route kernel, the gather into expert
order), ``moe_experts`` (the grouped GEMMs, the SwiGLU between them, the
combine), ``moe_shared`` (the shared experts; also the dense layer's
MLP, the same SwiGLU).

Departures from ``modeling_deepseek.py``: rope is applied in f32 to the
bf16 projections and rounded once (there cos/sin are cast to bf16 and the
rotation runs in bf16); attention is PyTorch's
``scaled_dot_product_attention``, flash attention on the card (f32
accumulation, probabilities rounded to bf16 before the product with V, as
there); the router's softmax is exp(l − max)/Σ.  Supported:
``q_lora_rank`` None, ``scoring_func`` softmax, ``topk_method`` greedy,
``norm_topk_prob`` False, ``routed_scaling_factor`` 1, SiLU, no attention
bias (DeepSeek-V2-Lite's values); anything else raises.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention.bias import causal_lower_right

from meg_decoding_tpu_torch.ops.kernels.moe import moe_combine, moe_route
from meg_decoding_tpu_torch.utils.profiling import scope

__all__ = ["DeepseekV2Config", "DSV2_LITE", "DeepseekV2Model",
           "rope_inv_freq", "rope_mscale", "softmax_scale",
           "yarn_get_mscale"]

_KV_A_EPS = 1e-6  # DeepseekV2RMSNorm's default, which kv_a_layernorm keeps


def _yarn():
    return {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
            "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
            "type": "yarn"}


@dataclass(frozen=True)
class DeepseekV2Config:
    """The keys of ``DeepseekV2Config`` the forward reads; the defaults are
    DeepSeek-V2-Lite's ``config.json``."""
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: dict | None = field(default_factory=_yarn)
    max_position_embeddings: int = 163840

    # the values of the keys this forward does not implement otherwise
    _FIXED = {"q_lora_rank": None, "scoring_func": "softmax",
              "topk_method": "greedy", "norm_topk_prob": False,
              "routed_scaling_factor": 1, "hidden_act": "silu",
              "attention_bias": False, "n_group": 1, "topk_group": 1}

    # the settings of the shared MLA and MoE classes that DeepSeek-V2 fixes
    # (another model's config sets them: features/kimi_linear_model.py)
    mla_use_nope = False
    scoring_func = "softmax"
    norm_topk_prob = False
    routed_scaling_factor = 1.0
    experts_first = 0
    experts_held = None   # all n_routed_experts

    @classmethod
    def from_dict(cls, d: dict) -> "DeepseekV2Config":
        """From a ``config.json`` (unknown keys ignored); raises for a
        setting this forward does not implement."""
        for key, want in cls._FIXED.items():
            got = d.get(key, want)
            if got != want and not (key in ("n_group", "topk_group")
                                    and got is None):
                raise NotImplementedError(f"{key} = {got!r} (only {want!r})")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, i: int) -> bool:
        return (self.n_routed_experts is not None
                and i >= self.first_k_dense_replace
                and i % self.moe_layer_freq == 0)

    @property
    def moe_layers(self) -> list:
        return [i for i in range(self.num_hidden_layers) if self.is_moe(i)]


DSV2_LITE = DeepseekV2Config()


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations, dim, base, max_pos) -> float:
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) \
        / (2 * math.log(base))


def rope_inv_freq(cfg: DeepseekV2Config) -> torch.Tensor:
    """(rope dim / 2,) f32 on the CPU: YaRN's blend of the interpolated
    and the original frequencies (DeepseekV2YarnRotaryEmbedding), or the
    plain rope frequencies without ``rope_scaling``."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device="cpu") / dim
    extra = 1.0 / (base ** ar)
    rs = cfg.rope_scaling
    if not rs:
        return extra
    if rs.get("type") != "yarn":
        raise NotImplementedError(
            f"rope_scaling {rs.get('type')!r} (only yarn)")
    factor, orig = rs["factor"], rs["original_max_position_embeddings"]
    inter = 1.0 / (factor * base ** ar)
    low = max(math.floor(_correction_dim(rs.get("beta_fast", 32), dim, base,
                                         orig)), 0)
    high = min(math.ceil(_correction_dim(rs.get("beta_slow", 1), dim, base,
                                         orig)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device="cpu") - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def rope_mscale(cfg: DeepseekV2Config) -> float:
    """The factor on YaRN's cos and sin (1 where ``mscale`` equals
    ``mscale_all_dim``, as in DeepSeek-V2-Lite)."""
    rs = cfg.rope_scaling
    if not rs:
        return 1.0
    f = rs["factor"]
    return (yarn_get_mscale(f, rs.get("mscale", 1))
            / yarn_get_mscale(f, rs.get("mscale_all_dim", 0)))


def softmax_scale(cfg: DeepseekV2Config) -> float:
    """192^−½, times m² with m = yarn_get_mscale(factor, mscale_all_dim)."""
    s = cfg.q_head_dim ** -0.5
    rs = cfg.rope_scaling
    if rs and rs.get("mscale_all_dim", 0):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        s = s * m * m
    return s


def _deinterleave(x: torch.Tensor) -> torch.Tensor:
    """(…, d) with pairs (2i, 2i + 1) → (…, d) with them at (i, i + d/2)."""
    d = x.shape[-1]
    return x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """DeepSeek's rotation of x (C, …, d) at cos/sin (C, d/2) f32: the
    pairs de-interleaved, then x·cos + rotate_half(x)·sin, in f32, rounded
    once to x's dtype."""
    y = _deinterleave(x).float()
    a, b = y.chunk(2, dim=-1)
    shape = (cos.shape[0],) + (1,) * (x.dim() - 2) + (cos.shape[1],)
    c, s = cos.reshape(shape), sin.reshape(shape)
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1).to(x.dtype)


def _attention(q, k, v, scale: float) -> torch.Tensor:
    """Causal attention of the chunk's queries q (C, nh, d) over the
    document's keys k (L, nh, d) and values v (L, nh, dv), the queries at
    the last C positions: (C, nh, dv).  On the card, flash attention with
    its lower-right causal mask, V zero-padded to d (flash takes one head
    size; the padded dims of the output are dropped); on the CPU the mask
    is materialised."""
    C, L, dv, d = q.shape[0], k.shape[0], v.shape[-1], q.shape[-1]
    q, k = q.transpose(0, 1)[None], k.transpose(0, 1)[None]
    if q.device.type == "cuda":
        v = F.pad(v, (0, d - dv)).transpose(0, 1)[None]
        o = F.scaled_dot_product_attention(
            q, k, v, attn_mask=causal_lower_right(C, L), scale=scale)
        return o[0, ..., :dv].transpose(0, 1)
    mask = torch.ones(C, L, dtype=torch.bool, device=q.device).tril(L - C)
    o = F.scaled_dot_product_attention(q, k, v.transpose(0, 1)[None],
                                       attn_mask=mask, scale=scale)
    return o[0].transpose(0, 1)


class _Linear(nn.Module):
    """A bias-free linear map over ``weight`` (out, in), which may be a view
    of a larger tensor."""

    def __init__(self, weight: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)

    def forward(self, x):
        return F.linear(x, self.weight)


class _Embedding(nn.Module):
    def __init__(self, n: int, h: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, h, dtype=dtype),
                                   requires_grad=False)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class RMSNorm(nn.Module):
    """DeepseekV2RMSNorm: the mean square in f32, the weight applied in the
    input's dtype."""

    def __init__(self, n: int, eps: float, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n, dtype=dtype),
                                   requires_grad=False)
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * x32.to(x.dtype)


class MLP(nn.Module):
    """DeepseekV2MLP, ``down(silu(gate(x)) · up(x))``; gate and up are views
    of one (2I, H) weight, one product for both."""

    def __init__(self, hidden: int, inter: int, dtype):
        super().__init__()
        self.w13 = torch.empty(2 * inter, hidden, dtype=dtype)
        self.gate_proj = _Linear(self.w13[:inter])
        self.up_proj = _Linear(self.w13[inter:])
        self.down_proj = _Linear(torch.empty(hidden, inter, dtype=dtype))
        self.inter = inter

    def forward(self, x):
        g, u = F.linear(x, self.w13).split(self.inter, dim=-1)
        return self.down_proj(F.silu(g) * u)


class _Expert(nn.Module):
    def __init__(self, gate, up, down):
        super().__init__()
        self.gate_proj, self.up_proj = _Linear(gate), _Linear(up)
        self.down_proj = _Linear(down)


class _Experts(nn.ModuleDict):
    """The experts held, by their ids among all the routed experts (so a
    checkpoint's ``experts.<id>`` names load in place); ``[e]`` takes the
    id."""

    def __getitem__(self, e):
        return super().__getitem__(str(e))


class _Gate(nn.Module):
    """A sigmoid router: ``weight`` (E, H) and the f32 selection bias
    ``e_score_correction_bias`` (E,) (DeepSeek-V3's and Kimi's MoEGate)."""

    def __init__(self, E: int, H: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(E, H, dtype=dtype),
                                   requires_grad=False)
        self.e_score_correction_bias = nn.Parameter(
            torch.empty(E, dtype=torch.float32), requires_grad=False)


class _Chunk:
    """What every layer of one chunk's forward shares: its positions
    [start, end) of the document, its rope cos/sin (C, d/2) f32, the
    tokens below ``n_valid`` (a one-int32 tensor) that are not padding."""
    __slots__ = ("start", "end", "cos", "sin", "n_valid")

    def __init__(self, start, end, cos, sin, n_valid):
        self.start, self.end = start, end
        self.cos, self.sin, self.n_valid = cos, sin, n_valid


class MLA(nn.Module):
    """DeepseekV2Attention (``q_lora_rank`` None) over the latent cache;
    with ``mla_use_nope`` (Kimi-Linear) the 64 "rope" dims of q and of the
    shared key are used as they come, unrotated."""

    def __init__(self, cfg: DeepseekV2Config, dtype):
        super().__init__()
        H, nh = cfg.hidden_size, cfg.num_attention_heads
        self.nh, self.r = nh, cfg.kv_lora_rank
        self.nope, self.rope, self.v = (cfg.qk_nope_head_dim,
                                        cfg.qk_rope_head_dim, cfg.v_head_dim)
        self.q_proj = _Linear(torch.empty(nh * cfg.q_head_dim, H, dtype=dtype))
        self.kv_a_proj_with_mqa = _Linear(torch.empty(
            self.r + self.rope, H, dtype=dtype))
        self.kv_a_layernorm = RMSNorm(self.r, _KV_A_EPS, dtype)
        self.kv_b_proj = _Linear(torch.empty(nh * (self.nope + self.v),
                                             self.r, dtype=dtype))
        self.o_proj = _Linear(torch.empty(H, nh * self.v, dtype=dtype))
        self.scale = softmax_scale(cfg)
        self.use_rope = not cfg.mla_use_nope

    def _prefix(self, cache: torch.Tensor, start: int, end: int):
        """The cache's positions [0, end): the document's latents so far."""
        return cache[:end]

    def forward(self, x, ctx: _Chunk, cache: torch.Tensor):
        C, nh, r = x.shape[0], self.nh, self.r
        q = self.q_proj(x).view(C, nh, self.nope + self.rope)
        q_nope, q_pe = q.split([self.nope, self.rope], dim=-1)
        c, k_pe = self.kv_a_proj_with_mqa(x).split([r, self.rope], dim=-1)
        cache[ctx.start:ctx.end, :r] = self.kv_a_layernorm(c)
        cache[ctx.start:ctx.end, r:] = (apply_rope(k_pe, ctx.cos, ctx.sin)
                                        if self.use_rope else k_pe)
        prefix = self._prefix(cache, ctx.start, ctx.end)
        L = prefix.shape[0]
        kv = self.kv_b_proj(prefix[:, :r]).view(L, nh, self.nope + self.v)
        k_nope, value = kv.split([self.nope, self.v], dim=-1)
        k = torch.cat([k_nope, prefix[:, None, r:].expand(L, nh, self.rope)],
                      dim=-1)
        qq = (torch.cat([q_nope, apply_rope(q_pe, ctx.cos, ctx.sin)], dim=-1)
              if self.use_rope else q)
        o = _attention(qq, k, value, self.scale)
        return self.o_proj(o.reshape(C, nh * self.v))


class DeepseekV2MoE(nn.Module):
    """The expert-parallel MoE layer (module docstring); ``index`` is its
    row in the model's routing record and counter.  It routes over all
    ``n_routed_experts`` and holds the experts ``experts_first`` ..
    ``experts_first + experts_held − 1`` (all by default): a (token, slot)
    pair sent to another expert adds nothing here, as on one card of an
    expert-parallel deployment without its exchange.  Scoring by
    ``scoring_func``: softmax (DeepSeek-V2), or sigmoid with the gate's
    selection bias; then ``norm_topk_prob`` renormalises the k weights and
    ``routed_scaling_factor`` scales them (``ops/kernels/moe.py``)."""

    _EXPERT = _Expert  # an expert's module, by its checkpoint's names

    def __init__(self, cfg, index: int, dtype):
        super().__init__()
        E, I, H = (cfg.n_routed_experts, cfg.moe_intermediate_size,
                   cfg.hidden_size)
        self.first = cfg.experts_first
        self.held = cfg.experts_held or E
        self.index, self.k, self.inter = index, cfg.num_experts_per_tok, I
        self.sigmoid = cfg.scoring_func == "sigmoid"
        self.renormalize = bool(cfg.norm_topk_prob)
        self.scale = float(cfg.routed_scaling_factor)
        self.gate = (_Gate(E, H, dtype) if self.sigmoid
                     else _Linear(torch.empty(E, H, dtype=dtype)))
        self.w13 = torch.empty(self.held, 2 * I, H, dtype=dtype)
        self.w2 = torch.empty(self.held, H, I, dtype=dtype)
        self.experts = _Experts(
            (str(self.first + e), self._EXPERT(self.w13[e, :I],
                                               self.w13[e, I:], self.w2[e]))
            for e in range(self.held))
        self.shared_experts = (MLP(H, I * cfg.n_shared_experts, dtype)
                               if cfg.n_shared_experts else None)

    def _logits(self, x):
        """The router's logits in f32 (MoEGate.forward)."""
        return F.linear(x.float(), self.gate.weight.float())

    def _shared(self, x):
        return None if self.shared_experts is None else self.shared_experts(x)

    def forward(self, x, ctx: _Chunk, counter, ids_out):
        with scope("moe_route"):
            w, _, offs, pos, token = moe_route(
                self._logits(x), self.k, ctx.n_valid, counter, ids_out,
                self.gate.e_score_correction_bias if self.sigmoid else None,
                self.renormalize, self.scale, self.first, self.held)
            xs = x.index_select(0, token)
        with scope("moe_experts"):
            gu = torch._grouped_mm(xs, self.w13.transpose(1, 2), offs=offs)
            h = F.silu(gu[:, :self.inter]) * gu[:, self.inter:]
            ys = torch._grouped_mm(h, self.w2.transpose(1, 2), offs=offs)
        with scope("moe_shared"):
            shared = self._shared(x)
        with scope("moe_experts"):
            return moe_combine(ys, pos, w, shared)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, i: int, moe_index, dtype):
        super().__init__()
        eps = cfg.rms_norm_eps
        self.self_attn = MLA(cfg, dtype)
        self.mlp = (DeepseekV2MoE(cfg, moe_index, dtype) if cfg.is_moe(i)
                    else MLP(cfg.hidden_size, cfg.intermediate_size, dtype))
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps, dtype)

    def forward(self, h, ctx: _Chunk, cache, record):
        with scope("mla"):
            h = h + self.self_attn(self.input_layernorm(h), ctx, cache)
        x = self.post_attention_layernorm(h)
        if isinstance(self.mlp, DeepseekV2MoE):
            return h + self.mlp(x, ctx, *record)
        with scope("moe_shared"):
            return h + self.mlp(x)


class DeepseekV2Model(nn.Module):
    """The decoder stack (module docstring), built on the current device
    in ``dtype`` with its weights uninitialised: load a checkpoint or
    call ``init_random``."""

    def __init__(self, cfg: DeepseekV2Config = DSV2_LITE,
                 dtype=torch.bfloat16):
        super().__init__()
        self.config, self.dtype = cfg, dtype
        self.embed_tokens = _Embedding(cfg.vocab_size, cfg.hidden_size, dtype)
        moe = {i: j for j, i in enumerate(cfg.moe_layers)}
        self.layers = nn.ModuleList(DecoderLayer(cfg, i, moe.get(i), dtype)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.register_buffer("rope_inv_freq", rope_inv_freq(cfg).to(
            self.norm.weight.device), persistent=False)
        self.rope_mscale = rope_mscale(cfg)
        self.latent_cache = self.route_ids = self.expert_counts = None
        self.positions = None

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "DeepseekV2Model":
        """Every weight N(0, 0.02²) but the norms' (ones), as DeepSeek's
        ``_init_weights`` draws a fresh model."""
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)
        return self

    def routed_parameters(self) -> list:
        """The routed experts' weights (views of each MoE's ``w13`` and
        ``w2``)."""
        return [p for n, p in self.named_parameters() if ".experts." in n]

    def carried(self) -> list:
        """What a chunk updates in place and the next chunk reads: the
        expert counter (``allocate`` first)."""
        return [self.expert_counts]

    def allocate(self, positions: int) -> None:
        """The latent cache, the routing record and the expert counter for
        documents of up to ``positions`` tokens (made once: a capture holds
        their addresses)."""
        if self.latent_cache is not None:
            if self.latent_cache.shape[1] != positions:
                raise ValueError("the cache holds "
                                 f"{self.latent_cache.shape[1]} positions, "
                                 f"not {positions}")
            return
        cfg, dev = self.config, self.norm.weight.device
        n_moe = len(cfg.moe_layers)
        self.latent_cache = torch.zeros(
            cfg.num_hidden_layers, positions,
            cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype=self.dtype,
            device=dev)
        self.route_ids = torch.zeros(n_moe, positions,
                                     cfg.num_experts_per_tok,
                                     dtype=torch.int32, device=dev)
        self.expert_counts = torch.zeros(n_moe, cfg.n_routed_experts,
                                         dtype=torch.int32, device=dev)
        self.positions = torch.arange(positions, device=dev)

    def forward(self, input_ids: torch.Tensor, positions: torch.Tensor,
                n_valid: torch.Tensor | None = None, keep: int = 4) -> list:
        """The last ``keep`` hidden states (C, H) of a chunk of C tokens
        at the last C of ``positions`` (L,), the last one normed (module
        docstring).  ``n_valid`` (one int32): the chunk's tokens below it
        are counted in ``expert_counts``; all of them by default."""
        C, L = input_ids.shape[0], positions.shape[0]
        if self.latent_cache is None or L > self.latent_cache.shape[1]:
            raise ValueError(f"allocate({L}) or more before a forward at "
                             f"position {L}")
        if n_valid is None:
            n_valid = torch.full((1,), C, dtype=torch.int32,
                                 device=input_ids.device)
        freqs = positions[L - C:].float()[:, None] * self.rope_inv_freq[None]
        ctx = _Chunk(L - C, L, freqs.cos() * self.rope_mscale,
                     freqs.sin() * self.rope_mscale, n_valid)
        h = self.embed_tokens(input_ids)
        n = len(self.layers)
        out = []
        for i, layer in enumerate(self.layers):
            m = layer.mlp
            record = ((self.expert_counts[m.index],
                       self.route_ids[m.index, L - C:L])
                      if isinstance(m, DeepseekV2MoE) else None)
            h = layer(h, ctx, self.latent_cache[i], record)
            if n - keep <= i < n - 1:
                out.append(h)
        out.append(self.norm(h))
        return out[-keep:]
