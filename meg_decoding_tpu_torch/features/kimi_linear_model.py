"""Kimi-Linear (Kimi Linear tech report, arXiv:2510.26692;
``moonshotai/Kimi-Linear-48B-A3B-Instruct``'s ``modeling_kimi.py``) as the
port's second text-stimulus encoder: the hybrid decoder stack without the
LM head, for inference.

Per layer (RMSNorm eps ``rms_norm_eps``): ``h += attn(norm(h));
h += mlp(norm(h))``, then a final RMSNorm.  The attention of the layers
``linear_attn_config["kda_layers"]`` (1-based) is Kimi Delta Attention;
the others' (``full_attn_layers``) is DeepSeek-V2's MLA
(``features/deepseek_v2_model.py:MLA``) with ``mla_use_nope``: no rope,
softmax scale 192^−½.  Layer 0 (``first_k_dense_replace``) has a dense
SwiGLU; the others a MoE (``DeepseekV2MoE`` with Kimi's names): sigmoid
scores over ``num_experts`` in f32, the top ``num_experts_per_token``
chosen by score + ``e_score_correction_bias``, their scores renormalised
(``moe_renormalize``) and scaled by ``routed_scaling_factor``, and one
shared SwiGLU.  ``num_expert_group`` = ``topk_group`` = 1, so the
grouped top-k's group step is the identity: it is left out.

**KDA** (per head, d = ``head_dim``, x the normed input):

  q, k, v = SiLU(causal depthwise conv_K(W_q x | W_k x | W_v x))
  g = −exp(A_log[h]) · softplus(W_fb W_fa x + dt_bias)   (f32, a decay a
      key channel);  β = sigmoid(W_b x)[h]                (f32)
  o = kda_chunk(q, k, v, g, β, S)   (the gated delta rule, q and k
      L2-normalised inside: ``ops/kernels/kda.py``)
  out = W_o (RMSNorm_d(o) · w_onorm · sigmoid(W_gb W_ga x))

The three projections are views of one (3P, H) weight (one product) and
the three convolutions' weights views of one (3P, 1, K) tensor; the
convolution and its SiLU are one kernel over the 3P channels
(``ops/kernels/kda.py:short_conv``), in f32, which also carries the tail.

**The forward is one chunk** of C tokens at the last C of ``positions``,
as ``DeepseekV2Model.forward``'s.  Two kinds of per-document state sit
side by side, made once by ``allocate`` (a capture holds their
addresses): the MLA layers' latent rows (MLA layers, positions, 512 +
64), written at the chunk's positions and read over the prefix; and the
KDA layers' f32 state (KDA layers, heads, d, d) with the convolutions'
last K − 1 inputs (KDA layers, K − 1, 3P), carried from one chunk to the
next in place.  A chunk at position 0 starts from zero state and zero
tails (it zeroes them); a later one reads what the chunk before it
wrote.  Routing is recorded as DeepSeek-V2's (``route_ids``,
``expert_counts`` over every routed expert; ``held_pairs()`` the pairs
routed to the experts held).

Scopes (``utils/profiling.py``): ``kda`` (a KDA layer's input norm,
projections, convolution, gates, the kernel, the gated norm, ``o_proj``),
``mla``, ``moe_route``, ``moe_experts``, ``moe_shared`` as DeepSeek-V2's.

Departures from ``modeling_kimi.py`` (its fla kernels): the chunk
kernel's intermediates and the state's products run in bf16 with f32
accumulation (fla's ``chunk_kda`` does the same);
``kv_a_layernorm``'s eps is 1e-6 (its class default, as DeepSeek's).
The parameter names are those of the published ``modeling_kimi.py`` as
far as it could be read: no checkpoint is in the repository to confirm
them.  Supported: ``q_lora_rank`` None, ``mla_use_nope``,
``moe_router_activation_func`` sigmoid, one expert group, SiLU; anything
else raises.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from meg_decoding_tpu_torch.features.deepseek_v2_model import (
    MLA,
    MLP,
    DeepseekV2MoE,
    RMSNorm,
    _Chunk,
    _Embedding,
    _Linear,
)
from meg_decoding_tpu_torch.ops.kernels.kda import kda_chunk, short_conv
from meg_decoding_tpu_torch.utils.profiling import scope

__all__ = ["KimiLinearConfig", "KIMI_LINEAR_48B", "KimiLinearModel",
           "KimiDeltaAttention"]


def _kda():
    return {"full_attn_layers": [4, 8, 12, 16, 20, 24, 27], "head_dim": 128,
            "kda_layers": [1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18,
                           19, 21, 22, 23, 25, 26],
            "num_heads": 32, "short_conv_kernel_size": 4}


@dataclass(frozen=True)
class KimiLinearConfig:
    """The keys of Kimi-Linear's ``config.json`` the forward reads; the
    defaults are Kimi-Linear-48B-A3B-Instruct's.  ``experts_first`` and
    ``experts_held`` (not the published config's keys) say which routed
    experts this card holds (all by default)."""
    vocab_size: int = 163840
    hidden_size: int = 2304
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_hidden_layers: int = 27
    num_attention_heads: int = 32
    num_experts: int = 256
    num_experts_per_token: int = 8
    num_shared_experts: int = 1
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    routed_scaling_factor: float = 2.446
    moe_renormalize: bool = True
    linear_attn_config: dict = field(default_factory=_kda)
    experts_first: int = 0
    experts_held: int | None = None

    # the values of the keys this forward does not implement otherwise
    _FIXED = {"q_lora_rank": None, "mla_use_nope": True,
              "moe_router_activation_func": "sigmoid", "hidden_act": "silu",
              "num_expert_group": 1, "topk_group": 1, "rope_scaling": None}

    # the names the shared MLA and MoE classes read
    mla_use_nope = True
    scoring_func = "sigmoid"
    rope_scaling = None

    @classmethod
    def from_dict(cls, d: dict) -> "KimiLinearConfig":
        """From a ``config.json`` (unknown keys ignored); raises for a
        setting this forward does not implement."""
        for key, want in cls._FIXED.items():
            got = d.get(key, want)
            if got != want:
                raise NotImplementedError(f"{key} = {got!r} (only {want!r})")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @property
    def n_routed_experts(self) -> int:
        return self.num_experts

    @property
    def num_experts_per_tok(self) -> int:
        return self.num_experts_per_token

    @property
    def n_shared_experts(self) -> int:
        return self.num_shared_experts

    @property
    def norm_topk_prob(self) -> bool:
        return self.moe_renormalize

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_kda(self, i: int) -> bool:
        return i + 1 in self.linear_attn_config["kda_layers"]

    def is_moe(self, i: int) -> bool:
        return (bool(self.num_experts) and i >= self.first_k_dense_replace
                and i % self.moe_layer_freq == 0)

    @property
    def kda_layers(self) -> list:
        return [i for i in range(self.num_hidden_layers) if self.is_kda(i)]

    @property
    def mla_layers(self) -> list:
        return [i for i in range(self.num_hidden_layers)
                if not self.is_kda(i)]

    @property
    def moe_layers(self) -> list:
        return [i for i in range(self.num_hidden_layers) if self.is_moe(i)]


KIMI_LINEAR_48B = KimiLinearConfig()


class _Conv(nn.Module):
    """A depthwise causal convolution's ``weight`` (channels, 1, K), a view
    of the layer's stacked weight (fla's ShortConvolution, no bias)."""

    def __init__(self, weight: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)


class _GatedNorm(nn.Module):
    """fla's FusedRMSNormGated with a sigmoid gate: RMSNorm over the last
    dim in f32, times ``weight``, times sigmoid(gate), rounded once."""

    def __init__(self, d: int, eps: float, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, dtype=dtype),
                                   requires_grad=False)
        self.eps = eps

    def forward(self, x, gate):
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        y = y * self.weight.float() * torch.sigmoid(gate.float())
        return y.to(x.dtype)


class KimiDeltaAttention(nn.Module):
    """One KDA layer (module docstring); its state and convolution tail are
    the model's, passed to ``forward``."""

    def __init__(self, cfg: KimiLinearConfig, dtype):
        super().__init__()
        la = cfg.linear_attn_config
        H, nh, d = cfg.hidden_size, la["num_heads"], la["head_dim"]
        K, P = la["short_conv_kernel_size"], la["num_heads"] * la["head_dim"]
        self.nh, self.d, self.K, self.P = nh, d, K, P
        self.w_qkv = torch.empty(3 * P, H, dtype=dtype)
        self.q_proj = _Linear(self.w_qkv[:P])
        self.k_proj = _Linear(self.w_qkv[P:2 * P])
        self.v_proj = _Linear(self.w_qkv[2 * P:])
        self.w_conv = torch.empty(3 * P, 1, K, dtype=dtype)
        self.q_conv1d = _Conv(self.w_conv[:P])
        self.k_conv1d = _Conv(self.w_conv[P:2 * P])
        self.v_conv1d = _Conv(self.w_conv[2 * P:])
        self.A_log = nn.Parameter(torch.empty(1, 1, nh, 1,
                                              dtype=torch.float32),
                                  requires_grad=False)
        self.f_a_proj = _Linear(torch.empty(d, H, dtype=dtype))
        self.f_b_proj = _Linear(torch.empty(P, d, dtype=dtype))
        self.dt_bias = nn.Parameter(torch.empty(P, dtype=torch.float32),
                                    requires_grad=False)
        self.b_proj = _Linear(torch.empty(nh, H, dtype=dtype))
        self.g_a_proj = _Linear(torch.empty(d, H, dtype=dtype))
        self.g_b_proj = _Linear(torch.empty(P, d, dtype=dtype))
        self.o_norm = _GatedNorm(d, cfg.rms_norm_eps, dtype)
        self.o_proj = _Linear(torch.empty(H, P, dtype=dtype))

    def _start(self, ctx: _Chunk, state, tail) -> None:
        """A document's first chunk starts from zero state and tails."""
        if ctx.start == 0:
            state.zero_()
            tail.zero_()

    def _gate(self, x: torch.Tensor) -> torch.Tensor:
        """g (C, heads, d) f32: −exp(A_log) · softplus(W_fb W_fa x +
        dt_bias) (fla's fused_kda_gate)."""
        f = self.f_b_proj(self.f_a_proj(x)).float() + self.dt_bias
        g = F.softplus(f).view(-1, self.nh, self.d)
        return -self.A_log.view(1, self.nh, 1).exp() * g

    def forward(self, x, ctx: _Chunk, state, tail):
        C = x.shape[0]
        self._start(ctx, state, tail)
        qkv = short_conv(F.linear(x, self.w_qkv), tail, self.w_conv).view(
            C, 3, self.nh, self.d)
        beta = torch.sigmoid(self.b_proj(x).float())
        o = kda_chunk(qkv[:, 0], qkv[:, 1], qkv[:, 2], self._gate(x),
                      beta.contiguous(), state)
        gate = self.g_b_proj(self.g_a_proj(x)).view(C, self.nh, self.d)
        o = self.o_norm(o, gate)
        return self.o_proj(o.reshape(C, self.P))


class _KimiExpert(nn.Module):
    """A routed expert by modeling_kimi's names: w1 gate, w3 up, w2 down."""

    def __init__(self, gate, up, down):
        super().__init__()
        self.w1, self.w3 = _Linear(gate), _Linear(up)
        self.w2 = _Linear(down)


class KimiSparseMoeBlock(DeepseekV2MoE):
    """Kimi's MoE: ``DeepseekV2MoE`` with sigmoid routing and its experts'
    names (``gate.weight``, ``gate.e_score_correction_bias``,
    ``experts.<id>.w1/w2/w3``, ``shared_experts``)."""

    _EXPERT = _KimiExpert


class KimiDecoderLayer(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, i: int, index, moe_index,
                 dtype):
        super().__init__()
        eps, H = cfg.rms_norm_eps, cfg.hidden_size
        self.kda = cfg.is_kda(i)
        self.index = index  # among the KDA layers, or among the MLA layers
        self.self_attn = (KimiDeltaAttention(cfg, dtype) if self.kda
                          else MLA(cfg, dtype))
        if cfg.is_moe(i):
            self.block_sparse_moe = KimiSparseMoeBlock(cfg, moe_index, dtype)
        else:
            self.mlp = MLP(H, cfg.intermediate_size, dtype)
        self.input_layernorm = RMSNorm(H, eps, dtype)
        self.post_attention_layernorm = RMSNorm(H, eps, dtype)

    def forward(self, h, ctx: _Chunk, model: "KimiLinearModel"):
        if self.kda:
            with scope("kda"):
                h = h + self.self_attn(self.input_layernorm(h), ctx,
                                       model.kda_state[self.index],
                                       model.conv_tail[self.index])
        else:
            with scope("mla"):
                h = h + self.self_attn(self.input_layernorm(h), ctx,
                                       model.latent_cache[self.index])
        x = self.post_attention_layernorm(h)
        moe = getattr(self, "block_sparse_moe", None)
        if moe is not None:
            return h + moe(x, ctx, model.expert_counts[moe.index],
                           model.route_ids[moe.index, ctx.start:ctx.end])
        with scope("moe_shared"):
            return h + self.mlp(x)


class KimiLinearModel(nn.Module):
    """The decoder stack (module docstring), built on the current device
    in ``dtype`` with its weights uninitialised: load a checkpoint or call
    ``init_random``."""

    def __init__(self, cfg: KimiLinearConfig = KIMI_LINEAR_48B,
                 dtype=torch.bfloat16):
        super().__init__()
        self.config, self.dtype = cfg, dtype
        self.embed_tokens = _Embedding(cfg.vocab_size, cfg.hidden_size, dtype)
        kda = {i: j for j, i in enumerate(cfg.kda_layers)}
        mla = {i: j for j, i in enumerate(cfg.mla_layers)}
        moe = {i: j for j, i in enumerate(cfg.moe_layers)}
        self.layers = nn.ModuleList(
            KimiDecoderLayer(cfg, i, kda.get(i, mla.get(i)), moe.get(i),
                             dtype)
            for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype)
        self.latent_cache = self.kda_state = self.conv_tail = None
        self.route_ids = self.expert_counts = self.positions = None

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "KimiLinearModel":
        """Every weight N(0, 0.02²) (the selection bias too) but the norms'
        (ones), ``A_log`` = log U[1, 16] and ``dt_bias`` = softplus⁻¹(dt),
        dt log-uniform in [1e-3, 0.1] (fla's and Mamba-2's initialisers)."""
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith("A_log"):
                p.uniform_(1.0, 16.0, generator=generator).log_()
            elif name.endswith("dt_bias"):
                dt = torch.empty_like(p).uniform_(
                    math.log(1e-3), math.log(0.1), generator=generator).exp()
                p.copy_(dt + torch.log(-torch.expm1(-dt)))
            else:
                p.normal_(0.0, 0.02, generator=generator)
        return self

    def routed_parameters(self) -> list:
        """The routed experts' weights (views of each MoE's ``w13`` and
        ``w2``)."""
        return [p for n, p in self.named_parameters() if ".experts." in n]

    def held_pairs(self) -> torch.Tensor:
        """(MoE layers,) int32: the (token, slot) pairs of the last request
        routed to the experts this card holds (from ``expert_counts``)."""
        cfg = self.config
        first = cfg.experts_first
        held = cfg.experts_held or cfg.num_experts
        return self.expert_counts[:, first:first + held].sum(
            1, dtype=torch.int32)

    def carried(self) -> list:
        """What a chunk updates in place and the next chunk reads: the KDA
        state, the convolution tails and the expert counter (``allocate``
        first)."""
        return [self.kda_state, self.conv_tail, self.expert_counts]

    def allocate(self, positions: int) -> None:
        """The latent cache, the KDA state and convolution tails, the
        routing record and the expert counter for documents of up to
        ``positions`` tokens (made once: a capture holds their
        addresses)."""
        if self.latent_cache is not None:
            if self.latent_cache.shape[1] != positions:
                raise ValueError("the cache holds "
                                 f"{self.latent_cache.shape[1]} positions, "
                                 f"not {positions}")
            return
        cfg, dev = self.config, self.norm.weight.device
        la = cfg.linear_attn_config
        nh, d, K = (la["num_heads"], la["head_dim"],
                    la["short_conv_kernel_size"])
        self.latent_cache = torch.zeros(
            len(cfg.mla_layers), positions,
            cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype=self.dtype,
            device=dev)
        self.kda_state = torch.zeros(len(cfg.kda_layers), nh, d, d,
                                     dtype=torch.float32, device=dev)
        self.conv_tail = torch.zeros(len(cfg.kda_layers), K - 1, 3 * nh * d,
                                     dtype=self.dtype, device=dev)
        self.route_ids = torch.zeros(len(cfg.moe_layers), positions,
                                     cfg.num_experts_per_token,
                                     dtype=torch.int32, device=dev)
        self.expert_counts = torch.zeros(len(cfg.moe_layers), cfg.num_experts,
                                         dtype=torch.int32, device=dev)
        self.positions = torch.arange(positions, device=dev)

    def forward(self, input_ids: torch.Tensor, positions: torch.Tensor,
                n_valid: torch.Tensor | None = None, keep: int = 4) -> list:
        """The last ``keep`` hidden states (C, H) of a chunk of C tokens at
        the last C of ``positions`` (L,), the last one normed.
        ``n_valid`` (one int32): the chunk's tokens below it are counted in
        ``expert_counts``; all of them by default."""
        C, L = input_ids.shape[0], positions.shape[0]
        if self.latent_cache is None or L > self.latent_cache.shape[1]:
            raise ValueError(f"allocate({L}) or more before a forward at "
                             f"position {L}")
        if n_valid is None:
            n_valid = torch.full((1,), C, dtype=torch.int32,
                                 device=input_ids.device)
        ctx = _Chunk(L - C, L, None, None, n_valid)
        h = self.embed_tokens(input_ids)
        n = len(self.layers)
        out = []
        for i, layer in enumerate(self.layers):
            h = layer(h, ctx, self)
            if n - keep <= i < n - 1:
                out.append(h)
        out.append(self.norm(h))
        return out[-keep:]
