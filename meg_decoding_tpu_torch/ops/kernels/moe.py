"""A mixture-of-experts layer's routing and combine: the CUDA kernels
``csrc/moe_route.cu`` and their plain PyTorch versions.

``moe_route`` takes a chunk's router logits (T, E) f32 and gives:

* ``weights`` (T, k) f32 and ``ids`` (T, k) int32.  Softmax scoring
  (``bias`` None, DeepSeek-V2): the softmax over the E routed experts in
  f32 and its k largest, greedily, ties to the lower expert (DeepSeek-V2's
  ``topk_method: greedy``; the weights are the probabilities themselves).
  Sigmoid scoring (``bias`` (E,) f32, Kimi-Linear and DeepSeek-V3's
  ``noaux_tc``): s = sigmoid(logits) in f32, the k largest of s + bias
  chosen greedily (the bias chooses), the weights the chosen experts' s.
  Either way the weights are then divided by their sum (+ 1e-20, summed
  in slot order) where ``renormalize``, and multiplied by ``scale``;
* ``offs`` (held,) int32: where each held expert's rows end in the
  expert-sorted order (cumulative counts), as ``torch._grouped_mm`` takes
  them.  The held experts are ``first`` .. ``first + held − 1`` (all E by
  default): the layer routes over every expert and runs its own;
* ``pos`` (T, k) int32: the row of each (token, slot) pair there, −1 for
  a pair sent to an expert not held, and ``sorted_token`` (T·k,) int32:
  the token of each row (0 past the held experts' rows, which no product
  reads).  Within an expert the rows keep the pairs' order (token-major),
  a stable sort by expert.

It adds the experts chosen for the tokens below ``n_valid`` (a one-int32
tensor on the tensors' device) to ``counter`` (E,) int32, over every
expert, held or not, and writes the ids into ``ids_out`` when one is given
(the caller's record of a request's routing).  ``moe_combine`` gives
``bf16(bf16(Σ_r weights[t, r] · ys[pos[t, r]]) + shared[t])``: the
weighted sum of a token's expert rows in f32 (each product rounded, then
added in slot order; a slot whose ``pos`` is −1 adds nothing), rounded to
bf16, and the shared experts' output added in bf16, as DeepSeek's
``moe_infer`` and ``DeepseekV2MoE.forward`` round them.

These kernels replace no Pallas kernel: the JAX package has no language
model.  Both launch their kernels for CUDA tensors and run the plain
versions only for CPU tensors (where ``moe_combine`` also takes f32 rows,
for the tests).  ``launches`` counts the calls on the card
(``moe_route``: a memset and two kernels a call, two memsets more when
some experts are not held; ``moe_combine``: one kernel).
"""

from __future__ import annotations

import ctypes
import math

import torch

__all__ = ["moe_route", "moe_route_plain", "moe_combine",
           "moe_combine_plain", "launches", "reset_launches", "MAX_TOP_K",
           "MAX_EXPERTS"]

MAX_TOP_K = 8
MAX_EXPERTS = 256

# kernel launches since the last reset_launches(), per kernel (a replay of
# a captured forward adds what its capture counted, train/graph.py)
launches = {"moe_route": 0, "moe_combine": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _top_k_greedy(p: torch.Tensor, k: int) -> tuple:
    """The k largest of each row of ``p`` in k argmax rounds, ties to the
    lower index (``torch.argmax`` returns the first maximal index)."""
    p = p.clone()
    idx, val = [], []
    for _ in range(k):
        i = torch.argmax(p, dim=-1)
        val.append(p.gather(-1, i[:, None])[:, 0])
        idx.append(i)
        p.scatter_(-1, i[:, None], -math.inf)
    return torch.stack(val, -1), torch.stack(idx, -1)


def _top_k_scores(logits: torch.Tensor, k: int, bias, renormalize: bool,
                  scale: float) -> tuple:
    """(weights, ids) of the route's scoring (module docstring)."""
    x = logits.float()
    if bias is None:
        weights, ids = _top_k_greedy(torch.softmax(x, dim=-1), k)
    else:
        s = 1.0 / (1.0 + torch.exp(-x))
        _, ids = _top_k_greedy(s + bias.float(), k)
        weights = s.gather(-1, ids)
    if renormalize:
        den = weights[:, 0]
        for r in range(1, k):
            den = den + weights[:, r]
        weights = weights / (den + 1e-20)[:, None]
    if scale != 1.0:
        weights = weights * scale
    return weights, ids


def moe_route_plain(logits: torch.Tensor, k: int, n_valid: torch.Tensor,
                    counter: torch.Tensor, ids_out=None, bias=None,
                    renormalize: bool = False, scale: float = 1.0,
                    first: int = 0, held=None) -> tuple:
    """The kernel's arithmetic in PyTorch: ``(weights, ids, offs, pos,
    sorted_token)``; adds to ``counter`` in place."""
    T, E = logits.shape
    held = E if held is None else held
    weights, ids = _top_k_scores(logits, k, bias, renormalize, scale)
    ids = ids.to(torch.int32)
    flat = ids.reshape(-1).long()
    mine = (flat >= first) & (flat < first + held)
    counts = torch.bincount(flat[mine] - first, minlength=held)
    offs = counts.cumsum(0).to(torch.int32)
    # a stable sort of the held pairs by expert; the others after them
    order = torch.argsort(torch.where(mine, flat - first, held), stable=True)
    rows = torch.arange(flat.numel(), device=flat.device)
    pos = torch.empty_like(flat)
    pos[order] = rows
    pos = torch.where(mine, pos, -1)
    n_rows = int(mine.sum())
    token = torch.where(rows < n_rows, order // k, 0)
    valid = torch.arange(T, device=logits.device) < n_valid.reshape(-1)[0]
    counter += torch.bincount(ids[valid].reshape(-1).long(),
                              minlength=E).to(counter.dtype)
    if ids_out is not None:
        ids_out.copy_(ids)
    return (weights, ids, offs, pos.to(torch.int32).reshape(T, k),
            token.to(torch.int32))


def moe_combine_plain(ys: torch.Tensor, pos: torch.Tensor,
                      weights: torch.Tensor, shared=None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch (the slots summed in order, a
    slot whose ``pos`` is −1 left out)."""
    p = pos.long()
    rows = torch.where((p >= 0)[..., None], ys[p.clamp(min=0)].float(),
                       0.0)  # (T, k, H)
    acc = torch.zeros(rows.shape[0], rows.shape[2], dtype=torch.float32,
                      device=ys.device)
    for r in range(pos.shape[1]):
        acc = acc + torch.where((p[:, r] >= 0)[:, None],
                                rows[:, r] * weights[:, r, None], 0.0)
    y = acc.to(ys.dtype)
    if shared is not None:
        y = (y.float() + shared.float()).to(ys.dtype)
    return y


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# kernel → its launcher in the library and the launcher's arguments
_LAUNCHERS = {
    "moe_route": ("moe_route_launch",
                  [_PTR, _INT, _INT, _INT] + [_PTR] * 9
                  + [_INT, ctypes.c_float, _INT, _INT, _PTR]),
    "moe_combine": ("moe_combine_launch", [_PTR] * 5 + [_INT] * 3 + [_PTR]),
}
_FNS: dict = {}


def _fn(kernel: str):
    fn = _FNS.get(kernel)
    if fn is None:
        from meg_decoding_tpu_torch.ops.kernels.build import load_library

        name, argtypes = _LAUNCHERS[kernel]
        fn = getattr(load_library("moe_route"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FNS[kernel] = fn
    return fn


def _on_cpu(name: str, *xs: torch.Tensor) -> bool:
    """True when the tensors lie on the CPU (the plain version's case);
    raises for another device or a non-contiguous tensor on the card."""
    dev = xs[0].device
    if any(t.device != dev for t in xs):
        raise ValueError(f"{name}: tensors on different devices")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    if not all(t.is_contiguous() for t in xs):
        raise ValueError(f"{name}: tensors must be contiguous")
    return False


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def moe_route(logits: torch.Tensor, k: int, n_valid: torch.Tensor,
              counter: torch.Tensor, ids_out=None, bias=None,
              renormalize: bool = False, scale: float = 1.0, first: int = 0,
              held=None) -> tuple:
    """``(weights, ids, offs, pos, sorted_token)`` of the logits (module
    docstring); adds to ``counter``, writes ``ids_out`` when given."""
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise TypeError("moe_route takes (T, E) float32 logits")
    T, E = logits.shape
    held = E if held is None else held
    if not 1 <= k <= min(MAX_TOP_K, E) or E > MAX_EXPERTS:
        raise ValueError(f"moe_route: k = {k}, E = {E} (1 ≤ k ≤ 8, "
                         "k ≤ E ≤ 256)")
    if not (0 <= first and 1 <= held and first + held <= E):
        raise ValueError(f"moe_route: held experts {first}..{first + held} "
                         f"of {E}")
    if counter.shape != (E,) or counter.dtype != torch.int32 \
            or n_valid.dtype != torch.int32 or n_valid.numel() != 1:
        raise ValueError("moe_route: counter is (E,) int32, n_valid one int32")
    if ids_out is not None and (ids_out.shape != (T, k)
                                or ids_out.dtype != torch.int32):
        raise ValueError("moe_route: ids_out is (T, k) int32")
    if bias is not None and (bias.shape != (E,) or bias.dtype != torch.float32):
        raise ValueError("moe_route: bias is (E,) float32")
    tensors = [logits, n_valid, counter] + [t for t in (ids_out, bias)
                                            if t is not None]
    if _on_cpu("moe_route", *tensors):
        return moe_route_plain(logits, k, n_valid, counter, ids_out, bias,
                               renormalize, scale, first, held)
    dev = logits.device
    ids = (ids_out if ids_out is not None
           else torch.empty(T, k, dtype=torch.int32, device=dev))
    weights = torch.empty(T, k, dtype=torch.float32, device=dev)
    counts = torch.empty(E, dtype=torch.int32, device=dev)
    offs = torch.empty(held, dtype=torch.int32, device=dev)
    pos = torch.empty(T, k, dtype=torch.int32, device=dev)
    sorted_token = torch.empty(T * k, dtype=torch.int32, device=dev)
    err = _fn("moe_route")(
        logits.data_ptr(), T, E, k, n_valid.data_ptr(), ids.data_ptr(),
        weights.data_ptr(), counts.data_ptr(), counter.data_ptr(),
        offs.data_ptr(), pos.data_ptr(), sorted_token.data_ptr(),
        None if bias is None else bias.data_ptr(), int(renormalize),
        float(scale), first, held, _stream(logits))
    if err != 0:
        raise RuntimeError(f"moe_route kernel launch failed: CUDA error {err}")
    launches["moe_route"] += 1
    return weights, ids, offs, pos, sorted_token


def moe_combine(ys: torch.Tensor, pos: torch.Tensor, weights: torch.Tensor,
                shared=None) -> torch.Tensor:
    """(T, H) bf16: each token's weighted sum of its expert rows of ``ys``
    (rows, H) bf16, plus ``shared`` (T, H) bf16 when given."""
    T, k = pos.shape
    H = ys.shape[1]
    if ys.dtype not in (torch.bfloat16, torch.float32) or (
            shared is not None and (shared.dtype != ys.dtype
                                    or shared.shape != (T, H))):
        raise TypeError("moe_combine takes bf16 rows, or f32 on the CPU (and "
                        "shared (T, H) of their dtype)")
    if pos.dtype != torch.int32 or weights.dtype != torch.float32 \
            or weights.shape != (T, k) or not 1 <= k <= MAX_TOP_K:
        raise ValueError("moe_combine: pos (T, k) int32, weights (T, k) f32")
    tensors = [ys, pos, weights] + ([shared] if shared is not None else [])
    if _on_cpu("moe_combine", *tensors):
        return moe_combine_plain(ys, pos, weights, shared)
    if ys.dtype != torch.bfloat16:
        raise TypeError("moe_combine's kernel takes bf16 rows")
    if H % 8 or any(t.data_ptr() % 16 for t in (ys,) + (
            (shared,) if shared is not None else ())):
        raise ValueError("moe_combine: rows of 16-byte packets (H % 8 == 0, "
                         "16-byte aligned)")
    out = torch.empty(T, H, dtype=torch.bfloat16, device=ys.device)
    err = _fn("moe_combine")(
        ys.data_ptr(), pos.data_ptr(), weights.data_ptr(),
        None if shared is None else shared.data_ptr(), out.data_ptr(), T, H,
        k, _stream(ys))
    if err != 0:
        raise RuntimeError("moe_combine kernel launch failed: CUDA error "
                           f"{err}")
    launches["moe_combine"] += 1
    return out
