"""Training state: the encoder (parameters and BN running statistics), the
CLIP temperature, the Adam state, the step counter and a ``torch.Generator``.
Port of ``meg_decoding_tpu/train/state.py``.

The reference saves only ``model.state_dict()`` (``train.py:274``) — no
optimizer or step state, so no true resume.  Here ``state_dict()`` holds
everything, and a checkpoint resumes exactly.

Parameter names are the port's state_dict names (flax's, see
``interop.py``) plus ``'loss.temp'`` for the temperature, the name
``interop.params_from_jax`` gives a TrainState's ``params['loss']['temp']``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from meg_decoding_tpu_torch.train.optim import Adam, AdamState

__all__ = ["TrainState", "create_train_state"]

TEMP = "loss.temp"


@dataclass
class TrainState:
    model: nn.Module
    temp: torch.Tensor             # 0-dim f32 leaf that requires grad
    opt_state: AdamState
    step: torch.Tensor             # 0-dim int32 on the model's device
    generator: torch.Generator     # CPU: dropout centres

    def params(self) -> dict[str, torch.Tensor]:
        """Every trained tensor by name: the encoder's parameters and
        ``'loss.temp'``."""
        return {**dict(self.model.named_parameters()), TEMP: self.temp}

    def state_dict(self) -> dict:
        """``params``: the encoder's state_dict (parameters and BN buffers)
        and ``'loss.temp'`` — the flat format the eval CLI loads; ``opt``:
        Adam's moments and count; ``step``; the generator's state."""
        return {
            "params": {**self.model.state_dict(), TEMP: self.temp.detach()},
            "opt": {"mu": self.opt_state.mu, "nu": self.opt_state.nu,
                    "count": self.opt_state.count},
            "step": self.step,
            "generator": self.generator.get_state(),
        }

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        params = dict(sd["params"])
        self.temp.copy_(params.pop(TEMP))
        self.model.load_state_dict(params)
        for mine, theirs in ((self.opt_state.mu, sd["opt"]["mu"]),
                             (self.opt_state.nu, sd["opt"]["nu"])):
            if mine.keys() != theirs.keys():
                raise KeyError("optimizer state names differ: "
                               f"{sorted(mine.keys() ^ theirs.keys())}")
            for k, v in theirs.items():
                mine[k].copy_(v)
        self.opt_state.count.copy_(sd["opt"]["count"])
        self.step.copy_(sd["step"])
        self.generator.set_state(sd["generator"].cpu())


def create_train_state(model: nn.Module, optimizer: Adam,
                       init_temperature: float = 5.1,
                       seed: int = 0) -> TrainState:
    """Wrap an initialized encoder with a trained temperature (reference
    ``train.py:158-162``), a fresh Adam state and a generator seeded with
    ``seed``."""
    dev = next(model.parameters()).device
    temp = torch.tensor(float(init_temperature), dtype=torch.float32,
                        device=dev, requires_grad=True)
    params = {**dict(model.named_parameters()), TEMP: temp}
    return TrainState(model=model, temp=temp,
                      opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev),
                      generator=torch.Generator().manual_seed(int(seed)))
