"""The port's reference-checkpoint import (``utils/torch_import.py``)
against the JAX package's (``meg_decoding_tpu/utils/torch_import.py``)
followed by ``interop.params_from_jax``, on the CPU.

The reference-named state_dicts are built as ``tests/test_torch_import.py``
builds them: the brain encoder's from flax variables through
``tests/fixtures.py:reference_named_state_dict`` (the certified transplant
into the reference's torch module, renamed to its module names), EEGNet's
from the reference's own ``nn.Sequential`` module, the linear encoder's
from its two entries.  Both imports must give the same names and the same
bits, and the port's model with the imported weights must compute the
reference's forward (rtol/atol 1e-4 for EEGNet, as the JAX test; 1e-5 for
the brain encoder and the linear encoder, which the port computes in f32
like the JAX module).
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from meg_decoding_tpu_torch.interop import params_from_jax

C, T, D1, D2, F, K, S = 12, 40, 8, 12, 16, 4, 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_bit_identical(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype == torch.float32, k
        assert torch.equal(got[k], w), k


@pytest.fixture(scope="module")
def brain_encoder_case():
    from meg_decoding_tpu.data.layout import (
        normalize_locations,
        synthetic_cap_locations,
    )
    from meg_decoding_tpu.models.brain_encoder import BrainEncoder
    from tests.fixtures import reference_named_state_dict

    loc = np.asarray(normalize_locations(synthetic_cap_locations(C)))
    model = BrainEncoder(loc=loc, num_subjects=S, D1=D1, D2=D2, F=F, K=K,
                         seq2seq=False)
    rng = np.random.RandomState(0)
    X = jnp.asarray(rng.randn(4, C, T), jnp.float32)
    subs = jnp.asarray(rng.randint(0, S, 4))
    variables = jax.device_get(model.init(
        {"params": jax.random.PRNGKey(0), "spatial": jax.random.PRNGKey(1)},
        X, subs))
    # running statistics away from (0, 1), so that their import counts
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.rand(*np.shape(a)).astype(np.float32),
        variables["batch_stats"])
    ref_sd, ref_model = reference_named_state_dict(
        variables, loc, d1=D1, d2=D2, f_dim=F, k_dim=K, num_subjects=S,
        seq2seq=False)
    return dict(loc=loc, ref_sd=ref_sd, ref_model=ref_model)


def test_brain_encoder_import_equals_jax_import_bit_for_bit(brain_encoder_case):
    from meg_decoding_tpu.utils import torch_import as jimport
    from meg_decoding_tpu_torch.utils import torch_import as timport

    ref_sd = brain_encoder_case["ref_sd"]
    params, stats = jimport.brain_encoder_from_state_dict(
        jimport.state_dict_to_numpy(ref_sd))
    want = params_from_jax({"params": params, "batch_stats": stats})
    _assert_bit_identical(timport.brain_encoder_from_state_dict(ref_sd), want)
    # numpy leaves (state_dict_to_numpy's output) import the same
    _assert_bit_identical(timport.brain_encoder_from_state_dict(
        timport.state_dict_to_numpy(ref_sd)), want)


def test_imported_brain_encoder_serves_the_reference_forward(brain_encoder_case):
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from meg_decoding_tpu_torch.utils.torch_import import (
        brain_encoder_from_state_dict,
    )

    s = brain_encoder_case
    model = BrainEncoder(s["loc"], S, D1=D1, D2=D2, F=F, K=K, seq2seq=False,
                         device="cpu")
    model.load_state_dict(brain_encoder_from_state_dict(s["ref_sd"]))
    model.eval()
    rng = np.random.RandomState(7)
    X = torch.from_numpy(rng.randn(4, C, T).astype(np.float32))
    subs = np.array([0, 1, 2, 0])
    s["ref_model"].eval()
    with torch.no_grad():
        got = model(X, torch.from_numpy(subs))
        want = s["ref_model"](X, subs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_load_torch_checkpoint_reads_a_saved_reference_state_dict(
        brain_encoder_case, tmp_path):
    from meg_decoding_tpu_torch.utils.torch_import import load_torch_checkpoint

    ref_sd = brain_encoder_case["ref_sd"]
    path = tmp_path / "model_last.pt"
    torch.save(ref_sd, path)
    got = load_torch_checkpoint(str(path))
    assert got.keys() == ref_sd.keys()
    assert all(torch.equal(got[k], v) for k, v in ref_sd.items())
    # a whole pickled module needs allow_pickle
    torch.save(brain_encoder_case["ref_model"], tmp_path / "module.pt")
    with pytest.raises(Exception):
        load_torch_checkpoint(str(tmp_path / "module.pt"))
    whole = load_torch_checkpoint(str(tmp_path / "module.pt"), allow_pickle=True)
    assert whole.keys() == brain_encoder_case["ref_model"].state_dict().keys()


F1, DEPTH, F2, K1, K2, P1, P2, OUT, T_EEG, C_EEG = 4, 2, 8, 10, 4, 2, 4, 32, 64, 16


def _reference_eegnet():
    """The reference's EEGNet module structure (``models.py:32-94``:
    positional ``nn.Sequential`` stages, an NCHW flatten), as
    ``tests/test_torch_import.py`` builds it, with running statistics away
    from (0, 1)."""

    class RefEEGNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = nn.Sequential(
                nn.Conv2d(1, F1, (1, K1), padding="same", bias=False),
                nn.BatchNorm2d(F1))
            self.conv2 = nn.Sequential(
                nn.Conv2d(F1, DEPTH * F1, (C_EEG, 1), groups=F1, bias=False),
                nn.BatchNorm2d(DEPTH * F1), nn.ELU(),
                nn.AvgPool2d((1, P1)), nn.Dropout(0.0))
            self.conv3 = nn.Sequential(
                nn.Conv2d(DEPTH * F1, DEPTH * F1, (1, K2), padding="same",
                          groups=DEPTH * F1, bias=False),
                nn.Conv2d(DEPTH * F1, F2, (1, 1), bias=False),
                nn.BatchNorm2d(F2), nn.ELU(),
                nn.AvgPool2d((1, P2)), nn.Dropout(0.0))
            self.classifier = nn.Linear(F2 * (T_EEG // P1 // P2), OUT)

        def forward(self, x):
            x = self.conv3(self.conv2(self.conv1(x.unsqueeze(1))))
            return self.classifier(x.view(len(x), -1))

    torch.manual_seed(0)
    tm = RefEEGNet()
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn_like(m.running_mean) * 0.1)
                m.running_var.copy_(1.0 + torch.rand_like(m.running_var))
    return tm.eval()


def test_eegnet_import_equals_jax_import_and_serves_the_reference_forward():
    from meg_decoding_tpu.utils import torch_import as jimport
    from meg_decoding_tpu_torch.models.eegnet import EEGNet
    from meg_decoding_tpu_torch.utils import torch_import as timport

    ref = _reference_eegnet()
    sd = ref.state_dict()
    params, stats = jimport.eegnet_from_state_dict(jimport.state_dict_to_numpy(sd))
    got = timport.eegnet_from_state_dict(sd)
    _assert_bit_identical(got, params_from_jax({"params": params,
                                                "batch_stats": stats}))
    model = EEGNet(C_EEG, T_EEG, F1=F1, D=DEPTH, F2=F2, k1=K1, k2=K2, p1=P1,
                   p2=P2, out_dim=OUT, device="cpu")
    model.load_state_dict(got)
    model.eval()
    X = torch.from_numpy(np.random.RandomState(3).randn(6, C_EEG, T_EEG)
                         .astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(model(X).numpy(), ref(X).numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_linear_encoder_import_equals_jax_import_and_forward():
    from meg_decoding_tpu.utils import torch_import as jimport
    from meg_decoding_tpu_torch.models.eegnet import LinearEncoder
    from meg_decoding_tpu_torch.utils import torch_import as timport

    rng = np.random.RandomState(0)
    sd = {"linear.weight": torch.from_numpy(rng.randn(8, C).astype(np.float32)),
          "linear.bias": torch.from_numpy(rng.randn(8).astype(np.float32))}
    params, stats = jimport.linear_encoder_from_state_dict(
        jimport.state_dict_to_numpy(sd))
    got = timport.linear_encoder_from_state_dict(sd)
    _assert_bit_identical(got, params_from_jax({"params": params,
                                                "batch_stats": stats}))
    model = LinearEncoder(C, out_dim=8, scp=True, device="cpu")
    model.load_state_dict(got)
    X = rng.randn(4, C, T).astype(np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(X)).numpy()
    want = X.mean(-1) @ sd["linear.weight"].numpy().T + sd["linear.bias"].numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
