"""One rank of the port's data-parallel tests: a gloo process group on the
CPU, one torch thread.  ``tests/test_torch_port_data_parallel.py`` starts
``world`` of these with

    python -m tests.torch_dp_worker RANK WORLD STORE IN.pt OUT_DIR CASE…

They meet in the ``file://`` store, read the inputs the test wrote, run
each case on their rows of every global batch and write ``OUT_DIR/RANK.pt``
(a dict case → results).  The module imports torch and the port only.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from meg_decoding_tpu_torch.core.config import Config
from meg_decoding_tpu_torch.core.mesh import make_mesh, shard_batch


def _t(a):
    return torch.from_numpy(np.asarray(a))


def case_clip(mesh, inp):
    from meg_decoding_tpu_torch.objectives.clip import (
        clip_loss_local_rows_gathered,
        clip_loss_sharded,
    )

    out = {}
    for name, (x, y, temp) in inp["clip"].items():
        for impl in ("factored", "normalized"):
            xl, yl = (shard_batch(mesh, (_t(x), _t(y))))
            xl.requires_grad_(True)
            yl.requires_grad_(True)
            t = torch.tensor(float(temp), requires_grad=True)
            share, met = clip_loss_sharded(xl, yl, t, mesh, top_ks=(1, 10),
                                           impl=impl)
            share.backward()
            out[f"{name}/{impl}"] = {
                "loss": float(met["loss"]), "top1": float(met["top1"]),
                "top10": float(met["top10"]), "gx": xl.grad.numpy(),
                "gy": yl.grad.numpy(), "gt": float(t.grad)}
        xl, yl = shard_batch(mesh, (_t(x), _t(y)))
        t = torch.tensor(float(temp))
        share = clip_loss_local_rows_gathered(xl, yl, t, mesh)
        out[f"{name}/gathered"] = float(mesh.all_reduce_(share.detach().clone()))
    return out


def case_bn(mesh, inp):
    from meg_decoding_tpu_torch.ops.batchnorm import batch_norm_train

    b = inp["bn"]
    x, g = shard_batch(mesh, (_t(b["x"]), _t(b["g"])))
    x.requires_grad_(True)
    scale = _t(b["scale"]).requires_grad_(True)
    bias = _t(b["bias"]).requires_grad_(True)
    y, mean, var = batch_norm_train(x, scale, bias, 1e-5, mesh)
    # the mean and var terms are global: each rank holds 1/n of them, so
    # the ranks' losses sum to the one global loss
    loss = (y * g).sum() + ((mean * _t(b["cm"])).sum()
                            + (var * _t(b["cv"])).sum()) / mesh.world_size
    loss.backward()
    return {"y": y.detach().numpy(), "mean": mean.detach().numpy(),
            "var": var.detach().numpy(), "dx": x.grad.numpy(),
            "dscale": scale.grad.numpy(), "dbias": bias.grad.numpy()}


def _speech_splits(inp):
    from meg_decoding_tpu_torch.data.gwilliams import (
        build_gwilliams_dataset,
        load_gwilliams_cache,
    )

    cfg = Config(inp["speech_cfg"])
    return build_gwilliams_dataset(cfg, *load_gwilliams_cache(cfg.cache_dir),
                                   split_mode="sentence", device="cpu")


def case_gather(mesh, inp):
    from meg_decoding_tpu_torch.data.gwilliams import (
        compute_collate_stats,
        pad_sessions,
    )
    from meg_decoding_tpu_torch.train.scan_loop import (
        _make_sharded_gather,
        shard_gwilliams_splits,
    )

    g = inp["gather"]
    tr, te = _speech_splits(inp)
    padded = pad_sessions(tr, mesh.world_size)
    str_, ste = shard_gwilliams_splits(mesh, tr, te)
    X, Y, subs = _make_sharded_gather(mesh, str_)(g["idx"], _t(g["sess"]))
    return {"padded_recordings": padded.recordings.numpy(),
            "padded_subjects": padded.session_subject.numpy(),
            "aliased": str_.recordings is ste.recordings,
            "X": X.numpy(), "Y": Y.numpy(), "subs": subs.numpy(),
            "stats": compute_collate_stats(str_, g["baseline"],
                                           mesh=mesh).numpy()}


def case_spill(mesh, inp):
    from meg_decoding_tpu_torch.cli.evaluate_speech import SpeechPool
    from meg_decoding_tpu_torch.cli.train_speech import shard_speech_splits
    from meg_decoding_tpu_torch.data.gwilliams import to_host

    g = inp["gather"]
    tr, te = _speech_splits(inp)
    sharded = (SpeechPool(tr), SpeechPool(te))
    shard_speech_splits(mesh, *sharded)
    spilled = (SpeechPool(to_host(tr)), SpeechPool(to_host(te)))
    shard_speech_splits(mesh, *spilled)
    out = {}
    for n in (len(g["idx"]), 1):  # a global batch, and one too small to split
        a = sharded[0].gather(g["idx"][:n], torch.Generator().manual_seed(5))
        b = spilled[0].gather(g["idx"][:n], torch.Generator().manual_seed(5))
        out[n] = [(x.numpy(), y.numpy()) for x, y in zip(a, b)]
    return out


def _state(inp, key, make_model):
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state

    m = inp[key]
    model = make_model(m)
    model.load_state_dict({k: _t(v) for k, v in m["init"].items()
                           if not k.startswith("loss.")})
    opt = make_optimizer(Config(m["sched"]), m["updates_per_epoch"])
    return model, opt, create_train_state(model, opt, m["temp0"], seed=0)


def _result(state, history):
    return {"metrics": [{k: float(v) for k, v in h.items()} for h in history],
            "state": {**{k: v.numpy() for k, v in state.model.state_dict().items()},
                      "loss.temp": state.temp.detach().numpy()}}


def case_speech(mesh, inp):
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from meg_decoding_tpu_torch.train.scan_loop import make_fused_speech_step
    from meg_decoding_tpu_torch.train.steps import CollateConfig, LossConfig

    m = inp["speech"]
    model, opt, state = _state(inp, "speech", lambda m: BrainEncoder(
        m["loc"], **m["model"], device="cpu"))
    tr, _ = _speech_splits(inp)
    fused = make_fused_speech_step(model, opt, LossConfig(),
                                   CollateConfig(**m["collate"]), tr, mesh=mesh,
                                   cache_collate_stats=m["cache_stats"])
    history = []
    for idx, sess in m["steps"]:
        state, met = fused(state, idx, sess_ids=_t(sess))
        history.append(met)
    return _result(state, history)


def case_god(mesh, inp):
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from meg_decoding_tpu_torch.train.steps import (
        CollateConfig,
        LossConfig,
        make_train_step,
    )

    m = inp["god"]
    model, opt, state = _state(inp, "god", lambda m: BrainEncoder(
        m["loc"], **m["model"], device="cpu"))
    step = make_train_step(model, opt, LossConfig(**m["loss"]),
                           CollateConfig(**m["collate"]), mesh=mesh)
    history = []
    for batch in m["steps"]:
        X, Y, subs, labels = shard_batch(mesh, batch)
        state, met = step(state, X, Y, subs, labels)
        history.append(met)
    return _result(state, history)


def case_cli(mesh, inp):
    from meg_decoding_tpu_torch.cli import train_speech

    c = inp["cli"]
    kept = {}

    def fit(*a, **k):
        state, best = real_fit(*a, **k)
        kept["state"] = state
        return state, best

    real_fit, train_speech.fit = train_speech.fit, fit
    cfg = Config({**c["cfg"], "save_root": c["save_roots"][mesh.rank]})
    best = train_speech.run(cfg, device="cpu")
    state = kept["state"]
    return {"best": best, "state": {k: v.numpy() for k, v in
                                    state.model.state_dict().items()}}


def case_resume(mesh, inp):
    """The train CLI's whole-epoch form in the group, one epoch, then a
    second CLI run resumed from rank 0's checkpoint in the shared
    save_root (a barrier between them, as between two invocations)."""
    from meg_decoding_tpu_torch.cli import train_speech

    c = inp["cli"]
    cfg = {**c["cfg"], "save_root": c["resume_root"], "run_name": None,
           "split_mode": "sentence", "use_scan_epochs": True}
    train_speech.run(Config({**cfg, "epochs": 1}), device="cpu")
    dist.barrier()
    kept = {}
    real_fit_scan = train_speech.fit_scan

    def fit_scan(*a, **k):
        state, best = real_fit_scan(*a, **k)
        kept["state"] = state
        return state, best

    train_speech.fit_scan = fit_scan
    train_speech.run(Config({**cfg, "epochs": 2, "resume": True}), device="cpu")
    state = kept["state"]
    return {"step": int(state.step),
            "state": {k: v.numpy() for k, v in state.model.state_dict().items()}}


CASES = {"clip": case_clip, "bn": case_bn, "gather": case_gather,
         "spill": case_spill, "speech": case_speech, "god": case_god,
         "cli": case_cli, "resume": case_resume}


def main(argv):
    rank, world, store, in_path, out_dir = argv[:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    inp = torch.load(in_path, weights_only=False)
    out = {}
    cfg_block = {"coordinator_address": f"file://{store}",
                 "num_processes": world, "process_id": rank, "timeout_s": 120}
    from meg_decoding_tpu_torch.parallel.dp import maybe_distributed_init

    maybe_distributed_init(Config({"distributed": cfg_block}), "cpu")
    mesh = make_mesh("cpu")
    try:
        for case in argv[5:]:
            out[case] = CASES[case](mesh, inp)
            dist.barrier()
    finally:
        torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
