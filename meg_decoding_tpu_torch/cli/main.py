"""Hydra-style CLI argument handling and the dispatching entry points.
Port of ``meg_decoding_tpu/cli/main.py``.

Mirrors the reference's two invocation styles (SURVEY §5.6): decorator-style
``python train_torch.py dataset=GOD preprocs.clamp_lim=10`` overrides and
programmatic ``compose(config_name=...)``.  Supports
``--config-path/--config-name`` (hydra flags, and ``-cp/-cn`` shorthands),
``-m``/``--multirun`` grid sweeps, and ``--device`` (default ``cuda``),
which every dispatch passes to the port's CLIs.

    python train_torch.py dataset=GOD epochs=10
    python train_torch.py -m dataset=GOD lr=1e-3,3e-4 seed=0,1   # 4 jobs
    python evaluate_torch.py --device cpu dataset=Gwilliams2022 save_root=runs_out
"""

from __future__ import annotations

import os
import sys

from meg_decoding_tpu_torch.core.config import Config, compose

__all__ = ["parse_cli", "parse_cli_auto", "default_config_dir",
           "dispatch_train", "dispatch_evaluate", "train_main",
           "evaluate_main", "expand_multirun", "run_multirun", "split_device"]

DEFAULT_DEVICE = "cuda"


def default_config_dir() -> str:
    # repo-root configs/ next to the entry scripts
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "configs")


def split_device(argv) -> tuple[list, str]:
    """(argv without ``--device X`` / ``--device=X``, the device)."""
    argv = list(argv)
    rest, device, i = [], DEFAULT_DEVICE, 0
    while i < len(argv):
        a = argv[i]
        if a == "--device":
            if i + 1 >= len(argv):
                raise SystemExit("--device requires a value")
            device = argv[i + 1]
            i += 2
            continue
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
        i += 1
    return rest, device


def parse_cli(argv=None, default_config_name: str = "config") -> Config:
    argv = list(sys.argv[1:] if argv is None else argv)
    config_path = default_config_dir()
    config_name = default_config_name
    overrides = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("--config-path", "-cp", "--config-name", "-cn"):
            if i + 1 >= len(argv):
                raise SystemExit(f"{a} requires a value")
            if a in ("--config-path", "-cp"):
                config_path = argv[i + 1]
            else:
                config_name = argv[i + 1]
            i += 2
        elif a.startswith("--config-path="):
            config_path = a.split("=", 1)[1]
            i += 1
        elif a.startswith("--config-name="):
            config_name = a.split("=", 1)[1]
            i += 1
        elif "=" in a:
            overrides.append(a)
            i += 1
        else:
            raise SystemExit(f"unrecognized argument {a!r} (expected key=value)")
    return compose(config_path, config_name, overrides)


def parse_cli_auto(argv=None, default_config_name: str = "config") -> Config:
    """``parse_cli`` that picks the default config FILE from a ``dataset=``
    override before composing — ``config.yaml`` for the speech datasets,
    ``config_GOD.yaml`` for GOD — so ``train_torch.py dataset=GOD``
    composes the GOD defaults without an explicit ``--config-name``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides = dict(a.split("=", 1) for a in argv
                     if "=" in a and not a.startswith("--"))
    ds = overrides.get("dataset")
    if ds == "GOD":
        name = "config_GOD"
    elif ds in ("Gwilliams2022", "Brennan2018"):
        name = "config"
    else:
        name = default_config_name
    return parse_cli(argv, default_config_name=name)


def dispatch_train(cfg, device: str = DEFAULT_DEVICE):
    """Select the GOD or speech trainer by ``cfg.dataset`` — the dispatch of
    the reference's ``train.py run(args)`` (train.py:28-58 picks the dataset
    class from ``args.dataset``)."""
    if cfg.dataset == "GOD":
        from meg_decoding_tpu_torch.cli.train_god import run as _run
    elif cfg.dataset in ("Gwilliams2022", "Brennan2018"):
        from meg_decoding_tpu_torch.cli.train_speech import run as _run
    else:
        raise ValueError(f"unknown dataset {cfg.dataset!r}")
    return _run(cfg, device=device)


def dispatch_evaluate(cfg, device: str = DEFAULT_DEVICE):
    """Select the GOD or speech evaluator by ``cfg.dataset`` (counterpart of
    ``dispatch_train``)."""
    if cfg.dataset == "GOD":
        from meg_decoding_tpu_torch.cli.evaluate_god import run as _run
    elif cfg.dataset in ("Gwilliams2022", "Brennan2018"):
        from meg_decoding_tpu_torch.cli.evaluate_speech import run as _run
    else:
        raise ValueError(f"unknown dataset {cfg.dataset!r}")
    return _run(cfg, device=device)


def expand_multirun(argv):
    """Hydra basic-sweeper semantics (``-m``/``--multirun``): every
    comma-separated override value contributes one grid axis; returns the
    cartesian product as one full argv per job (first listed override
    varies slowest, like Hydra).  ``key=[a,b]`` list VALUES are not axes.
    Returns ``None`` when the flag is absent — comma then keeps its plain
    single-value meaning, exactly as in Hydra."""
    import itertools

    if not any(a in ("-m", "--multirun") for a in argv):
        return None
    argv = [a for a in argv if a not in ("-m", "--multirun")]
    base, axes = [], []
    for a in argv:
        if "=" in a and not a.startswith("--"):
            k, v = a.split("=", 1)
            if "," in v and not v.startswith(("[", "{")):
                axes.append([f"{k}={x}" for x in v.split(",")])
                continue
        base.append(a)
    if not axes:
        return [base]
    return [base + list(job) for job in itertools.product(*axes)]


def _claim_sweep_dir(save_root: str) -> str:
    """Create a fresh ``{save_root}/multirun/{stamp}`` dir — collision-proof
    even for sweeps launched within the same second (a ``-1``/``-2`` suffix
    claims a new dir atomically via makedirs(exist_ok=False))."""
    import time

    stamp = time.strftime("%Y-%m-%d_%H-%M-%S")
    for suffix in [""] + [f"-{i}" for i in range(1, 1000)]:
        sweep_dir = os.path.join(save_root, "multirun", stamp + suffix)
        try:
            os.makedirs(sweep_dir, exist_ok=False)
            return sweep_dir
        except FileExistsError:
            continue
    raise RuntimeError(f"could not claim a sweep dir under {save_root}")


def run_multirun(jobs, dispatch, default_config_name="config",
                 checkpoint_is_input=False):
    """Run one composed job per override set under a TIMESTAMPED sweep dir
    ``{save_root}/multirun/{stamp}/{job_num}`` (Hydra's layout — reruns of
    different sweeps never mix artifacts in the same job dirs), recording
    each job's overrides and result beside its outputs.  Returns the list
    of per-job results; a failed job records the error and the sweep
    continues (Hydra basic launcher behavior).

    Every job's ``save_root`` becomes its own job dir, so per-job OUTPUTS
    (checkpoints, metrics, eval artifacts like top5.csv) never clobber each
    other.  ``checkpoint_is_input=True`` (evaluate sweeps) additionally
    pins ``cfg.ckpt_dir`` to the ORIGINAL ``{save_root}/ckpt`` — there the
    checkpoint is an input every job must read.  ``dispatch`` takes the
    composed config."""
    import json

    results = []
    sweep_dirs = {}  # save_root → claimed sweep dir (save_root may be swept)
    for num, job_argv in enumerate(jobs):
        cfg = parse_cli_auto(job_argv, default_config_name=default_config_name)
        save_root = cfg.get("save_root", "runs_out")
        if save_root not in sweep_dirs:
            sweep_dirs[save_root] = _claim_sweep_dir(save_root)
        job_dir = os.path.join(sweep_dirs[save_root], str(num))
        os.makedirs(job_dir, exist_ok=True)
        with open(os.path.join(job_dir, "overrides.txt"), "w") as f:
            f.write("\n".join(job_argv) + "\n")
        if checkpoint_is_input and not cfg.get("ckpt_dir"):
            cfg.ckpt_dir = os.path.join(save_root, "ckpt")
        cfg.save_root = job_dir
        print(f"[multirun] job {num}: {' '.join(job_argv)}")
        try:
            r = dispatch(cfg)
        except Exception as e:  # noqa: BLE001 — sweep survives a bad point
            print(f"[multirun] job {num} FAILED: {type(e).__name__}: {e}")
            r = {"error": f"{type(e).__name__}: {e}"}
        results.append(r)
        # serialize FIRST: a mid-dump failure must not leave a truncated,
        # unparseable result.json behind — and an unserializable result
        # (e.g. tuple keys) must not kill the remaining sweep jobs
        try:
            payload = json.dumps(r, default=str)
        except TypeError:
            payload = json.dumps({"unserializable_result": repr(r)})
        with open(os.path.join(job_dir, "result.json"), "w") as f:
            f.write(payload)
    for num, r in enumerate(results):
        print(f"[multirun] job {num} result: {r}")
    return results


def train_main(argv=None):
    """Entry of ``train_torch.py``: dispatch to the GOD or speech trainer by
    ``dataset=`` on ``--device`` (default ``cuda``).  ``-m``/``--multirun``
    sweeps comma-separated override values as a grid, one job per point
    (``train_torch.py -m dataset=GOD lr=1e-3,3e-4 seed=0,1`` → 4 jobs
    under ``{save_root}/multirun/{timestamp}/{0..3}``)."""
    argv, device = split_device(sys.argv[1:] if argv is None else argv)
    jobs = expand_multirun(argv)
    if jobs is not None:
        return run_multirun(jobs, lambda cfg: dispatch_train(cfg, device))
    best = dispatch_train(parse_cli_auto(argv), device)
    print("best:", best)
    return best


def evaluate_main(argv=None):
    """Entry of ``evaluate_torch.py``: dispatch to the GOD or speech
    evaluator on ``--device``.  Supports ``-m`` grid sweeps like
    ``train_main``."""
    argv, device = split_device(sys.argv[1:] if argv is None else argv)
    jobs = expand_multirun(argv)
    if jobs is not None:
        # the checkpoint under the original save_root is an INPUT every
        # job reads; per-job eval artifacts go to the job dirs
        return run_multirun(jobs, lambda cfg: dispatch_evaluate(cfg, device),
                            default_config_name="config_GOD",
                            checkpoint_is_input=True)
    return dispatch_evaluate(parse_cli_auto(argv,
                                            default_config_name="config_GOD"),
                             device)
