"""Small shapes for running the cells on the CPU: every width cut, the
data a few seconds long, so that a run takes seconds."""

SPEECH = {"model.C": 12, "model.D1": 16, "model.D2": 24, "model.F": 16,
          "model.K": 4, "data.subjects": 3, "data.sessions_per_subject": 1,
          "data.rec_sec": 30.0, "data.words_per_task": 24}
GOD = {"model.D1": 16, "model.D2": 24, "model.F": 16, "model.K": 4}
TRAIN = {"traffic.batch_size": 8, "traffic.trace_steps": 2,
         "traffic.warmup_steps": 1}
SERVE = {"traffic.request_pool": 8, "traffic.trace_requests": 3,
         "traffic.sample_every": 3, "traffic.warmup_requests": 2}

CELLS = {
    "speech_train_f32_b64": {**SPEECH, **TRAIN},
    "god_train_b64": {**GOD, **TRAIN},
    # the exact recipe's cached collate and erf_poly GELU, at f32
    "speech_train_exact_b256": {**SPEECH, **TRAIN,
                                "traffic.compute_dtype": "float32"},
    "speech_serve_b1": {**SPEECH, **SERVE},
}

# At these shapes a BatchNorm's running mean, which carries its conv's
# bias (moved by round-off under Adam, and so left out), reads a change
# gap of ~1e-3 in sound runs against the reference; the cell's limit is
# set at its own size, where it reads under 5e-4.  Faults read 4e-2 or
# more here.
LIMITS = {"speech_train_f32_b64": {"change": 1e-2}}
