"""The plain reference the benchmark holds the program against: the
brain encoder, the collate, the CLIP loss and Adam written out in plain
PyTorch at f32 (TF32 off), from the published description (Défossez et
al., arXiv:2208.12266; the repository's ``configs/config.yaml`` and
``configs/config_GOD.yaml``).  It imports neither JAX nor anything of the
program, and takes nothing the program has made."""
