"""The replay's plain reference: the JAX package's scalar MIND model
(``src/repro/core``), copied and cut to one ``mind`` rack on one switch."""
