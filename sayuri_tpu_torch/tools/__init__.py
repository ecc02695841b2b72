"""Entry points of the port's tools: ``train_worker`` (one training run
from a reference setting.json), ``rl_loop`` (self-play, train, gate) and
``ab_match`` (two search configurations play each other)."""
