"""Entry points of the port's learner: ``train_worker`` (one training run
from a reference setting.json) and ``rl_loop`` (self-play, train, gate)."""
