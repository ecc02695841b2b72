"""Self-play (PyTorch port of sayuri_tpu.selfplay): so far the game
randomization (randomize.py); the actor, data and pipe are not ported."""
