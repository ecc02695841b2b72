"""Self-play (PyTorch port of sayuri_tpu.selfplay): game randomization
(randomize.py), the batched actor and its targets (actor.py), the chunk
format (data.py) and the pipe that writes chunks, SGFs and query counts
(pipe.py)."""
