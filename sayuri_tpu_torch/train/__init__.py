"""Learner on one card: masked batch renorm in training mode, the 11-term
loss, the chunk loader with surprise sampling and a growing window,
SGD+Nesterov or AdamW with warmup, clipping, macro-batches, SWA and
checkpoints (PyTorch port of sayuri_tpu.train)."""
