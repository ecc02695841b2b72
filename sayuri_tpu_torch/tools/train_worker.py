"""Training worker driven by a reference setting.json (port of
tools/train_worker.py).

    python -m sayuri_tpu_torch.tools.train_worker -j setting.json [-w workspace]
        [--max-steps N] [--device cuda|cpu]

One invocation resumes from the newest checkpoint under StorePath, runs up
to MaxStepsPerRunning optimizer steps (``--max-steps`` overrides) on the
growing window of self-play chunks, runs a validation pass when a
ValidationDirectory is set, then stores a checkpoint, the v5 weights and
the SWA v5 weights (``checkpoint/``, ``weights/``, ``swa/`` under
StorePath) and appends ``step=N key=value`` lines to ``training.log`` and
``validation.log``. Paths in the JSON are taken relative to ``-w``. Runs on
the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from sayuri_tpu_torch.models.network import SayuriNet
from sayuri_tpu_torch.models.weights_io import export_reference_weights
from sayuri_tpu_torch.train import dataset as DS
from sayuri_tpu_torch.train.pipeline import Trainer
from sayuri_tpu_torch.train.setting import load_setting


def log_line(step, parts, div=1):
    """``step=N key=value ...``, the form tools/plot_loss.py reads."""
    return f"step={step} " + " ".join(f"{k}={v / div:.6f}" for k, v in parts.items()) + "\n"


def validate(trainer, files, nn_size, batch_size, max_batches, seed=0):
    """Mean loss parts of up to `max_batches` eval batches over `files`
    (no sampling, no looping), or None when they hold no batch."""
    loader = DS.ChunkLoader(files, nn_size=nn_size, batch_size=batch_size,
                            down_sample_rate=1, policy_surprise_factor=0.0,
                            shuffle_capacity=256, virtual_buffsize=1, loop=False, seed=seed)
    acc, n = None, 0
    try:
        for planes, targets in loader:
            p = trainer.eval_batch(planes, targets)
            acc = p if acc is None else {k: acc[k] + p[k] for k in p}
            n += 1
            if n >= max_batches:
                break
    finally:
        loader.close()
    return (acc, n) if acc else None


def export_v5(trainer, path, swa=False):
    """The trainer's net (or its SWA parameters with the current statistics)
    as a v5 weight file."""
    params = trainer.unreplicated_swa_params() if swa else trainer.unreplicated_params()
    net = SayuriNet(trainer.net_cfg)
    net.load_state_dict({**params, **trainer.unreplicated_batch_stats()})
    export_reference_weights(net, str(path))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-j", "--setting", required=True, help="reference setting.json")
    ap.add_argument("-w", "--workspace", default=".",
                    help="base dir for relative paths in the JSON")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="override MaxStepsPerRunning")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    setting = load_setting(args.setting)
    loop = setting.loop
    base = Path(args.workspace)

    def rel(p):
        p = Path(p)
        return p if p.is_absolute() else base / p

    store = rel(loop.store_path)
    ckpt_dir, weights_dir, swa_dir = store / "checkpoint", store / "weights", store / "swa"
    for d in (ckpt_dir, weights_dir, swa_dir):
        d.mkdir(parents=True, exist_ok=True)

    trainer = Trainer(setting.net, setting.train, device=args.device)
    latest = Trainer.latest_checkpoint(str(ckpt_dir))
    if latest:
        trainer.load_checkpoint(latest)
        print(f"resume <- {latest} (step {trainer.steps})")

    # growing window over the newest chunks
    kw = {}
    if loop.chunks_increasing_c:
        kw = dict(c=loop.chunks_increasing_c, scale=loop.chunks_increasing_scale,
                  alpha=loop.chunks_increasing_alpha, beta=loop.chunks_increasing_beta)
    chunks, n_all = DS.select_window_chunks(str(rel(loop.train_dir)), **kw)
    if not chunks:
        print(f"no chunks under {rel(loop.train_dir)}: nothing to do")
        return trainer
    print(f"window: {len(chunks)}/{n_all} chunks")

    loader = DS.ChunkLoader(
        chunks,
        nn_size=setting.net.boardsize,
        batch_size=setting.train.batch_size,
        down_sample_rate=loop.down_sample_rate,
        policy_surprise_factor=loop.policy_surprise_factor,
        shuffle_capacity=max(256, loop.buffer_size // 64),
        virtual_buffsize=64,
        seed=int(time.time()) % (1 << 31),
    )
    max_steps = args.max_steps or loop.max_steps_per_running
    t0 = time.time()
    done = 0
    try:
        with open(store / "training.log", "a") as lf:
            for planes, targets in loader:
                parts = trainer.train_batch(planes, targets)
                done += 1
                if done % max(1, loop.verbose_steps) == 0 or done == 1:
                    rate = done * setting.train.batch_size / (time.time() - t0)
                    print(f"step {trainer.steps}: loss={parts['loss']:.4f} "
                          f"({rate:.0f} samples/s)")
                lf.write(log_line(trainer.steps, parts))
                if done >= max_steps:
                    break
    finally:
        loader.close()

    vdir = rel(loop.validation_dir) if loop.validation_dir else None
    if vdir and vdir.exists():
        vchunks = sorted(vdir.rglob("*.txt.gz"))[-50:]
        res = validate(trainer, vchunks, setting.net.boardsize, setting.train.batch_size,
                       loop.validation_steps) if vchunks else None
        if res:
            with open(store / "validation.log", "a") as lf:
                lf.write(log_line(trainer.steps, *res))

    # store: checkpoint + engine weights + swa weights
    name = trainer.checkpoint_name(num_chunks=n_all, window=len(chunks))
    trainer.save_checkpoint(str(ckpt_dir / f"{name}.ckpt"),
                            extra={"setting_json": setting.json_str})
    export_v5(trainer, weights_dir / f"{name}.bin.txt")
    export_v5(trainer, swa_dir / f"{name}-swa.bin.txt", swa=True)
    print(f"stored {name} ({done} steps, {time.time() - t0:.1f}s)")
    return trainer


if __name__ == "__main__":
    main()
