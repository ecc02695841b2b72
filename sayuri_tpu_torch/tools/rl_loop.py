"""Sequential self-play -> train -> gate loop on one card (port of
tools/rl_loop.py).

    python -m sayuri_tpu_torch.tools.rl_loop --workdir DIR --rounds 2 \\
        --games-per-round 16 --boardsize 9 --steps-per-round 40 [--device cpu]

A round:
  1. self-play a batch of games with the newest gated weights (the pipe
     reloads when a new file appears in DIR/weights);
  2. train on the growing window of chunks, then a validation pass on the
     held-out vdata (``training.log``, ``validation.log``);
  3. checkpoint, and "gate": copy the checkpoint into the weights dir (the
     reference's gate is a copy), which the next round's actor loads.
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import shutil
import time
from pathlib import Path

from sayuri_tpu_torch.mcts.core import SearchConfig
from sayuri_tpu_torch.models.network import NetConfig
from sayuri_tpu_torch.selfplay.actor import SelfplayConfig
from sayuri_tpu_torch.selfplay.pipe import SelfPlayPipe
from sayuri_tpu_torch.tools.train_worker import log_line, validate
from sayuri_tpu_torch.train import dataset as DS
from sayuri_tpu_torch.train.pipeline import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--games-per-round", type=int, default=16)
    ap.add_argument("--parallel-games", type=int, default=16)
    ap.add_argument("--boardsize", type=int, default=9)
    ap.add_argument("--komi", type=float, default=7.5)
    ap.add_argument("--steps-per-round", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--playouts", type=int, default=150)
    ap.add_argument("--fast-playouts", type=int, default=50)
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--cache-entries-per-lane", type=int, default=512,
                    help="NN cache entries per self-play lane (0 = off)")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    work = Path(args.workdir)
    weights_dir, ckpt_dir = work / "weights", work / "checkpoint"
    for d in (weights_dir, ckpt_dir):
        d.mkdir(parents=True, exist_ok=True)

    stack = tuple(["ResidualBlock"] * (args.blocks - 2)
                  + ["ResidualBlock-SE", "ResidualBlock-SE"])
    net_cfg = NetConfig(
        boardsize=args.boardsize,
        residual_channels=args.channels,
        stack=stack,
        se_ratio=4,
        policy_head_channels=min(32, args.channels),
        value_head_channels=min(32, args.channels),
    )
    trainer = Trainer(net_cfg, TrainConfig(batch_size=args.batch_size,
                                           lr_schedule=((0, args.lr),), warmup_steps=20),
                      device=args.device)
    latest = Trainer.latest_checkpoint(str(ckpt_dir))
    if latest:
        print(f"resuming from {latest}")
        trainer.load_checkpoint(latest)

    pipe = SelfPlayPipe(
        out_dir=str(work / "selfplay"),
        boardsize=args.boardsize,
        komi=args.komi,
        parallel_games=args.parallel_games,
        search_cfg=SearchConfig(max_nodes=args.playouts + 26, gumbel=True,
                                nn_cache_size=args.cache_entries_per_lane),
        sp_cfg=SelfplayConfig(playouts=args.playouts,
                              fastsearch_playouts=args.fast_playouts),
        weights_dir=str(weights_dir),
        device=args.device,
    )

    rounds = []
    for rnd in range(args.rounds):
        t0 = time.time()
        if pipe.should_reload():
            pipe._build_actor()
        actor_weights = pipe.current_weights
        target = pipe.games_done + args.games_per_round
        while pipe.games_done < target:
            pipe.play_round()
        t_sp = time.time() - t0

        # train on the growing window
        chunks, n_all = DS.select_window_chunks(str(work / "selfplay" / "tdata"))
        loader = DS.ChunkLoader(chunks, nn_size=args.boardsize, batch_size=args.batch_size,
                                down_sample_rate=4, policy_surprise_factor=0.5,
                                shuffle_capacity=2048, virtual_buffsize=64, seed=rnd)
        t1 = time.time()
        steps, losses = 0, []
        try:
            with open(work / "training.log", "a") as lf:
                for planes, targets in loader:
                    parts = trainer.train_batch(planes, targets)
                    losses.append(parts["loss"])
                    steps += 1
                    lf.write(log_line(trainer.steps, parts))
                    if steps >= args.steps_per_round:
                        break
        finally:
            loader.close()
        t_tr = time.time() - t1

        # validation pass on the held-out vdata
        vchunks = list((work / "selfplay" / "vdata").rglob("*.txt.gz"))
        res = validate(trainer, vchunks[-20:], args.boardsize, args.batch_size, 10,
                       seed=rnd) if vchunks else None
        if res:
            with open(work / "validation.log", "a") as lf:
                lf.write(log_line(trainer.steps, *res))

        # checkpoint + gate: the copy in weights_dir is what the next round loads
        name = trainer.checkpoint_name(num_chunks=n_all, window=len(chunks))
        ckpt = ckpt_dir / f"{name}.ckpt"
        trainer.save_checkpoint(str(ckpt))
        shutil.copy(ckpt, weights_dir / f"{name}.ckpt")

        avg_loss = sum(losses) / max(len(losses), 1)
        print(f"round {rnd}: games={pipe.games_done} chunks={n_all} steps={steps} "
              f"loss={avg_loss:.4f} selfplay={t_sp:.1f}s train={t_tr:.1f}s -> {name}")
        rounds.append({"actor_weights": actor_weights, "games": pipe.games_done,
                       "steps": steps, "loss": avg_loss, "checkpoint": str(ckpt),
                       "selfplay_s": t_sp, "train_s": t_tr})
    return rounds


if __name__ == "__main__":
    main()
