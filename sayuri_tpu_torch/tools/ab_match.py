"""A/B strength harness: two search configurations play fixed-seed games
(PyTorch port of tools/ab_match.py).

Measures the strength impact of search-semantics knobs with
color-balanced, vectorized matches: B parallel games in lockstep, A
playing black in the first half and white in the second. Both
configurations share one evaluator (and its weights) unless
``--weights-b`` names another, so any win-rate delta is the search knob
itself.

Usage:
  python -m sayuri_tpu_torch.tools.ab_match --games 128 --boardsize 9 --playouts 64 \\
      --weights /path/net.ckpt \\
      --a gumbel_per_selection=true --b gumbel_per_selection=false

Each --a/--b takes key=value SearchConfig overrides (repeatable).
``--weights`` / ``--weights-b`` take a v5 weight file, a checkpoint of the
port's trainer or one of the JAX package's trainer; weightless without
(the random-output evaluator). Runs on the card (bf16 forward) unless
given ``--cpu``. Prints one JSON line: wins/losses/draws for A, win rate,
and the two-sided 95% normal interval.
"""

import argparse
import json
import math
import sys
from pathlib import Path


def parse_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        lv = v.lower()
        if lv in ("true", "false"):
            out[k] = lv == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                out[k] = float(v)
    return out


def parse_eval_overrides(pairs):
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        if k == "symmetry" and v not in ("random", "average"):
            out[k] = int(v)
        elif v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = float(v) if "." in v else v
            except ValueError:
                out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--games", type=int, default=128)
    ap.add_argument("--boardsize", type=int, default=9)
    ap.add_argument("--komi", type=float, default=7.0)
    ap.add_argument("--playouts", type=int, default=64)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--weights-b", default=None,
                    help="separate checkpoint for side B (strength-trend "
                         "matches: round-k vs round-0 nets at equal "
                         "playouts)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--a", action="append", help="SearchConfig k=v for A")
    ap.add_argument("--b", action="append", help="SearchConfig k=v for B")
    ap.add_argument("--eval-a", action="append",
                    help="make_eval_fn k=v override for A (e.g. "
                         "ladder_mode=full, symmetry=0)")
    ap.add_argument("--eval-b", action="append",
                    help="make_eval_fn k=v override for B")
    ap.add_argument("--label-a", default="A")
    ap.add_argument("--label-b", default="B")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from sayuri_tpu_torch.game.ladder import ladder_planes_batch
    from sayuri_tpu_torch.game.state import GoEnv
    from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
    from sayuri_tpu_torch.models.evaluator import make_dummy_eval_fn, make_eval_fn

    device = torch.device("cpu" if args.cpu else "cuda")
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    ev_a = parse_eval_overrides(args.eval_a)
    ev_b = parse_eval_overrides(args.eval_b)

    env = GoEnv(n=args.boardsize)
    if args.weights:
        from sayuri_tpu_torch.models import weights_io

        def load(path):
            _, net = weights_io.load_checkpoint_for_inference(path, boardsize=args.boardsize)
            return net.to(device)

        def build_eval(over, net):
            return make_eval_fn(env, net, compute_dtype=dtype,
                                **{"symmetry": "random", **over})

        net_a = load(args.weights)
        eval_a = build_eval(ev_a, net_a)
        if args.weights_b:
            eval_b = build_eval(ev_b, load(args.weights_b))
        else:
            eval_b = build_eval(ev_b, net_a) if ev_b != ev_a else eval_a
    else:
        eval_a = eval_b = make_dummy_eval_fn(env)
        if ev_a or ev_b:
            print("note: --eval-a/--eval-b ignored without --weights",
                  file=sys.stderr)

    base = dict(
        max_nodes=args.playouts + 16,
        max_depth=64,
        gumbel=True,
        dirichlet_noise=False,
    )
    cfg_a = SearchConfig(**{**base, **parse_overrides(args.a)})
    cfg_b = SearchConfig(**{**base, **parse_overrides(args.b)})
    mcts_a = MCTS(env, eval_a, cfg_a)
    mcts_b = MCTS(env, eval_b, cfg_b)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    B = args.games
    half = B // 2
    n = args.boardsize

    def best_move(mcts, states):
        # the root ladder planes feed the net (the weightless evaluator
        # reads none)
        ctx = ({"ladders": ladder_planes_batch(states.stones, states.size, states.ko)}
               if args.weights else None)
        superko = env.superko_action_mask(states)
        tree = mcts.init_tree(states, gen, prior_mask=~superko, ctx=ctx)
        tree = mcts.run(tree, args.playouts, ctx=ctx)
        return mcts.best_move(tree)

    states = env.new_batch(B, komi=args.komi, device=device)
    # A is black in lanes [0, half), white in [half, B)
    a_is_black = torch.arange(B, device=device) < half

    max_moves = int(1.8 * n * n)
    for mv in range(max_moves):
        ma = best_move(mcts_a, states)
        mb = best_move(mcts_b, states)
        a_to_act = torch.where(states.to_move == 0, a_is_black, ~a_is_black)
        move = torch.where(a_to_act, ma, mb)
        states = env.step(states, move.to(torch.int32))
        if bool(states.terminated.all()):
            break

    score_b = env.final_score(states).cpu().numpy()
    a_black = a_is_black.cpu().numpy()
    a_margin = np.where(a_black, score_b, -score_b)
    wins = int((a_margin > 1e-4).sum())
    losses = int((a_margin < -1e-4).sum())
    draws = B - wins - losses
    decided = max(wins + losses, 1)
    wr = wins / decided
    se = math.sqrt(wr * (1 - wr) / decided)
    line = {
        "a": args.label_a,
        "b": args.label_b,
        "overrides_a": {**parse_overrides(args.a), **ev_a},
        "overrides_b": {**parse_overrides(args.b), **ev_b},
        **(
            {
                "weights_a": Path(args.weights).name,
                "weights_b": Path(args.weights_b).name,
            }
            if args.weights_b
            else {}
        ),
        "games": B,
        "moves_played": mv + 1,
        "a_wins": wins,
        "a_losses": losses,
        "draws": draws,
        "a_winrate": round(wr, 4),
        "ci95": [
            round(max(0.0, wr - 1.96 * se), 4),
            round(min(1.0, wr + 1.96 * se), 4),
        ],
        "elo_delta": round(
            -400 * math.log10(1 / max(wr, 1e-6) - 1)
            if 0 < wr < 1
            else float("inf") * (1 if wr >= 1 else -1),
            1,
        ),
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
