"""Mode dispatch (PyTorch port of sayuri_tpu.__main__):

    python -m sayuri_tpu_torch --mode gtp|selfplay|benchmark [flags] [--config FILE]

- ``gtp``: the GTP engine on stdin / stdout, one game on one card (the
  v5 weight file of --weights in bf16; weightless without one);
- ``selfplay``: the self-play pipe on one card, which writes training
  chunks, SGFs and query counts to --target-directory with the newest v5
  weight file of --weights-dir (weightless without one);
- ``benchmark``: the playout rate of the search with root ladder planes
  over the --benchmark-query ``bg:BATCH:PLAYOUTS`` queries.

A flag the mode does not read yet raises. Runs on the card (`cuda`); a
caller passes ``device="cpu"`` to ``main`` for a CPU run.
"""

from __future__ import annotations

import sys

import torch

from sayuri_tpu_torch.config import Options


def _load_net(path, boardsize=None):
    from sayuri_tpu_torch.models import weights_io

    return weights_io.load_checkpoint_for_inference(path, boardsize=boardsize)[1]


def build_gtp_loop(opts: Options, device="cuda", net=None):
    """The GtpLoop (with its Agent) that `--mode gtp` runs; `net` (a
    SayuriNet) stands in for the --weights file when given."""
    from sayuri_tpu_torch.gtp.engine import Agent
    from sayuri_tpu_torch.gtp.loop import GtpLoop

    g = opts.get
    wf = g("weights_file")
    if net is None and wf:
        net = _load_net(wf)
    agent = Agent(
        boardsize=g("boardsize"),
        komi=g("komi"),
        playouts=g("playouts"),
        net=net,
        search_cfg=opts.search_config(),
        use_rollout=g("use_rollout"),
        ponder=g("ponder"),
        ponder_factor=g("ponder_factor"),
        kldgain_per_node=g("kldgain_per_node"),
        kldgain_interval=g("kldgain_interval"),
        policy_temp=g("policy_temp"),
        root_policy_temp=g("root_policy_temp"),
        suppress_pass_factor=g("suppress_pass_factor"),
        use_stm_winrate=g("use_stm_winrate"),
        use_optimistic_policy=g("use_optimistic_policy"),
        timemanage=g("timemanage"),
        symm_pruning=g("symm_pruning"),
        friendly_pass=g("friendly_pass"),
        capture_all_dead=g("capture_all_dead"),
        device=device,
    )
    agent.reuse_tree = g("reuse_tree")
    if g("book_file"):
        from sayuri_tpu_torch.game.book import Book

        agent.book = Book.load(g("book_file"))
    return GtpLoop(
        agent=agent,
        const_time=g("const_time"),
        lag_buffer=g("lag_buffer"),
        resign_threshold=g("resign_threshold"),
        kgs_hint=g("kgs_hint"),
        logfile=g("logfile") or None,
    )


def run_gtp(opts: Options, device="cuda"):
    loop = build_gtp_loop(opts, device=device)
    loop.run(sys.stdin, sys.stdout)
    return loop


def run_selfplay(opts: Options, device="cuda"):
    from sayuri_tpu_torch.selfplay.pipe import SelfPlayPipe

    pipe = SelfPlayPipe(
        out_dir=opts.get("target_directory") or "selfplay-out",
        boardsize=opts.get("boardsize"),
        komi=opts.get("komi"),
        parallel_games=opts.get("parallel_games"),
        search_cfg=opts.search_config(),
        sp_cfg=opts.selfplay_config(),
        weights_dir=opts.get("weights_dir") or None,
        queries=opts.get("selfplay_query"),
        device=device,
        handicap_fair_komi_prob=opts.get("handicap_fair_komi_prob"),
    )
    max_games = opts.get("num_games") or opts.get("parallel_games")
    pipe.loop(max_games)
    print(f"selfplay done: {pipe.games_done} games -> {pipe.out_dir}")
    return pipe


def run_benchmark(opts: Options, device="cuda", iters: int = 3):
    """Playout-rate benchmark: for each ``bg:BATCH:PLAYOUTS`` query, one
    warm-up search and `iters` timed searches from empty boards, each with
    the roots' ladder planes; prints playouts/s and the Elo-effect estimate
    against 800 playouts a game. Returns the rates."""
    import math
    import time

    from sayuri_tpu_torch.game.ladder import ladder_planes_batch
    from sayuri_tpu_torch.game.state import GoEnv
    from sayuri_tpu_torch.mcts.core import MCTS
    from sayuri_tpu_torch.models.evaluator import make_dummy_eval_fn, make_eval_fn

    device = torch.device(device)
    queries = opts.get("benchmark_query") or ["bg:64:96"]
    boardsize = opts.get("boardsize")
    env = GoEnv(n=boardsize)
    wf = opts.get("weights_file")
    if wf:
        net = _load_net(wf, boardsize).to(device)
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        eval_fn = make_eval_fn(env, net, symmetry="random", compute_dtype=dtype)
    else:
        eval_fn = make_dummy_eval_fn(env)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rates = []
    for q in queries:
        parts = q.split(":")
        batch = int(parts[1]) if len(parts) > 1 else 64
        playouts = int(parts[2]) if len(parts) > 2 else 96
        mcts = MCTS(env, eval_fn, opts.search_config(max_nodes=playouts + 16))
        states = env.new_batch(batch, komi=opts.get("komi"), device=device)

        def search(i):
            ctx = {"ladders": ladder_planes_batch(states.stones, states.size, states.ko)}
            gen = torch.Generator(device=device).manual_seed(i)
            tree = mcts.init_tree(states, gen, ctx=ctx)
            return mcts.run(tree, playouts, ctx=ctx).visits[:, 0]

        search(0)
        sync()
        t0 = time.monotonic()
        for i in range(iters):
            search(i + 1)
        sync()
        dt = time.monotonic() - t0
        rate = iters * batch * playouts / dt
        # Elo effect against an 800-playout baseline
        p = rate / batch
        elo = 250.0 * math.log2(max(p, 1) / 800.0)
        print(f"batch {batch} x {playouts} playouts: {rate:.1f} p/s "
              f"(per-game {p:.1f} p/s, elo-effect {elo:+.0f})")
        rates.append(rate)
    return rates


def main(argv=None, device="cuda"):
    opts = Options().parse_args(argv if argv is not None else sys.argv[1:])
    mode = opts.get("mode")
    if mode == "gtp":
        opts.check_gtp_flags()
        return run_gtp(opts, device=device)
    if mode == "selfplay":
        opts.check_selfplay_flags()
        return run_selfplay(opts, device=device)
    if mode == "benchmark":
        opts.check_benchmark_flags()
        return run_benchmark(opts, device=device)
    raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main()
