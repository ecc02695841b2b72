"""Mode dispatch (PyTorch port of sayuri_tpu.__main__):

    python -m sayuri_tpu_torch --mode selfplay [flags] [--config FILE]

Only the `selfplay` mode is ported: the self-play pipe on one card, which
writes training chunks, SGFs and query counts to --target-directory with
the newest v5 weight file of --weights-dir (weightless without one). The
`gtp` and `benchmark` modes raise. A flag the selfplay mode does not read
yet raises as well. Runs on the card (`cuda`); a caller passes
``device="cpu"`` to ``main`` for a CPU run.
"""

from __future__ import annotations

import sys

from sayuri_tpu_torch.config import Options


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


def main(argv=None, device="cuda"):
    opts = Options().parse_args(argv if argv is not None else sys.argv[1:])
    mode = opts.get("mode")
    if mode in ("gtp", "benchmark"):
        raise SystemExit(f"--mode {mode} is not ported to the PyTorch package yet")
    if mode != "selfplay":
        raise SystemExit(f"unknown mode {mode!r}")
    opts.check_selfplay_flags()
    return run_selfplay(opts, device=device)


if __name__ == "__main__":
    main()
