#!/usr/bin/env python3
"""Smoke run of the PyTorch port (sayuri_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and prints
no result line):

1. device: the card's name and power limit; TF32 off for the f32 phases.
2. build: compile csrc/analysis.cu, csrc/ladder.cu and csrc/flood.cu with
   nvcc for sm_90a (first use, the three nvcc processes at once); ptxas
   resources printed.
3. kernel parity: random legal 19x19 positions (B=256, numpy seed, played
   by the env on the card), the
   pass-dead golden boards and the stress boards of game/positions.py
   (one-colour spiral, checkerboard, full and empty boards, the capture of
   a whole spiral, smaller games in the buffer; 19x19 and 9x9 buffers),
   through both analysis kernels and their plain twins on the CPU: every
   output equal cell for cell; kernel and plain version timed on the card
   at B=256.
4. ladder kernel parity: the same 256 positions plus the 54 records of
   tests/goldens/go_goldens_19.json. ladder_prep, run_greedy and run_chases
   equal their plain twins cell for cell and lane for lane (the lanes that
   ladder_planes_batch builds); ladder_planes_batch on the card equals the
   plain one on the CPU; on the goldens the four planes equal the
   reference's encoder planes 33-36; ladder_prep also on the stress boards
   (19x19 and 9x9 buffers). Kernels and plain versions timed on
   the card at B=256 (the plain chase on the CPU: on the card it took
   76-81 s); the searches' bounds count the plies the plain twins
   ran on these lanes (for each search: the plies of its longest lane,
   their sum, median, p90 and p99 over the searched lanes, the kernel's
   ms a ply of the longest lane and that lane's time alone are printed).
5. slice: bench_playouts(256, 96) (19x19, b6c96, bf16, random symmetry,
   root ladder planes), one warm-up search and three timed; launch counters
   prove the main path ran through all five kernels, each ladder kernel
   once per search.
6. midgame roots: the same bench from the 256 positions of phase 3 (one
   warm-up search, one timed): root ladder planes non-zero and equal to the
   CPU twin's, root visits = playouts + 1, legal best moves.
7. f32 search parity: 9x9 midgame roots with root ladder planes, B=8, 32
   playouts, the same seeded weights on the card and on the CPU (twins):
   root NetEvals within 1e-4, share of lanes with identical root visit
   vectors reported.
8. step-legal parity: step_and_legal against its plain version on the
   CPU over the positions and actions of phase 3, the pass-dead goldens
   and the stress boards, every output equal; at B=4096 (the positions
   tiled 16 times) equal to the tiled plain output; kernel timed at B=256
   and B=4096; then
   the env-steps bench (bench_env_steps: B=4096 19x19, 64 light steps a
   run, one warm-up and three timed runs), one launch a step plus the pass
   pre-step, every lane's move count advanced, and the last run's final
   GoState equal to the same rollout through step_and_legal_plain.
9. board fixpoints: flood and chain_labels against their plain versions
   on the colour masks of the 256 positions, on reach seeds and on a
   nested [2, B, n, n] batch; then the rules queries (legal_action_mask,
   step, superko_action_mask, final_score, ownership) on the B=256 card
   states, equal to the plain CPU run (superko on 32 lanes); kernels and
   superko_action_mask timed at B=256.
10. rollout: mc_ownership at B=256 with the full 723-move cap on the card;
    the moves it played replayed through the plain CPU env give the same
    ownership and scores (on 64 lanes); a search with the rollout-wrapped
    weightless evaluator (cut playout cap): root visits = playouts + 1.
11. randomize: GameRandomizer.prepare at B=256 with the b6c96 net (bf16)
    as the policy, random openings on every lane and a bhp:19:4:0.5
    handicap query; its sampled moves replayed on the CPU give the same
    GoState, and every lane keeps a legal move.
12. fixpoint shapes: flood and chain_labels at every board count their
    wrappers were given in phases 9-11 (a spy on the kernel wrappers keeps the
    first inputs of each), equal to their plain versions and timed there;
    the launches of each shape give its share of the kernel's time; then
    both on the stress boards' colour masks at 512 boards (the flood with
    two seedings).

13. self-play: a v5 weight file of the b6c96 net (seeded random weights)
    written by the port's exporter into a temporary --weights-dir, then
    the CLI, ``python -m sayuri_tpu_torch --mode selfplay --config
    configs/selfplay-gumbel-p150.txt`` with the playouts cut to 12/4 and
    the parallel games from 64 to 32 (all else the config's: Gumbel,
    playout caps, the bkp:9 / bkp:7 and srs:area:territory queries, the NN
    cache), one round of 32 games: every chunk holds 53 lines a position starting "2", "0",
    bsize; the chunks hold as many positions as there were kept records;
    every SGF's moves replay legally (superko included) through the plain
    CPU env; net_queries is written; territory lanes ran the helper
    playout; the round's kept positions/s. A spy keeps, for each kernel
    wrapper and shape in that run, the inputs of a launch from the second
    half of its launches there (the last power-of-two launch number), so
    the boards are mid- to late-game: each is held against its plain twin
    there and timed. Then the 19x19 reading: ``bench.bench_selfplay``
    (b6c96 bf16, the config's 150/50 playouts, B=256, 4 moves after a
    one-move warm-up), moves/s and kept positions/s, with the NN cache of
    512 sets, then without it.

14. GTP: the GTP mode as ``python -m sayuri_tpu_torch --mode gtp --config
    configs/gtp-p400.txt --weights F`` builds it, in-process with stdin
    fed line by line and stdout captured, on phase 13's b6c96 v5 file
    (bf16) and ``--threads 4`` (a flag the JAX package ignores):
    name, list_commands, boardsize 19, clear_board, four genmoves
    alternating colours with tree reuse, play and undo, a kata-analyze
    stream held about two seconds before the next line (an info line
    parsed), sayuri-raw_nn avg, final_score, final_status_list dead,
    printsgf; every answer "=", the SGF replayed legally on the CPU, each
    genmove's seconds and the B=1 playouts/s printed. Then two 9x9 games
    of alternating genmoves at 8 playouts (up to 80 moves or two
    passes): the area rule with --first-pass-bonus --friendly-pass
    --capture-all-dead --symm-pruning, and the territory rule with the
    territory helper playout before final_score; final_score,
    final_status_list dead, gogui-seki and printsgf answer "=", the moves
    replay legally, the kernels' launches a simulation printed. While
    these run, the plain functions of the kernels raise on a CUDA tensor
    (no plain twin runs on the card's path), and a spy keeps the inputs of
    a late launch at each shape (boards or lanes, and board width: the
    19x19 session's one-board launches apart from the 9x9 games'): each
    kernel is held against its plain twin and timed there. Last, ``--mode benchmark --benchmark-query
    bg:16:32`` prints its line.

15. train: (a) one b6c96 SGD step at batch 256 (a batch of phase 13's
    9x9 / 7x7 chunks in the 19x19 buffer) on the card and on the CPU from
    the same seeded weights, f32 with TF32 off: loss parts within 1e-4
    relative, parameters and running statistics after the step within 1e-4;
    (b) ``python -m sayuri_tpu_torch.tools.train_worker`` on a setting.json
    it writes (b6c96, MaxBoardSize 19, BatchSize 256, TrainDirectory =
    phase 13's tdata) with --max-steps 32: 32 finite training.log lines, the
    checkpoint, v5 and SWA v5 files, the v5 file read back through
    load_checkpoint_for_inference gives the trainer's eval-mode heads within
    1e-4 on the card, a second invocation resumes at step 32; (c) ``bench
    train`` on the same chunks: ms a step and samples/s of the step alone,
    samples/s through the loader and the share of the wall time the step
    loop waits on it; (d) ``python -m sayuri_tpu_torch.tools.rl_loop`` on the
    card, two 7x7 rounds of 8 games at 8/4 playouts and 8 steps of batch
    64: round 2's actor loads round 1's gated .ckpt, the self-play kernels
    launch, the plain functions raise on a CUDA tensor meanwhile, and every
    kernel is held against its plain twin at each shape the loop gave it
    (the kernels line carries `rl_launches` and `rl_by_shape`); (e) the
    loader alone (``bench.bench_loader``, 4 batches of 256) with the native
    chunk codec and with the Python parse, alternated (on, off, off, on),
    on phase 13's chunks and on seeded 19x19 chunks that the port's native
    writer produces here. In (a) and (e) the loader must have parsed every
    sample on the path asked for (the codec builds on the card's host).

16. block families: the b6c96-mix net (``bench.NETS``: b6c96's width and
    depth with the stack BottleneckBlock, NestedBottleneckBlock-SE,
    MixerBlock, MixerBlockV2-SE, ResidualBlock, ResidualBlock-SE and a
    32-channel RepLK policy head; seeded random weights). (a) f32 with TF32
    off on the card and on the CPU over random planes of 19x19, 13x13 and
    9x9 boards in the 19x19 buffer: every head within 1e-4 of the CPU's
    (phase 7's bound), the max error of each printed. (b) bench_playouts on
    b6c96-mix at B=256 x 96 playouts (bf16, root ladder planes), one
    warm-up and three timed searches, then the same bench on b6c96 (mix,
    b6c96): around the mix run the counters show
    step_and_analyze once a simulation and the ladder kernels once a search,
    root visits = playouts + 1 and legal best moves; both rates and their
    ratio. (c) The port's exporter writes the net as a v5 file, read back
    through load_checkpoint_for_inference: heads within the same bound of
    the source net on the card; the GTP CLI with configs/gtp-p400.txt at
    50 playouts on that file answers one 19x19 genmove with "=". (d) One
    b6c96-mix SGD step at batch 256 on phase 13's chunks, card vs CPU as in
    15(a), then ``bench train --net b6c96-mix``: ms a step of the step alone. (e)
    ``bench profile --net b6c96-mix``: the device ms of the depthwise conv
    blocks' convolutions (their merged kernel and the grouped conv), by
    kernel, and their share of a search's busy time and wall.

17. group: a world-size-1 NCCL process group (SAYURI_COORDINATOR on a
    free localhost port, SAYURI_NUM_PROCS=1, SAYURI_PROC_ID=0), in child
    processes: (a) the port of the JAX package's multi-chip dry run
    (``parallel.dryrun``: one sharded train step of the 9x9 16-channel
    net, eight moves of 9x9 self-play over the group, the invariants: each
    all-reduce spans every rank, together they cover every parameter,
    each rank holds the global batch over the world size), counted through
    a wrapper around ``torch.distributed.all_reduce``, its kernels held
    against their plain twins at its shapes; (b) one b6c96 SGD step at
    batch 256 on phase 13's chunks under the group and without it, from
    the same weights: equal bit for bit, both timed, the NCCL kernels'
    share of the step; (c) ``python -m sayuri_tpu_torch --mode selfplay``
    under the group, one round of 8 games with phase 13's config: no p0 in
    the run id at world size 1, the chunks parse (the kernels line carries
    `group_launches` and `group_by_shape`).

18. gammas: (a) ``genpatterns`` through the port's GTP loop on four of
    phase 13's SGFs (the games replayed on the card): the gamma count and
    the seconds. (b) On phase 3's 256 midgame 19x19 positions, the device
    gammas (pattern/gammas_device.py) on the card against the CPU: spatial
    keys and table lookups equal, the gammas policy (seeded ownership)
    within 1e-6, the gammas-mixed f32 root NetEvals of phase 13's b6c96
    weights within 1e-4; the gammas policy timed at B=256 and B=1. (c) The
    gtp-p400 session through the CLI with ``--patterns FILE
    --gammas-policy-factor 0.5`` on phase 13's v5 file (bf16): three
    genmoves, gogui-gammas_heatmap and gogui-gammas_rating, the factor set
    to 0 by sayuri-setoption, one more genmove; every answer "=", seconds a
    genmove beside phase 14's, the kernels' launches a simulation with and
    without the gammas, and all CUDA kernels a simulation (torch.profiler,
    a 16-playout search each way); every kernel held against its plain
    twin at each shape the session gave it (`gammas_launches`,
    `gammas_by_shape`). (d) ``python -m sayuri_tpu_torch.tools.ab_match``
    on the card: 8 7x7 games at 8 playouts, weightless, Gumbel with a draw
    a selection against one draw a search; its JSON line.

Launch counters are set to 0 right before each main path (phases 5, 8-11,
13, 14, 15(d), the b6c96-mix run of 16(b), 17(a), 18(c)) and read right
after it. The second-to-last line is the kernels JSON
(all eight kernels: launches on their path, max abs error against the plain
version, kernel and plain ms with the plain version's device, the bound,
library call; the self-play, GTP, RL-loop, group and gammas launches and
shapes);
the last line is {"ok": true, "device": {...}}.
There is no CPU fallback: without a CUDA device the script fails.
"""

import json
import re
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PARITY_B = 256
SLICE_BATCH, SLICE_PLAYOUTS = 256, 96
EVAL_ATOL = 1e-4  # f32 card vs CPU: conv/matmul sums in another order
ENV_BATCH, ENV_STEPS, ENV_RUNS = 4096, 64, 3
ROLLOUT_REPLAY_LANES = 64
WRAPPED_PLAYOUTS, WRAPPED_MAX_MOVES = 8, 64
SPIN_CYCLES = 50_000_000   # time_card's head start, about 25 ms at 1980 MHz
# the bound: H100 SXM data sheet rates (HBM bytes/s; float32 outside the
# tensor cores, taken as the rate of the scalar integer work these kernels
# do). Operations counted: OPS_PER_CELL a board cell (or lane row), the
# least any algorithm spends to read a cell and its four neighbours once.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
OPS_PER_CELL = 8
# a ply of a ladder search (greedy step or chase descent) needs at least one
# neighbour step, OPS_PER_CELL a row, over the lane's own, opponent and prey
# rows on the board
PLY_BOARDS = 3
# phase 13: the CLI self-play run (playouts cut so a whole 9x9 game batch
# fits the smoke, games from the config's 64 to leave phase 18 room) and
# the 19x19 reading
SP_PLAYOUTS, SP_FAST_PLAYOUTS, SP_GAMES = 12, 4, 32
SP_BENCH_BATCH, SP_BENCH_MOVES = 256, 4
# the config's cache, then none (two runs, to leave the GTP phase room in
# the time limit)
SP_BENCH_CACHE_SETS = (512, 0)


def phase(name):
    print(f"== {name}", flush=True)


def tensor_bytes(torch, obj):
    """Bytes of every tensor in `obj` (a tensor, or nested tuples, lists and
    dicts of them)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(torch, x) for x in obj)
    return 0


def bound(nbytes, ops):
    """(bound_ms, bound_by): the least time the card could take to read the
    inputs and write the outputs once (`nbytes`) and to do `ops` scalar
    operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def lane_work(lanes, plies, outputs, n):
    """(bytes, operations) a ladder search needs on these lanes: each valid
    lane's two rows of words and four scalars read, every lane's valid flag
    read and its `outputs` int32 results written; PLY_BOARDS * n rows of
    OPS_PER_CELL operations for each ply the lanes ran (`plies`, from the
    plain twin: the work depends on the data)."""
    valid = lanes[6] > 0
    v, L = int(valid.sum()), valid.numel()
    nbytes = 4 * (v * (2 * lanes[0].shape[1] + 4) + L * (1 + outputs))
    return nbytes, OPS_PER_CELL * PLY_BOARDS * n * int(plies.sum())


def golden_positions(torch, np):
    from sayuri_tpu_torch.game.state import GoEnv

    data = json.loads((ROOT / "tests/goldens/passdead_goldens.json").read_text())
    n = data["size"]
    env = GoEnv(n=n)
    boards = []
    for rec in data["records"]:
        s = env.new_batch(1, komi=data["komi"], device="cpu")
        for _, v in rec["moves"]:
            s = env.step(s, torch.tensor([n * n if v < 0 else v], dtype=torch.int32))
        if rec["stones"] is not None and s.stones.reshape(-1).tolist() != rec["stones"]:
            raise RuntimeError(f"golden {rec['name']}: replay mismatch")
        boards.append(s.stones)
    stones = torch.cat(boards + boards)
    b = stones.shape[0]
    z = torch.zeros(b, dtype=torch.int32)
    tm = torch.arange(b, dtype=torch.int32) // (b // 2)   # both sides to move
    return stones, z + n, z - 1, tm


def compare(torch, kernel_out, plain_out, tag):
    """Cell-for-cell equality (floats exact too); returns (cells compared,
    max abs error)."""
    cells, err = 0, 0
    for k, want in plain_out.items():
        got, want = kernel_out[k].cpu(), want.cpu()
        if got.shape != want.shape:
            raise RuntimeError(f"{tag}: {k} shape {tuple(got.shape)} != {tuple(want.shape)}")
        if want.is_floating_point():
            diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
        else:
            diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
        cells += diff.numel()
        err = max(err, diff.max().item() if diff.numel() else 0)
        if err:
            bad = diff.reshape(diff.shape[0], -1).amax(1).nonzero().flatten().tolist()
            raise RuntimeError(f"{tag}: {k} differs in lanes {bad[:16]}")
    return cells, err


def time_card(torch, fn, args, iters=20, warmup=2):
    """ms per call on the card: CUDA events around `iters` calls. A spin
    kernel queued first (about 25 ms) keeps the card busy while the host
    queues the calls, so that a kernel shorter than its wrapper's host time
    is timed back to back and not at the host's pace; a call that waits on
    the card is still timed at the host's pace."""
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    e0.record()
    for _ in range(iters):
        fn(*args)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def legal_actions(torch, np, args, seed):
    """One action per board of (stones, size, ko, to_move): a random legal
    board move, or a pass for every fifth board and where none is legal."""
    from sayuri_tpu_torch.game import board as TB

    stones, size, ko, tm = args
    nn = stones.shape[-1] ** 2
    legal = TB.legal_moves(stones, size, tm, ko, plain=True).numpy()
    rng = np.random.RandomState(seed)
    return torch.tensor([
        rng.choice(np.nonzero(l)[0]) if l.any() and i % 5 else nn
        for i, l in enumerate(legal)
    ], dtype=torch.int32)


def golden19_positions(torch):
    """The 54 records of go_goldens_19.json replayed with the port's plain
    env in one batch (a lane stops after its last move). Returns (states,
    reference ladder planes [B, n, n, 4] in encoder order 33-36)."""
    from sayuri_tpu_torch.game.state import GoEnv, GoState

    data = json.loads((ROOT / "tests/goldens/go_goldens_19.json").read_text())
    records = data["records"]
    n, b = data["size"], len(records)
    env = GoEnv(n=n)
    s = env.new_batch(b, komi=data["komi"], device="cpu")
    moves = [r["moves"] for r in records]
    for t in range(max(len(m) for m in moves)):
        active = torch.tensor([t < len(m) for m in moves])
        acts = torch.tensor([n * n if t >= len(m) or m[t] == "pass" else int(m[t])
                             for m in moves], dtype=torch.int32)
        new = env.step(s, acts)
        s = GoState(**{
            k: torch.where(active.view((b,) + (1,) * (v.ndim - 1)), v, getattr(s, k))
            for k, v in new.fields().items()
        })
    planes = torch.tensor([r["planes"][33:37] for r in records]).permute(0, 2, 3, 1)
    return s, planes


class LaneSpy:
    """Stands in for the ladder search wrappers while ladder_planes_batch
    runs on the CPU: runs their plain twins, which also count each lane's
    plies, and records arguments, results and plies (to replay the same
    lanes through the kernels and to count the work they need)."""

    def __init__(self, LK):
        self.LK = LK
        self.calls = {}
        self.seconds = {}

    def __enter__(self):
        LK = self.LK
        self.real = {k: getattr(LK, k) for k in ("run_greedy", "run_chases")}

        def greedy(*args, **kw):
            res, forked, steps = LK.greedy_steps_plain(*args, **kw)
            self.calls["run_greedy"] = (args, (res, forked), steps)
            return res, forked

        def chases(*args, **kw):
            # run_chases_plain is chase_descents_plain's result alone: this
            # times the plain twin itself, on the CPU
            t0 = time.monotonic()
            res, descents = LK.chase_descents_plain(*args, **kw)
            self.seconds["run_chases"] = time.monotonic() - t0
            self.calls["run_chases"] = (args, res, descents)
            return res

        LK.run_greedy, LK.run_chases = greedy, chases
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(self.LK, name, fn)


class KernelSpy:
    """While installed, counts the CUDA launches of all eight kernel
    wrappers by (name, boards or lanes, board width) and keeps a copy of the inputs of
    one launch of each (to check and time every kernel at the shapes a main
    path gave it): the first launch, or with `late` the last launch whose
    number at that shape is a power of two, which lies in the second half
    of the run's launches there (`kept[key]` holds its number)."""

    def __init__(self, TA, LK, FK, late=False):
        self.late = late
        self.kept = {}
        self.wrappers = [(TA, ("step_and_analyze", "board_analysis", "ladder_prep",
                               "step_and_legal")),
                         (LK, ("run_greedy", "run_chases")),
                         (FK, ("flood", "chain_labels"))]
        self.FK, self.LK = FK, LK
        self.counts = {}
        self.inputs = {}

    def install(self):
        self.real = []
        for mod, names in self.wrappers:
            for name in names:
                fn = getattr(mod, name)
                self.real.append((mod, name, fn))

                def spy(*args, _fn=fn, _name=name, _mod=mod):
                    t = args[-1] if _mod is self.FK else args[0]
                    if t.device.type == "cuda" and t.numel():
                        size = (t.numel() // (t.shape[-1] ** 2) if _mod is self.FK
                                else t.shape[0])
                        # the ladder searches take the width as an argument
                        n = args[7] if _mod is self.LK else t.shape[-1]
                        key = (_name, size, int(n))
                        k = self.counts[key] = self.counts.get(key, 0) + 1
                        if k == 1 or (self.late and k & (k - 1) == 0):
                            self.kept[key] = k
                            self.inputs[key] = tuple(
                                a.clone() if hasattr(a, "clone") else a for a in args)
                    return _fn(*args)
                setattr(mod, name, spy)

    def remove(self):
        for mod, name, fn in self.real:
            setattr(mod, name, fn)


def replay_sgfs(torch, sgf_dir, n):
    """Replay every SGF of `sgf_dir` in one batch through the plain CPU env
    (a lane per game, padded with passes): every move must be the side to
    move's and legal, positional superko included. Returns (games,
    moves)."""
    from sayuri_tpu_torch.game import sgf as SGF
    from sayuri_tpu_torch.game.state import GoEnv

    games = [SGF.parse_file(str(f))[0] for f in sorted(sgf_dir.glob("*.sgf"))]
    if not games:
        raise RuntimeError(f"no SGF in {sgf_dir}")
    b = len(games)
    env = GoEnv(n=n)
    sizes = [g.board_size() for g in games]
    seqs = [g.moves() for g in games]
    s = env.new_batch(b, device="cpu").replace(
        size=torch.tensor(sizes, dtype=torch.int32))
    total = 0
    for t in range(max(len(m) for m in seqs)):
        live = torch.tensor([t < len(m) for m in seqs])
        acts, colours = [], []
        for m, size in zip(seqs, sizes):
            c, v = m[t] if t < len(m) else (0, None)
            colours.append(c)
            acts.append(env.pass_action if v is None else (v // size) * n + v % size)
        acts = torch.tensor(acts, dtype=torch.int32)
        legal = env.legal_action_mask(s).gather(1, acts.long()[:, None])[:, 0]
        ok = (legal & ~env.superko_violation(s, acts)
              & (s.to_move == torch.tensor(colours)) & ~s.terminated)
        bad = (live & ~ok).nonzero().flatten().tolist()
        if bad:
            raise RuntimeError(f"SGF replay: move {t} illegal in games {bad[:8]}")
        total += int(live.sum())
        s = env.step(s, torch.where(live, acts, env.pass_action))
    return b, total


def check_shapes(torch, card, spy, tag, where):
    """Hold every kernel against its plain twin and time both at each
    shape `spy` (a KernelSpy) saw, on the inputs it kept; `where(k,
    n_launch)` says where in the run launch k fell. Returns {name: [shape
    records]}."""
    from sayuri_tpu_torch.game import board as TB
    from sayuri_tpu_torch.ops import analysis as TA
    from sayuri_tpu_torch.ops import flood as FK
    from sayuri_tpu_torch.ops import ladder_kernel as LK

    plain_of = {"step_and_analyze": TA.step_and_analyze_plain,
                "board_analysis": TA.board_analysis_plain,
                "ladder_prep": TA.ladder_prep_plain,
                "step_and_legal": TA.step_and_legal_plain,
                "run_greedy": LK.run_greedy_plain, "run_chases": LK.run_chases_plain,
                "flood": TB.flood_plain, "chain_labels": TB.chain_labels_plain}
    kernel_of = {name: getattr(mod, name) for mod, names in spy.wrappers
                 for name in names}
    shapes = {}
    for (name, size, n), n_launch in sorted(spy.counts.items()):
        a = spy.inputs[(name, size, n)]
        got = kernel_of[name](*a)
        # the ladder searches' plain twins that also count each lane's plies
        if name == "run_greedy":
            res, forked, plies = LK.greedy_steps_plain(*a)
            got = dict(zip(("result", "forked"), got))
            want = {"result": res, "forked": forked}
        elif name == "run_chases":
            res, plies = LK.chase_descents_plain(*a)
            got, want = {"result": got}, {"result": res}
        else:
            want = plain_of[name](*a)
            if not isinstance(got, dict):
                got, want = {name: got}, {name: want}
        at = f"{size} {'lanes' if name.startswith('run_') else 'boards'} of {n}x{n}"
        cells, err = compare(torch, got, want, f"{name} at {at} ({tag})")
        ms = time_card(torch, kernel_of[name], a, iters=10)
        plain_ms = time_card(torch, plain_of[name], a, iters=1, warmup=0)
        if name.startswith("run_"):
            # the searched lanes' bytes and the plies these inputs need
            b_ms = bound(*lane_work(a, plies, len(got), a[7]))[0]
        else:
            # bytes of the inputs and outputs, OPS_PER_CELL a cell
            cells_in = (a[-1] if name in ("flood", "chain_labels") else a[0]).numel()
            b_ms = bound(tensor_bytes(torch, (a, got)), OPS_PER_CELL * cells_in)[0]
        k = spy.kept[(name, size, n)]
        shapes.setdefault(name, []).append(
            {"boards": size, "n": n, "launches": n_launch, "inputs_of_launch": k, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "max_abs_err": err})
        print(f"{name} at {at} ({tag}): {n_launch} launches, the inputs of launch {k} "
              f"({where(k, n_launch)}): {cells} outputs equal the plain version, kernel "
              f"{ms:.4f} ms, plain on card {plain_ms:.2f} ms, bound {b_ms:.3g} ms  "
              f"[{card}]")
    return shapes


# phase 14: the GTP mode on the shipped config, two 9x9 endgames, the
# benchmark mode
GTP_CONFIG = ROOT / "configs/gtp-p400.txt"
GTP_GENMOVES = 4
GTP_ANALYZE_S = 2.0          # the analyze stream runs this long before the next line
ENDGAME_N, ENDGAME_PLAYOUTS, ENDGAME_MOVES = 9, 8, 80
BENCH_QUERY = "bg:16:32"
# the plain functions that must not run on the card's GTP path
GTP_GUARDED = {"ops.analysis": ("board_analysis_plain", "step_and_analyze_plain",
                                "step_and_legal_plain", "ladder_prep_plain", "_step_plain"),
               "ops.ladder_kernel": ("run_greedy_plain", "run_chases_plain",
                                     "greedy_steps_plain", "chase_descents_plain"),
               "game.board": ("chain_labels_plain", "flood_plain"),
               "game.analysis": ("pass_alive_area", "safe_and_ownership")}


class PlainGuard:
    """While installed, the plain functions of GTP_GUARDED raise when any
    argument is a CUDA tensor: the card's path runs the kernels only."""

    def __enter__(self):
        import importlib

        self.real = []
        for mod_name, names in GTP_GUARDED.items():
            mod = importlib.import_module(f"sayuri_tpu_torch.{mod_name}")
            for name in names:
                fn = getattr(mod, name)
                self.real.append((mod, name, fn))

                def guarded(*args, _fn=fn, _name=name, **kw):
                    if any(getattr(a, "is_cuda", False) for a in args):
                        raise RuntimeError(f"{_name} ran on the card's GTP path")
                    return _fn(*args, **kw)
                setattr(mod, name, guarded)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.real:
            setattr(mod, name, fn)


def gtp_cli(torch, dev, args, script, stdin, out, tag, on_line=None):
    """``--mode gtp ARGS`` through the CLI, reading `stdin` and printing into
    `out`, with GtpLoop.execute wrapped to wait for the card after each
    command and time each genmove (`on_line(line)` first, if given). Every
    command of `script` must answer "=". Returns (the answers, [(command,
    seconds, playouts)] of the genmoves)."""
    import contextlib

    from sayuri_tpu_torch import __main__ as CLI
    from sayuri_tpu_torch.gtp import loop as GL

    timed = []
    real_execute = GL.GtpLoop.execute

    def execute(self, line):
        if on_line is not None:
            on_line(line)
        t0 = time.monotonic()
        ok, body = real_execute(self, line)
        torch.cuda.synchronize()
        if line.split()[:1] == ["genmove"]:
            timed.append((line, time.monotonic() - t0, self.agent.last_stats["playouts"]))
        return ok, body

    GL.GtpLoop.execute = execute
    saved, sys.stdin = sys.stdin, stdin
    try:
        with contextlib.redirect_stdout(out):
            CLI.main(["--mode", "gtp"] + args, device=dev)
        torch.cuda.synchronize()
    finally:
        sys.stdin = saved
        GL.GtpLoop.execute = real_execute
    answers = [line for line in out.getvalue().split("\n") if line[:1] in ("=", "?")]
    if len(answers) != len(script) or any(a[0] != "=" for a in answers):
        bad = [(c, a) for c, a in zip(script, answers) if a[0] != "="]
        raise RuntimeError(f"{tag}: {len(answers)} answers to {len(script)} commands, "
                           f"failures {bad[:4]}")
    return answers, timed


def run_gtp_phase(torch, dev, card, wfile, work, reset_counts, counts, need):
    """Phase 14. (a) `--mode gtp --config configs/gtp-p400.txt --weights
    F` through the CLI with stdin and stdout replaced: the admin commands,
    GTP_GENMOVES genmoves with tree reuse, play and undo, a kata-analyze
    stream of about GTP_ANALYZE_S seconds before the next line arrives,
    sayuri-raw_nn avg, final_score, final_status_list dead, printsgf; every
    answer "=", the SGF replayed legally on the CPU. (b) Two 9x9 games of
    genmoves: the area rule with --first-pass-bonus --friendly-pass
    --capture-all-dead --symm-pruning, and the territory rule, whose
    territory helper playout runs before final_score; final_score,
    final_status_list dead, gogui-seki and printsgf answer "=", the SGFs
    replay legally. (c) Every kernel held against its plain twin at each
    shape (a) and (b) gave it. (d) `--mode benchmark --benchmark-query
    BENCH_QUERY`. Returns (launches of (a) + (b), shapes, the median
    seconds of (a)'s genmoves)."""
    import contextlib
    import io
    import os
    import threading

    from sayuri_tpu_torch import __main__ as CLI
    from sayuri_tpu_torch.config import Options
    from sayuri_tpu_torch.ops import analysis as TA
    from sayuri_tpu_torch.ops import flood as FK
    from sayuri_tpu_torch.ops import ladder_kernel as LK

    kernels = ("step_and_analyze", "board_analysis", "ladder_prep", "flood", "chain_labels")
    spy = KernelSpy(TA, LK, FK, late=True)
    analyze_started = threading.Event()

    def on_line(line):
        if line.startswith("kata-analyze"):
            analyze_started.set()

    genmoves = [f"genmove {'bw'[i % 2]}" for i in range(GTP_GENMOVES)]
    script = (["name", "list_commands", "boardsize 19", "clear_board"] + genmoves
              + ["play b A1", "undo", "kata-analyze b 50", "sayuri-raw_nn avg", "final_score",
                 "final_status_list dead", "printsgf", "quit"])
    r, w = os.pipe()
    instream, feed = os.fdopen(r, "r"), os.fdopen(w, "w")

    out = io.StringIO()

    def writer():
        """Feed the script; after kata-analyze, hold the next line until
        the stream has run GTP_ANALYZE_S seconds and printed an info line
        (the interval emission every 0.5 s)."""
        for line in script:
            feed.write(line + "\n")
            feed.flush()
            if line.startswith("kata-analyze"):
                analyze_started.wait(timeout=900)
                t_start = time.monotonic()
                while "info move" not in out.getvalue() and time.monotonic() - t_start < 900:
                    time.sleep(0.05)
                time.sleep(max(0.0, GTP_ANALYZE_S - (time.monotonic() - t_start)))
        feed.close()

    spy.install()
    reset_counts()
    feeder = threading.Thread(target=writer, daemon=True)
    t0 = time.monotonic()
    try:
        feeder.start()
        with PlainGuard():
            # --threads: a flag the JAX package ignores, ignored here too
            answers, timed = gtp_cli(torch, dev, ["--config", str(GTP_CONFIG), "--weights",
                                                  str(wfile), "--threads", "4"], script,
                                     instream, out, "19x19 GTP", on_line)
    finally:
        feeder.join(timeout=60)
        instream.close()
    session_s = time.monotonic() - t0
    a_launches = counts()
    text = out.getvalue()
    infos = [line for line in text.split("\n") if line.startswith("info move")]
    if not infos:
        raise RuntimeError("19x19 GTP: the kata-analyze stream gave no info line:\n" + text[-3000:])
    first = infos[-1].split()
    visits, winrate = int(first[first.index("visits") + 1]), float(first[first.index("winrate") + 1])
    if visits <= 0 or not 0.0 <= winrate <= 1.0:
        raise RuntimeError(f"19x19 GTP: info line {infos[-1][:120]}")
    sgf_dir = work / "gtp-sgf"
    sgf_dir.mkdir()
    sgf = next(a for a in answers if a.startswith("= (;"))[2:]
    (sgf_dir / "game.sgf").write_text(sgf)
    n_games, n_moves = replay_sgfs(torch, sgf_dir, 19)
    if n_moves != GTP_GENMOVES:
        raise RuntimeError(f"19x19 GTP: the SGF holds {n_moves} moves")
    need(a_launches, "19x19 GTP", some=kernels + ("run_greedy",))
    secs = [t for _, t, _ in timed]
    playouts = [p for _, _, p in timed]
    moves = [a.split()[1] for a in answers[4:4 + GTP_GENMOVES]]
    print(f"19x19 gtp-p400 session ({session_s:.1f} s): every answer '=', {len(infos)} "
          f"info lines in {GTP_ANALYZE_S} s of kata-analyze (last: {visits} visits, winrate "
          f"{winrate}), SGF of {n_moves} moves replays legally on the CPU; moves {moves}")
    print(f"19x19 genmove seconds {[round(t, 3) for t in secs]}, playouts {playouts}; "
          f"median {sorted(secs)[len(secs) // 2]:.3f} s a genmove, B=1 "
          f"{sum(playouts) / sum(secs):.1f} playouts/s (b6c96 bf16, 400 playouts, tree "
          f"reuse)  [{card}]")
    print(f"19x19 GTP launches: { {k: v for k, v in a_launches.items() if v} }")

    def endgame(tag, extra, territory):
        opts = Options().parse_args(["--boardsize", str(ENDGAME_N), "--komi", "7",
                                     "--playouts", str(ENDGAME_PLAYOUTS),
                                     "--weights", str(wfile)] + extra)
        opts.check_gtp_flags()
        loop = CLI.build_gtp_loop(opts, device=dev)

        def ex(line):
            ok, body = loop.execute(line)
            if not ok:
                raise RuntimeError(f"9x9 {tag}: {line}: ? {body}")
            return body

        before = counts()
        ex("clear_board")
        if territory:
            ex("rules japanese")
        passes, sims, played = 0, 0, []
        for i in range(ENDGAME_MOVES):
            mv = ex(f"genmove {'bw'[i % 2]}")
            sims += loop.agent.last_stats["playouts"]
            played.append(mv)
            if mv == "resign":
                break
            passes = passes + 1 if mv == "pass" else 0
            if passes == 2:
                break
        if territory:
            loop.agent.update_territory_helper()
        score = ex("final_score")
        dead = ex("final_status_list dead")
        seki = ex("gogui-seki").split()
        gdir = work / f"gtp-{tag}"
        gdir.mkdir()
        (gdir / "game.sgf").write_text(ex("printsgf"))
        replay_sgfs(torch, gdir, ENDGAME_N)
        after = counts()
        used = {k: after[k] - before[k] for k in after}
        print(f"9x9 {tag}: {len(played)} genmoves (last {played[-3:]}), {sims} simulations, "
              f"final_score {score}, {len(dead.split())} dead stones, {seki.count('1')} seki "
              f"points; the moves replay legally on the CPU; chain_labels launches a "
              f"simulation {used['chain_labels'] / max(sims, 1):.2f}, flood "
              f"{used['flood'] / max(sims, 1):.2f}, step_and_analyze "
              f"{used['step_and_analyze'] / max(sims, 1):.2f}")
        return used

    try:
        with PlainGuard():
            endgame("area, --first-pass-bonus --friendly-pass --capture-all-dead "
                    "--symm-pruning", ["--first-pass-bonus", "--friendly-pass",
                                       "--capture-all-dead", "--symm-pruning"], False)
            endgame("territory", [], True)
        torch.cuda.synchronize()
    finally:
        spy.remove()
    launches = counts()
    need(launches, "GTP", some=kernels)
    seen = {}
    for (name, *_), c in spy.counts.items():
        seen[name] = seen.get(name, 0) + c
    if any(seen.get(k, 0) != v for k, v in launches.items()):
        raise RuntimeError(f"GTP: the spy saw {seen}, the counters {launches}")
    print(f"GTP launches (19x19 session and both 9x9 games): "
          f"{ {k: v for k, v in launches.items() if v} }")
    shapes = check_shapes(torch, card, spy, "GTP", lambda k, n: f"launch {k} of {n}")

    bench_out = io.StringIO()
    with contextlib.redirect_stdout(bench_out):
        rates = CLI.main(["--mode", "benchmark", "--benchmark-query", BENCH_QUERY], device=dev)
    line = bench_out.getvalue().strip()
    if not re.match(r"batch 16 x 32 playouts: [0-9.]+ p/s", line) or not rates[0] > 0:
        raise RuntimeError(f"benchmark mode printed {line!r}")
    print(f"benchmark mode: {line}  [{card}]")
    return launches, shapes, sorted(secs)[len(secs) // 2]


# phase 15: the trainer on phase 13's chunks, the train worker, bench
# train, the RL loop
TRAIN_TOL = 1e-4       # card step vs CPU step, f32 with TF32 off: sums in another order
TRAIN_SEED = 5
WORKER_STEPS = 32
RL_ARGS = ["--rounds", "2", "--boardsize", "7", "--games-per-round", "8",
           "--parallel-games", "8", "--playouts", "8", "--fast-playouts", "4",
           "--steps-per-round", "8", "--batch-size", "64"]


def train_step_parity(torch, dev, tdata, net_cfg, tag):
    """One SGD step at batch 256 (a batch of the chunks under `tdata` in the
    19x19 buffer) of `net_cfg` on the card and on the CPU from the same
    seeded weights, f32: loss parts within TRAIN_TOL relative, parameters and
    running statistics after the step within TRAIN_TOL absolute. Returns the
    batch's planes."""
    import math

    from sayuri_tpu_torch.train import dataset as DS
    from sayuri_tpu_torch.train.pipeline import TrainConfig, Trainer

    files, _ = DS.select_window_chunks(str(tdata))
    loader = DS.ChunkLoader(files, nn_size=19, batch_size=256, down_sample_rate=1,
                            policy_surprise_factor=0.0, shuffle_capacity=256, seed=0)
    try:
        planes, targets = next(iter(loader))
    finally:
        loader.close()
    # g++ is on the card's host: the batch must come from the native codec
    if not loader.codec or loader.python_parses or not loader.native_parses:
        raise RuntimeError(f"train step, {tag}: the loader parsed {loader.native_parses} "
                           f"samples natively and {loader.python_parses} in Python")
    boards = planes[..., 42].reshape(256, -1).sum(1)
    t0 = time.monotonic()
    trainers = {d: Trainer(net_cfg, TrainConfig(), seed=TRAIN_SEED, device=d)
                for d in ("cpu", dev)}
    parts = {d: t.train_batch(planes, targets) for d, t in trainers.items()}
    torch.cuda.synchronize()
    worst = {"loss parts (relative)": 0.0, "parameters": 0.0, "statistics": 0.0}
    for k, want in parts["cpu"].items():
        rel = abs(parts[dev][k] - want) / max(abs(want), 1e-6)
        worst["loss parts (relative)"] = max(worst["loss parts (relative)"], rel)
    for what, get in (("parameters", "unreplicated_params"),
                      ("statistics", "unreplicated_batch_stats")):
        want, got = getattr(trainers["cpu"], get)(), getattr(trainers[dev], get)()
        for k in want:
            worst[what] = max(worst[what], (got[k].cpu() - want[k]).abs().max().item())
    print(f"train step, {tag} SGD batch 256 (phase 13's chunks: {int(boards.min())}-"
          f"{int(boards.max())} on-board cells a position in the 19x19 buffer), card vs "
          f"CPU, f32 TF32 off: loss {parts[dev]['loss']:.6f} vs {parts['cpu']['loss']:.6f}; "
          f"max error {worst} (bound {TRAIN_TOL}); {time.monotonic() - t0:.1f} s")
    if not all(math.isfinite(v) for v in parts[dev].values()) or max(worst.values()) > TRAIN_TOL:
        raise RuntimeError(f"train step, {tag}: card and CPU disagree: {worst}")
    return planes


def run_train_phase(torch, dev, card, out_dir, work, reset_counts, counts, need):
    """Phase 15. (a) One b6c96 SGD step at batch 256 (a batch of phase 13's
    chunks in the 19x19 buffer) on the card and on the CPU from the same
    seeded weights: loss parts within TRAIN_TOL relative, parameters and
    running statistics after the step within TRAIN_TOL absolute. (b)
    ``python -m sayuri_tpu_torch.tools.train_worker`` on a setting.json of
    b6c96 at 19x19, batch 256, TrainDirectory = phase 13's tdata,
    ``--max-steps WORKER_STEPS``: WORKER_STEPS finite training.log lines; the checkpoint, v5 and
    SWA v5 files; the v5 file read back through load_checkpoint_for_inference
    gives the trainer's eval-mode heads within TRAIN_TOL on the card; a
    second invocation resumes at step WORKER_STEPS. (c) ``bench train`` on the same
    chunks: the step alone, the loader alone, and the steps fed by the
    loader at the default and at a short thread switch interval. (d) ``python -m
    sayuri_tpu_torch.tools.rl_loop`` with RL_ARGS on the card: round 2's
    actor loads round 1's gated .ckpt, the self-play kernels launch, the
    plain functions raise on a CUDA tensor meanwhile, and every kernel is
    held against its plain twin at the shapes the loop gave it. (e) The
    loader alone with the native codec and without, alternated, on phase
    13's chunks and on seeded 19x19 chunks. Returns (launches of (d),
    shapes of (d))."""
    import math
    import os

    from sayuri_tpu_torch import bench
    from sayuri_tpu_torch.models.network import NetConfig
    from sayuri_tpu_torch.models.weights_io import load_checkpoint_for_inference
    from sayuri_tpu_torch.ops import analysis as TA
    from sayuri_tpu_torch.ops import flood as FK
    from sayuri_tpu_torch.ops import ladder_kernel as LK
    from sayuri_tpu_torch.tools import rl_loop, train_worker
    from sayuri_tpu_torch.train import dataset as DS

    tdata = out_dir / "tdata"
    t_phase = time.monotonic()

    # (a) the card's step against the CPU's
    files, n_all = DS.select_window_chunks(str(tdata))
    planes = train_step_parity(torch, dev, tdata, NetConfig(), "b6c96")

    # (b) the train worker
    tw = work / "train-worker"
    tw.mkdir()
    setting = {
        "NeuralNetwork": {"MaxBoardSize": 19, "ResidualChannels": 96,
                          "PolicyHeadChannels": 32, "ValueHeadChannels": 32,
                          "Stack": list(NetConfig().stack), "SeRatio": 4},
        "Train": {"BatchSize": 256, "LearningRateSchedule": [[0, 0.005]], "SwaSteps": 16,
                  "VerboseSteps": 16, "ValidationSteps": 4, "TrainDirectory": str(tdata),
                  "ValidationDirectory": str(out_dir / "vdata"), "StorePath": "store"},
    }
    (tw / "setting.json").write_text(json.dumps(setting))
    argv = ["-j", str(tw / "setting.json"), "-w", str(tw)]
    t0 = time.monotonic()
    trainer = train_worker.main(argv + ["--max-steps", str(WORKER_STEPS)])
    torch.cuda.synchronize()
    worker_s = time.monotonic() - t0
    store = tw / "store"
    lines = (store / "training.log").read_text().splitlines()
    values = [float(kv.split("=")[1]) for ln in lines for kv in ln.split()[1:]]
    if len(lines) != WORKER_STEPS or not all(math.isfinite(v) for v in values):
        raise RuntimeError(f"training.log: {len(lines)} lines, finite {all(map(math.isfinite, values))}")
    name = trainer.checkpoint_name(num_chunks=n_all, window=len(files))
    stored = [store / f"checkpoint/{name}.ckpt", store / f"weights/{name}.bin.txt",
              store / f"swa/{name}-swa.bin.txt"]
    missing = [str(f) for f in stored if not f.is_file()]
    if missing or trainer.steps != WORKER_STEPS:
        raise RuntimeError(f"train worker: steps {trainer.steps}, missing {missing}")
    _, net = load_checkpoint_for_inference(str(stored[1]), boardsize=19)
    net = net.to(dev)
    trainer.net.eval()
    x = torch.as_tensor(planes[:64], device=dev)
    with torch.no_grad():
        want, got = trainer.net(x), net(x)
    v5_err = max((got[k] - want[k]).abs().max().item() for k in want)
    if v5_err > TRAIN_TOL:
        raise RuntimeError(f"v5 file of the trained net: heads differ by {v5_err}")
    resumed = train_worker.main(argv + ["--max-steps", "1"])
    last = (store / "training.log").read_text().splitlines()[-1]
    if resumed.steps != WORKER_STEPS + 1 or not last.startswith(f"step={WORKER_STEPS + 1} "):
        raise RuntimeError(f"second worker run: steps {resumed.steps}, last line {last[:40]}")
    vlog = (store / "validation.log").read_text().splitlines() \
        if (store / "validation.log").exists() else []
    print(f"train worker: {WORKER_STEPS} steps of b6c96 batch 256 in {worker_s:.1f} s "
          f"({WORKER_STEPS * 256 / worker_s:.1f} samples/s with start-up and storing) "
          f"[{card}]; loss {lines[0].split()[1]} -> {lines[-1].split()[1]}; stored "
          f"{', '.join(f.name for f in stored)}; v5 heads within {v5_err:.3g} of the "
          f"trainer's; {len(vlog)} validation lines; a second run resumed at step "
          f"{WORKER_STEPS} and wrote step {resumed.steps}")
    del trainer, resumed, net

    # (c) bench train
    res = bench.bench_train(chunks=tdata, device=dev)
    print(f"{bench.TRAIN_METRIC}: step alone {res['step_ms']:.3f} ms a step, "
          f"{res['step_samples_per_s']:.1f} samples/s (b6c96 19x19 batch 256 SGD f32 TF32 "
          f"off, {res['steps']} steps after 5)  [{card}]")
    print(f"train through the loader ({res['chunks']} chunks of {res['chunk_boards']} boards "
          f"in the 19x19 buffer): loader alone {res['loader_alone_samples_per_s']:.1f} "
          f"samples/s; "
          + "; ".join(f"{label}: {res[k + '_samples_per_s']:.1f} samples/s, "
                      f"{res[k + '_step_ms']:.3f} ms a step of which "
                      f"{res[k + '_train_ms']:.3f} in train_batch, waiting on the loader "
                      f"{100 * res[k + '_wait_share']:.1f}% of the wall time"
                      for label, k in (("fed, 5 ms switch interval", "loader"),
                                       ("fed, 0.5 ms", "loader_fast_switch")))
          + f"  [{card}]")
    print(f"train step alone under the profiler: card busy {res['device_busy_ms']:.3f} ms a "
          f"step, idle share {res['device_idle_share']:.4f}, {res['launches_a_step']:.0f} "
          f"launches a step; top kernels (ms a step) "
          f"{[(n[:60], round(t, 3)) for n, t in res['top_kernels_ms']]}  [{card}]")

    # (e) the loader alone with the native codec and without it, alternated,
    # on phase 13's chunks and on seeded 19x19 chunks of the port's writer
    seeded19 = write_seeded_chunks(work / "seeded19", 19)
    for label, chunks in (("phase 13's chunks", tdata), ("seeded 19x19 chunks", seeded19)):
        runs = {True: [], False: []}
        for codec in (True, False, False, True):
            r = bench.bench_loader(chunks, codec=codec, batches=CODEC_BATCHES)
            parses = (r["native_parses"], r["python_parses"])
            if r["codec"] != codec or min(parses) or not max(parses):
                raise RuntimeError(f"loader, codec {codec}: {parses} samples parsed "
                                   f"natively / in Python")
            runs[codec].append(r["samples_per_s"])
        on, off = (sum(runs[c]) / 2 for c in (True, False))
        print(f"loader alone on {label} ({r['chunks']} chunks of {r['boards']} boards, "
              f"{CODEC_BATCHES} batches of 256 a run; runs on, off, off, on): codec on "
              f"{[round(x, 1) for x in runs[True]]}, off {[round(x, 1) for x in runs[False]]} "
              f"samples/s; mean {on:.1f} vs {off:.1f}, x{on / off:.3f}  [{card}]")

    # (d) the RL loop
    spy = KernelSpy(TA, LK, FK, late=True)
    spy.install()
    reset_counts()
    t0 = time.monotonic()
    try:
        with PlainGuard():
            rounds = rl_loop.main(["--workdir", str(work / "rl")] + RL_ARGS)
        torch.cuda.synchronize()
    finally:
        spy.remove()
    rl_s = time.monotonic() - t0
    launches = counts()
    gated = str(work / "rl" / "weights" / os.path.basename(rounds[0]["checkpoint"]))
    if rounds[0]["actor_weights"] is not None or rounds[1]["actor_weights"] != gated:
        raise RuntimeError(f"RL loop: actors loaded {[r['actor_weights'] for r in rounds]}, "
                           f"round 1 gated {gated}")
    need(launches, "RL loop", some=("step_and_analyze", "board_analysis", "ladder_prep",
                                    "run_greedy", "run_chases", "flood", "chain_labels"))
    for r in rounds:
        print(f"RL loop round: {r['games']} games, {r['steps']} steps, loss {r['loss']:.4f}, "
              f"self-play {r['selfplay_s']:.1f} s, training {r['train_s']:.1f} s, actor "
              f"{os.path.basename(r['actor_weights'] or 'weightless')}  [{card}]")
    print(f"RL loop: 2 rounds in {rl_s:.1f} s; round 2's actor loaded round 1's "
          f"{os.path.basename(gated)}; launches {({k: v for k, v in launches.items() if v})}")
    shapes = check_shapes(torch, card, spy, "RL loop", lambda k, n: f"launch {k} of {n}")
    print(f"train phase: {time.monotonic() - t_phase:.1f} s")
    return launches, shapes


# phase 15(e): the loader alone, codec on and off
CODEC_BATCHES = 4
CODEC_FILES, CODEC_POSITIONS = 8, 256


def write_seeded_chunks(out, n, seed=3):
    """CODEC_FILES gzip chunks of CODEC_POSITIONS positions of n x n boards
    from seeded arrays, through the port's native writer
    (``native.serialize_positions``): a parse costs in proportion to the
    text, not to how real the game is. Returns `out`."""
    import gzip

    import numpy as np

    from sayuri_tpu_torch import native

    rng = np.random.RandomState(seed)
    hw, m = n * n, CODEC_POSITIONS
    out.mkdir(parents=True)
    for f in range(CODEC_FILES):
        sc = np.zeros((m, native.NUM_SCALARS), np.float32)
        sc[:, 0], sc[:, 1] = n, 7.5
        sc[:, 2], sc[:, 4] = rng.randint(0, 2, m), rng.randint(0, 2, m)
        sc[:, 5] = rng.randint(-1, 2, m)
        sc[:, 6:10] = rng.uniform(-1, 1, (m, 4))
        sc[:, 10:15] = rng.uniform(-60, 60, (m, 5))
        sc[:, 15:18] = rng.rand(m, 3)
        text = native.serialize_positions(
            n, (rng.rand(m, native.NUM_BINARY_PLANES, hw) < 0.3).astype(np.float32),
            rng.dirichlet(np.ones(hw + 1), m).astype(np.float32),
            rng.dirichlet(np.ones(hw + 1), m).astype(np.float32),
            rng.randint(-1, 2, (m, hw)).astype(np.float32), sc)
        if text is None:
            raise RuntimeError("the native chunk codec did not build")
        with gzip.open(out / f"seeded{n}_{f:03d}.txt.gz", "wt", compresslevel=1) as fh:
            fh.write(text)
    return out


# phase 16: the block families, through the b6c96-mix net
MIX_GTP_PLAYOUTS = 50
MIX = "b6c96-mix"
MIX_SEED = 13
MIX_BOARDS = (19, 13, 9)       # board sizes of 16(a)'s batch in the 19x19 buffer
MIX_BATCH = 48


def check_heads(got, want, tag):
    """Every head of `got` within EVAL_ATOL of `want`'s."""
    err = {k: (got[k].detach().double().cpu() - w.detach().double().cpu()).abs().max().item()
           for k, w in want.items()}
    print(f"{tag}: max abs err by head { {k: float(f'{e:.3g}') for k, e in err.items()} } "
          f"(limit {EVAL_ATOL})")
    bad = {k: e for k, e in err.items() if not e <= EVAL_ATOL}
    if bad:
        raise RuntimeError(f"{tag}: heads differ {bad}")


def run_blocks_phase(torch, np, dev, card, tdata, work, reset_counts, counts,
                     check_launches, check_roots):
    """Phase 16. (a) The b6c96-mix net (bench.NETS: every block family and
    the RepLK head at the b6c96 width) from seeded weights, f32 with TF32
    off, on the card and on the CPU over random planes of 19x19, 13x13 and
    9x9 boards in the 19x19 buffer: every head within EVAL_ATOL. (b)
    bench_playouts on b6c96-mix at B=256 x 96 playouts (bf16, root ladder
    planes), then the same bench on b6c96: launch
    counters read around each mix run (step_and_analyze once a simulation,
    the ladder kernels once a search), root visits = playouts + 1, legal
    best moves; both rates and their ratio. (c) The port's exporter writes
    the net as a v5 file, load_checkpoint_for_inference reads it back: heads
    within EVAL_ATOL of the source net on the card; the GTP CLI with
    configs/gtp-p400.txt at MIX_GTP_PLAYOUTS playouts on that file plays one
    19x19 genmove. (d) One SGD step of b6c96-mix at batch 256 on phase
    13's chunks, card vs CPU (train_step_parity), then ``bench train --net
    b6c96-mix``, the step alone. (e) ``bench profile --net b6c96-mix``: the depthwise conv
    blocks' device ms and their share of a search."""
    import io

    from sayuri_tpu_torch import bench
    from sayuri_tpu_torch.models.network import SayuriNet
    from sayuri_tpu_torch.models.weights_io import (export_reference_weights,
                                                    load_checkpoint_for_inference)

    t_phase = time.monotonic()
    cfg = bench.net_config(MIX)
    net_cpu = SayuriNet(cfg).init_random(MIX_SEED).eval()
    print(f"{MIX}: stack {list(cfg.stack)}, {cfg.policy_head_type} policy head (kernel "
          f"{cfg.policy_head_kernel}), {sum(p.numel() for p in net_cpu.parameters())} "
          f"parameters")

    # (a) the net on the card against the CPU, f32
    rng = np.random.RandomState(MIX_SEED)
    n = 19
    planes = (rng.rand(MIX_BATCH, n, n, 43) > 0.6).astype(np.float32)
    planes[..., 37:42] = rng.normal(size=(MIX_BATCH, 1, 1, 5))
    mask = np.zeros((MIX_BATCH, n, n), np.float32)
    for i in range(MIX_BATCH):
        size = MIX_BOARDS[i % len(MIX_BOARDS)]
        mask[i, :size, :size] = 1.0
    planes *= mask[..., None]
    planes[..., 42] = mask
    x = torch.from_numpy(planes)
    net = SayuriNet(cfg).init_random(MIX_SEED).to(dev).eval()
    with torch.no_grad():
        want = net_cpu(x)
        got = net(x.to(dev))
    torch.cuda.synchronize()
    check_heads(got, want, f"{MIX} f32 card vs CPU ({MIX_BATCH} boards of {MIX_BOARDS} in the "
                           f"19x19 buffer)")

    # (b) the search, then b6c96's
    rates = {MIX: [], "b6c96": []}
    for which in (MIX, "b6c96"):
        reset_counts()
        res = bench.bench_playouts(SLICE_BATCH, SLICE_PLAYOUTS, device=dev, net=which)
        torch.cuda.synchronize()
        if which == MIX:
            check_launches(counts(), res, MIX)
            check_roots(res, MIX)
        rates[which].append(res["rate"])
        print(f"{bench.METRIC.replace('b6c96', which)} = {res['rate']:.1f} playouts/s "
              f"(B={SLICE_BATCH} x {SLICE_PLAYOUTS}, bf16, {res['searches'] - 1} timed "
              f"searches in {res['seconds']:.3f} s)  [{card}]")
    mean = {k: sum(v) / len(v) for k, v in rates.items()}
    print(f"playouts/s {MIX} / b6c96 in this call: {mean[MIX]:.1f} / "
          f"{mean['b6c96']:.1f} = {mean[MIX] / mean['b6c96']:.4f}  [{card}]")

    # (c) the v5 file, and the GTP CLI on it
    wfile = work / f"{MIX}-seed{MIX_SEED}.bin.txt"
    export_reference_weights(net_cpu, str(wfile))
    back_cfg, back = load_checkpoint_for_inference(str(wfile), boardsize=19)
    if (tuple(back_cfg.stack), back_cfg.policy_head_type) != (tuple(cfg.stack), "RepLK"):
        raise RuntimeError(f"v5 file read back as {back_cfg}")
    with torch.no_grad():
        again = back.to(dev)(x.to(dev))
    check_heads(again, got, f"{MIX} v5 file read back, on the card")
    script = ["boardsize 19", "clear_board", "genmove b", "quit"]
    t0 = time.monotonic()
    # the config's 400 playouts took 53-56 s here: MIX_GTP_PLAYOUTS
    answers, timed = gtp_cli(torch, dev, ["--config", str(GTP_CONFIG), "--weights", str(wfile),
                                          "--playouts", str(MIX_GTP_PLAYOUTS)],
                             script, io.StringIO("".join(f"{c}\n" for c in script)),
                             io.StringIO(), f"{MIX} GTP")
    (_, secs, playouts), = timed
    print(f"{MIX} GTP (gtp-p400 at {MIX_GTP_PLAYOUTS} playouts, the v5 file): genmove b -> "
          f"{answers[2]!r} in {secs:.3f} s, "
          f"{playouts} playouts, {playouts / secs:.1f} B=1 playouts/s; the session "
          f"{time.monotonic() - t0:.1f} s  [{card}]")

    # (d) training
    train_step_parity(torch, dev, tdata, cfg, MIX)
    res = bench.bench_train(device=dev, net=MIX)
    print(f"{bench.TRAIN_METRIC.replace('b6c96', MIX)}: step alone {res['step_ms']:.3f} ms a "
          f"step, {res['step_samples_per_s']:.1f} samples/s (19x19 batch 256 SGD f32 TF32 off, "
          f"{res['steps']} steps after 5); card busy {res['device_busy_ms']:.3f} ms a step, "
          f"idle share {res['device_idle_share']:.4f}, {res['launches_a_step']:.0f} launches a "
          f"step; top kernels (ms a step) "
          f"{[(k[:60], round(t, 3)) for k, t in res['top_kernels_ms']]}  [{card}]")

    # (e) the profile of one search
    prof = bench.profile_playouts(SLICE_BATCH, SLICE_PLAYOUTS, device=dev, net=MIX)
    print(f"{MIX} search profile: {prof['wall_ms']:.1f} ms a search unprofiled, card busy "
          f"{prof['device_busy_ms']:.1f} ms, idle share {prof['device_idle_share']:.4f}, "
          f"{prof['kernel_launches']} launches; depthwise conv blocks' convolutions "
          f"{prof['depthwise_device_ms']:.3f} ms ({100 * prof['depthwise_busy_share']:.2f}% of "
          f"the busy time, {100 * prof['depthwise_wall_share']:.2f}% of the wall) by kernel "
          f"(name, ms, launches) {[(k[:70], round(t, 3), c) for k, t, c in prof['depthwise_kernels_ms']]}"
          f"  [{card}]")
    print(f"{MIX} search profile, stages (device ms, launches): "
          f"{ {k: (round(t, 3), c) for k, (t, c) in prof['stage_device_ms_launches'].items()} }; "
          f"recorder's host ms of the unprofiled search "
          f"{ {k: round(t, 3) for k, t in prof['stage_host_ms'].items()} }, "
          f"{prof['descent_syncs_per_sim']:.2f} descent syncs a simulation; "
          f"top kernels {[(k[:60], round(t, 3), c) for k, t, c in prof['top_kernels_ms'][:8]]}")
    if not prof["depthwise_kernels_ms"]:
        raise RuntimeError(f"{MIX} profile: no kernel ran in a depthwise conv range")
    print(f"blocks phase: {time.monotonic() - t_phase:.1f} s")


# phase 17: the process group (world size 1, NCCL) in a child process
GROUP_STEPS = 10          # timed steps a block (blocks: none, group, group, none)
GROUP_PROFILED_STEPS = 3
GROUP_MICRO_CALLS = 620   # the group step's 62 all-reduces, ten times
GROUP_GAMES = 8
GROUP_PLAYOUTS, GROUP_FAST_PLAYOUTS = 2, 1   # (c): phase 13's config, fewer playouts
GROUP_KERNELS = ("step_and_analyze", "board_analysis", "ladder_prep", "run_greedy",
                 "run_chases", "flood", "chain_labels")


# phase 19: the two benchmark cells' nets (bench.NETS), batches and trunk
# channels
EPI_SHAPES = (("b15c192", 256, 192), ("b6c96-h24", 1024, 96))
EPI_SEARCH_PLAYOUTS = 96


def epilogue_inputs(torch, dev, b, c, seed):
    """A conv output (bf16 NHWC), its block's input, the board mask
    (19x19 boards, a 9x9 one in every seventh lane) and the planes it sits
    in, SE gates (bf16) and a MaskedBatchNorm with drawn statistics, for
    the epilogue at batch `b` and `c` channels."""
    from sayuri_tpu_torch.models.network import MaskedBatchNorm

    g = torch.Generator(device=dev).manual_seed(seed)
    m = torch.ones(b, 19, 19, device=dev)
    m[::7] = 0.0
    m[::7, :9, :9] = 1.0
    planes = torch.zeros(b, 19, 19, 43, device=dev)
    planes[..., 42] = m
    bn = MaskedBatchNorm(c, True).to(dev).eval()
    with torch.no_grad():
        bn.mean.normal_(0.0, 0.1, generator=g)
        bn.var.uniform_(0.5, 2.0, generator=g)
        bn.beta.normal_(0.0, 0.1, generator=g)
        bn.gamma.uniform_(0.5, 1.5, generator=g)
    return {
        "x": torch.randn(b, 19, 19, c, device=dev, generator=g).to(torch.bfloat16),
        "skip": torch.randn(b, 19, 19, c, device=dev, generator=g) * m[..., None],
        "m": m,
        "mask": planes.permute(0, 3, 1, 2)[:, 42:],
        "se": torch.randn(b, 2 * c, device=dev, generator=g).to(torch.bfloat16),
        "bn": bn,
    }


def epilogue_forms(torch, EP, N, t):
    """name -> (kernel call, plain twin call, today's ATen chain): a
    block tail without SE (bf16 conv output, folded batch norm, skip, mish;
    float32 and bf16 out), a block's first conv (bf16 out only) and the SE
    pass (the float32 batch-norm output, bf16 gates, skip, mish). Each call
    returns (float32 or None, bf16)."""
    act = N.act_fn("mish")
    bn, mask = t["bn"], t["mask"]
    scale, bias = bn.folded()
    nchw = lambda u: u.permute(0, 3, 1, 2)
    y32 = EP.epilogue_plain(t["x"], t["m"], scale, bias)[0]
    kw = {
        "tail": (t["x"], dict(scale=scale, bias=bias, skip=t["skip"], act="mish",
                              out_lo=torch.bfloat16)),
        "conv": (t["x"], dict(scale=scale, bias=bias, act="mish", out_f32=False,
                              out_lo=torch.bfloat16)),
        "se": (y32, dict(se=t["se"], skip=t["skip"], act="mish", out_lo=torch.bfloat16)),
    }

    def chain(name):
        def run():
            if name == "se":
                gm, bt = t["se"].chunk(2, dim=1)
                out = torch.sigmoid(gm)[:, :, None, None] * nchw(y32) + bt[:, :, None, None]
                out = act(out * mask + nchw(t["skip"]))
            else:
                out = bn(nchw(t["x"]) * mask, mask)
                out = act(out + nchw(t["skip"])) if name == "tail" else act(out)
            return (None if name == "conv" else out), out.to(torch.bfloat16)
        return run

    return {name: ((lambda x=x, k=k: EP.epilogue(x, t["m"], **k)),
                   (lambda x=x, k=k: EP.epilogue_plain(x, t["m"], **k)),
                   chain(name))
            for name, (x, k) in kw.items()}


def max_diff(torch, got, want):
    """(max abs difference, share of equal elements) over the pairs of
    outputs that are not None."""
    err, same, total = 0.0, 0, 0
    for a, b in zip(got, want):
        if a is None or b is None:
            continue
        if a.shape != b.shape:     # today's chain is NCHW
            b = b.permute(0, 2, 3, 1)
        d = (a.float() - b.float()).abs()
        err = max(err, d.max().item())
        same += int((d == 0).sum())
        total += d.numel()
    return err, same / max(total, 1)


def run_epilogue_phase(torch, dev):
    """Phase 19: the eval epilogue kernel (csrc/epilogue.cu) on the card.
    (a) Built, its ptxas resources printed. (b) At both cells' shapes
    (b15c192 B=256 x 192 channels, b6c96 B=1024 x 96): every activation,
    bf16 and float32 input, with SE gates and the skip, against the plain
    twin on the card; then three forms (a block tail, a first conv, the
    SE pass) against the twin and against today's ATen chain (the modules'
    eval formulas, NCHW, the cast to bf16 the next conv's autocast did),
    each timed (kernel, twin, chain as library_ms) beside its byte bound.
    (c) Each cell's net (random weights, drawn statistics), bf16 autocast:
    the eval forward through the kernel against the modules' forward, the
    heads' widest gaps; the card's kernels a forward (profiler) and each forward
    timed. (d) One b15c192 search of 256 empty roots x 96 playouts after a
    warm-up one: the kernel's launches and the recorder's counters of the
    search. Returns the kernels line's row."""
    from torch.profiler import ProfilerActivity, profile

    from sayuri_tpu_torch import bench, telemetry
    from sayuri_tpu_torch.models import network as N
    from sayuri_tpu_torch.ops import build
    from sayuri_tpu_torch.ops import epilogue as EP

    EP._lib()
    print(f"epilogue.cu built in {build.BUILD_SECONDS['epilogue']:.2f} s")
    for line in (build.BUILD_DIR / "libepilogue.ptxas.txt").read_text().splitlines():
        if "Used" in line or "spill" in line:
            print("    " + line.strip())
    by_shape, worst = [], 0.0
    row = None
    torch.set_grad_enabled(False)
    for cell, b, c in EPI_SHAPES:
        t = epilogue_inputs(torch, dev, b, c, seed=c)
        scale, bias = t["bn"].folded()
        exact = {}
        for act in EP.ACTS:
            for dtype in (torch.bfloat16, torch.float32):
                kw = dict(se=t["se"] if dtype == torch.bfloat16 else t["se"].float(),
                          skip=t["skip"], act=act, out_lo=torch.bfloat16)
                x = t["x"].to(dtype)
                got = EP.epilogue(x, t["m"], scale, bias, **kw)
                want = EP.epilogue_plain(x, t["m"], scale, bias, **kw)
                err, same = max_diff(torch, got, want)
                worst = max(worst, err)
                exact[f"{act}/{str(dtype)[6:]}"] = round(same, 6)
                # float32 within a few ulps; bf16 within one rounding step
                for a, w, rtol in zip(got, want, (1e-6, 2.0 ** -7)):
                    torch.testing.assert_close(a, w, rtol=rtol, atol=1e-6,
                                               msg=f"epilogue {cell} {act} {dtype}")
        print(f"{cell}: kernel vs twin, 8 activations x bf16/f32 input: widest gap "
              f"{worst:.3g}; share of equal elements {json.dumps(exact)}")
        for name, (kern, plain, chain) in epilogue_forms(torch, EP, N, t).items():
            out = kern()
            err_twin, same_twin = max_diff(torch, out, plain())
            err_lib, same_lib = max_diff(torch, out, chain())
            nbytes = tensor_bytes(torch, out) + t["m"].numel() * 4 + 2 * 4 * c + (
                t["x"].numel() * (4 if name == "se" else 2)
                + (0 if name == "conv" else t["skip"].numel() * 4)
                + (tensor_bytes(torch, t["se"]) if name == "se" else 0))
            bound_ms, bound_by = bound(nbytes, 0)
            ms = time_card(torch, kern, ())
            rec = {"cell": cell, "form": name, "batch": b, "channels": c, "ms": ms,
                   "plain_ms": time_card(torch, plain, ()),
                   "library_ms": time_card(torch, chain, ()), "bound_ms": bound_ms,
                   "bound_by": bound_by, "share_of_bound": bound_ms / ms,
                   "max_abs_err": err_twin, "equal_share": same_twin,
                   "library_max_abs_err": err_lib, "library_equal_share": same_lib}
            by_shape.append(rec)
            print(json.dumps(rec))
            if row is None:
                row = dict(rec)
        del t
    torch.set_grad_enabled(True)
    # (c) whole forwards
    forwards = {}
    for cell, b, _ in EPI_SHAPES:
        net = N.SayuriNet(bench.net_config(cell)).init_random(0).to(dev).eval()
        g = torch.Generator(device=dev).manual_seed(1)
        with torch.no_grad():
            for name, buf in net.named_buffers():
                (buf.uniform_(0.5, 2.0, generator=g) if name.endswith("var")
                 else buf.normal_(0.0, 0.1, generator=g))
        t = epilogue_inputs(torch, dev, b, 8, seed=2)
        planes = (torch.rand(b, 19, 19, 43, device=dev, generator=g) > 0.7).float()
        planes = planes * t["m"][..., None]
        planes[..., 42] = t["m"]
        del t

        def fwd(fn):
            with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
                return fn(planes)

        fused, ref = fwd(net), fwd(net.forward_modules)
        gaps = {"modules": {k: (fused[k] - ref[k]).abs().max().item() for k in fused}}
        counts = {}
        for name, fn in (("fused", net), ("modules", net.forward_modules)):
            fwd(fn)
            EP.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fwd(fn)
                torch.cuda.synchronize()
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            counts[name] = {"kernels": len(kernels), "epilogues": EP.LAUNCHES["epilogue"],
                            "ms": time_card(torch, lambda fn=fn: fwd(fn), (), iters=10)}
        forwards[cell] = {"batch": b, "gaps": gaps, "per_forward": counts}
        print(json.dumps({"forward": cell, **forwards[cell]}))
        del net
    # (d) one search
    EP.reset_launch_counts()
    res = bench.bench_playouts(SLICE_BATCH, EPI_SEARCH_PLAYOUTS, iters=1, net="b15c192")
    rec = telemetry.last(profiled=False)
    search = {"launches": EP.LAUNCHES["epilogue"] / res["searches"],
              "rate": res["rate"], "sims": rec.sims,
              **{k: rec.counter(k) for k in ("net_conv_blocks", "net_epilogues_fused",
                                             "net_weight_refolds")}}
    print(json.dumps({"search": "b15c192", **search}))
    if search["net_epilogues_fused"] != search["net_conv_blocks"] or search["net_weight_refolds"]:
        raise RuntimeError(f"epilogue: the search's conv blocks not all fused: {search}")
    row.update({"name": "epilogue", "route": "cuda", "source":
                "sayuri_tpu_torch/csrc/epilogue.cu", "replaces": None,
                "launches": search["launches"],
                "path": f"b15c192 search B={SLICE_BATCH} x {EPI_SEARCH_PLAYOUTS}",
                "max_abs_err": worst, "plain_device": "cuda", "by_shape": by_shape,
                "forwards": forwards, "search": search})
    return row


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def group_env(port):
    """The environment that names a world-size-1 group at localhost:port."""
    import os

    return dict(os.environ, SAYURI_COORDINATOR=f"localhost:{port}", SAYURI_NUM_PROCS="1",
                SAYURI_PROC_ID="0", PYTHONPATH=str(ROOT))


def group_child(result_path, tdata):
    """Phase 17's child, run as ``chip_smoke.py --group-child RESULT TDATA``
    in the environment of ``group_env``: it joins the group (NCCL on the
    card), wraps torch.distributed.all_reduce to record each call's elements
    and group size, and (a) runs the dry run (``parallel.dryrun``: a sharded
    train step and its invariants, eight moves of 9x9 self-play) with the
    kernel counters set to 0 before it and read after, every kernel it
    launched held against its plain twin at the shapes it gave them; (b)
    takes one b6c96 SGD step at batch 256 on a batch of phase 13's chunks
    with the group's Trainer and with a Trainer without one, from the same
    seeded weights (cuDNN deterministic, TF32 off): loss parts, parameters
    and statistics must be equal, bit for bit; then times both (blocks of
    GROUP_STEPS steps: none, group, group, none; the collectives' share is
    the extra wall time of the group step), traces a few steps of each on
    the host and the card (``trace_group_step``) and times the all-reduce
    alone on the idle card. Writes a JSON of what it read to RESULT."""
    import torch
    import torch.distributed as dist

    from sayuri_tpu_torch import bench
    from sayuri_tpu_torch.models.network import NetConfig
    from sayuri_tpu_torch.ops import analysis as TA
    from sayuri_tpu_torch.ops import flood as FK
    from sayuri_tpu_torch.ops import ladder_kernel as LK
    from sayuri_tpu_torch.parallel import distributed as DI
    from sayuri_tpu_torch.parallel import mesh as M
    from sayuri_tpu_torch.parallel.dryrun import dryrun_multichip
    from sayuri_tpu_torch.train import dataset as DS
    from sayuri_tpu_torch.train.pipeline import TrainConfig, Trainer

    card = bench.device_info()
    t0 = time.monotonic()
    if not DI.initialize_from_env(device="cuda"):
        raise RuntimeError("group child: the environment names no group")
    mesh = M.make_mesh(1)
    if dist.get_backend() != "nccl" or mesh.device.type != "cuda":
        raise RuntimeError(f"group child: backend {dist.get_backend()}, device {mesh.device}")
    res = {"join_s": time.monotonic() - t0, "backend": dist.get_backend(), "world": mesh.size}
    calls = []
    real = dist.all_reduce

    def all_reduce(tensor, *args, **kw):
        calls.append((tensor.numel(), dist.get_world_size(kw.get("group"))))
        return real(tensor, *args, **kw)

    dist.all_reduce = all_reduce

    # (a) the dry run
    spy = KernelSpy(TA, LK, FK, late=True)
    spy.install()
    for mod in (TA, LK, FK):
        mod.reset_launch_counts()
    t0 = time.monotonic()
    try:
        d = dryrun_multichip(mesh, calls)
        torch.cuda.synchronize()
    finally:
        spy.remove()
    res["dryrun_s"] = time.monotonic() - t0
    launches = {**TA.LAUNCHES, **LK.LAUNCHES, **FK.LAUNCHES}
    missing = [k for k in GROUP_KERNELS if not launches[k]]
    if missing:
        raise RuntimeError(f"group dry run: {missing} never launched ({launches})")
    res["dryrun"] = {k: d[k] for k in ("loss", "world", "local_batch", "n_params",
                                       "all_reduces", "all_reduced_elements")}
    res["launches"] = launches
    res["shapes"] = check_shapes(torch, card, spy, "group dry run",
                                 lambda k, n: f"launch {k} of {n}")

    # (b) the b6c96 step under the group and without it
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    files, _ = DS.select_window_chunks(tdata)
    loader = DS.ChunkLoader(files, nn_size=19, batch_size=256, down_sample_rate=1,
                            policy_surprise_factor=0.0, shuffle_capacity=256, seed=0)
    try:
        planes, targets = next(iter(loader))
    finally:
        loader.close()
    planes = torch.as_tensor(planes, device=mesh.device)
    targets = {k: torch.as_tensor(v, device=mesh.device) for k, v in targets.items()}
    trainers = {"none": Trainer(NetConfig(), TrainConfig(), seed=TRAIN_SEED, device=mesh.device),
                "group": Trainer(NetConfig(), TrainConfig(), seed=TRAIN_SEED, mesh=mesh)}
    parts = {}
    for k, tr in trainers.items():
        calls.clear()
        parts[k] = tr.train_batch(planes, targets)
        res[f"{k}_all_reduces"] = len(calls)
    torch.cuda.synchronize()
    a, b = trainers["none"], trainers["group"]
    diff = max([abs(parts["none"][k] - parts["group"][k]) for k in parts["none"]]
               + [(x - y).abs().max().item() for x, y in zip(a.params, b.params)]
               + [(x - y).abs().max().item() for x, y in zip(a.net.buffers(), b.net.buffers())])
    res["step_equal"] = diff == 0.0
    res["step_max_diff"] = diff
    res["loss"] = parts["group"]["loss"]
    ms = {"none": [], "group": []}
    for k in ("none", "group", "group", "none"):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(GROUP_STEPS):
            trainers[k].train_batch(planes, targets)
        torch.cuda.synchronize()
        ms[k].append(1e3 * (time.monotonic() - t0) / GROUP_STEPS)
    res["step_ms"] = ms
    res["trace"] = trace_group_step(torch, trainers, planes, targets)
    # the all-reduce alone: one call a BN's size on the idle card, host time
    x = torch.ones(97, device=mesh.device)
    for _ in range(10):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(GROUP_MICRO_CALLS):
        dist.all_reduce(x)
    host_ms = 1e3 * (time.monotonic() - t0)
    torch.cuda.synchronize()
    res["micro_ms_a_call"] = host_ms / GROUP_MICRO_CALLS
    res["micro_synced_ms_a_call"] = 1e3 * (time.monotonic() - t0) / GROUP_MICRO_CALLS
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) = flags
    DI.shutdown()
    Path(result_path).write_text(json.dumps(res))


# the host's CUDA calls that wait for the card or serialize its streams
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpy", "cudaMemcpyAsync", "cudaLaunchHostFunc", "cudaStreamWaitEvent",
              "cudaEventRecord", "cudaEventQuery")


def trace_group_step(torch, trainers, planes, targets):
    """Where the group step's extra time goes: GROUP_PROFILED_STEPS steps of
    each trainer under torch.profiler (host and card). For each: the wall
    and the card's busy time a step; the host's ops a step (calls, self ms)
    of the all-reduces, the CUDA calls of SYNC_CALLS and the ops whose host
    time grew most from the plain step to the group step."""
    from torch.profiler import ProfilerActivity, profile

    from sayuri_tpu_torch import bench

    out, ops = {}, {}
    n = GROUP_PROFILED_STEPS
    for k in ("none", "group"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(n):
                trainers[k].train_batch(planes, targets)
            torch.cuda.synchronize()
            wall = 1e3 * (time.monotonic() - t0) / n
        kernels, busy = bench._device_kernels(prof.events())
        ops[k] = {e.key: (e.count / n, e.self_cpu_time_total / 1e3 / n,
                          e.cpu_time_total / 1e3 / n) for e in prof.key_averages()}
        allreduce = {key: v for key, v in ops[k].items() if "allreduce" in key.lower()
                     or "all_reduce" in key.lower()}
        out[k] = {
            "wall_ms": wall, "busy_ms": busy / 1e3 / n,
            "nccl_kernels": sum(1 for e in kernels if "nccl" in e.name.lower()) / n,
            "nccl_ms": sum(e.time_range.elapsed_us() for e in kernels
                           if "nccl" in e.name.lower()) / 1e3 / n,
            "allreduce": {key: [round(c, 2), round(tot, 4)] for key, (c, _, tot)
                          in allreduce.items()},
            "sync_calls": {key: [round(ops[k][key][0], 2), round(ops[k][key][1], 4)]
                           for key in SYNC_CALLS if key in ops[k]},
        }
    keys = set(ops["none"]) | set(ops["group"])
    grew = sorted(keys, key=lambda key: ops["group"].get(key, (0, 0, 0))[1]
                  - ops["none"].get(key, (0, 0, 0))[1], reverse=True)
    out["grew"] = [[key, round(ops["none"].get(key, (0, 0, 0))[0], 2),
                    round(ops["group"].get(key, (0, 0, 0))[0], 2),
                    round(ops["none"].get(key, (0, 0, 0))[1], 4),
                    round(ops["group"].get(key, (0, 0, 0))[1], 4)] for key in grew[:10]]
    return out


def run_group_phase(torch, card, out_dir, work):
    """Phase 17: a world-size-1 NCCL group formed from SAYURI_COORDINATOR
    (localhost, a free port), SAYURI_NUM_PROCS=1 and SAYURI_PROC_ID=0, in
    child processes (the collectives run at world size 1: nothing skips
    them). (a)+(b): ``group_child``. (c) ``python -m sayuri_tpu_torch --mode
    selfplay`` under the group for one round of GROUP_GAMES games with
    phase 13's config and weights, at GROUP_PLAYOUTS / GROUP_FAST_PLAYOUTS
    playouts: the chunks carry no p0 suffix at world size 1 (as in the JAX
    package), and parse natively and in Python alike.
    Returns (launches of (a), shapes of (a))."""
    import gzip
    import subprocess

    import numpy as np

    from sayuri_tpu_torch.train import dataset as DS

    t_phase = time.monotonic()
    result = work / "group.json"
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--group-child",
                           str(result), str(out_dir / "tdata")],
                          env=group_env(free_port()), cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    print(proc.stdout, end="")
    if proc.returncode != 0 or not result.exists():
        raise RuntimeError(f"group child failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    res = json.loads(result.read_text())
    d = res["dryrun"]
    print(f"group: {res['backend']} world size {res['world']}, joined in {res['join_s']:.1f} s; "
          f"dry run in {res['dryrun_s']:.1f} s: loss {d['loss']:.4f}, {d['all_reduces']} "
          f"all-reduces in its train step over every rank, {d['all_reduced_elements']} elements "
          f">= {d['n_params']} parameters, {d['local_batch']} rows a rank; eight 9x9 moves; "
          f"launches { {k: v for k, v in res['launches'].items() if v} }")
    if not res["step_equal"]:
        raise RuntimeError(f"b6c96 step under the group differs from the step without it by "
                           f"{res['step_max_diff']}")
    none_ms, group_ms = (float(np.mean(res["step_ms"][k])) for k in ("none", "group"))
    print(f"b6c96 SGD step at batch 256 on phase 13's chunks, world-size-1 NCCL group vs no "
          f"group: loss parts, parameters and statistics equal bit for bit ({res['loss']:.6f}); "
          f"{res['group_all_reduces']} all-reduces a step (none without the group); ms a step "
          f"none {res['step_ms']['none']}, group {res['step_ms']['group']} (blocks of "
          f"{GROUP_STEPS}: none, group, group, none): {none_ms:.3f} vs {group_ms:.3f}, "
          f"x{group_ms / none_ms:.4f}: the collectives' share of the group step "
          f"{100 * (group_ms - none_ms) / group_ms:.2f}% of its wall time  [{card}]")
    tr = res["trace"]
    for k in ("none", "group"):
        t = tr[k]
        print(f"  traced, {k}: {t['wall_ms']:.3f} ms a step, card busy {t['busy_ms']:.3f} ms "
              f"(idle share {1 - t['busy_ms'] / t['wall_ms']:.4f}), NCCL kernels "
              f"{t['nccl_kernels']:.0f} ({t['nccl_ms']:.3f} ms); all-reduce ops a step "
              f"[calls, host ms with children] {t['allreduce']}; CUDA calls a step "
              f"[calls, host ms] {t['sync_calls']}")
    print(f"  host ops that grew most a step [op, calls none, calls group, self ms none, "
          f"self ms group]: {tr['grew']}")
    print(f"  dist.all_reduce alone, 97 floats on the idle card: {res['micro_ms_a_call']:.4f} "
          f"ms of host time a call, {res['micro_synced_ms_a_call']:.4f} ms with the card's "
          f"work ({GROUP_MICRO_CALLS} calls)  [{card}]")

    # (c) the self-play CLI under the group
    wdir, sp_out = work / "weights", work / "group-selfplay"
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "sayuri_tpu_torch", "--mode", "selfplay",
         "--config", str(ROOT / "configs/selfplay-gumbel-p150.txt"),
         "--playouts", str(GROUP_PLAYOUTS), "--fastsearch-playouts", str(GROUP_FAST_PLAYOUTS),
         "--parallel-games", str(GROUP_GAMES), "--num-games", str(GROUP_GAMES),
         "--weights-dir", str(wdir), "--target-directory", str(sp_out)],
        env=group_env(free_port()), cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.monotonic() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"selfplay under the group failed:\n{proc.stderr[-4000:]}")
    runs = [p.name for p in (sp_out / "tdata").iterdir()] + \
        [p.name for p in (sp_out / "vdata").iterdir()]
    chunks = sorted(sp_out.glob("[tv]data/*/*.txt.gz"))
    if not chunks or any("p0" in r for r in runs):
        raise RuntimeError(f"selfplay under the group: runs {runs}, {len(chunks)} chunks")
    n = 0
    for f in chunks:
        for s in DS.read_chunk(f):
            want = DS.Sample(s.lines).parse()
            got = s.parse_native()
            if got.board_size not in (7, 9) or any(
                    getattr(got, k).tobytes() != getattr(want, k).tobytes()
                    for k in ("planes", "prob", "aux_prob", "ownership")):
                raise RuntimeError(f"{f.name}: a position parses differently natively")
            n += 1
    with gzip.open(chunks[0], "rt") as fh:
        head = fh.read(8)
    print(f"selfplay CLI under the group: {GROUP_GAMES} games in {cli_s:.1f} s with start-up "
          f"({proc.stdout.strip().splitlines()[-1]}); run ids {sorted(set(runs))} (no p0 at "
          f"world size 1); {len(chunks)} chunks, {n} positions parse natively as in Python "
          f"(first lines {head.split()})  [{card}]")
    print(f"group phase: {time.monotonic() - t_phase:.1f} s")
    return res["launches"], res["shapes"]


# phase 18: the pattern gammas (genpatterns, the device gammas at 19x19,
# the GTP session with --patterns) and the A/B harness
GAMMAS_SGFS = 4               # phase 13's SGFs that genpatterns reads
GAMMAS_FACTOR = 0.5
GAMMAS_GENMOVES = 3           # with gammas, then one more at factor 0
GAMMAS_TOL = 1e-6             # the gammas policy, f32 card vs CPU
GAMMAS_PROFILE_PLAYOUTS = 16  # each profiled search of 18(c), gammas on and off
AB_GAMES, AB_BOARD, AB_PLAYOUTS = 8, 7, 8


GAMMAS_RANGE = "gammas.mix"


def profile_gammas(torch, fn):
    """fn() under torch.profiler with gammas_device.apply_to_evals in a
    GAMMAS_RANGE range: (CUDA kernels launched, the card's busy ms, the
    kernels that start inside the range, their device ms, {search stage
    (`mcts.*` range): kernels}); None when the profiler sees no device."""
    import bisect

    from torch.profiler import ProfilerActivity, profile, record_function

    from sayuri_tpu_torch import bench
    from sayuri_tpu_torch.pattern import gammas_device as GD

    apply = GD.apply_to_evals

    def ranged(*args, **kw):
        with record_function(GAMMAS_RANGE):
            return apply(*args, **kw)

    GD.apply_to_evals = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        GD.apply_to_evals = apply
    events = prof.events()
    kernels, busy_us = bench._device_kernels(events, skip=("mcts.", GAMMAS_RANGE))
    if not kernels:
        return None
    cuda = torch.autograd.DeviceType.CUDA

    def ranges(pick):
        rs = sorted((e for e in events if e.device_type == cuda and pick(e.name)),
                    key=lambda e: e.time_range.start)
        return rs, [r.time_range.start for r in rs]

    def holder(rs, starts, k):
        i = bisect.bisect_right(starts, k.time_range.start) - 1
        return rs[i] if i >= 0 and k.time_range.start < rs[i].time_range.end else None

    mix, stages = ranges(lambda name: name == GAMMAS_RANGE), ranges(
        lambda name: name.startswith("mcts."))
    inside, per_stage = [], {}
    for k in kernels:
        if holder(*mix, k) is not None:
            inside.append(k.time_range.elapsed_us())
        st = holder(*stages, k)
        name = st.name if st is not None else "outside"
        per_stage[name] = per_stage.get(name, 0) + 1
    return len(kernels), busy_us / 1e3, len(inside), sum(inside) / 1e3, per_stage


def run_gammas_phase(torch, np, dev, card, s19, ladders19, wfile, sgf_dir, work, reset_counts,
                     counts, need, gtp_genmove_s):
    """Phase 18. (a) ``genpatterns`` through the port's GTP loop on
    GAMMAS_SGFS of phase 13's SGFs: the gamma count and the seconds. (b) On
    phase 3's 256 midgame 19x19 positions: spatial keys and table lookups
    on the card equal the CPU's, the gammas policy (seeded ownership)
    within GAMMAS_TOL, and the gammas-mixed f32 root NetEvals of phase 13's
    b6c96 weights (random symmetry, the positions' root ladder planes)
    within EVAL_ATOL; the gammas policy timed at B=256 and B=1. (c) The
    gtp-p400 session through the CLI with --patterns FILE
    --gammas-policy-factor GAMMAS_FACTOR and phase 13's v5 file (bf16):
    GAMMAS_GENMOVES genmoves, both gogui gammas commands, the factor set to
    0, one more genmove; every answer "=", seconds a genmove beside phase
    14's; the kernels' launches a simulation with and without the gammas;
    a search of GAMMAS_PROFILE_PLAYOUTS playouts from a new tree each way,
    timed, then under torch.profiler: all CUDA kernels a simulation, the
    card's busy ms and the gammas mix's kernels and device ms (a range
    around gammas_device.apply_to_evals); every kernel held
    against its plain twin at each shape the session gave it. (d)
    ``tools.ab_match`` on the card: AB_GAMES 7x7 games at AB_PLAYOUTS
    playouts, weightless (the JAX tool's default), Gumbel, one draw a
    search against a draw a selection. Returns (launches of (c), shapes of
    (c))."""
    import contextlib
    import copy
    import io
    import shutil

    from sayuri_tpu_torch import __main__ as CLI
    from sayuri_tpu_torch.config import Options
    from sayuri_tpu_torch.game.state import GoEnv
    from sayuri_tpu_torch.gtp.loop import GtpLoop
    from sayuri_tpu_torch.models.evaluator import make_eval_fn
    from sayuri_tpu_torch.models.weights_io import load_checkpoint_for_inference
    from sayuri_tpu_torch.ops import analysis as TA
    from sayuri_tpu_torch.ops import flood as FK
    from sayuri_tpu_torch.ops import ladder_kernel as LK
    from sayuri_tpu_torch.pattern import gammas_device as GD
    from sayuri_tpu_torch.pattern.gammas import GammasDict
    from sayuri_tpu_torch.tools import ab_match

    t_phase = time.monotonic()

    # (a) genpatterns on the card
    pat_sgf = work / "pattern-sgf"
    pat_sgf.mkdir()
    for f in sorted(sgf_dir.glob("*.sgf"))[:GAMMAS_SGFS]:
        shutil.copy(f, pat_sgf / f.name)
    pfile = work / "patterns.json"
    t0 = time.monotonic()
    ok, body = GtpLoop(boardsize=19, device=dev).execute(f"genpatterns {pat_sgf} {pfile}")
    gen_s = time.monotonic() - t0
    gd = GammasDict.load(pfile)
    if not ok or body != f"{len(gd)} gammas" or len(gd) < 10:
        raise RuntimeError(f"genpatterns: {ok} {body!r}, {len(gd)} gammas in the file")
    n_spatial = sum(k[0].isdigit() for k in gd.table)
    print(f"genpatterns on {GAMMAS_SGFS} of phase 13's SGFs: '= {body}' ({n_spatial} spatial, "
          f"dist {gd.dist}) in {gen_s:.1f} s  [{card}]")

    # (b) the device gammas at 19x19, card vs CPU
    t_b = time.monotonic()
    n = 19
    # the analysis (legality, liberty map) from the kernel's plain twin, a
    # seeded ownership
    a_cpu = TA.board_analysis(s19.stones, s19.size, s19.ko, s19.to_move)
    legal, libs, last = a_cpu["legal"], a_cpu["libs"], s19.last_moves[:, 0]
    own = torch.from_numpy(np.random.RandomState(11).uniform(-1, 1, (s19.stones.shape[0], n * n))
                           .astype(np.float32))
    d19 = s19.to(dev)
    dev_cpu = GD.DeviceGammas.compile(gd, device="cpu")
    dev_card = GD.DeviceGammas.compile(gd, device=dev)
    keys = GD.spatial_keys_batch(s19.stones, s19.size, s19.to_move, gd.dist)
    keys_card = GD.spatial_keys_batch(d19.stones, d19.size, d19.to_move, gd.dist)
    compare(torch, {"keys": keys_card}, {"keys": keys}, "19x19 spatial keys")
    g_cpu, g_card = dev_cpu.lookup(keys), dev_card.lookup(keys_card)
    compare(torch, {"lookup": g_card}, {"lookup": g_cpu}, "19x19 table lookups")
    hits = int((g_cpu != 1.0).sum())
    args = (s19.stones, s19.size, s19.to_move, legal, last, libs, own)
    card_args = tuple(a.to(dev) for a in args)
    p_cpu = GD.gammas_policy_device(dev_cpu, *args[:-1], ownership=own)
    p_card = GD.gammas_policy_device(dev_card, *card_args[:-1], ownership=card_args[-1])
    p_err = float((p_card.cpu() - p_cpu).abs().max())
    if not p_err <= GAMMAS_TOL:
        raise RuntimeError(f"19x19 gammas policy: card vs CPU {p_err} > {GAMMAS_TOL}")
    ms = {b: time_card(torch, lambda *a: GD.gammas_policy_device(dev_card, *a[:-1],
                                                                 ownership=a[-1]),
                       tuple(a[:b] for a in card_args), iters=10) for b in (256, 1)}
    print(f"19x19 device gammas on phase 3's {keys.shape[0]} positions: keys and lookups "
          f"({hits} of {keys.numel()} cells found in the table) equal the CPU's; the gammas "
          f"policy within {p_err:.3g} (limit {GAMMAS_TOL}); gammas_policy_device "
          f"{ms[256]:.3f} ms at B=256, {ms[1]:.3f} ms at B=1  [{card}]")
    _, net_cpu = load_checkpoint_for_inference(str(wfile), boardsize=n)
    net_card = copy.deepcopy(net_cpu).to(dev)
    env19 = GoEnv(n=n)
    # the evaluators read the analysis from ctx (the CPU's from the plain
    # twin above, the card's from the kernel)
    a_card = TA.board_analysis(d19.stones, d19.size, d19.ko, d19.to_move)
    ctx = {"cpu": {"ladders": ladders19, "analysis": a_cpu},
           "cuda": {"ladders": ladders19.to(dev), "analysis": a_card}}
    evs = {}
    for where, net, st, gdev in (("cpu", net_cpu, s19, dev_cpu), ("cuda", net_card, d19,
                                                                  dev_card)):
        evs[where] = make_eval_fn(env19, net, symmetry="random", ladder_mode="root",
                                  gammas=(gdev, GAMMAS_FACTOR))(st, ctx[where])
    plain = make_eval_fn(env19, net_card, symmetry="random", ladder_mode="root")(
        d19, ctx["cuda"])
    torch.cuda.synchronize()
    ev_err = max(float((getattr(evs["cpu"], k) - getattr(evs["cuda"], k).cpu()).abs().max())
                 for k in evs["cpu"]._fields)
    moved = float((evs["cuda"].priors - plain.priors).abs().max())
    if not ev_err <= EVAL_ATOL or not moved > 0:
        raise RuntimeError(f"19x19 mixed root NetEvals: card vs CPU {ev_err} (limit "
                           f"{EVAL_ATOL}); the mix moved the priors by {moved}")
    print(f"19x19 gammas-mixed root NetEvals (b6c96 f32, factor {GAMMAS_FACTOR}): max abs err "
          f"card vs CPU {ev_err:.3g} (limit {EVAL_ATOL}); the mix moves a prior by up to "
          f"{moved:.4f}; (b) took {time.monotonic() - t_b:.1f} s")

    # (c) the GTP session with --patterns
    spy = KernelSpy(TA, LK, FK, late=True)
    genmoves = [f"genmove {'bw'[i % 2]}" for i in range(GAMMAS_GENMOVES)]
    script = (["boardsize 19", "clear_board"] + genmoves
              + ["gogui-gammas_heatmap", "gogui-gammas_rating",
                 "sayuri-setoption name gammas policy factor value 0",
                 f"genmove {'bw'[GAMMAS_GENMOVES % 2]}", "quit"])
    argv = ["--config", str(GTP_CONFIG), "--weights", str(wfile), "--patterns", str(pfile),
            "--gammas-policy-factor", str(GAMMAS_FACTOR)]
    marks = {}

    def on_line(line):
        if line.startswith("sayuri-setoption"):
            marks["with"] = counts()

    spy.install()
    reset_counts()
    t0 = time.monotonic()
    try:
        with PlainGuard():
            answers, timed = gtp_cli(torch, dev, argv, script,
                                     io.StringIO("".join(f"{c}\n" for c in script)),
                                     io.StringIO(), "gammas GTP", on_line)
    finally:
        spy.remove()
    session_s = time.monotonic() - t0
    launches = counts()
    need(launches, "gammas GTP", some=("step_and_analyze", "board_analysis", "ladder_prep",
                                       "flood", "chain_labels"))
    sims_with = sum(p for _, _, p in timed[:GAMMAS_GENMOVES])
    sims_without = timed[-1][2]
    without = {k: launches[k] - marks["with"][k] for k in launches}
    per_sim = {tag: {k: round(v / max(s, 1), 3) for k, v in c.items() if v}
               for tag, c, s in (("with", marks["with"], sims_with),
                                 ("without", without, sims_without))}
    secs = [round(t, 3) for _, t, _ in timed]
    print(f"19x19 gtp-p400 session with --patterns, factor {GAMMAS_FACTOR} ({session_s:.1f} s): "
          f"every answer '=', moves {[a.split()[1] for a in answers[2:2 + GAMMAS_GENMOVES]]}; "
          f"genmove seconds {secs[:-1]} with the gammas, {secs[-1]} at factor 0 (playouts "
          f"{[p for _, _, p in timed]}); phase 14's median without patterns "
          f"{gtp_genmove_s:.3f} s  [{card}]")
    print(f"kernel launches a simulation with the gammas {per_sim['with']}, at factor 0 "
          f"{per_sim['without']}")
    # all CUDA kernels a simulation, a search each way from the same position
    t_p = time.monotonic()
    opts = Options().parse_args(argv)
    opts.check_gtp_flags()
    agent = CLI.build_gtp_loop(opts, device=dev).agent
    agent.play(0, 3 * n + 3)
    agent.think(playouts=8)
    prof = {}
    for factor in (GAMMAS_FACTOR, 0.0):
        agent.gammas_policy_factor = factor
        agent.refresh_gammas()
        t0 = time.monotonic()
        agent.think(playouts=GAMMAS_PROFILE_PLAYOUTS)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        agent._drop_tree()
        prof[factor] = (wall, profile_gammas(
            torch, lambda: agent.think(playouts=GAMMAS_PROFILE_PLAYOUTS)))
    if prof[0.0][1] is None:
        print("CUDA kernels a simulation: not measured (the profiler saw no device)")
    else:
        p = GAMMAS_PROFILE_PLAYOUTS
        for factor, (wall, (k, busy, gk, gms, stages)) in prof.items():
            print(f"a {p}-playout search from a new tree at factor {factor} (b6c96 bf16): "
                  f"{1e3 * wall / p:.2f} ms a simulation unprofiled; under torch.profiler "
                  f"{k / p:.1f} CUDA kernels a simulation, card busy {busy / p:.3f} ms, idle "
                  f"share {1 - busy / 1e3 / wall:.4f}; the gammas mix {gk / p:.1f} kernels "
                  f"and {gms / p:.4f} device ms a simulation; kernels a simulation by stage "
                  f"{ {k_: round(v / p, 1) for k_, v in sorted(stages.items())} }  [{card}]")
        if not prof[GAMMAS_FACTOR][1][2] or prof[0.0][1][2]:
            raise RuntimeError(f"the gammas mix ran {prof[GAMMAS_FACTOR][1][2]} kernels at "
                               f"factor {GAMMAS_FACTOR}, {prof[0.0][1][2]} at 0")
    print(f"the profiled searches took {time.monotonic() - t_p:.1f} s")
    seen = {}
    for (name, *_), c in spy.counts.items():
        seen[name] = seen.get(name, 0) + c
    if any(seen.get(k, 0) != v for k, v in launches.items()):
        raise RuntimeError(f"gammas GTP: the spy saw {seen}, the counters {launches}")
    shapes = check_shapes(torch, card, spy, "gammas GTP", lambda k, c: f"launch {k} of {c}")

    # (d) the A/B harness on the card
    reset_counts()
    out = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        line = ab_match.main(["--games", str(AB_GAMES), "--boardsize", str(AB_BOARD),
                              "--playouts", str(AB_PLAYOUTS),
                              "--a", "gumbel_per_selection=true",
                              "--b", "gumbel_per_selection=false"])
    torch.cuda.synchronize()
    ab_s = time.monotonic() - t0
    printed = json.loads(out.getvalue().strip().splitlines()[-1])
    if (printed["games"] != AB_GAMES
            or printed["a_wins"] + printed["a_losses"] + printed["draws"] != AB_GAMES
            or printed["overrides_b"] != {"gumbel_per_selection": False}):
        raise RuntimeError(f"ab_match printed {printed}")
    need(counts(), "ab_match", some=("step_and_analyze", "flood"))
    print(f"ab_match on the card ({AB_GAMES} {AB_BOARD}x{AB_BOARD} games, {AB_PLAYOUTS} "
          f"playouts, weightless, a draw a selection vs one a search) in {ab_s:.1f} s: "
          f"{json.dumps(line)}; launches { {k: v for k, v in counts().items() if v} }  [{card}]")
    print(f"gammas phase: {time.monotonic() - t_phase:.1f} s")
    return launches, shapes


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    import numpy as np

    from concurrent.futures import ThreadPoolExecutor

    from sayuri_tpu_torch import bench
    from sayuri_tpu_torch.game import ladder as TL
    from sayuri_tpu_torch.game.positions import random_positions, stress_positions
    from sayuri_tpu_torch.ops import analysis as TA
    from sayuri_tpu_torch.ops import build
    from sayuri_tpu_torch.ops import flood as FK
    from sayuri_tpu_torch.ops import ladder_kernel as LK

    shape_spy = KernelSpy(TA, LK, FK)

    def reset_counts():
        TA.reset_launch_counts()
        LK.reset_launch_counts()
        FK.reset_launch_counts()
        shape_spy.counts.clear()

    def counts():
        return {**TA.LAUNCHES, **LK.LAUNCHES, **FK.LAUNCHES}

    phase_t0 = [time.monotonic()]

    def phase_done(name):
        now = time.monotonic()
        print(f"-- {name}: {now - phase_t0[0]:.1f} s", flush=True)
        phase_t0[0] = now

    # ---- 1. device ----
    phase("device")
    card = bench.device_info()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 2. build ----
    phase("build")
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda f: f(), (TA._lib, LK._lib, FK._lib)))
    for name in ("analysis", "ladder", "flood"):
        print(f"{name}.cu built in {build.BUILD_SECONDS[name]:.2f} s "
              f"({build.find_nvcc()})")
        ptxas = (build.BUILD_DIR / f"lib{name}.ptxas.txt").read_text().splitlines()
        for line in ptxas:
            if "Compiling entry" in line:
                print("  " + re.search(r"\d([a-z_]+_kernel)E", line).group(1))
            elif "Used" in line or "spill" in line:
                print("    " + line.strip())
    phase_done("device and build")

    # ---- 3. kernel parity ----
    phase("kernel parity")
    t0 = time.monotonic()
    # played on the card: the same games as the plain env's, in seconds
    s19, a19 = random_positions(19, PARITY_B, seed=0, max_moves=260, device=dev)
    print(f"{PARITY_B} random 19x19 positions in {time.monotonic() - t0:.1f} s")
    gold = golden_positions(torch, np)
    stress = {n: stress_positions(n) for n in (19, 9)}
    print(f"stress boards ({len(stress[19][5])} a buffer size): "
          f"{'; '.join(sorted(set(stress[19][5])))}")
    rec = {}
    total_cells = 0
    for tag, args_cpu, fn, plain in (
        ("board_analysis 19x19",
         (s19.stones, s19.size, s19.ko, s19.to_move),
         TA.board_analysis, TA.board_analysis_plain),
        ("step_and_analyze 19x19",
         (s19.stones, s19.size, s19.ko, s19.to_move, a19),
         TA.step_and_analyze, TA.step_and_analyze_plain),
        ("board_analysis goldens 9x9", gold,
         TA.board_analysis, TA.board_analysis_plain),
        *((f"{name} stress boards {n}x{n} buffer", args, fn, plain)
          for n in (19, 9)
          for name, args, fn, plain in (
              ("board_analysis", stress[n][:4], TA.board_analysis,
               TA.board_analysis_plain),
              ("step_and_analyze", stress[n][:5], TA.step_and_analyze,
               TA.step_and_analyze_plain))),
    ):
        args = tuple(x.to(dev).contiguous() for x in args_cpu)
        want = plain(*args_cpu)
        got = fn(*args)
        torch.cuda.synchronize()
        cells, err = compare(torch, got, want, tag)
        total_cells += cells
        name = fn.__name__
        r = rec.setdefault(name, {"cells": 0, "max_abs_err": 0})
        r["cells"] += cells
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if tag.endswith(" 19x19"):
            t_cpu = time.monotonic()
            plain(*args_cpu)
            r["cpu_plain_ms"] = (time.monotonic() - t_cpu) * 1e3
            r["ms"] = time_card(torch, fn, args)
            r["plain_ms"] = time_card(torch, plain, args, iters=3)
            r["nbytes"] = tensor_bytes(torch, (args, got))
            r["ops"] = OPS_PER_CELL * args[0].numel()
            compare(torch, plain(*args), want, tag + " plain on card")
        print(f"{tag}: {cells} cells equal, max abs err {err}")
    print(f"kernel parity: {total_cells} cells compared, all equal")
    phase_done("kernel parity")
    for name, r in rec.items():
        print(f"{name} B={PARITY_B} 19x19: kernel {r['ms']:.4f} ms, plain torch "
              f"on card {r['plain_ms']:.2f} ms, plain torch on CPU "
              f"{r['cpu_plain_ms']:.1f} ms  [{card}]")

    # ---- 4. ladder kernel parity ----
    phase("ladder kernel parity")
    t0 = time.monotonic()
    g19, gold_planes = golden19_positions(torch)
    print(f"{g19.stones.shape[0]} 19x19 golden records replayed in "
          f"{time.monotonic() - t0:.1f} s")
    ladder_rec = {k: {"cells": 0, "max_abs_err": 0} for k in
                  ("ladder_prep", "run_greedy", "run_chases")}
    for n in (19, 9):
        args_cpu = stress[n][:3]
        args = tuple(x.to(dev).contiguous() for x in args_cpu)
        cells, _ = compare(torch, TA.ladder_prep(*args), TA.ladder_prep_plain(*args_cpu),
                           f"ladder_prep stress boards {n}x{n} buffer")
        ladder_rec["ladder_prep"]["cells"] += cells
        print(f"ladder_prep stress boards {n}x{n} buffer: {cells} outputs equal")
    cpu_planes = {}
    for tag, st in (("random", s19), ("goldens", g19)):
        args_cpu = (st.stones, st.size, st.ko)
        args = tuple(x.to(dev).contiguous() for x in args_cpu)
        want = TA.ladder_prep_plain(*args_cpu)
        cells, err = compare(torch, TA.ladder_prep(*args), want, f"ladder_prep {tag}")
        ladder_rec["ladder_prep"]["cells"] += cells
        t_cpu = time.monotonic()
        with LaneSpy(LK) as spy:
            cpu_planes[tag] = TL.ladder_planes_batch(*args_cpu)
        cpu_s = time.monotonic() - t_cpu
        g_args, (g_res, g_forked), g_steps = spy.calls["run_greedy"]
        c_args, c_res, c_descents = spy.calls["run_chases"]
        n = st.stones.shape[-1]
        g_dev = tuple(x.to(dev) for x in g_args[:7])
        c_dev = tuple(x.to(dev) for x in c_args[:7])
        k_res, k_forked = LK.run_greedy(*g_dev, n)
        cells, _ = compare(torch, {"result": k_res, "forked": k_forked},
                           {"result": g_res, "forked": g_forked}, f"run_greedy {tag}")
        ladder_rec["run_greedy"]["cells"] += cells
        cells, _ = compare(torch, {"result": LK.run_chases(*c_dev, n)},
                           {"result": c_res}, f"run_chases {tag}")
        ladder_rec["run_chases"]["cells"] += cells
        got_planes = TL.ladder_planes_batch(*args)
        compare(torch, {"planes": got_planes}, {"planes": cpu_planes[tag]},
                f"ladder_planes_batch {tag}")
        active, forked = int((g_args[6] > 0).sum()), int((c_args[6] > 0).sum())
        boards = int((cpu_planes[tag].sum((1, 2, 3)) > 0).sum())
        print(f"{tag}: B={st.stones.shape[0]}, {g_args[0].shape[0]} lanes, {active} "
              f"active, {forked} forked; planes equal, {boards} boards with marks; "
              f"plain ladder_planes_batch on CPU {cpu_s:.1f} s")
        if tag == "goldens":
            compare(torch, {"planes": got_planes}, {"planes": gold_planes},
                    "ladder planes vs golden planes 33-36")
            print(f"goldens: planes 33-36 equal the reference's on "
                  f"{int(gold_planes.sum())} marked cells")
        else:
            lanes_b256 = (args, g_dev, c_dev, n)
            plies = {"run_greedy": (g_args, g_steps, 2, "steps"),
                     "run_chases": (c_args, c_descents, 1, "descents")}
            chase_cpu_ms = spy.seconds["run_chases"] * 1e3
    args, g_dev, c_dev, n = lanes_b256
    timed = (
        ("ladder_prep", TA.ladder_prep, TA.ladder_prep_plain, args),
        ("run_greedy", lambda *a: LK.run_greedy(*a, n),
         lambda *a: LK.run_greedy_plain(*a, n), g_dev),
        ("run_chases", lambda *a: LK.run_chases(*a, n),
         lambda *a: LK.run_chases_plain(*a, n), c_dev),
    )
    for name, fn, plain, a in timed:
        r = ladder_rec[name]
        if name in plies:
            r["nbytes"], r["ops"] = lane_work(*plies[name][:3], n)
        else:
            r["nbytes"] = tensor_bytes(torch, (a, fn(*a)))
            r["ops"] = OPS_PER_CELL * a[0].numel()
        r["ms"] = time_card(torch, fn, a)
        if name == "run_chases":
            # the plain chase on the card took 76-81 s here: its time on the
            # CPU, on the same lanes, from the ladder_planes_batch run above;
            # plain_device says where each plain_ms was taken
            r["plain_ms"], r["plain_device"] = chase_cpu_ms, "cpu"
        else:
            r["plain_ms"] = time_card(torch, plain, a, iters=1, warmup=0)
        rec[name] = r
        print(f"{name} B={PARITY_B} 19x19: kernel {r['ms']:.4f} ms, plain torch on "
              f"{r.get('plain_device', 'card')} {r['plain_ms']:.2f} ms, {r['cells']} outputs "
              f"equal  [{card}]")
    # a launch lasts as long as its longest lane: that lane alone, timed
    searches = {name: (fn, a) for name, fn, _, a in timed if name in plies}
    for name, (lanes, lane_plies, _, unit) in plies.items():
        fn, a = searches[name]
        alone_ms = time_card(torch, fn, tuple(t[[int(lane_plies.argmax())]] for t in a))
        lane_plies = lane_plies[lanes[6] > 0]
        longest, total = int(lane_plies.max()), int(lane_plies.sum())
        ms = rec[name]["ms"]
        q = torch.quantile(lane_plies.double(), torch.tensor([0.5, 0.9, 0.99]).double())
        print(f"{name}: {lane_plies.numel()} lanes searched; {unit}: {total} in all, "
              f"{longest} on the longest lane (median {q[0]:.0f}, p90 {q[1]:.0f}, "
              f"p99 {q[2]:.0f}); kernel {ms / longest:.6f} ms a "
              f"{unit[:-1]} of the longest lane, which alone takes {alone_ms:.4f} ms; "
              f"bound {bound(rec[name]['nbytes'], rec[name]['ops'])[0]:.6f} ms  [{card}]")
    planes_ms = time_card(torch, TL.ladder_planes_batch, args, iters=5)
    print(f"ladder_planes_batch B={PARITY_B} 19x19 (prep, candidates, both "
          f"searches, planes): {planes_ms:.3f} ms on the card  [{card}]")
    phase_done("ladder kernel parity")

    def check_roots(res, tag):
        tree, mcts, batch = res["tree"], res["mcts"], res["states"].stones.shape[0]
        root_visits = tree.visits[:, 0].cpu()
        if not bool((root_visits == SLICE_PLAYOUTS + 1).all()):
            raise RuntimeError(f"{tag}: root visits {root_visits.unique().tolist()}")
        best = mcts.best_move(tree).cpu()
        legal = mcts.env.legal_action_mask(res["states"].to("cpu"))
        if not bool(legal[torch.arange(batch), best].all()):
            raise RuntimeError(f"{tag}: best_move picked an illegal move")
        child_visits = mcts.root_child_visits(tree).cpu()
        if not bool((child_visits.sum(-1) == SLICE_PLAYOUTS).all()):
            raise RuntimeError(f"{tag}: root child visits do not sum to the playouts")

    def check_launches(launches, res, tag):
        searches = res["searches"]
        sims = SLICE_PLAYOUTS * searches
        print(f"launches in the {tag} run: {launches} ({searches} searches, "
              f"{sims} simulations)")
        if launches["step_and_analyze"] != sims:
            raise RuntimeError(f"{tag}: step_and_analyze launched "
                               f"{launches['step_and_analyze']} times for {sims} simulations")
        if launches["board_analysis"] < searches:
            raise RuntimeError(f"{tag}: board_analysis launched fewer times than searches")
        for k in ("ladder_prep", "run_greedy", "run_chases"):
            if launches[k] != searches:
                raise RuntimeError(f"{tag}: {k} launched {launches[k]} times for "
                                   f"{searches} searches")

    # ---- 5. slice ----
    phase("slice")
    reset_counts()
    res = bench.bench_playouts(SLICE_BATCH, SLICE_PLAYOUTS, device=dev)
    torch.cuda.synchronize()
    launches = counts()
    path_launches = {k: ("slice", launches[k]) for k in (
        "step_and_analyze", "board_analysis", "ladder_prep", "run_greedy",
        "run_chases")}
    check_launches(launches, res, "slice")
    check_roots(res, "slice")
    empty_rate = res["rate"]
    print(f"{bench.METRIC} = {empty_rate:.1f} playouts/s "
          f"(B={SLICE_BATCH} x {SLICE_PLAYOUTS} playouts, empty roots, "
          f"{res['searches'] - 1} timed searches in {res['seconds']:.3f} s)  [{card}]")
    phase_done("slice")

    # ---- 6. midgame roots ----
    phase("midgame roots")
    reset_counts()
    res = bench.bench_playouts(SLICE_BATCH, SLICE_PLAYOUTS, device=dev, iters=1,
                               roots=s19)
    torch.cuda.synchronize()
    check_launches(counts(), res, "midgame")
    check_roots(res, "midgame")
    st = res["states"]
    root_planes = TL.ladder_planes_batch(st.stones, st.size, st.ko)
    compare(torch, {"planes": root_planes}, {"planes": cpu_planes["random"]},
            "midgame root ladder planes")
    marked = int((root_planes.sum((1, 2, 3)) > 0).sum())
    if marked == 0:
        raise RuntimeError("midgame roots: no root ladder planes")
    print(f"midgame roots: {marked} of {SLICE_BATCH} boards with ladder marks, equal "
          f"to the CPU twin's; {res['rate']:.1f} playouts/s from midgame roots "
          f"({res['seconds']:.3f} s) vs {empty_rate:.1f} from empty roots  [{card}]")
    phase_done("midgame roots")

    # ---- 7. f32 search parity ----
    phase("f32 search parity")
    from sayuri_tpu_torch.game.state import GoEnv
    from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
    from sayuri_tpu_torch.models.evaluator import make_eval_fn
    from sayuri_tpu_torch.models.network import NetConfig, SayuriNet

    env9 = GoEnv(n=9)
    roots, _ = random_positions(9, 8, seed=3, max_moves=50)
    net_cpu = SayuriNet(NetConfig(boardsize=9)).init_random(7).eval()
    net_gpu = SayuriNet(NetConfig(boardsize=9)).init_random(7).to(dev).eval()
    outs = {}
    for where, net, st in (("cpu", net_cpu, roots), ("cuda", net_gpu, roots.to(dev))):
        fn = make_eval_fn(env9, net, symmetry="random", ladder_mode="root")
        m = MCTS(env9, fn, SearchConfig(max_nodes=48, max_depth=32))
        ctx = {"ladders": TL.ladder_planes_batch(st.stones, st.size, st.ko)}
        ev = fn(st, ctx)
        tree9 = m.run(m.init_tree(st, ctx=ctx), 32, ctx=ctx)
        outs[where] = (ev, m.root_child_visits(tree9).cpu(), tree9.visits[:, 0].cpu(),
                       ctx["ladders"].cpu())
    compare(torch, {"planes": outs["cuda"][3]}, {"planes": outs["cpu"][3]},
            "9x9 root ladder planes")
    if not outs["cpu"][3].sum() > 0:
        raise RuntimeError("9x9 roots: no ladder marks")
    ev_err = max(
        float((getattr(outs["cpu"][0], k) - getattr(outs["cuda"][0], k).cpu()).abs().max())
        for k in outs["cpu"][0]._fields
    )
    if not ev_err <= EVAL_ATOL:
        raise RuntimeError(f"root NetEvals differ by {ev_err} > {EVAL_ATOL}")
    for where in outs:
        if not bool((outs[where][2] == 33).all()):
            raise RuntimeError(f"{where}: root visits {outs[where][2].tolist()}")
    same = (outs["cpu"][1] == outs["cuda"][1]).all(-1).float().mean().item()
    print(f"9x9 midgame roots, {int((outs['cpu'][3].sum((1, 2, 3)) > 0).sum())} of 8 "
          f"with ladder marks")
    print(f"root NetEvals max abs err card vs CPU: {ev_err:.3g} (limit {EVAL_ATOL})")
    print(f"lanes with identical root visit vectors: {same:.3f} of 8")
    phase_done("f32 search parity")

    from sayuri_tpu_torch.game import board as TB
    from sayuri_tpu_torch.mcts import rollout as R
    from sayuri_tpu_torch.mcts.core import NetEvals
    from sayuri_tpu_torch.models.evaluator import make_dummy_eval_fn
    from sayuri_tpu_torch.selfplay import randomize as RZ

    def need(launches, tag, exact=None, some=()):
        """Raise unless each counter of `exact` has exactly its count and
        each kernel named in `some` was launched at all."""
        for k, v in (exact or {}).items():
            if launches[k] != v:
                raise RuntimeError(f"{tag}: {k} launched {launches[k]} times, expected {v}")
        for k in some:
            if not launches[k]:
                raise RuntimeError(f"{tag}: {k} was never launched")

    # ---- 8. step-legal parity ----
    phase("step-legal parity")
    step_rec = {"cells": 0, "max_abs_err": 0}
    for tag, args_cpu in (
        ("random 19x19", (s19.stones, s19.size, s19.ko, s19.to_move, a19)),
        ("pass-dead goldens 9x9", (*gold, legal_actions(torch, np, gold, seed=5))),
        ("stress boards 19x19 buffer", stress[19][:5]),
        ("stress boards 9x9 buffer", stress[9][:5]),
    ):
        args = tuple(x.to(dev).contiguous() for x in args_cpu)
        want = TA.step_and_legal_plain(*args_cpu)
        got = TA.step_and_legal(*args)
        torch.cuda.synchronize()
        cells, err = compare(torch, got, want, f"step_and_legal {tag}")
        step_rec["cells"] += cells
        step_rec["max_abs_err"] = max(step_rec["max_abs_err"], err)
        print(f"step_and_legal {tag}: {cells} outputs equal")
        if tag.startswith("random"):
            args256, out256, want256 = args, got, want
    step_rec["nbytes"] = tensor_bytes(torch, (args256, out256))
    step_rec["ops"] = OPS_PER_CELL * args256[0].numel()
    step_rec["ms"] = time_card(torch, TA.step_and_legal, args256)
    step_rec["plain_ms"] = time_card(torch, TA.step_and_legal_plain, args256, iters=3)
    reps = ENV_BATCH // PARITY_B
    args_env = tuple(x.repeat((reps,) + (1,) * (x.ndim - 1)).contiguous() for x in args256)
    want_env = {k: v.repeat((reps,) + (1,) * (v.ndim - 1)) for k, v in want256.items()}
    cells, _ = compare(torch, TA.step_and_legal(*args_env), want_env,
                       f"step_and_legal B={ENV_BATCH}")
    step_rec["cells"] += cells
    print(f"step_and_legal B={ENV_BATCH} (the {PARITY_B} positions tiled {reps} "
          f"times): {cells} outputs equal the tiled plain output")
    ms_env = time_card(torch, TA.step_and_legal, args_env)
    env_nbytes = tensor_bytes(torch, (args_env, want_env))
    step_rec["by_shape"] = [{"boards": ENV_BATCH, "n": 19, "ms": ms_env,
                             "bound_ms": bound(env_nbytes, OPS_PER_CELL
                                               * args_env[0].numel())[0]}]
    rec["step_and_legal"] = step_rec
    print(f"step_and_legal 19x19: kernel {step_rec['ms']:.4f} ms at B={PARITY_B}, "
          f"{ms_env:.4f} ms at B={ENV_BATCH}; plain torch on card "
          f"{step_rec['plain_ms']:.2f} ms at B={PARITY_B}  [{card}]")

    reset_counts()
    env_res = bench.bench_env_steps(ENV_BATCH, ENV_STEPS, device=dev, iters=ENV_RUNS)
    torch.cuda.synchronize()
    env_launches = counts()
    need(env_launches, "env steps",
         exact={"step_and_legal": (1 + ENV_STEPS) * env_res["rollouts"]})
    others = {k: v for k, v in env_launches.items() if v and k != "step_and_legal"}
    if others:
        raise RuntimeError(f"env steps: other kernels launched {others}")
    path_launches["step_and_legal"] = ("env steps", env_launches["step_and_legal"])
    step_rec["by_shape"][0]["launches"] = env_launches["step_and_legal"]
    if not bool((env_res["states"].move_count == 1 + ENV_STEPS).all()):
        raise RuntimeError("env steps: move counts did not advance on every lane")
    print(f"launches in the env-steps run: step_and_legal "
          f"{env_launches['step_and_legal']} ({env_res['rollouts']} runs of 1 + "
          f"{ENV_STEPS} steps); every lane at move {1 + ENV_STEPS}")
    real_step_legal = TA.step_and_legal
    TA.step_and_legal = TA.step_and_legal_plain
    try:
        env_plain = GoEnv(n=19)
        plain_final = bench.env_steps_rollout(
            env_plain, env_plain.new_batch(ENV_BATCH, komi=7.5, device=dev),
            ENV_STEPS, ENV_RUNS)
    finally:
        TA.step_and_legal = real_step_legal
    cells, _ = compare(torch, env_res["states"].fields(), plain_final.fields(),
                       "env steps final GoState vs the plain rollout")
    print(f"env steps: the last run's final GoState equals the same rollout through "
          f"step_and_legal_plain ({cells} values)")
    print(f"{bench.ENV_METRIC} = {env_res['rate']:.1f} steps/s (B={ENV_BATCH} x "
          f"{ENV_STEPS} steps, {ENV_RUNS} timed runs in {env_res['seconds']:.3f} s)  [{card}]")
    phase_done("step-legal parity")

    # ---- 9. board fixpoints ----
    phase("board fixpoints")
    env19 = GoEnv(n=19)
    mask19 = TB.board_mask(s19.size, 19)
    empty, black, white = (((s19.stones == c) & mask19) for c in (0, 1, 2))
    colours = torch.stack([empty, black, white])                  # [3, B, n, n]
    reach_allowed = torch.stack([black, white, empty])
    reach_seeds = torch.stack([black & TB.nbr_or(empty), white & TB.nbr_or(empty),
                               empty & TB.nbr_or(black)])
    nested = colours[1:].contiguous()                              # [2, B, n, n]
    nested_seeds = torch.from_numpy(np.random.RandomState(9).rand(*nested.shape) < 0.03)
    for name in ("flood", "chain_labels"):
        rec[name] = {"cells": 0, "max_abs_err": 0}
    for tag, m in (("colour masks", colours), ("nested", nested)):
        cells, err = compare(torch, {"labels": FK.chain_labels(m.to(dev))},
                             {"labels": TB.chain_labels_plain(m)}, f"chain_labels {tag}")
        rec["chain_labels"]["cells"] += cells
        print(f"chain_labels {tag} {tuple(m.shape)}: {cells} labels equal")
    for tag, sd, al in (("reach seeds", reach_seeds, reach_allowed),
                        ("nested", nested_seeds, nested)):
        cells, err = compare(torch, {"flood": FK.flood(sd.to(dev), al.to(dev))},
                             {"flood": TB.flood_plain(sd, al)}, f"flood {tag}")
        rec["flood"]["cells"] += cells
        print(f"flood {tag} {tuple(al.shape)}: {cells} cells equal")
    for name, fn, plain, a in (
        ("chain_labels", FK.chain_labels, TB.chain_labels_plain, (black.to(dev),)),
        ("flood", FK.flood, TB.flood_plain,
         (reach_seeds[0].to(dev).contiguous(), black.to(dev))),
    ):
        r = rec[name]
        r["nbytes"] = tensor_bytes(torch, (a, fn(*a)))
        r["ops"] = OPS_PER_CELL * a[0].numel()
        r["ms"] = time_card(torch, fn, a)
        r["plain_ms"] = time_card(torch, plain, a, iters=3)
        print(f"{name} B={PARITY_B} 19x19: kernel {r['ms']:.4f} ms, plain torch on card "
              f"{r['plain_ms']:.2f} ms  [{card}]")

    d19, da19 = s19.to(dev), a19.to(dev)
    shape_spy.install()
    shape_runs = []
    queries = ("legal_action_mask", "step", "superko_action_mask", "final_score",
               "ownership")

    def run_queries(st, acts):
        return {
            "legal_action_mask": env19.legal_action_mask(st),
            "step": env19.step(st, acts).fields(),
            "superko_action_mask": env19.superko_action_mask(st),
            "final_score": env19.final_score(st),
            "ownership": env19.ownership(st),
        }

    reset_counts()
    t0 = time.monotonic()
    q_card = run_queries(d19, da19)
    torch.cuda.synchronize()
    rules_s = time.monotonic() - t0
    rules_launches = counts()
    need(rules_launches, "rules queries", some=("flood", "chain_labels"))
    flood_paths = {"rules queries": rules_launches}
    shape_runs.append(dict(shape_spy.counts))
    sub = s19.map(lambda x: x[:32])
    q_cpu = run_queries(s19, a19)
    q_cpu["superko_action_mask"] = env19.superko_action_mask(sub)
    q_card["superko_action_mask"] = q_card["superko_action_mask"][:32]
    for k in queries:
        got, want = q_card[k], q_cpu[k]
        if not isinstance(want, dict):
            got, want = {k: got}, {k: want}
        cells, err = compare(torch, got, want, f"{k} card vs CPU")
        print(f"{k}: {cells} values equal to the plain CPU run")
    if not bool(q_cpu["superko_action_mask"].any()):
        print("superko_action_mask: no violation in these 32 lanes")
    superko_ms = time_card(torch, env19.superko_action_mask, (d19,), iters=3, warmup=1)
    print(f"launches in the rules-queries run: flood {rules_launches['flood']}, "
          f"chain_labels {rules_launches['chain_labels']}, board_analysis "
          f"{rules_launches['board_analysis']}; all five queries at B={PARITY_B} took "
          f"{rules_s * 1e3:.1f} ms (first call)")
    print(f"superko_action_mask B={PARITY_B} 19x19 ({PARITY_B * 361} boards in one "
          f"play_move): {superko_ms:.3f} ms  [{card}]")
    phase_done("board fixpoints")

    # ---- 10. rollout ----
    phase("rollout")
    played = []
    real_pick = R.random_move_batch

    def spy_pick(*a):
        mv = real_pick(*a)
        played.append(mv)
        return mv

    R.random_move_batch = spy_pick
    try:
        reset_counts()
        t0 = time.monotonic()
        own, score = R.mc_ownership(env19, d19, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        mc_s = time.monotonic() - t0
        mc_launches = counts()
    finally:
        R.random_move_batch = real_pick
    need(mc_launches, "mc_ownership", exact={"step_and_analyze": len(played)},
         some=("flood", "chain_labels"))
    flood_paths["mc_ownership"] = mc_launches
    shape_runs.append(dict(shape_spy.counts))
    k = ROLLOUT_REPLAY_LANES
    roots_k = s19.map(lambda x: x[:k])
    st = roots_k
    for mv in played:
        st = env19.step(st, mv[:k].cpu())
    ended = int(st.terminated.sum())
    want_own = TB.area_ownership(st.stones, st.size).reshape(k, -1).to(torch.float32)
    want_score = want_own.sum(-1) - env19.komi_with_penalty(roots_k)
    cells, _ = compare(torch, {"own": own[:k], "score": score[:k]},
                       {"own": want_own, "score": want_score}, "mc_ownership replay")
    board_moves = sum(int((mv < 361).sum()) for mv in played)
    print(f"mc_ownership B={PARITY_B} 19x19, cap {2 * 361 + 1}: {len(played)} batch "
          f"steps, {board_moves / PARITY_B:.1f} board moves a lane, {mc_s:.3f} s "
          f"[{card}]; launches {({n: c for n, c in mc_launches.items() if c})}")
    print(f"mc_ownership replay: {cells} ownership and score values of {k} lanes equal "
          f"the plain CPU env's ({ended} of the {k} playouts ended by two passes)")

    wrapped = R.wrap_eval_with_rollout(env19, make_dummy_eval_fn(env19),
                                       max_moves=WRAPPED_MAX_MOVES)
    m = MCTS(env19, wrapped, SearchConfig(max_nodes=WRAPPED_PLAYOUTS + 8, max_depth=16))
    reset_counts()
    t0 = time.monotonic()
    tree = m.run(m.init_tree(d19), WRAPPED_PLAYOUTS)
    torch.cuda.synchronize()
    wrapped_s = time.monotonic() - t0
    wrapped_launches = counts()
    need(wrapped_launches, "wrapped search", some=("flood", "chain_labels"))
    flood_paths["wrapped search"] = wrapped_launches
    shape_runs.append(dict(shape_spy.counts))
    if not bool((tree.visits[:, 0] == WRAPPED_PLAYOUTS + 1).all()):
        raise RuntimeError(f"wrapped search: root visits "
                           f"{tree.visits[:, 0].unique().tolist()}")
    print(f"rollout-wrapped search B={PARITY_B}, {WRAPPED_PLAYOUTS} playouts, playout "
          f"cap {WRAPPED_MAX_MOVES} moves: root visits {WRAPPED_PLAYOUTS + 1}, "
          f"{wrapped_s:.3f} s [{card}]; launches "
          f"{({n: c for n, c in wrapped_launches.items() if c})}")
    phase_done("rollout")

    # ---- 11. randomize ----
    phase("randomize")

    class RecordingEnv(GoEnv):
        """GoEnv whose step keeps the actions it is given."""

        def __init__(self, n):
            super().__init__(n=n)
            self.actions = []

        def step(self, states, actions):
            self.actions.append(actions)
            return super().step(states, actions)

    dist = RZ.parse_queries(["bkp:19:7.5:1.0", "bhp:19:4:0.5"], random_opening_prob=1.0)
    net19 = SayuriNet(NetConfig(boardsize=19)).init_random(0).to(dev).eval()
    rec_env = RecordingEnv(19)
    randomizer = RZ.GameRandomizer(
        rec_env, dist, make_eval_fn(env19, net19, compute_dtype=torch.bfloat16))
    reset_counts()
    t0 = time.monotonic()
    prepared = randomizer.prepare(PARITY_B, 0, device=dev)
    torch.cuda.synchronize()
    prep_s = time.monotonic() - t0
    rz_launches = counts()
    steps = len(rec_env.actions)
    need(rz_launches, "prepare", exact={"flood": 2 * steps, "board_analysis": steps})
    flood_paths["prepare"] = rz_launches
    shape_runs.append(dict(shape_spy.counts))
    shape_spy.remove()
    replay = iter([a.cpu() for a in rec_env.actions])

    def replay_eval(states, ctx=None):
        """One-hot priors on the move the card sampled at this step (the
        Gumbel draw cannot overturn a one-hot policy)."""
        b = states.stones.shape[0]
        z = torch.zeros(b)
        return NetEvals(
            priors=torch.nn.functional.one_hot(next(replay).long(), 362).float(),
            black_wl=z + 0.5, draw=z, black_score=z, black_ownership=torch.zeros((b, 361)))

    cpu_prep = RZ.GameRandomizer(GoEnv(n=19), dist, replay_eval).prepare(
        PARITY_B, 0, device="cpu")
    cells, _ = compare(torch, prepared.fields(), cpu_prep.fields(), "prepare replay")
    if not bool(env19.legal_action_mask(prepared)[:, :-1].any(-1).all()):
        raise RuntimeError("prepare: a lane has no legal board move")
    hcp = prepared.handicap.cpu()
    print(f"prepare B={PARITY_B} 19x19, b6c96 bf16 policy: {steps} policy steps, "
          f"{int((hcp > 0).sum())} handicap lanes (max {int(hcp.max())}), move counts "
          f"{int(prepared.move_count.min())}-{int(prepared.move_count.max())}, "
          f"{prep_s:.3f} s [{card}]; launches "
          f"{({n: c for n, c in rz_launches.items() if c})}")
    print(f"prepare replay on the CPU: {cells} GoState values equal; every lane has a "
          f"legal move")
    for name in ("flood", "chain_labels"):
        path_launches[name] = (" + ".join(flood_paths),
                               sum(c[name] for c in flood_paths.values()))
    phase_done("randomize")

    # ---- 12. fixpoint shapes ----
    phase("fixpoint shapes")
    shape_launches = {}
    for run in shape_runs:
        for key, c in run.items():
            if key[0] in ("flood", "chain_labels"):
                shape_launches[key] = shape_launches.get(key, 0) + c
    plains = {"flood": TB.flood_plain, "chain_labels": TB.chain_labels_plain}
    for name in plains:
        seen = sum(c for (k, *_), c in shape_launches.items() if k == name)
        if seen != path_launches[name][1]:
            raise RuntimeError(f"{name}: the shape spy saw {seen} launches, the "
                               f"counter {path_launches[name][1]}")
        rec[name]["by_shape"] = []
    for (name, boards, n), n_launch in sorted(shape_launches.items()):
        a = shape_spy.inputs[(name, boards, n)]
        fn = getattr(FK, name)
        got = fn(*a)
        cells, err = compare(torch, {name: got}, {name: plains[name](*a)},
                             f"{name} at {boards} boards")
        r = rec[name]
        r["cells"] += cells
        r["max_abs_err"] = max(r["max_abs_err"], err)
        ms = time_card(torch, fn, a, iters=10)
        b_ms = bound(tensor_bytes(torch, (a, got)), OPS_PER_CELL * a[-1].numel())[0]
        r["by_shape"].append({"boards": boards, "n": n, "launches": n_launch, "ms": ms,
                              "bound_ms": b_ms})
        print(f"{name} at {boards} boards {tuple(a[-1].shape)}: {n_launch} launches on "
              f"the main paths, kernel {ms:.4f} ms, bound {b_ms:.6f} ms, {cells} cells "
              f"equal the plain version; (kernel - bound) x launches "
              f"{(ms - b_ms) * n_launch:.3f} ms  [{card}]")
    # the stress boards' colour masks, tiled to the labels' main shape (512
    # boards); the flood seeded at the cells on the mask's edge,
    # and at its cells next to an empty one (reach's seeds: on the double
    # spiral one hole, from which the flood climbs every turn of the snake)
    for n in (19, 9):
        st, sz = stress[n][:2]
        masks = torch.stack([(st == c) & TB.board_mask(sz, n) for c in (0, 1, 2)])
        libs = masks & TB.nbr_or(masks[0])
        reps = -(-512 // (3 * st.shape[0]))
        masks, libs = (x.reshape(-1, n, n).repeat(reps, 1, 1)[:512] for x in (masks, libs))
        seeds = masks & TB.nbr_or(~masks)
        d_masks, d_seeds, d_libs = masks.to(dev), seeds.to(dev), libs.to(dev)
        for name, seeding, a, a_cpu in (
                ("chain_labels", "", (d_masks,), (masks,)),
                ("flood", " (seeds on the mask's edge)", (d_seeds, d_masks), (seeds, masks)),
                ("flood", " (seeds next to an empty cell)", (d_libs, d_masks), (libs, masks))):
            cells, err = compare(torch, {name: getattr(FK, name)(*a)},
                                 {name: plains[name](*a_cpu)},
                                 f"{name}{seeding} stress boards {n}x{n}")
            rec[name]["cells"] += cells
            rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
            ms = time_card(torch, getattr(FK, name), a, iters=10)
            print(f"{name}{seeding} on the stress boards' colour masks, {n}x{n} buffer, 512 "
                  f"boards: {cells} cells equal the plain version, kernel {ms:.4f} ms "
                  f"[{card}]")
    phase_done("fixpoint shapes")

    # ---- 13. self-play ----
    phase("self-play")
    import gzip
    import shutil
    import tempfile

    from sayuri_tpu_torch import __main__ as CLI

    work = Path(tempfile.mkdtemp(prefix="sayuri-selfplay-"))
    wdir, out_dir = work / "weights", work / "out"
    wdir.mkdir()
    wfile = bench.write_seeded_v5(wdir / f"b6c96-seed{bench.V5_SEED}.txt")
    kernel_spy = KernelSpy(TA, LK, FK, late=True)
    kernel_spy.install()
    reset_counts()
    t0 = time.monotonic()
    try:
        pipe = CLI.main(["--mode", "selfplay",
                         "--config", str(ROOT / "configs/selfplay-gumbel-p150.txt"),
                         "--playouts", str(SP_PLAYOUTS),
                         "--fastsearch-playouts", str(SP_FAST_PLAYOUTS),
                         "--num-games", str(SP_GAMES), "--parallel-games", str(SP_GAMES),
                         "--weights-dir", str(wdir), "--target-directory", str(out_dir)],
                        device=dev)
        torch.cuda.synchronize()
    finally:
        kernel_spy.remove()
    sp_s = time.monotonic() - t0
    sp_launches = counts()
    rnd = pipe.last_round
    print(f"selfplay CLI: {pipe.games_done} games of B={pipe.parallel_games} in "
          f"{sp_s:.1f} s [{card}]; {rnd['moves']} moves, {rnd['kept_records']} kept "
          f"records, {rnd['chunks']} chunk files; NN cache {rnd['queries']}; launches "
          f"{({k: v for k, v in sp_launches.items() if v})}")
    print(f"selfplay CLI round: {rnd['kept_records']} kept positions in "
          f"{rnd['seconds']:.3f} s = {rnd['kept_records'] / rnd['seconds']:.2f} kept "
          f"positions/s, {rnd['moves'] * pipe.parallel_games / rnd['seconds']:.2f} lane-moves/s "
          f"(9x9/7x7 b6c96 bf16, {SP_PLAYOUTS}/{SP_FAST_PLAYOUTS} playouts, whole games with "
          f"the helper playout)  [{card}]")
    need(sp_launches, "self-play", some=("step_and_analyze", "board_analysis",
                                         "ladder_prep", "run_greedy", "run_chases",
                                         "flood", "chain_labels"))
    seen = {}
    for (name, *_), c in kernel_spy.counts.items():
        seen[name] = seen.get(name, 0) + c
    if any(seen.get(k, 0) != v for k, v in sp_launches.items()):
        raise RuntimeError(f"self-play: the spy saw {seen}, the counters {sp_launches}")
    positions = 0
    chunks = sorted(out_dir.glob("[tv]data/*/*.txt.gz"))
    for f in chunks:
        with gzip.open(f, "rt") as fh:
            lines = fh.read().split("\n")[:-1]
        if not lines or len(lines) % 53:
            raise RuntimeError(f"{f.name}: {len(lines)} lines, not a multiple of 53")
        for i in range(0, len(lines), 53):
            if lines[i:i + 2] != ["2", "0"] or lines[i + 2] not in ("9", "7"):
                raise RuntimeError(f"{f.name}: position {i // 53} starts {lines[i:i + 3]}")
        positions += len(lines) // 53
    if len(chunks) != rnd["chunks"] or positions != rnd["kept_records"] or not positions:
        raise RuntimeError(f"chunks: {len(chunks)} files with {positions} positions for "
                           f"{rnd['kept_records']} kept records")
    n_games, n_moves = replay_sgfs(torch, out_dir / "sgf", pipe.env.n)
    if n_games != SP_GAMES:
        raise RuntimeError(f"{n_games} SGFs for {SP_GAMES} games")
    queries = (out_dir / "net_queries").glob("*.txt")
    q_text = [q.read_text().split() for q in queries]
    if len(q_text) != 1 or int(q_text[0][0]) != 0 or int(q_text[0][1]) <= 0:
        raise RuntimeError(f"net_queries: {q_text}")
    if not (rnd["territory_lanes"] and rnd["helper_steps"]):
        raise RuntimeError(f"territory helper: {rnd['territory_lanes']} territory lanes, "
                           f"{rnd['helper_steps']} helper steps")
    print(f"chunks: {len(chunks)} files, {positions} positions of 53 lines = the kept "
          f"records; {n_games} SGFs replay legally on the CPU ({n_moves} moves); "
          f"net_queries {' '.join(q_text[0])}; {rnd['territory_lanes']} territory lanes, "
          f"helper playout {rnd['helper_steps']} moves")

    # the NN cache runs every lane through the net (it saves no forward
    # pass), so the reading is taken with it on and off (on, then off)
    for cache_sets in SP_BENCH_CACHE_SETS:
        reset_counts()
        sp_bench = bench.bench_selfplay(SP_BENCH_BATCH, SP_BENCH_MOVES, device=dev,
                                        nn_cache_size=cache_sets)
        torch.cuda.synchronize()
        bench_launches = counts()
        need(bench_launches, "self-play bench", some=("step_and_analyze", "board_analysis",
                                                      "ladder_prep", "run_greedy",
                                                      "run_chases", "flood", "chain_labels"))
        print(f"{bench.SELFPLAY_METRIC} = {sp_bench['positions_per_s']:.2f} positions/s, "
              f"{sp_bench['moves_per_s']:.2f} moves/s (19x19 b6c96 bf16, "
              f"{'/'.join(map(str, sp_bench['playouts']))} playouts, NN cache "
              f"{cache_sets} sets, B={SP_BENCH_BATCH} x {sp_bench['moves']} moves, "
              f"{sp_bench['positions']} kept positions in {sp_bench['seconds']:.3f} s; "
              f"NN cache {sp_bench['queries']})  [{card}]")

    sp_shapes = check_shapes(
        torch, card, kernel_spy, "self-play",
        lambda k, n: f"about move {round(rnd['moves'] * k / n)} of {rnd['moves']}")
    phase_done("self-play")

    # ---- 14. GTP ----
    phase("GTP")
    gtp_launches, gtp_shapes, gtp_genmove_s = run_gtp_phase(
        torch, dev, card, wfile, work, reset_counts, counts, need)
    phase_done("GTP")

    try:
        # ---- 15. train ----
        phase("train")
        rl_launches, rl_shapes = run_train_phase(
            torch, dev, card, out_dir, work, reset_counts, counts, need)
        phase_done("train")

        # ---- 16. block families ----
        phase("block families")
        run_blocks_phase(torch, np, dev, card, out_dir / "tdata", work, reset_counts, counts,
                         check_launches, check_roots)
        phase_done("block families")

        # ---- 17. the process group ----
        phase("group")
        group_launches, group_shapes = run_group_phase(torch, card, out_dir, work)
        phase_done("group")

        # ---- 18. the pattern gammas ----
        phase("gammas")
        gammas_launches, gammas_shapes = run_gammas_phase(
            torch, np, dev, card, s19, cpu_planes["random"], wfile, out_dir / "sgf", work,
            reset_counts, counts, need, gtp_genmove_s)
        phase_done("gammas")

        # ---- 19. the eval epilogue ----
        phase("epilogue")
        epilogue_row = run_epilogue_phase(torch, dev)
        phase_done("epilogue")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- result ----
    kernels = []
    for name, src, replaces in (
        ("step_and_analyze", "analysis.cu", "sayuri_tpu/ops/analysis.py:528"),
        ("board_analysis", "analysis.cu", "sayuri_tpu/ops/analysis.py:451"),
        ("ladder_prep", "analysis.cu", "sayuri_tpu/ops/analysis.py:718"),
        ("run_greedy", "ladder.cu", "sayuri_tpu/ops/ladder_kernel.py:743"),
        ("run_chases", "ladder.cu", "sayuri_tpu/ops/ladder_kernel.py:824"),
        ("step_and_legal", "analysis.cu", "sayuri_tpu/ops/analysis.py:854"),
        ("flood", "flood.cu", "sayuri_tpu/ops/flood.py:59"),
        ("chain_labels", "flood.cu", "sayuri_tpu/ops/flood.py:76"),
    ):
        r = rec[name]
        path, n_launches = path_launches[name]
        bound_ms, bound_by = bound(r["nbytes"], r["ops"])
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"sayuri_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": n_launches,
            "path": path,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "selfplay_launches": sp_launches[name],
            "selfplay_by_shape": sp_shapes.get(name, []),
            "gtp_launches": gtp_launches[name],
            "gtp_by_shape": gtp_shapes.get(name, []),
            "rl_launches": rl_launches[name],
            "rl_by_shape": rl_shapes.get(name, []),
            "group_launches": group_launches[name],
            "group_by_shape": group_shapes.get(name, []),
            "gammas_launches": gammas_launches[name],
            "gammas_by_shape": gammas_shapes.get(name, []),
            "plain_device": r.get("plain_device", "cuda"),
            **({"by_shape": r["by_shape"]} if "by_shape" in r else {}),
        })
    kernels.append(epilogue_row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0

if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--group-child"]:
            group_child(*sys.argv[2:4])
            sys.exit(0)
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
