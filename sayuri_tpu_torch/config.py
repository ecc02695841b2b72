"""Option store: CLI flags + config files (PyTorch port of
sayuri_tpu.config, its own copy).

A typed flat option dict with defaults and bounds, fed by CLI flags and
`--config FILE` files in the same syntax (one `--flag value` pair per
line, `#` comments). Multi-valued options (`--selfplay-query`) accumulate
into lists. `--no-X` negates a boolean option X; `--no-cache` turns the NN
cache off; `--cache-memory-mib` sizes it in MiB.

The port runs the `gtp`, `selfplay` and `benchmark` modes.
``check_gtp_flags``, ``check_selfplay_flags`` and
``check_benchmark_flags`` raise for every option that was given on the
command line or in a config file and that the mode does not read yet, so
that no flag is silently dropped.
"""

from __future__ import annotations

import dataclasses
import shlex
from typing import Any


@dataclasses.dataclass
class Opt:
    default: Any
    lo: Any = None
    hi: Any = None
    multi: bool = False


# Option registry: names follow the reference engine's option map.
OPTIONS: dict[str, Opt] = {
    "mode": Opt("gtp"),
    "boardsize": Opt(19, 2, 25),
    "komi": Opt(7.5, -150.0, 150.0),
    "scoring_rule": Opt("area"),
    "playouts": Opt(400, 1, 100000000),
    "const_time": Opt(0, 0, 1000000),
    "batch_size": Opt(0, 0, 4096),
    "weights_file": Opt(""),
    "weights_dir": Opt(""),
    "quiet": Opt(False),
    "analysis_verbose": Opt(False),
    "reuse_tree": Opt(True),
    "ponder": Opt(False),
    # end-of-game etiquette
    "friendly_pass": Opt(False),
    "capture_all_dead": Opt(False),
    # ponder_playouts = playouts * ponder_factor
    "ponder_factor": Opt(100, 1, 100000),
    "resign_threshold": Opt(0.1, 0.0, 1.0),
    # early-stop time management: off/on/fast/keep
    "timemanage": Opt("off"),
    # time-management extras and the opening book (--book)
    "lag_buffer": Opt(0.0, 0.0, 60.0),
    "kldgain_per_node": Opt(0.0, 0.0, 100.0),
    "kldgain_interval": Opt(0, 0, 1 << 30),
    "book_file": Opt(""),
    # NN eval cache sets (the reference sizes its cache in MiB,
    # --cache-memory-mib; here the unit is entries because the store is
    # dense device tensors). 0 disables. --cache-memory-mib / --no-cache
    # convert into this at parse time.
    "nn_cache_size": Opt(512, 0, 1 << 20),
    "cache_memory_mib": Opt(0, 0, 1 << 20),
    # canonical-symmetry cache keys for opening positions
    "early_symm_cache": Opt(False),
    # root symmetry pruning in the opening
    "symm_pruning": Opt(False),
    # legacy pattern system
    "patterns_file": Opt(""),
    "gammas_policy_factor": Opt(0.0, 0.0, 1.0),
    # MC-rollout ownership fallback
    "use_rollout": Opt(False),
    # endgame score bonus
    "first_pass_bonus": Opt(False),
    # search knobs
    "cpuct_init": Opt(0.5),
    "cpuct_base": Opt(19652.0),
    "cpuct_base_factor": Opt(1.0),
    "cpuct_dynamic": Opt(True),
    "cpuct_dynamic_k_factor": Opt(4.0),
    "cpuct_dynamic_k_base": Opt(10000.0),
    "fpu_reduction": Opt(0.25),
    "root_fpu_reduction": Opt(0.25),
    "score_utility_factor": Opt(0.4),
    "score_utility_div": Opt(1.0),
    "lcb_reduction": Opt(0.02, 0.0, 1.0),
    "forced_playouts_k": Opt(0.0),
    "gumbel": Opt(False),
    "gumbel_c_visit": Opt(50.0),
    "gumbel_c_scale": Opt(1.0),
    "gumbel_considered_moves": Opt(16),
    "gumbel_prom_visits": Opt(1, 1, 1 << 20),
    "gumbel_playouts_threshold": Opt(400, 1, 1 << 30),
    "always_completed_q_policy": Opt(False),
    "ci_alpha": Opt(1e-5, 0.0, 1.0),
    # policy softmax temperatures (the root temp follows policy_temp
    # unless set explicitly; < 0 = follow)
    "policy_temp": Opt(1.0, 0.0, 100.0),
    "root_policy_temp": Opt(-1.0, -1.0, 100.0),
    # remove pass from expansion candidates while more than
    # (1 - factor) * intersections legal moves remain
    "suppress_pass_factor": Opt(0.1667, 0.0, 1.0),
    # wl from the net's stm-winrate head instead of (w-l+1)/2
    "use_stm_winrate": Opt(False),
    # search policy from the optimistic policy head at non-root nodes
    "use_optimistic_policy": Opt(False),
    "dirichlet_noise": Opt(False),
    "dirichlet_epsilon": Opt(0.25),
    "dirichlet_init": Opt(0.03),
    "dirichlet_factor": Opt(361.0),
    # selfplay
    "selfplay_query": Opt("", multi=True),
    "num_games": Opt(0, 0, 10000000),
    "parallel_games": Opt(32, 1, 4096),
    "random_moves_factor": Opt(0.0),
    "random_moves_temp": Opt(1.0, 0.0, 100.0),
    "random_fastsearch_prob": Opt(0.0, 0.0, 1.0),
    "random_min_ratio": Opt(0.0, 0.0, 1.0),
    "random_min_visits": Opt(1, 0, 1 << 30),
    "random_opening_prob": Opt(-1.0, -1.0, 1.0),
    "random_opening_temp": Opt(1.2, 0.0, 100.0),
    "komi_stddev": Opt(0.0),
    "komi_big_stddev": Opt(0.0),
    "komi_big_stddev_prob": Opt(0.0, 0.0, 1.0),
    "handicap_fair_komi_prob": Opt(0.0, 0.0, 1.0),
    "fastsearch_playouts": Opt(0),
    "fastsearch_playouts_prob": Opt(0.0, 0.0, 1.0),
    "resign_playouts": Opt(0),
    "resign_discard_prob": Opt(0.0, 0.0, 1.0),
    "target_directory": Opt(""),
    # benchmark
    "benchmark_query": Opt("", multi=True),
    # misc front-end
    "kgs_hint": Opt(""),          # appended to the version string
    "logfile": Opt(""),           # tee GTP protocol I/O to a file
    "fixed_nn_boardsize": Opt(0, 0, 25),
    # reference CLI flags that the JAX package accepts and ignores (device
    # lists, host threading, fp16/winograd kernel selection, virtual loss);
    # the port parses them and its selfplay mode refuses them
    "gpu": Opt(0, 0, 1024, multi=True),
    "gpu_waittime": Opt(0, 0, 1 << 30),
    "threads": Opt(0, 0, 4096),
    "no_fp16": Opt(False),
    "no_winograd": Opt(False),
    "virtual_loss_count": Opt(1, 0, 1 << 20),
}

# reference CLI spellings that differ from the option name
_ALIASES = {
    "book": "book_file",
    "patterns": "patterns_file",
    "weights": "weights_file",
    "board_size": "boardsize",
    "noise": "dirichlet_noise",
    "reduce_playouts": "fastsearch_playouts",
    "reduce_playouts_prob": "fastsearch_playouts_prob",
}


# what the selfplay mode reads: the search and self-play fields and the
# pipe's arguments (the reference's compatibility no-ops raise there too:
# --no-fp16, for one, would change what the port computes)
SELFPLAY_OPTIONS = frozenset({
    "mode", "boardsize", "komi", "playouts", "weights_dir",
    "resign_threshold", "nn_cache_size", "cache_memory_mib",
    "cpuct_init", "cpuct_base", "cpuct_base_factor", "cpuct_dynamic",
    "cpuct_dynamic_k_factor", "cpuct_dynamic_k_base", "fpu_reduction",
    "root_fpu_reduction", "score_utility_factor", "score_utility_div",
    "lcb_reduction", "forced_playouts_k", "gumbel", "gumbel_c_visit",
    "gumbel_c_scale", "gumbel_considered_moves", "gumbel_prom_visits",
    "gumbel_playouts_threshold", "ci_alpha", "dirichlet_noise",
    "dirichlet_epsilon", "dirichlet_init", "dirichlet_factor",
    "selfplay_query", "num_games", "parallel_games", "random_moves_factor",
    "random_moves_temp", "random_fastsearch_prob", "random_min_ratio",
    "random_min_visits", "random_opening_prob", "random_opening_temp",
    "komi_stddev", "komi_big_stddev", "komi_big_stddev_prob",
    "handicap_fair_komi_prob", "fastsearch_playouts", "fastsearch_playouts_prob",
    "resign_playouts", "resign_discard_prob", "target_directory", "first_pass_bonus",
})


# the search fields the gtp and benchmark modes read
_SEARCH_OPTIONS = frozenset({
    "nn_cache_size", "cache_memory_mib", "cpuct_init", "cpuct_base",
    "cpuct_base_factor", "cpuct_dynamic", "cpuct_dynamic_k_factor",
    "cpuct_dynamic_k_base", "fpu_reduction", "root_fpu_reduction",
    "score_utility_factor", "score_utility_div", "lcb_reduction",
    "forced_playouts_k", "gumbel", "gumbel_c_visit", "gumbel_c_scale",
    "gumbel_considered_moves", "gumbel_prom_visits", "gumbel_playouts_threshold",
    "ci_alpha", "dirichlet_noise", "dirichlet_epsilon", "dirichlet_init",
    "dirichlet_factor", "first_pass_bonus",
})
# what the gtp mode reads: the search fields, the Agent's and the loop's
# arguments (the pattern gammas wait for their port)
GTP_OPTIONS = _SEARCH_OPTIONS | {
    "mode", "boardsize", "komi", "playouts", "weights_file", "use_rollout",
    "ponder", "ponder_factor", "kldgain_per_node", "kldgain_interval",
    "policy_temp", "root_policy_temp", "suppress_pass_factor", "use_stm_winrate",
    "use_optimistic_policy", "timemanage", "symm_pruning", "friendly_pass",
    "capture_all_dead", "reuse_tree", "book_file", "const_time", "lag_buffer",
    "resign_threshold", "kgs_hint", "logfile",
}
# what the benchmark mode reads
BENCHMARK_OPTIONS = _SEARCH_OPTIONS | {
    "mode", "boardsize", "komi", "playouts", "weights_file", "benchmark_query",
}
# flags that need the pattern-gammas port
_GAMMAS_OPTIONS = ("patterns_file", "gammas_policy_factor")


class Options:
    def __init__(self):
        self._vals: dict[str, Any] = {}
        self._given: set[str] = set()
        for k, o in OPTIONS.items():
            self._vals[k] = list() if o.multi else o.default

    def get(self, name):
        if name == "nn_cache_size" and self._vals["cache_memory_mib"] > 0:
            # --cache-memory-mib converted to entries: one entry holds
            # priors [A] + ownership [n*n] f32 + a few scalars
            n = self._vals["boardsize"]
            entry_bytes = (2 * n * n + 16) * 4
            return max(1, (self._vals["cache_memory_mib"] << 20) // entry_bytes)
        return self._vals[name]

    def print_help(self):
        print("Options (reference CLI spellings):")
        for k, o in sorted(OPTIONS.items()):
            print(f"  --{k.replace('_', '-')} (default {o.default!r})")

    def set(self, name, value):
        o = OPTIONS[name]
        ref = o.default
        if name == "timemanage" and value not in ("off", "on", "fast", "keep"):
            raise ValueError("--timemanage takes off|on|fast|keep")
        if isinstance(ref, bool):
            if isinstance(value, str):
                value = value.lower() in ("1", "true", "yes", "on")
        elif isinstance(ref, int):
            value = int(value)
        elif isinstance(ref, float):
            value = float(value)
        if o.lo is not None and not isinstance(ref, str):
            value = max(o.lo, min(o.hi, value))
        self._given.add(name)
        if o.multi:
            self._vals[name].append(value)
        else:
            self._vals[name] = value

    def parse_args(self, argv):
        """Parse `--flag [value]` pairs; `--config FILE` loads more flags
        in the same syntax."""
        i = 0
        while i < len(argv):
            tok = argv[i]
            if not tok.startswith("--"):
                raise ValueError(f"unexpected token {tok!r}")
            name = tok[2:].replace("-", "_")
            name = _ALIASES.get(name, name)
            if name == "config":
                self.parse_file(argv[i + 1])
                i += 2
                continue
            if name == "help":
                self.print_help()
                raise SystemExit(0)
            if name == "no_cache":
                self._vals["nn_cache_size"] = 0
                self._vals["cache_memory_mib"] = 0
                self._given.update(("nn_cache_size", "cache_memory_mib"))
                i += 1
                continue
            # --no-X negates a boolean option X
            if (name.startswith("no_") and name not in OPTIONS and name[3:] in OPTIONS
                    and isinstance(OPTIONS[name[3:]].default, bool)):
                self._vals[name[3:]] = False
                self._given.add(name[3:])
                i += 1
                continue
            if name not in OPTIONS:
                raise ValueError(f"unknown option --{tok[2:]}")
            o = OPTIONS[name]
            if isinstance(o.default, bool) and (
                i + 1 >= len(argv) or argv[i + 1].startswith("--")
            ):
                self._vals[name] = True
                self._given.add(name)
                i += 1
            else:
                self.set(name, argv[i + 1])
                i += 2
        return self

    def parse_file(self, path):
        with open(path) as f:
            toks = []
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    toks.extend(shlex.split(line))
        self.parse_args(toks)
        return self

    def _check_flags(self, mode, reads):
        unsupported = sorted(self._given - reads)
        if unsupported:
            flags = ", ".join("--" + k.replace("_", "-") for k in unsupported)
            gammas = [f for f in _GAMMAS_OPTIONS if f in unsupported]
            why = (" (" + ", ".join("--" + k.replace("_", "-") for k in gammas)
                   + " wait for the pattern-gammas port)") if gammas else ""
            raise ValueError(f"--mode {mode}: not supported by the PyTorch port yet: "
                             f"{flags}{why}")

    def check_selfplay_flags(self):
        """Raise ValueError naming every given option the selfplay mode
        does not read."""
        self._check_flags("selfplay", SELFPLAY_OPTIONS)

    def check_gtp_flags(self):
        """Raise ValueError naming every given option the gtp mode does not
        read (--patterns and --gammas-policy-factor among them, until the
        pattern gammas are ported)."""
        self._check_flags("gtp", GTP_OPTIONS)

    def check_benchmark_flags(self):
        """Raise ValueError naming every given option the benchmark mode
        does not read."""
        self._check_flags("benchmark", BENCHMARK_OPTIONS)

    def search_config(self, max_nodes=None, **over):
        from sayuri_tpu_torch.mcts.core import SearchConfig

        g = self.get
        return SearchConfig(
            max_nodes=max_nodes or (g("playouts") + 32),
            cpuct_init=g("cpuct_init"),
            cpuct_base=g("cpuct_base"),
            cpuct_base_factor=g("cpuct_base_factor"),
            cpuct_dynamic=g("cpuct_dynamic"),
            cpuct_dynamic_k_factor=g("cpuct_dynamic_k_factor"),
            cpuct_dynamic_k_base=g("cpuct_dynamic_k_base"),
            fpu_reduction=g("fpu_reduction"),
            root_fpu_reduction=g("root_fpu_reduction"),
            score_utility_factor=g("score_utility_factor"),
            score_utility_div=g("score_utility_div"),
            lcb_reduction=g("lcb_reduction"),
            forced_playouts_k=g("forced_playouts_k"),
            gumbel=g("gumbel"),
            gumbel_c_visit=g("gumbel_c_visit"),
            gumbel_c_scale=g("gumbel_c_scale"),
            gumbel_considered_moves=g("gumbel_considered_moves"),
            gumbel_prom_visits=g("gumbel_prom_visits"),
            gumbel_playouts_threshold=g("gumbel_playouts_threshold"),
            ci_alpha=g("ci_alpha"),
            dirichlet_noise=g("dirichlet_noise"),
            dirichlet_epsilon=g("dirichlet_epsilon"),
            dirichlet_init=g("dirichlet_init"),
            dirichlet_factor=g("dirichlet_factor"),
            nn_cache_size=g("nn_cache_size"),
            first_pass_bonus=g("first_pass_bonus"),
            **over,
        )

    def selfplay_config(self):
        from sayuri_tpu_torch.selfplay.actor import SelfplayConfig

        g = self.get
        return SelfplayConfig(
            playouts=g("playouts"),
            fastsearch_playouts=g("fastsearch_playouts"),
            fastsearch_playouts_prob=g("fastsearch_playouts_prob"),
            resign_threshold=g("resign_threshold"),
            resign_playouts=g("resign_playouts"),
            resign_discard_prob=g("resign_discard_prob"),
            random_moves_factor=g("random_moves_factor"),
            random_moves_temp=g("random_moves_temp"),
            random_fastsearch_prob=g("random_fastsearch_prob"),
            random_min_ratio=g("random_min_ratio"),
            random_min_visits=g("random_min_visits"),
            random_opening_prob=g("random_opening_prob"),
            random_opening_temp=g("random_opening_temp"),
            komi_stddev=g("komi_stddev"),
            komi_big_stddev=g("komi_big_stddev"),
            komi_big_stddev_prob=g("komi_big_stddev_prob"),
        )
