"""GTP time management (a copy of sayuri_tpu.gtp.time_control, which is
pure Python).

The reference engine's TimeControl (time_control.cc, time_control.h):
absolute / japanese byo-yomi /
canadian time systems, thinking-time heuristic (Coulom's remaining-move
estimate, time_control.cc:318-345), lag buffer, japanese period
bookkeeping (TookTime, time_control.cc:84-125). Host-side pure Python —
the budget it produces feeds the playout loop.

The reference stores centiseconds; we keep float seconds (same math, no
4-byte overflow concerns in Python)."""

from __future__ import annotations

import time


class TimeControl:
    """Tracks both players' clocks (time_control.h:51-63).

    State per color: `maintime_left`, `byotime_left`, `stones_left`
    (canadian), `periods_left` (japanese), `in_byo`."""

    def __init__(self):
        self.lag_buffer = 0.0  # seconds (SetLagBuffer, config lag_buffer)
        self.time_settings(0, 0, 0, 0)

    # -- setup (TimeSettings, time_control.cc:18-51) ---------------------

    def time_settings(self, main_time, byo_time, byo_stones, byo_periods=0):
        """GTP time_settings is canadian (stones); kgs byoyomi passes
        periods. Mutually-exclusive validation follows the reference."""
        max_value = 248 * 24 * 60 * 60
        if main_time > max_value or byo_time > max_value:
            self.time_settings(0, 0, 0, 0)
            return
        self.main_time = max(float(main_time), 0.0)
        self.byo_time = float(byo_time)
        self.byo_stones = int(byo_stones)
        self.byo_periods = int(byo_periods)
        if (self.byo_stones <= 0 and self.byo_periods <= 0) or (
            self.byo_stones > 0 and self.byo_periods > 0
        ):
            self.byo_time = 0.0
            self.byo_periods = 0
        if self.byo_time <= 0 and self.byo_periods == 0:
            self.byo_stones = 0
        self.reset()

    def kgs_time_settings(self, system, main_time, byo_time, extra):
        """kgs-time_settings none|absolute|byoyomi|canadian (gtp.cc:427)."""
        system = system.lower()
        if system == "none":
            self.time_settings(0, 0, 0, 0)
        elif system == "absolute":
            self.time_settings(main_time, 0, 0, 0)
        elif system == "canadian":
            self.time_settings(main_time, byo_time, extra, 0)
        elif system == "byoyomi":
            self.time_settings(main_time, byo_time, 0, extra)

    def reset(self):
        self.maintime_left = [self.main_time, self.main_time]
        self.byotime_left = [self.byo_time, self.byo_time]
        self.stones_left = [self.byo_stones, self.byo_stones]
        self.periods_left = [self.byo_periods, self.byo_periods]
        self._check_in_byo()

    def _check_in_byo(self):
        self.in_byo = [self.maintime_left[0] <= 0, self.maintime_left[1] <= 0]

    # -- GTP updates (TimeLeft, time_control.cc:53-75) -------------------

    def time_left(self, color, seconds, stones):
        if seconds <= 0 and stones <= 0:
            # from pachi: some GTP clients send 0 0 at end of main time
            self.byotime_left[color] = self.byo_time
            self.stones_left[color] = self.byo_stones
            self.periods_left[color] = self.byo_periods
        elif stones <= 0:
            self.maintime_left[color] = float(seconds)
        else:
            self.maintime_left[color] = 0.0
            self.byotime_left[color] = float(seconds)
            if self.byo_periods:
                self.periods_left[color] = int(stones)
                self.stones_left[color] = 0
            elif self.byo_stones:
                self.periods_left[color] = 0
                self.stones_left[color] = int(stones)
        self._check_in_byo()

    # -- consumption (TookTime, time_control.cc:84-125) ------------------

    def took_time(self, color, seconds):
        if self.is_infinite():
            return
        remaining = float(seconds)
        if not self.in_byo[color]:
            if self.maintime_left[color] >= remaining:
                self.maintime_left[color] -= remaining
                remaining = 0.0
            else:
                remaining -= self.maintime_left[color]
                self.maintime_left[color] = 0.0
                self.in_byo[color] = True
        if self.in_byo[color] and remaining > 0:
            self.byotime_left[color] -= remaining
            if self.byo_periods:
                # japanese: overrunning a period spends it
                if self.byotime_left[color] < 0:
                    self.periods_left[color] -= 1
                if self.periods_left[color] > 0:
                    self.byotime_left[color] = self.byo_time
            elif self.byo_stones:
                self.stones_left[color] -= 1
                if self.stones_left[color] == 0:
                    if self.byotime_left[color] > 0:
                        self.byotime_left[color] = self.byo_time
                        self.stones_left[color] = self.byo_stones

    # back-compat alias (older loop code)
    consume = took_time

    # -- queries ----------------------------------------------------------

    def is_infinite(self, color=None):
        return (
            self.main_time == 0
            and self.byo_time == 0
            and self.byo_stones == 0
            and self.byo_periods == 0
        )

    @property
    def infinite(self):
        return self.is_infinite()

    def is_time_over(self, color):
        return (
            self.maintime_left[color] <= 0 and self.byotime_left[color] <= 0
        )

    def can_accumulate(self, color):
        """CanAccumulateTime (time_control.cc:262-288): false in japanese
        byo-yomi and on the last canadian stone."""
        if self.in_byo[color]:
            if self.byo_periods:
                return False
            if self.byo_stones and self.stones_left[color] == 1:
                return False
        return True

    def estimate_moves_expected(self, boardsize, move_num):
        """EstimateMovesExpected (time_control.cc:318-345): Coulom's
        remaining-move model with an opening surcharge."""
        num_intersections = boardsize * boardsize
        side_move_num = move_num // 2
        base_move_num = int(
            (0.8 * num_intersections + 1.75 * (boardsize - 9)) / 2
        )
        base_remaining = base_move_num - side_move_num
        opening_move_num = int(0.2 * num_intersections) // 2
        opening_factor = 2.5
        estimated = base_remaining + int(
            opening_factor * max(opening_move_num - side_move_num, 0)
        )
        return max(estimated, max(int(0.3 * base_move_num), 15))

    def thinking_time(self, color, board_size, move_num,
                      use_lag_buffer=True) -> float:
        """GetThinkingTime (time_control.cc:215-260)."""
        if self.is_infinite():
            return float("inf")
        if self.is_time_over(color):
            return 0.0
        time_remaining = 0.0
        moves_remaining = 0
        extra_time_per_move = 0.0
        if self.in_byo[color]:
            if self.byo_periods:
                extra_time_per_move = self.byo_time
            elif self.byo_stones:
                time_remaining = self.byotime_left[color]
                moves_remaining = self.stones_left[color]
        else:
            byo_extra = 0.0
            if self.byo_periods:
                byo_extra = self.byo_time * (self.periods_left[color] - 1)
                extra_time_per_move = self.byo_time
            elif self.byo_stones:
                byo_extra = self.byotime_left[color] / max(
                    self.stones_left[color], 1
                )
                extra_time_per_move = byo_extra
            moves_remaining = self.estimate_moves_expected(
                board_size, move_num
            )
            time_remaining = self.maintime_left[color] + byo_extra
        lag = self.lag_buffer if use_lag_buffer else 0.0
        base_time = max(time_remaining - lag, 0.0) / max(moves_remaining, 1)
        inc_time = max(extra_time_per_move - lag, 0.0)
        return base_time + inc_time

    def buffer_effect(self, color, boardsize, move_num) -> float:
        """GetBufferEffect (time_control.cc:205-213): how much the lag
        buffer shrank this move's budget (feeds the adaptive lag-buffer
        adjustment, search.cc:438-455)."""
        if self.is_infinite():
            return 0.0
        t1 = self.thinking_time(color, boardsize, move_num, True)
        t2 = self.thinking_time(color, boardsize, move_num, False)
        return max(t2 - t1, 0.0)

    def update_lag_buffer(self, thinking_time, buffer_effect, elapsed,
                          lag_buffer_floor=0.0):
        """Search::UpdateLagBuffer (search.cc:438-455): grow the lag
        buffer when a move overran its conservative budget."""
        conservative = thinking_time + max(
            0.75 * buffer_effect, buffer_effect - 1.0
        )
        if elapsed > conservative:
            diff = elapsed - conservative
            grown = self.lag_buffer + min(1.5 * diff, 1.0 + diff)
            self.lag_buffer = max(lag_buffer_floor, grown)

    def should_stop(self, color, start_time, budget) -> bool:
        return (time.monotonic() - start_time) >= budget

    # -- display (TimeStream, time_control.cc:156-202) --------------------

    def to_string(self) -> str:
        return " | ".join(
            self._stream_color(c, name)
            for c, name in ((0, "Black"), (1, "White"))
        )

    def _stream_color(self, color, name):
        def hms(rem):
            rem = int(rem)
            return f"{rem // 3600:2d}:{(rem % 3600) // 60:02d}:{rem % 60:02d}"

        out = f"{name} time: "
        if self.is_infinite():
            return out + "infinite"
        if not self.in_byo[color]:
            return out + hms(self.maintime_left[color])
        out += hms(max(self.byotime_left[color], 0.0))
        if self.byo_periods:
            out += f", Periods left: {self.periods_left[color]}"
        elif self.byo_stones:
            out += f", Stones left: {self.stones_left[color]}"
        return out
