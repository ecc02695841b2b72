"""Constants for the batched Go engine (copied from sayuri_tpu.game.types).

Colors are 0/1 so ``opp = 1 - c``; cell contents are a separate small enum
so boards pack into int8; vertices are flat row-major indices with no
letterbox padding (off-board cells are handled with masks).
"""

# --- colors (players) ---
BLACK = 0
WHITE = 1

# --- cell contents (int8 board values) ---
EMPTY = 0
C_BLACK = 1  # stone of BLACK
C_WHITE = 2  # stone of WHITE


def stone_of(color):
    """Player color (0/1) -> cell content value (1/2)."""
    return color + 1


# --- actions ---
# Flat vertex v = y * size + x in [0, size*size); PASS is the extra action.
def pass_action(num_intersections: int) -> int:
    return num_intersections


PASS = -1          # sentinel used in "last move vertex" fields
NO_VERTEX = -1     # sentinel for "no ko", "no move"

# --- scoring rules ---
AREA_RULE = 0        # Tromp-Taylor / Chinese-like area scoring
TERRITORY_RULE = 1   # Japanese-like territory scoring

# --- limits ---
MAX_BOARD_SIZE = 19
DEFAULT_BOARD_SIZE = 19


def max_game_len(size: int) -> int:
    return 2 * size * size + 32
