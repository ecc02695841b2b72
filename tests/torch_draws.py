"""Shared by the test_torch_* search and self-play files: the same random
draws injected into both packages' searches, a tree comparison, and a
fixture that runs the port's CPU work on one thread.

The JAX package folds threefry keys by simulation index, the port draws
from a torch.Generator, so their Gumbel and Dirichlet numbers differ. The
tests replace `_selection_gumbel` and `MCTS._sample_dirichlet` on both
sides with lookups into one numpy table:
the selection noise of lane b at simulation s of the search from a root at
move m is table[m, s, b] (s = the table's last row for the final move
pick).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.mcts import core as JC
from sayuri_tpu.mcts import gumbel as JG
from sayuri_tpu_torch.mcts import core as TC
from sayuri_tpu_torch.mcts import gumbel as TG


@pytest.fixture(scope="module")
def one_torch_thread():
    """The port's CPU work on one thread for a module's tests: its many
    small tensors gain nothing from more, and the suite runs several
    workers on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Draws:
    def __init__(self, moves, sims, b, a, seed=0):
        rng = np.random.RandomState(seed)
        self.sims = sims
        self.table = rng.gumbel(size=(moves, sims + 1, b, a)).astype(np.float32)
        w = rng.uniform(0.1, 1.0, size=(b, a)).astype(np.float32)
        self.dirichlet = w
        self.j_table, self.t_table = jnp.asarray(self.table), torch.from_numpy(self.table)

    # ---- the JAX side ----
    def j_selection(self, mcts, tree, sim_idx):
        s = self.sims if sim_idx is None else sim_idx
        m = tree.states.move_count[:, 0]
        return self.j_table[m, s, jnp.arange(m.shape[0])]

    def j_dirichlet(self, mcts, rng, priors):
        if not mcts.cfg.dirichlet_noise:
            return jnp.zeros_like(priors)
        g = jnp.where(priors > 0, jnp.asarray(self.dirichlet), 0.0)
        return g / jnp.maximum(jnp.sum(g, axis=-1, keepdims=True), 1e-12)

    # ---- the port ----
    def t_selection(self, mcts, tree, sim_idx):
        s = self.sims if sim_idx is None else sim_idx
        m = tree.states.move_count[:, 0].long()
        return self.t_table[m, s, torch.arange(m.shape[0])]

    def t_dirichlet(self, mcts, gen, priors):
        if not mcts.cfg.dirichlet_noise:
            return torch.zeros_like(priors)
        g = torch.where(priors > 0, torch.from_numpy(self.dirichlet), 0.0)
        return g / g.sum(-1, keepdim=True).clamp(min=1e-12)

    def install(self, mp):
        """Patch both packages through a pytest MonkeyPatch."""
        mp.setattr(JG, "_selection_gumbel", self.j_selection)
        mp.setattr(JC.MCTS, "_sample_dirichlet", lambda m, r, p: self.j_dirichlet(m, r, p))
        mp.setattr(TG, "_selection_gumbel", self.t_selection)
        mp.setattr(TC.MCTS, "_sample_dirichlet", lambda m, g, p: self.t_dirichlet(m, g, p))


# the port's tree arrays (the JAX tree's parent_action, net_score, valid
# and root_gumbel are written there but read by nothing of the search or
# the actor at its default of fresh noise per selection)
TREE_ARRAYS = ("prior", "child", "parent", "stats", "terminal", "black_sb", "next_free",
               "root_noise", "root_ownership", "score_center", "use_noise", "use_gumbel")


def assert_trees_equal(jtree, ttree, atol=1e-5, tag="", rtol=1e-6):
    """Every tree array of the JAX tree equals the port's (its first N node
    rows; the port adds a scratch row): integers and bools exactly, floats
    within `atol` + `rtol` * |value| (the Welford and score sums reach
    ~1e2, where float32 rounding alone is ~1e-5); the per-node GoStates
    field by field. With an NN cache, the prior rows of terminal nodes are
    left out: the JAX cache's compacted forward may skip the lanes whose
    leaf is terminal (zeros there), the port's full-batch forward does not,
    and no search reads a terminal node's priors."""
    n_nodes = np.asarray(jtree.prior).shape[1]
    pairs = [(k, getattr(jtree, k), getattr(ttree, k)) for k in TREE_ARRAYS]
    if ttree.cache is not None:
        term = np.asarray(jtree.terminal)[..., None]
        tterm = ttree.terminal[:, :n_nodes, None]
        pairs[0] = ("prior", np.where(term, 0.0, np.asarray(jtree.prior)),
                    torch.where(tterm, 0.0, ttree.prior[:, :n_nodes]))
    jstates = jtree.states
    pairs += [(f"states.{k}", getattr(jstates, k), v)
              for k, v in ttree.states.fields().items()]
    for name, want, got in pairs:
        want = np.asarray(want)
        got = got.numpy()
        if got.ndim >= 2 and want.ndim >= 2 and got.shape[1] == n_nodes + 1:
            got = got[:, :n_nodes]
        assert want.shape == got.shape, (tag, name, want.shape, got.shape)
        if want.dtype.kind == "f":
            fin = np.isfinite(want)
            np.testing.assert_array_equal(fin, np.isfinite(got), err_msg=f"{tag}: {name}")
            np.testing.assert_allclose(np.where(fin, got, 0), np.where(fin, want, 0),
                                       atol=atol, rtol=rtol, err_msg=f"{tag}: {name}")
        else:
            np.testing.assert_array_equal(want.astype(np.int64), got.astype(np.int64),
                                          err_msg=f"{tag}: {name}")
