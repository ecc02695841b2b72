"""The port's NN evaluation cache (mcts/nncache.py) against the JAX
package's: the cache keys (two 32-bit words) equal, also for two positions
that transpose into one (their history planes differ, the keys do not);
the same probe and insert sequence on a small 2-way cache gives the same
hits, gathered outputs and cache contents after every insert (duplicate
lanes of one insert resolve alike); and two searches through one cache
(a uniform evaluator on both sides) give the same queries / hits / dups
counters, tree and cache contents. Floats within 1e-5 (+ 1e-6 relative in
the tree); everything else exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.game.state import GoEnv as JEnv
from sayuri_tpu.mcts import nncache as JNC
from sayuri_tpu.mcts.core import MCTS as JMCTS, NetEvals as JNetEvals
from sayuri_tpu.mcts.core import SearchConfig as JConfig
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.mcts import nncache as TNC
from sayuri_tpu_torch.mcts.core import MCTS, NetEvals, SearchConfig
from test_torch_board import jax_to_torch, random_jax_states
from torch_draws import assert_trees_equal, one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 9


def test_state_keys_match_jax():
    _, js, _ = random_jax_states(n=N, b=8, moves=30, seed=2)
    rng = np.random.RandomState(0)
    js = js.replace(
        ko=jnp.asarray(rng.randint(-1, N * N, 8).astype(np.int32)),
        komi=jnp.asarray(rng.choice([-7.5, -0.5, 0.0, 5.5, 7.5, 150.0], 8).astype(np.float32)),
        rule=jnp.asarray(rng.randint(0, 2, 8).astype(np.int32)),
        size=jnp.asarray(rng.choice([7, 9], 8).astype(np.int32)),
    )
    want = np.asarray(JNC.state_keys(js)).astype(np.int64)
    got = TNC.state_keys(jax_to_torch(js)).numpy()
    np.testing.assert_array_equal(want, got)
    assert len({tuple(k) for k in got.tolist()}) == 8


def test_transposed_positions_share_a_key():
    """b C3, w D4, b E5, w F6 and b E5, w D4, b C3, w F6: one board, other
    history planes, one key."""
    jenv, env = JEnv(n=N), GoEnv(n=N)
    orders = [(20, 30, 40, 50), (40, 30, 20, 50)]
    js = jenv.new_batch(2)
    ts = env.new_batch(2, device="cpu")
    for t in range(4):
        acts = np.array([o[t] for o in orders], np.int32)
        js = jax.vmap(jenv.step)(js, jnp.asarray(acts))
        ts = env.step(ts, torch.from_numpy(acts))
    assert torch.equal(ts.stones[0], ts.stones[1])
    assert not torch.equal(ts.history[0], ts.history[1])
    want = np.asarray(JNC.state_keys(js)).astype(np.int64)
    got = TNC.state_keys(ts).numpy()
    np.testing.assert_array_equal(want, got)
    assert (got[0] == got[1]).all()


def _evals(mod, rng, b, a, hw):
    x = [rng.rand(b, a), rng.rand(b), rng.rand(b), rng.randn(b), rng.randn(b, hw)]
    x = [v.astype(np.float32) for v in x]
    if mod == "jax":
        return JNetEvals(*(jnp.asarray(v) for v in x))
    return NetEvals(*(torch.from_numpy(v) for v in x))


CACHE_FIELDS = ("keys", "valid", "age", "tick", "priors", "wl", "draw", "score", "ownership")


def test_probe_and_insert_sequence_matches_jax():
    b, sets, a, hw = 6, 3, 10, 9
    jc = JNC.make_cache(b, sets, a, hw)
    tc = TNC.make_cache(b, sets, a, hw, device="cpu")
    rng = np.random.RandomState(4)
    pool = rng.randint(0, 2**32, size=(7, 2), dtype=np.uint64).astype(np.int64)
    hits = 0
    for step in range(14):
        keys = pool[rng.randint(0, len(pool), b)]
        mask = rng.rand(b) < 0.7
        jk = jnp.asarray(keys.astype(np.uint32))
        tk = torch.from_numpy(keys)
        jhit, jvals, jaux = JNC.probe(jc, jk)
        thit, tvals, taux = TNC.probe(tc, tk)
        np.testing.assert_array_equal(np.asarray(jhit), thit.numpy(), err_msg=f"step {step}")
        for w, g in zip(jvals, tvals):
            np.testing.assert_array_equal(np.asarray(w)[np.asarray(jhit)],
                                          g.numpy()[thit.numpy()])
        hits += int(thit.sum())
        seed = rng.randint(1 << 30)
        jc = JNC.insert(jc, jk, _evals("jax", np.random.RandomState(seed), b, a, hw),
                        jnp.asarray(mask), jaux)
        tc = TNC.insert(tc, tk, _evals("torch", np.random.RandomState(seed), b, a, hw),
                        torch.from_numpy(mask), taux)
        for f in CACHE_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(jc, f)).astype(np.float64),
                                          getattr(tc, f).numpy().astype(np.float64),
                                          err_msg=f"step {step}: {f}")
    assert hits > 0 and bool(tc.valid.all())


def _uniform_eval(env, mod):
    """Uniform priors over the legal moves, an even value: the same
    evaluator in both packages (the counters, not the net, are under
    test)."""
    if mod == "jax":
        legal_fn = jax.vmap(env.legal_action_mask)

        def jfn(states, ctx=None):
            legal = legal_fn(states).astype(jnp.float32)
            b = legal.shape[0]
            z = jnp.zeros((b,))
            return JNetEvals(legal / legal.sum(-1, keepdims=True), z + 0.5, z, z,
                             jnp.zeros((b, env.n * env.n)))
        return jfn

    def tfn(states, ctx=None):
        legal = env.legal_action_mask(states).float()
        b = legal.shape[0]
        z = torch.zeros(b)
        return NetEvals(legal / legal.sum(-1, keepdim=True), z + 0.5, z, z,
                        torch.zeros((b, env.n * env.n)))
    return tfn


def test_search_counters_match_jax():
    """Two searches from the same roots through one cache (the second hits
    the first's entries); lanes 0 and 1 search the same position (in-batch
    duplicates)."""
    jenv, js, _ = random_jax_states(n=N, b=4, moves=10, seed=12, pass_prob=0.0)
    js = jax.tree.map(lambda x: x.at[1].set(x[0]), js)
    env = GoEnv(n=N)
    cfg = dict(max_nodes=20, max_depth=10, nn_cache_size=8)
    jm = JMCTS(jenv, _uniform_eval(jenv, "jax"), JConfig(**cfg))
    tm = MCTS(env, _uniform_eval(env, "torch"), SearchConfig(**cfg))
    sims = 10

    @jax.jit
    def jsearch(s):
        t1 = jm.run(jm.init_tree(s, jax.random.PRNGKey(0)), sims)
        return jm.run(jm.init_tree(s, jax.random.PRNGKey(0), cache=t1.cache), sims)

    jtree = jsearch(js)
    ts = jax_to_torch(js)
    t1 = tm.run(tm.init_tree(ts), sims)
    tree = tm.run(tm.init_tree(ts, cache=t1.cache), sims)
    for f in ("queries", "hits", "dups"):
        np.testing.assert_array_equal(np.asarray(getattr(jtree.cache, f)),
                                      getattr(tree.cache, f).numpy(), err_msg=f)
    assert int(tree.cache.dups.sum()) > 0 and int(tree.cache.hits.sum()) > 0
    assert tree.cache.queries.tolist() == [2 * (sims + 1)] * 4
    assert_trees_equal(jtree, tree, 1e-5, "cached search")
    for f in CACHE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jtree.cache, f)).astype(np.float64),
                                      getattr(tree.cache, f).numpy().astype(np.float64),
                                      err_msg=f)
