"""The port's device gammas (pattern/gammas_device.py) against the JAX
package's gammas_jax.py and its host GammasDict, on the CPU at 7x7:

- spatial keys equal JAX's spatial_keys_batch at dist 3 and the host
  pattern_key at dist 1, 2 and 3 (a lane of a smaller board in the buffer
  included);
- gammas_policy_device equals JAX's at dist 3 and the host
  GammasDict.policy at dist 1, 2 and 3, within 2e-5 relative (the bound of
  the JAX package's own test_policy_matches_host);
- at dist 2, JAX's DeviceGammas finds few of a table's keys (its keys are
  split as if they had 24 digits), the port's lookup finds every one;
- make_eval_fn(gammas=) equals JAX's on weights carried across (f32,
  priors within 1e-5), and apply_to_evals equals JAX's on the same
  injected evals for the weightless path (libs_map_batch equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.models import evaluator as JEV
from sayuri_tpu.pattern import gammas_jax as JGJ
from sayuri_tpu.pattern import pattern as JP
from sayuri_tpu.pattern.gammas import GammasDict as JGammasDict
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.mcts.core import NetEvals
from sayuri_tpu_torch.models.evaluator import make_eval_fn
from sayuri_tpu_torch.ops import analysis as TA
from sayuri_tpu_torch.pattern import gammas_device as GD
from sayuri_tpu_torch.pattern.gammas import GammasDict
from test_torch_board import jax_to_torch, random_jax_states
from test_torch_network import seeded_variables
from torch_draws import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, B = 7, 5
RTOL = 2e-5


@pytest.fixture(scope="module")
def states():
    """(JAX env, JAX states, port states): B random 7x7 positions; the last
    lane holds a 6x6 board in the 7x7 buffer (its moves stay on it)."""
    jenv, js, _ = random_jax_states(n=N, b=B, moves=16, seed=3, pass_prob=0.0)
    ts = jax_to_torch(js)
    stones = ts.stones.clone()
    stones[-1, 6, :] = 0
    stones[-1, :, 6] = 0
    size = ts.size.clone()
    size[-1] = 6
    last = ts.last_moves.clone()
    last[-1, 0] = 2 * N + 3                    # a point of the 6x6 board
    ts = ts.replace(stones=stones, size=size, last_moves=last)
    js = js.replace(stones=jnp.asarray(stones.numpy()), size=jnp.asarray(size.numpy()),
                    last_moves=jnp.asarray(last.numpy()))
    return jenv, js, ts


def host_boards(ts):
    """[(board cropped to its size, size, to_move, last move or None)]."""
    out = []
    for b in range(ts.stones.shape[0]):
        s = int(ts.size[b])
        last = int(ts.last_moves[b, 0])
        if last >= 0:
            last = (last // N) * s + last % N
        out.append((ts.stones[b, :s, :s].numpy(), s, int(ts.to_move[b]),
                    last if last >= 0 else None))
    return out


def make_dict(ts, dist, seed=1):
    """A dict holding real keys of these boards and every tactical."""
    rng = np.random.RandomState(seed)
    table = {}
    for board, s, tm, _ in host_boards(ts):
        for v in rng.choice(s * s, size=20, replace=False):
            table[str(JP.pattern_key(board, s, int(v), tm, dist))] = float(rng.uniform(0.2, 5.0))
    for d in range(1, 5):
        table[f"dist_last:{d}"] = float(rng.uniform(0.5, 3.0))
    for f in GD._TACT4:
        table[f] = float(rng.uniform(0.5, 3.0))
    return table


def test_spatial_keys_match_jax_dist3(states):
    _, js, ts = states
    hi, lo = jax.jit(JGJ.spatial_keys_batch, static_argnums=3)(js.stones, js.size,
                                                              js.to_move, 3)
    want = (np.asarray(hi).astype(np.int64) << 28) | np.asarray(lo).astype(np.int64)
    got = GD.spatial_keys_batch(ts.stones, ts.size, ts.to_move, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dist", [1, 2, 3])
def test_spatial_keys_match_host(states, dist):
    _, _, ts = states
    got = GD.spatial_keys_batch(ts.stones, ts.size, ts.to_move, dist).numpy()
    for b, (board, s, tm, _) in enumerate(host_boards(ts)):
        want = [JP.pattern_key(board, s, v, tm, dist) for v in range(s * s)]
        np.testing.assert_array_equal(got[b, :s, :s].reshape(-1), want, err_msg=str(b))


def _policy_inputs(ts, seed=7):
    """Legality, the analysis' liberty map (the evaluator's; it keeps to
    each board's size) and a seeded ownership."""
    env = GoEnv(n=N)
    legal = env.legal_action_mask(ts)[:, :N * N]
    libs = TA.board_analysis(ts.stones, ts.size, ts.ko, ts.to_move)["libs"]
    own = torch.from_numpy(np.random.RandomState(seed).uniform(-1, 1, (B, N * N))
                           .astype(np.float32))
    return legal, libs, own


def test_policy_matches_jax_device(states):
    _, js, ts = states
    gd = GammasDict(make_dict(ts, 3), 3)
    legal, libs, own = _policy_inputs(ts)
    jdev = JGJ.DeviceGammas.compile(JGammasDict(gd.table, 3))
    want = jax.jit(JGJ.gammas_policy_device)(
        jdev, js.stones, js.size, js.to_move, jnp.asarray(legal.numpy()),
        js.last_moves[:, 0], jnp.asarray(libs.numpy()), ownership=jnp.asarray(own.numpy()))
    got = GD.gammas_policy_device(GD.DeviceGammas.compile(gd, device="cpu"), ts.stones,
                                  ts.size, ts.to_move, legal, ts.last_moves[:, 0], libs,
                                  ownership=own)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("dist", [1, 2, 3])
def test_policy_matches_host(states, dist):
    _, _, ts = states
    table = make_dict(ts, dist, seed=dist)
    dev = GD.DeviceGammas.compile(GammasDict(table, dist), device="cpu")
    legal, libs, own = _policy_inputs(ts, seed=dist)
    got = GD.gammas_policy_device(dev, ts.stones, ts.size, ts.to_move, legal,
                                  ts.last_moves[:, 0], libs, ownership=own).numpy()
    host = JGammasDict(table, dist)
    for b, (board, s, tm, last) in enumerate(host_boards(ts)):
        cells = (np.arange(s)[:, None] * N + np.arange(s)[None, :]).reshape(-1)
        want = host.policy(board, s, tm, legal[b].numpy()[cells], last_move=last,
                           ownership=own[b].numpy()[cells])
        np.testing.assert_allclose(got[b, cells], want[:s * s], rtol=RTOL, atol=1e-7,
                                   err_msg=str(b))
        assert got[b].sum() == pytest.approx(1.0, abs=1e-5)


def test_jax_device_lookup_misses_at_dist2(states):
    """The JAX package's device table splits every key as if it had 24
    digits: at dist 2 the (hi, lo) lanes of its table and of its probe
    keys differ, so most lookups miss (gamma 1.0). The port's lookup
    returns the table's gamma for every key."""
    _, js, ts = states
    keys = GD.spatial_keys_batch(ts.stones, ts.size, ts.to_move, 2)
    rng = np.random.RandomState(4)
    table = {str(k): float(rng.uniform(2.0, 5.0)) for k in sorted(set(keys.reshape(-1).tolist()))}
    want = np.vectorize(lambda k: table[str(k)])(keys.numpy()).astype(np.float32)
    got = GD.DeviceGammas.compile(GammasDict(table, 2), device="cpu").lookup(keys)
    np.testing.assert_array_equal(got.numpy(), want)

    jdev = JGJ.DeviceGammas.compile(JGammasDict(table, 2))
    hi, lo = jax.jit(JGJ.spatial_keys_batch, static_argnums=3)(js.stones, js.size,
                                                              js.to_move, 2)
    jgot = np.asarray(jax.jit(jdev.lookup)(hi, lo))
    found = float(np.mean(jgot == want))
    # every gamma of the table is >= 2, so a miss (1.0) never equals it
    assert found < 0.5, found
    print(f"JAX device gammas at dist 2 found {found:.1%} of the table's keys; the port 100%")


@pytest.fixture(scope="module")
def nets():
    net, variables, tnet = seeded_variables(n=N, seed=4)
    return net, variables, tnet


def test_eval_fn_gammas_matches_jax(states, nets):
    """On the lanes whose board fills the buffer: on the CPU the JAX
    evaluator has no analysis kernel and reads libs_map_batch's liberty
    map, which counts the empty cells beyond a smaller board as
    liberties; the port's evaluator reads the analysis' map, as the JAX
    evaluator does on its kernel path."""
    jenv, js, ts = states
    js, ts = jax.tree.map(lambda x: x[:-1], js), ts.map(lambda x: x[:-1])
    net, variables, tnet = nets
    gd = GammasDict(make_dict(ts, 3, seed=11), 3)
    f = 0.37
    jdev = JGJ.DeviceGammas.compile(JGammasDict(gd.table, 3))
    want = jax.jit(JEV.make_eval_fn(jenv, net, variables, symmetry=0, ladder_mode="off",
                                    gammas=(jdev, f)))(js)
    plain = make_eval_fn(GoEnv(n=N), tnet, symmetry=0, ladder_mode="off")(ts)
    got = make_eval_fn(GoEnv(n=N), tnet, symmetry=0, ladder_mode="off",
                       gammas=(GD.DeviceGammas.compile(gd, device="cpu"), f))(ts)
    for k in NetEvals._fields:
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   atol=1e-5, rtol=0, err_msg=k)
    assert not torch.allclose(got.priors, plain.priors)
    np.testing.assert_array_equal(got.black_wl.numpy(), plain.black_wl.numpy())


def test_apply_to_evals_weightless_matches_jax(states):
    jenv, js, ts = states
    gd = GammasDict(make_dict(ts, 3, seed=12), 3)
    libs = GD.libs_map_batch(ts.stones)
    np.testing.assert_array_equal(libs.numpy(),
                                  np.asarray(jax.jit(JGJ.libs_map_batch)(js.stones)))
    env = GoEnv(n=N)
    legal = env.legal_action_mask(ts)
    rng = np.random.RandomState(13)
    pri = rng.uniform(0.1, 1.0, (B, N * N + 1)).astype(np.float32) * legal.numpy()
    pri /= pri.sum(-1, keepdims=True)
    own = rng.uniform(-1, 1, (B, N * N)).astype(np.float32)
    z = np.zeros(B, np.float32)
    tev = NetEvals(priors=torch.from_numpy(pri), black_wl=torch.from_numpy(z + 0.5),
                   draw=torch.from_numpy(z), black_score=torch.from_numpy(z),
                   black_ownership=torch.from_numpy(own))
    jev = JEV.NetEvals(*(jnp.asarray(x.numpy()) for x in tev))
    f = 0.6
    jdev = JGJ.DeviceGammas.compile(JGammasDict(gd.table, 3))
    jlegal = jax.jit(jax.vmap(jenv.legal_action_mask))(js)
    want = jax.jit(lambda s, e, l: JGJ.apply_to_evals(jdev, f, s, e, l))(js, jev, jlegal)
    wrapped = GD.wrap_eval_with_gammas(env, lambda s, ctx=None: tev,
                                       GD.DeviceGammas.compile(gd, device="cpu"), f)
    got = wrapped(ts)
    np.testing.assert_allclose(got.priors.numpy(), np.asarray(want.priors), atol=1e-6,
                               rtol=RTOL)
    np.testing.assert_array_equal(got.black_ownership.numpy(), own)


def test_compile_refuses_dist_4():
    with pytest.raises(ValueError, match="dist <= 3"):
        GD.DeviceGammas.compile(GammasDict({}, 4), device="cpu")
    empty = GD.DeviceGammas.compile(GammasDict({}, 3), device="cpu")
    assert (empty.lookup(torch.tensor([[5, 7]])) == 1.0).all()
