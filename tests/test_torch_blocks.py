"""The block families and the RepLK policy head of the port's net against
the JAX package, from the JAX package's own initial parameters carried
over with ``from_flax_variables`` (biases, betas and gammas, the
depthwise convs' included, and the running statistics then redrawn from a
numpy seed, so that no mapping hides behind a zero or a one).

One JAX init of a net holding every family and the RepLK head gives the
variables of every case: a case is a one-block net (the block's variables
re-keyed as tower0) with the Normal head, or a residual block with the
RepLK head. One compiled JAX function returns, for every case, its
eval-mode heads, its train-mode heads and updated statistics (masked batch
renorm at rmax=2, dmax=1), the 11 loss parts and the gradients. 5x5
buffer holding 5x5, 4x4 and 3x3 boards, 16 channels, batch 4.

Bounds: heads within 1e-5 relative plus 1e-5 absolute, elementwise;
statistics within 1e-5 absolute; loss parts within 1e-5 relative; each
gradient within 1e-4 of its tensor's largest magnitude (as
test_torch_train_net.py). Then, on the net of every family: the port's v5
export byte-identical to the JAX export, the port's import of a JAX-exported
file against the JAX package's ``finalize_imported_variables`` net within
the head bound, a trainer step and its checkpoint; ``load_setting``
against the JAX one; a 5x5 search with a mixer + RepLK net against the JAX
MCTS (symmetry 0, no noise): the same root visits and best moves.
"""

import dataclasses
import functools
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sayuri_tpu.mcts.core import MCTS as JMCTS, SearchConfig as JConfig
from sayuri_tpu.models import evaluator as JEV
from sayuri_tpu.models import network as JN
from sayuri_tpu.models import weights_io as JW
from sayuri_tpu.train import loss as JL
from sayuri_tpu.train import setting as JS
from sayuri_tpu_torch.game.state import GoEnv
from sayuri_tpu_torch.mcts.core import MCTS, SearchConfig
from sayuri_tpu_torch.models import weights_io as TW
from sayuri_tpu_torch.models.evaluator import make_eval_fn
from sayuri_tpu_torch.models.network import NetConfig, SayuriNet
from sayuri_tpu_torch.train import loss as TL
from sayuri_tpu_torch.train import setting as TS
from sayuri_tpu_torch.train.pipeline import TrainConfig, Trainer
from test_torch_board import jax_to_torch, random_jax_states
from torch_draws import one_torch_thread  # noqa: F401 (fixture)
from torch_train_util import (assert_parts_close, assert_tensors_close, batch,
                              port_state, port_stats, to_numpy)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HEAD_TOL = 1e-5
STAT_TOL = 1e-5
GRAD_TOL = 1e-4
N = 5
SIZES = (5, 5, 4, 3)
# every family, each once; tower i of the net of every family
ALL = ("BottleneckBlock", "BottleneckBlock-SE", "NestedBottleneckBlock",
       "NestedBottleneckBlock-SE", "MixerBlock", "MixerBlockV2-SE", "ResidualBlock")
NET = dict(boardsize=N, residual_channels=16, policy_head_channels=8, value_head_channels=8,
           renorm_max_r=2.0, renorm_max_d=1.0)
# case -> (tower index in ALL, policy head)
CASES = {**{spec: (i, "Normal") for i, spec in enumerate(ALL[:6])},
         "RepLK": (ALL.index("ResidualBlock"), "RepLK")}


def configs(stack, head):
    kw = dict(NET, stack=tuple(stack), policy_head_type=head)
    return JN.NetConfig(**kw), NetConfig(**kw)


@functools.lru_cache
def all_variables():
    """numpy variables of the net of every family with the RepLK head: the
    JAX init's kernels, the rest redrawn from a numpy seed."""
    jcfg, _ = configs(ALL, "RepLK")
    dummy = jnp.zeros((1, N, N, 43)).at[..., -1].set(1.0)
    init = jax.jit(lambda key: JN.SayuriNet(jcfg).init(key, dummy, train=False))
    # the rbg bit generator: its init compiles in half the time of threefry's
    variables = to_numpy(init(jax.random.key(4, impl="unsafe_rbg")))
    rng = np.random.RandomState(4)

    def draw(path, x):
        key = path[-1].key
        if key in ("bias", "beta"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        if key == "gamma":                 # batch norms' (1) and depthwise convs' (1/sqrt(C))
            return (x * rng.uniform(0.5, 1.5, x.shape)).astype(np.float32)
        if key == "mean":
            return rng.normal(0, 0.5, x.shape).astype(np.float32)
        if key == "var":
            return rng.uniform(0.05, 4.0, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(draw, variables)


def case_variables(tower, head):
    """The variables of a one-block net: tower `tower` of the net of every
    family as tower0, the RepLK head's layers kept or dropped."""
    def cut(tree):
        out = {k: v for k, v in tree.items() if not k.startswith("tower")
               and (head == "RepLK" or k not in ("policy_dw", "policy_pw"))}
        out["tower0"] = tree[f"tower{tower}"]
        return out

    v = all_variables()
    return {"params": cut(v["params"]), "batch_stats": cut(v["batch_stats"])}


@functools.lru_cache
def references():
    """{case: (its configs, variables, batch and the JAX package's outputs)},
    the outputs of every case from one compiled function (one compile of
    the seven cases costs less than seven)."""
    planes, targets = batch(7, SIZES, N)
    cases = {}
    for case, (tower, head) in CASES.items():
        jcfg, tcfg = configs([ALL[tower]], head)
        cases[case] = (JN.SayuriNet(jcfg), tcfg, case_variables(tower, head))

    def run(jnet, v, x, t):
        heads = jnet.apply(v, x, train=False)

        def loss_fn(params):
            out, mutated = jnet.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                                      train=True, mutable=["batch_stats"])
            loss, parts = JL.compute_loss(out, t, x[..., -1:], 0.1)
            return loss, (parts, out, mutated["batch_stats"])

        (_, (parts, train_heads, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(v["params"])
        return heads, train_heads, stats, parts, grads

    @jax.jit
    def run_all(variables, x, t):
        return {k: run(cases[k][0], v, x, t) for k, v in variables.items()}

    out = to_numpy(run_all({k: c[2] for k, c in cases.items()}, jnp.asarray(planes),
                           jax.tree.map(jnp.asarray, targets)))
    return {k: (tcfg, variables, planes, targets, out[k])
            for k, (_, tcfg, variables) in cases.items()}


def reference(case):
    return references()[case]


def port_net(tcfg, variables):
    net = SayuriNet(tcfg)
    net.load_state_dict(port_state(tcfg, variables))
    return net


def assert_heads_close(got, want, tag):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=HEAD_TOL, atol=HEAD_TOL,
                                   err_msg=f"{tag} head {k}")


@pytest.mark.parametrize("case", list(CASES))
def test_eval_heads_match_jax(case):
    tcfg, variables, planes, _, (want, *_) = reference(case)
    net = port_net(tcfg, variables).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(planes))
    assert_heads_close(got, want, f"{case} eval")


@pytest.mark.parametrize("case", list(CASES))
def test_train_heads_and_statistics_match_jax(case):
    tcfg, variables, planes, _, (_, want, stats, _, _) = reference(case)
    net = port_net(tcfg, variables).train()
    with torch.no_grad():
        got = net(torch.from_numpy(planes))
    assert_heads_close(got, want, f"{case} train")
    assert_tensors_close(dict(net.named_buffers()),
                         port_stats(tcfg, variables["params"], stats), STAT_TOL,
                         f"{case} statistics")


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradients_match_jax(case):
    tcfg, variables, planes, targets, (*_, want_parts, want_grads) = reference(case)
    assert len(want_parts) == 11
    net = port_net(tcfg, variables).train()
    x = torch.from_numpy(planes)
    loss, parts = TL.compute_loss(net(x), {k: torch.from_numpy(v) for k, v in targets.items()},
                                  x[..., -1:], 0.1)
    loss.backward()
    assert_parts_close({k: v.item() for k, v in parts.items()}, want_parts, HEAD_TOL,
                       f"{case} loss")
    want = port_state(tcfg, {"params": want_grads, "batch_stats": variables["batch_stats"]})
    got = {k: p.grad for k, p in net.named_parameters()}
    assert all(g is not None for g in got.values())
    # a depthwise conv's bias shifts its channel on the board only, and the
    # train-mode batch norm subtracts that shift: its gradient is zero in
    # exact arithmetic, so both packages' rounding noise is held under the
    # bound of the block's kernel gradient instead of against each other
    zero = {k for k in got if re.search(r"(^|\.)(conv|rep3x3)\.bias$", k)}
    assert len(zero) == (2 if case in ("MixerBlock", "MixerBlockV2-SE", "RepLK") else 0)
    for k in zero:
        kernel = want[k.rsplit(".", 2)[0] + ".conv.weight"]
        bound = GRAD_TOL * float(kernel.abs().max())
        assert max(got[k].abs().max(), want[k].abs().max()) <= bound, k
    assert_tensors_close({k: g for k, g in got.items() if k not in zero},
                         {k: want[k] for k in got if k not in zero}, GRAD_TOL,
                         f"{case} gradient", scale=True)


@pytest.fixture(scope="module")
def every_family():
    jcfg, tcfg = configs(ALL, "RepLK")
    variables = all_variables()
    return jcfg, variables, port_net(tcfg, variables).eval()


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "text"])
def test_port_export_is_byte_identical(every_family, tmp_path, binary):
    jcfg, variables, net = every_family
    jpath, tpath = tmp_path / "jax.txt", tmp_path / "port.txt"
    JW.export_reference_weights(jcfg, variables, str(jpath), binary=binary)
    TW.export_reference_weights(net, str(tpath), binary=binary)
    text = tpath.read_bytes()
    assert text == jpath.read_bytes()
    assert text.count(b"DepthwiseConvolution 1 16 7\n") == 2      # the two mixers
    assert text.count(b"DepthwiseConvolution 1 8 7\n") == 1       # the RepLK head


def test_jax_export_imports_into_the_port(every_family, tmp_path):
    jcfg, variables, _ = every_family
    path = str(tmp_path / "w.bin.txt")
    JW.export_reference_weights(jcfg, variables, path)
    planes, _ = batch(8, SIZES, N)
    icfg, ivars = JW.import_reference_weights(path)

    @jax.jit
    def finalized(v, x):
        _, merged, net = JW.finalize_imported_variables(icfg, v, boardsize=N)
        return net.apply(merged, x, train=False)

    want = to_numpy(finalized(ivars, jnp.asarray(planes)))
    tcfg, net = TW.load_checkpoint_for_inference(path, boardsize=N)
    assert tcfg.stack == ALL and tcfg.policy_head_type == "RepLK"
    assert (tcfg.se_ratio, tcfg.policy_head_kernel) == (4, 7)
    # the merged depthwise kernel sits in `conv`: gamma 0, rep3x3 zero
    dw = net.tower[4].dw
    assert not dw.conv.gamma.any() and not dw.rep3x3.weight.any()
    with torch.no_grad():
        got = net(torch.from_numpy(planes))
    assert_heads_close(got, want, "imported")


def test_trainer_steps_and_checkpoints_every_family(tmp_path):
    """The Trainer's optimizer, clipping and SWA cover every parameter of
    every family; its checkpoint loads for inference."""
    _, tcfg = configs(ALL, "RepLK")
    trainer = Trainer(tcfg, TrainConfig(batch_size=4, swa_steps=1), seed=3, device="cpu")
    before = trainer.unreplicated_params()
    planes, targets = batch(9, SIZES, N)
    parts = trainer.train_batch(planes, targets)
    assert np.isfinite(parts["loss"])
    after = trainer.unreplicated_params()
    assert set(after) == set(trainer.swa_params)
    assert any(k.endswith("dw.rep3x3.gamma") for k in after)
    # every parameter moves, but the depthwise biases, whose gradient is zero
    # in exact arithmetic (test_loss_and_gradients_match_jax) and whose
    # decay starts from zero
    unchanged = [k for k in after if torch.equal(after[k], before[k])
                 and not re.search(r"(^|\.)(conv|rep3x3)\.bias$", k)]
    assert not unchanged, unchanged
    path = tmp_path / "every.ckpt"
    trainer.save_checkpoint(str(path))
    cfg, net = TW.load_checkpoint_for_inference(str(path))
    assert cfg == tcfg
    trainer.net.eval()
    x = torch.from_numpy(planes)
    with torch.no_grad():
        want, got = trainer.net(x), net(x)
    for k in want:
        assert torch.equal(got[k], want[k]), k


SETTING = {
    "NeuralNetwork": {
        "MaxBoardSize": 9, "ResidualChannels": 32, "PolicyHeadChannels": 16,
        "ValueHeadChannels": 16, "SeRatio": 4, "PolicyHeadType": {"Type": "RepLK"},
        "Stack": ["BottleneckBlock", "NestedBottleneckBlock-SE", "MixerBlock",
                  "MixerBlock-SE", "ResidualBlock-SE", "BottleneckBlock-SE"],
    },
    "Train": {"TrainDirectory": "tdata", "StorePath": "store", "RenormMaxR": 2,
              "RenormMaxD": 1},
}


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("head", [{"Type": "RepLK"}, "RepLK"], ids=["dict", "string"])
def test_load_setting_with_every_family_matches_jax(head):
    s = json.loads(json.dumps(SETTING))
    s["NeuralNetwork"]["PolicyHeadType"] = head
    source = json.dumps(s)
    want, got = JS.load_setting(source), TS.load_setting(source)
    wn = _fields(want.net)
    assert {k: wn[k] for k in _fields(got.net)} == _fields(got.net)
    assert _fields(got.train) == _fields(want.train)
    assert _fields(got.loop) == _fields(want.loop)
    assert got.net.policy_head_type == "RepLK"
    SayuriNet(got.net)          # the port builds what the setting names
    # MixerBlockV2 is not a name setting.json accepts, in either package
    s["NeuralNetwork"]["Stack"][2] = "MixerBlockV2"
    with pytest.raises(ValueError) as jerr:
        JS.load_setting(json.dumps(s))
    with pytest.raises(ValueError) as terr:
        TS.load_setting(json.dumps(s))
    assert str(terr.value) == str(jerr.value) == "unknown stack block 'MixerBlockV2'"


PLAYOUTS = 12


def test_mixer_replk_search_matches_jax_mcts():
    tower = ALL.index("MixerBlock")
    jcfg, tcfg = configs([ALL[tower]], "RepLK")
    variables = case_variables(tower, "RepLK")
    net = JN.SayuriNet(jcfg)
    jenv, js, _ = random_jax_states(n=N, b=2, moves=6, seed=12)
    jfn = jax.jit(JEV.make_eval_fn(jenv, net, jax.tree.map(jnp.asarray, variables),
                                   symmetry=0, ladder_mode="off"))

    def evaluate(states, ctx=None):
        """The root's states carry the whole hash history, the tree's leaves
        one entry; the evaluator reads neither, so with one entry each
        both calls share one trace of the jitted evaluator."""
        return jfn(states.replace(hash_history=states.hash_history[:, :1]), ctx)

    jm = JMCTS(jenv, evaluate, JConfig(max_nodes=PLAYOUTS + 8, max_depth=8))

    @jax.jit
    def jsearch(states):
        tree = jm.run(jm.init_tree(states, jax.random.PRNGKey(0)), PLAYOUTS)
        return jm.root_child_visits(tree), jm.best_move(tree), tree.visits[:, 0]

    j_visits, j_best, j_root_n = jsearch(js)

    env = GoEnv(n=N)
    tm = MCTS(env, make_eval_fn(env, port_net(tcfg, variables).eval(), symmetry=0,
                                ladder_mode="off"),
              SearchConfig(max_nodes=PLAYOUTS + 8, max_depth=8))
    tree = tm.run(tm.init_tree(jax_to_torch(js)), PLAYOUTS)
    assert (tree.visits[:, 0] == PLAYOUTS + 1).all()
    np.testing.assert_array_equal(np.asarray(j_root_n), tree.visits[:, 0].numpy())
    np.testing.assert_array_equal(np.asarray(j_visits), tm.root_child_visits(tree).numpy())
    np.testing.assert_array_equal(np.asarray(j_best), tm.best_move(tree).numpy())
