"""Shared by the test_torch_gtp* files: one seeded v5 weight file loaded by
the JAX package's GtpLoop and by the port's (on the CPU, float32), and a
runner that sends the same command script through both."""

import re

import jax
import numpy as np

from sayuri_tpu.gtp.loop import GtpLoop as JLoop, StreamBody as JStream
from sayuri_tpu.models import network as JN
from sayuri_tpu.models import weights_io as JW
from sayuri_tpu_torch.gtp.loop import GtpLoop, StreamBody
from sayuri_tpu_torch.models import weights_io as TW
from test_torch_network import STACK, seeded_variables


def write_weights(path, n, channels=16, seed=0):
    """A v5 file of a b2c16 net with seeded weights and BN statistics."""
    _, variables, _ = seeded_variables(n=n, channels=channels, seed=seed)
    cfg = JN.NetConfig(boardsize=n, residual_channels=channels, stack=STACK)
    JW.export_reference_weights(cfg, jax.device_get(variables), str(path))
    return str(path)


def loop_pair(path, **kw):
    """(JAX GtpLoop, port GtpLoop) on the same v5 file and Agent options."""
    net_cfg, variables = JW.load_checkpoint_for_inference(path)
    _, net = TW.load_checkpoint_for_inference(path)
    jloop = JLoop(net_cfg=net_cfg, variables=variables, **kw)
    tloop = GtpLoop(net=net, device="cpu", **kw)
    return jloop, tloop


def answer(loop, line):
    ok, body = loop.execute(line)
    if isinstance(body, (JStream, StreamBody)):
        body = body.collect()
    return ok, body


# the commands whose numbers are compared within a tolerance
NUMERIC = ("sayuri-raw_nn", "kata-analyze", "lz-analyze", "sayuri-analyze")

_NUM = re.compile(r"^-?\d+(\.\d+)?(e-?\d+)?$")


def split_numbers(text):
    """(words with every number replaced by '#', the numbers)."""
    words, nums = [], []
    for w in text.split():
        if _NUM.match(w):
            words.append("#")
            nums.append(float(w))
        else:
            words.append(w)
    return words, np.array(nums)


def assert_same_answers(jloop, tloop, script, numeric=(), atol=1e-4):
    """Send `script` through both loops. Answers are equal string for
    string, except the commands starting with one of `numeric`, whose
    words are equal and whose numbers agree within `atol` (plus the
    printed precision: 4 decimals for raw_nn, integers in 1/10000 for the
    lz rows)."""
    for line in script:
        want, got = answer(jloop, line), answer(tloop, line)
        assert want[0] == got[0], (line, want, got)
        if line.split()[0] in numeric:
            ww, wn = split_numbers(want[1])
            gw, gn = split_numbers(got[1])
            assert ww == gw, (line, want[1], got[1])
            tol = 1.0 + 1e-6 if line.startswith("lz-") else atol + 1e-6
            np.testing.assert_allclose(gn, wn, atol=tol, rtol=0, err_msg=line)
        else:
            assert want == got, (line, want, got)
