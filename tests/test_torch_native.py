"""The port's native chunk codec (``sayuri_tpu_torch.native``) against the
port's Python parser and against the JAX package's codec.

The chunks are written by the port's own writer
(``selfplay.data.serialize_position``) from seeded arrays at 5x5, 9x9 and
19x19 under both rules: a parse costs in proportion to the text, not to how
real the game is. The codec's arrays must equal ``Sample.parse``'s and
``sayuri_tpu.native.parse_positions``' byte for byte, serialize-then-parse
must round-trip, ``Sample.parse_native`` must set every field as
``Sample.parse`` does, a corrupt line that the Python path rejects (a
short policy line, a plane digit that is not hex, a garbled number) makes
the codec raise too, and without a compiler the library is None, the
loader parses in Python and the fallback is logged once.
"""

import logging

import numpy as np
import pytest

from sayuri_tpu import native as JN
from sayuri_tpu_torch import native as TN
from sayuri_tpu_torch.selfplay import data as D
from sayuri_tpu_torch.train import dataset as TD

CASES = [(5, 0.0), (5, 1.0), (9, 0.0), (9, 1.0), (19, 0.0), (19, 1.0)]


def chunk_text(bsize, rule, n=6, seed=0):
    """`n` positions of seeded arrays through the port's writer."""
    rng = np.random.RandomState(seed + bsize)
    hw = bsize * bsize
    out = []
    for _ in range(n):
        prob = rng.dirichlet(np.ones(hw + 1)).astype(np.float32)
        aux = rng.dirichlet(np.ones(hw + 1)).astype(np.float32)
        q = rng.uniform(-1, 1, 4)
        s = rng.uniform(-40, 40, 5)
        out.append(D.serialize_position(
            planes=(rng.rand(43, hw) < 0.3).astype(np.float32), bsize=bsize,
            komi=float(rng.choice([7.5, 6.5, -3.0, 0.5])), rule=rule,
            wave=float(rng.uniform(-1, 1)), stm_is_black=bool(rng.rand() < 0.5),
            probabilities=prob, aux_probabilities=aux,
            ownership=rng.randint(-1, 2, hw), result=int(rng.randint(-1, 2)),
            avg_q=q[0], short_q=q[1], middle_q=q[2], long_q=q[3], final_score=s[0],
            avg_s=s[1], short_s=s[2], middle_s=s[3], long_s=s[4],
            q_stddev=float(rng.rand()), score_stddev=float(rng.rand() * 10),
            kld=float(rng.rand())))
    return "".join(out)


@pytest.fixture(scope="module")
def lib():
    lib = TN.get_lib()
    if lib is None:
        pytest.skip("no g++: the codec cannot be built")
    return lib


def test_lib_builds(lib):
    assert lib.sayuri_codec_version() == 1


def python_parse(text):
    lines = text.splitlines()
    return [TD.Sample(lines[i:i + 53]).parse() for i in range(0, len(lines), 53)]


@pytest.mark.parametrize("bsize,rule", CASES)
def test_codec_equals_python_parse(lib, bsize, rule):
    text = chunk_text(bsize, rule)
    out = TN.parse_positions(text, bsize)
    samples = python_parse(text)
    assert out["planes"].shape == (len(samples), 37, bsize * bsize)
    for i, s in enumerate(samples):
        assert out["planes"][i].tobytes() == s.planes.tobytes()
        assert out["prob"][i].tobytes() == s.prob.tobytes()
        assert out["aux"][i].tobytes() == s.aux_prob.tobytes()
        assert out["own"][i].tobytes() == s.ownership.tobytes()
        want = [s.board_size, s.komi, s.rule, s.wave, s.to_move, s.result, s.avg_q,
                s.short_avg_q, s.mid_avg_q, s.long_avg_q, s.final_score, s.avg_score,
                s.short_avg_score, s.mid_avg_score, s.long_avg_score, s.q_stddev,
                s.score_stddev, s.kld]
        assert out["scalars"][i].tobytes() == np.asarray(want, np.float32).tobytes()


@pytest.mark.parametrize("bsize,rule", CASES)
def test_codec_equals_jax_codec(lib, bsize, rule):
    if JN.get_lib() is None:
        pytest.skip("no g++: the JAX package's codec cannot be built")
    text = chunk_text(bsize, rule, seed=1)
    got, want = TN.parse_positions(text, bsize), JN.parse_positions(text, bsize)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("bsize", [5, 9, 19])
def test_serialize_then_parse_round_trips(lib, bsize):
    out = TN.parse_positions(chunk_text(bsize, 1.0, seed=2), bsize)
    text = TN.serialize_positions(bsize, out["planes"], out["prob"], out["aux"], out["own"],
                                  out["scalars"])
    again = TN.parse_positions(text, bsize)
    for k in out:
        np.testing.assert_allclose(again[k], out[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert again["planes"].tobytes() == out["planes"].tobytes()
    assert again["own"].tobytes() == out["own"].tobytes()
    # the codec's text parses in Python too
    assert len(python_parse(text)) == out["planes"].shape[0]


def test_parse_native_sets_what_parse_sets(lib):
    text = chunk_text(9, 1.0, seed=3) + chunk_text(5, 0.0, seed=3)
    lines = text.splitlines()
    for i in range(0, len(lines), 53):
        want = TD.Sample(lines[i:i + 53]).parse()
        got = TD.Sample(lines[i:i + 53]).parse_native()
        for k in TD.Sample.__slots__:
            w, g = getattr(want, k), getattr(got, k)
            assert type(g) is type(w), k
            assert np.asarray(g).tobytes() == np.asarray(w).tobytes(), k
    bad = lines[:53]
    bad[6] = ""            # a plane line cut short: Python reads zeros
    with pytest.raises(ValueError, match="codec parse error"):
        TD.Sample(bad).parse_native()


def test_missing_compiler_falls_back_once(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(TN, "_OUT", tmp_path / "libsayuri_codec.so")
    monkeypatch.setattr(TN, "_LIB", None)
    monkeypatch.setattr(TN, "_TRIED", False)
    monkeypatch.setenv("PATH", str(tmp_path))
    chunk = tmp_path / "c.txt"
    chunk.write_text(chunk_text(5, 0.0, n=4))
    with caplog.at_level(logging.WARNING, logger=TN.__name__):
        assert TN.get_lib() is None and TN.get_lib() is None
        assert TN.parse_positions(chunk.read_text(), 5) is None
        loader = TD.ChunkLoader([chunk], nn_size=5, batch_size=2, down_sample_rate=1,
                                shuffle_capacity=1, loop=False)
        batches = list(loader)
        loader.close()
    assert len(batches) == 2 and not loader.codec
    assert loader.python_parses == 4 and loader.native_parses == 0
    assert sum("codec unavailable" in r.getMessage() for r in caplog.records) == 1
    with pytest.raises(RuntimeError, match="codec=True"):
        TD.ChunkLoader([chunk], nn_size=5, batch_size=2, codec=True)


def _short_prob(ln):
    ln[44] = " ".join(ln[44].split()[:-3])          # three numbers missing


def _bad_hex(ln):
    ln[6] = "g" + ln[6][1:]                          # a plane digit that is not hex


def _garbled_aux(ln):
    ln[45] = ln[45].replace(" ", "x ", 1)            # "0.0123x"


def _garbled_q(ln):
    ln[48] = ln[48].split()[0] + " junk"


MALFORMED = {"short_prob": _short_prob, "bad_hex": _bad_hex, "garbled_aux": _garbled_aux,
             "garbled_q": _garbled_q}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_line_raises_on_both_paths(lib, case):
    """A corrupt line that the Python path rejects (``float``, ``int(ch, 16)``
    or the reshape in ``wrap_sample``) makes the codec raise too, instead of
    reading zeros."""
    lines = chunk_text(9, 0.0, n=1, seed=4).splitlines()
    MALFORMED[case](lines)
    with pytest.raises((ValueError, IndexError)):
        TD.wrap_sample(TD.Sample(list(lines)).parse(), 9)
    with pytest.raises(ValueError):
        TD.Sample(list(lines)).parse_native()
    with pytest.raises(ValueError, match="codec parse error"):
        TN.parse_positions("\n".join(lines), 9)
