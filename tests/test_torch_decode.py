"""`BeamSearchDecoder` + `dynamic_decode`: the three cases of
tests/test_beam_decode.py run in both packages on the same weights. Every
step's tokens and parent beams, the assembled sequences (`gather_tree`)
and the number of steps are identical, the scores within 1e-6. The fixed
logit table makes many scores equal: among ties both packages take the
lower flat index first (`jax.lax.top_k`; the port sorts stably)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as ptt
from paddle_tpu_torch.models import load_reference_state
from torch_ops_parity import on_the_cpu  # noqa: F401


class _FixedCell:
    """A stateless cell emitting one logit table [V] for every row."""

    def __init__(self, table, P):
        self.table, self.P = table, P

    def __call__(self, inputs, states):
        rows = np.tile(self.table[None, :], (inputs.shape[0], 1))
        if self.P is torch:
            return torch.from_numpy(rows), states
        return self.P.to_tensor(rows), states


def _decode(P, cell, inits, beam, steps, **kw):
    """(sequences, scores, per-step (tokens, parents, scores)) as numpy."""
    dec = P.nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                 beam_size=beam, **kw)
    seen = []
    finalize = dec.finalize

    def recording(outputs, states, lengths):
        seen.extend(outputs)
        return finalize(outputs, states, lengths)
    dec.finalize = recording
    (seqs, scores), _ = P.nn.dynamic_decode(dec, inits=inits,
                                            max_step_num=steps)

    def host(t):
        return t.numpy() if torch.is_tensor(t) else np.asarray(t.numpy())
    return host(seqs), host(scores), [tuple(host(x) for x in o)
                                      for o in seen]


def _same(got, want):
    gs, gsc, gsteps = got
    ws, wsc, wsteps = want
    assert len(gsteps) == len(wsteps)
    for (gt, gp, gv), (wt, wp, wv) in zip(gsteps, wsteps):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gp, wp)
        assert gp.dtype == wp.dtype == np.int32
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_allclose(gsc, wsc, rtol=0, atol=1e-6)


def _zeros(P, *shape):
    z = np.zeros(shape, np.float32)
    return torch.from_numpy(z) if P is torch else P.to_tensor(z)


@pytest.mark.parametrize("case", ["greedy_optimum", "end_token"])
def test_fixed_table_cases_match_jax(case):
    if case == "greedy_optimum":
        V, beam, rows, steps = 8, 3, 2, 4
        table = np.full(V, -5.0, np.float32)
        table[3], table[1] = 2.0, 1.0
    else:
        V, beam, rows, steps = 6, 2, 1, 10
        table = np.full(V, -5.0, np.float32)
        table[1] = 3.0
    want = _decode(paddle, _FixedCell(table, paddle), _zeros(paddle, rows, 4),
                   beam, steps)
    got = _decode(ptt, _FixedCell(table, torch), _zeros(torch, rows, 4),
                  beam, steps)
    _same(got, want)
    if case == "end_token":      # every beam ends early
        assert len(got[2]) < steps


def test_beam_decoder_with_real_cell_and_embedding_matches_jax():
    paddle.seed(11)
    V, H = 10, 6
    jemb, jcell, jproj = (paddle.nn.Embedding(V, H), paddle.nn.LSTMCell(H, H),
                          paddle.nn.Linear(H, V))
    temb, tcell, tproj = (ptt.nn.Embedding(V, H), ptt.nn.LSTMCell(H, H),
                          ptt.nn.Linear(H, V))
    for j, t in ((jemb, temb), (jcell, tcell), (jproj, tproj)):
        load_reference_state(t, {k: np.asarray(v.numpy())
                                 for k, v in j.state_dict().items()})
    want = _decode(paddle, jcell, (_zeros(paddle, 3, H),
                                   _zeros(paddle, 3, H)), 4, 5,
                   embedding_fn=jemb, output_fn=jproj)
    with torch.no_grad():
        got = _decode(ptt, tcell, (_zeros(torch, 3, H), _zeros(torch, 3, H)),
                      4, 5, embedding_fn=temb, output_fn=tproj)
    _same(got, want)
    assert got[0].shape == (5, 3, 4)


def test_ties_take_the_lower_index_first():
    """Equal totals: torch.topk may return them in any order; the port's
    step keeps jax.lax.top_k's (lower flat index first)."""
    table = np.zeros(5, np.float32)
    got = _decode(ptt, _FixedCell(table, torch), _zeros(torch, 1, 2), 3, 1)
    np.testing.assert_array_equal(got[2][0][0], [[0, 1, 2]])
    np.testing.assert_array_equal(got[2][0][1], [[0, 0, 0]])
