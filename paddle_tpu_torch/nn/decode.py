"""Seq2seq decoding: `Decoder`, `BeamSearchDecoder` and `dynamic_decode`
(port of `paddle_tpu.nn.decode`, `decode.py:21-165` there; reference
`python/paddle/fluid/layers/rnn.py` over `beam_search_op` and
`gather_tree_op`).

The loop runs on the host over per-step tensor work, as in the JAX
package; `dynamic_decode` reads `finished` on the host each step. The
cell states are nests of tuples, lists and dicts, walked by
`ops._util.nest_map`.

A step keeps the reference's arithmetic: the log-softmax in float32;
finished beams extend only with `end_token` at no cost (every other
token -1e9); beams 1..W-1 start at -1e9; parent = index // V as int32.
The top W of the B x (W * V) scores are taken by a stable descending
sort, so among equal scores the lower flat index comes first, as
`jax.lax.top_k` orders them (`torch.topk` promises no order among
ties)."""
from __future__ import annotations

import torch

from ..ops._util import nest_leaves, nest_map
from ..ops.extra_ops import gather_tree

__all__ = ["Decoder", "BeamSearchDecoder", "dynamic_decode"]


class Decoder:
    """Protocol: initialize -> (inputs, states, finished); step ->
    (outputs, states, next_inputs, finished); finalize -> (outputs,
    final_states)."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        return outputs, final_states


class BeamSearchDecoder(Decoder):
    """Beam search over a cell `(inputs, states) -> (out, new_states)`;
    `embedding_fn` maps token ids to the cell's inputs and `output_fn`
    its outputs to vocabulary logits. States are batch-major with the
    beams inner: row b * W + w is beam w of batch row b."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, inits):
        """Tile every state leaf [B, ...] to [B * W, ...]; beam 0 starts
        at score 0 and the others at -1e9."""
        lead = nest_leaves(inits)[0]
        B, W = lead.shape[0], self.beam_size
        states = nest_map(lambda v: torch.repeat_interleave(v, W, dim=0),
                      inits)
        dev = lead.device
        ids = torch.full((B, W), self.start_token, dtype=torch.int32,
                         device=dev)
        scores = torch.where(torch.arange(W, device=dev)[None, :] == 0, 0.0,
                             -1e9) * torch.ones(B, 1, device=dev)
        finished = torch.zeros(B, W, dtype=torch.bool, device=dev)
        return (ids, scores), states, finished

    def step(self, time, inputs, states, **kwargs):
        ids, scores = inputs
        B, W = ids.shape
        flat_ids = ids.reshape(-1)
        emb = self.embedding_fn(flat_ids) if self.embedding_fn else flat_ids
        cell_out, new_states = self.cell(emb, states)
        logits = self.output_fn(cell_out) if self.output_fn else cell_out
        fin = kwargs["finished"]
        V = logits.shape[-1]
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(B, W, V)
        end_row = torch.where(torch.arange(V, device=logp.device)
                              == self.end_token, 0.0, -1e9)
        logp = torch.where(fin[:, :, None], end_row, logp)
        flat = (scores[:, :, None] + logp).reshape(B, W * V)
        top_sc, top_ix = torch.sort(flat, dim=1, descending=True,
                                    stable=True)
        top_sc, top_ix = top_sc[:, :W], top_ix[:, :W]
        parent = torch.div(top_ix, V, rounding_mode="floor").to(torch.int32)
        token = (top_ix % V).to(torch.int32)
        new_fin = torch.gather(fin, 1, parent.long()) | (token
                                                         == self.end_token)
        rows = (parent.long() + W * torch.arange(
            B, device=parent.device)[:, None]).reshape(-1)
        new_states = nest_map(lambda v: v[rows], new_states)
        return (token, parent, top_sc), new_states, (token, top_sc), new_fin

    def finalize(self, outputs, final_states, sequence_lengths):
        """Per-step (token, parent, score) -> (ids [T, B, W] assembled by
        `gather_tree`, the last step's scores [B, W]), final states."""
        tokens = torch.stack([o[0] for o in outputs])
        parents = torch.stack([o[1] for o in outputs])
        return (gather_tree(tokens, parents), outputs[-1][2]), final_states


def dynamic_decode(decoder, inits=None, max_step_num=100, **kwargs):
    """Step `decoder` until every beam has finished (read on the host
    each step) or `max_step_num` steps; returns its `finalize`."""
    inputs, states, finished = decoder.initialize(inits)
    outputs = []
    for t in range(int(max_step_num)):
        out, states, inputs, finished = decoder.step(
            t, inputs, states, finished=finished, **kwargs)
        outputs.append(out)
        if bool(finished.all()):
            break
    return decoder.finalize(outputs, states, None)
