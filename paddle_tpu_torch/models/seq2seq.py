"""An attention LSTM encoder-decoder, written once against the public API
that `paddle_tpu_torch` shares with the JAX package, so the same function
builds it in either (`paddle`: the package to build with, this one by
default).

The model is PaddleNLP's `examples/machine_translation/seq2seq`
(`seq2seq_attn.py`), which trains Paddle 2.0's RNN API on IWSLT'15
English-Vietnamese: source and target embeddings, an `nn.LSTM` encoder,
an `nn.RNN` decoder over a cell of `nn.LSTMCell`s with input feeding and
dropout after each layer, Luong dot-product attention (`input_proj` on
the encoder outputs, scores against the top hidden state plus a -1e9 pad
bias, softmax, the context concatenated with the hidden state,
`output_proj`, tanh), and an output `Linear` to the target vocabulary.
Every parameter starts Uniform(-init_scale, init_scale). The decoder
starts from the encoder's last states; the encoder, like every fused RNN
of both packages, ignores `sequence_length` and its dropout (ROADMAP
C23). The encoder outputs are projected once, before the decoder's loop;
the projection and the pad bias ride in the decoder's states, so
`BeamSearchDecoder.initialize` tiles them with the beams as it tiles the
LSTM states.

    net = seq2seq_attn(src_vocab=17191, trg_vocab=7709)   # IWSLT'15 width
    src, src_len, trg_in, trg_out, trg_len = map(paddle.to_tensor,
        reversal_batch(np.random.RandomState(0), 128, 17191, 7709))
    logits = net(src, src_len, trg_in)                     # [B, T, V]
    loss = seq2seq_criterion()(logits, trg_out, trg_len)
    ids, scores = net.beam_search(src, src_len, beam_size=10,
                                  max_step_num=2 * src.shape[1])

Token ids: 0 pads, `BOS` 1 starts a target, `EOS` 2 ends one."""
from __future__ import annotations

import numpy as np

__all__ = ["seq2seq_attn", "seq2seq_criterion", "reversal_batch", "BOS",
           "EOS"]

BOS, EOS = 1, 2


def _package(paddle):
    if paddle is None:
        import paddle_tpu_torch as paddle
    return paddle


def seq2seq_attn(paddle=None, src_vocab=17191, trg_vocab=7709, hidden=512,
                 num_layers=2, dropout=0.2, init_scale=0.1):
    """The network, on `paddle`'s default device (in this package the
    CUDA card unless `set_device` chose another)."""
    paddle = _package(paddle)
    nn, F = paddle.nn, paddle.nn.functional

    def uniform():
        return paddle.ParamAttr(initializer=nn.initializer.Uniform(
            -init_scale, init_scale))

    def lstm_attrs():
        return dict(weight_ih_attr=uniform(), weight_hh_attr=uniform(),
                    bias_ih_attr=uniform(), bias_hh_attr=uniform())

    class AttentionLayer(nn.Layer):
        def __init__(self):
            super().__init__()
            self.input_proj = nn.Linear(hidden, hidden,
                                        weight_attr=uniform(),
                                        bias_attr=False)
            self.output_proj = nn.Linear(2 * hidden, hidden,
                                         weight_attr=uniform(),
                                         bias_attr=False)

        def forward(self, h, memory, bias):
            """h [B, H]; memory: the projected encoder outputs
            [B, S, H]; bias [B, 1, S]."""
            scores = paddle.matmul(paddle.unsqueeze(h, [1]), memory,
                                   transpose_y=True) + bias
            attn = F.softmax(scores, axis=-1)
            ctx = paddle.squeeze(paddle.matmul(attn, memory), [1])
            return paddle.tanh(self.output_proj(paddle.concat([ctx, h],
                                                              axis=-1)))

    class DecoderCell(nn.Layer):
        """states: [[(h, c) a layer], input feed, memory, bias]."""

        def __init__(self):
            super().__init__()
            self.dropout = nn.Dropout(dropout)
            self.lstm_cells = nn.LayerList([
                nn.LSTMCell(2 * hidden if i == 0 else hidden, hidden,
                            **lstm_attrs()) for i in range(num_layers)])
            self.attention_layer = AttentionLayer()

        def forward(self, step_input, states):
            lstm_states, input_feed, memory, bias = states
            x = paddle.concat([step_input, input_feed], axis=-1)
            new_states = []
            for i, cell in enumerate(self.lstm_cells):
                out, st = cell(x, lstm_states[i])
                x = self.dropout(out)
                new_states.append(st)
            out = self.attention_layer(x, memory, bias)
            return out, [new_states, out, memory, bias]

    class Seq2SeqAttn(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_embedder = nn.Embedding(src_vocab, hidden,
                                             weight_attr=uniform())
            self.trg_embedder = nn.Embedding(trg_vocab, hidden,
                                             weight_attr=uniform())
            self.encoder = nn.LSTM(hidden, hidden, num_layers,
                                   dropout=dropout, **lstm_attrs())
            self.decoder = nn.RNN(DecoderCell())
            self.output_layer = nn.Linear(hidden, trg_vocab,
                                          weight_attr=uniform(),
                                          bias_attr=False)

        def encode(self, src, src_len):
            """The decoder's initial states for source ids [B, S] of
            lengths [B]."""
            enc_out, (h, c) = self.encoder(self.src_embedder(src),
                                           sequence_length=src_len)
            states = [(h[i], c[i]) for i in range(num_layers)]
            memory = self.decoder.cell.attention_layer.input_proj(enc_out)
            mask = F.sequence_mask(src_len, maxlen=src.shape[1],
                                   dtype="float32")
            bias = paddle.unsqueeze((mask - 1.0) * 1e9, [1])
            return [states, paddle.zeros_like(enc_out[:, 0]), memory, bias]

        def forward(self, src, src_len, trg):
            out, _ = self.decoder(self.trg_embedder(trg),
                                  self.encode(src, src_len))
            return self.output_layer(out)

        def beam_search(self, src, src_len, beam_size=10, max_step_num=100):
            """(ids [T, B, beam], scores [B, beam]) of `beam_size`-wide
            beam search from BOS until every beam has emitted EOS or
            `max_step_num` steps."""
            dec = nn.BeamSearchDecoder(
                self.decoder.cell, BOS, EOS, beam_size,
                embedding_fn=self.trg_embedder, output_fn=self.output_layer)
            with paddle.no_grad():
                (ids, scores), _ = nn.dynamic_decode(
                    dec, inits=self.encode(src, src_len),
                    max_step_num=max_step_num)
            return ids, scores

    return Seq2SeqAttn().to(device=paddle.get_device())


def seq2seq_criterion(paddle=None):
    """PaddleNLP's `CrossEntropyCriterion`: the per-token cross-entropy
    masked to each target's length, mean over the batch, sum over
    time."""
    paddle = _package(paddle)
    F = paddle.nn.functional

    class CrossEntropyCriterion(paddle.nn.Layer):
        def forward(self, logits, label, trg_len):
            cost = F.cross_entropy(logits, label, reduction="none")
            mask = F.sequence_mask(trg_len, maxlen=label.shape[1],
                                   dtype="float32")
            return paddle.sum(paddle.mean(cost * mask, axis=0))

    return CrossEntropyCriterion()


def reversal_batch(rng, batch, src_vocab, trg_vocab, min_len=5, max_len=50):
    """A learnable transduction as numpy int32 arrays (src [B, S],
    src_len [B], trg_in [B, T], trg_out [B, T], trg_len [B]): source
    lengths uniform in [min_len, max_len]; source tokens drawn from
    [3, src_vocab) by Zipf's law (the token of rank r with probability
    proportional to 1 / r, as words are in text); the target is the
    source reversed, each token mapped to 3 + (7 * token) % (trg_vocab -
    3), fed from BOS and ending in EOS. 0 pads both."""
    lens = rng.randint(min_len, max_len + 1, batch)
    S, T = int(lens.max()), int(lens.max()) + 1
    cdf = np.cumsum(1.0 / np.arange(1, src_vocab - 2))
    src = np.zeros((batch, S), np.int32)
    trg_in = np.zeros((batch, T), np.int32)
    trg_out = np.zeros((batch, T), np.int32)
    for b, n in enumerate(lens):
        tok = 3 + np.searchsorted(cdf, rng.random_sample(n) * cdf[-1])
        src[b, :n] = tok
        mapped = 3 + (7 * tok[::-1]) % (trg_vocab - 3)
        trg_in[b, :n + 1] = np.concatenate([[BOS], mapped])
        trg_out[b, :n + 1] = np.concatenate([mapped, [EOS]])
    return (src, lens.astype(np.int32), trg_in, trg_out,
            (lens + 1).astype(np.int32))
