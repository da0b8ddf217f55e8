"""Model-free draft proposal for speculative decoding.

Port of `paddle_tpu.serving.spec_decode`. Decode is weight-streaming
bound: one engine step reads every weight byte to advance each sequence
ONE token, so a forward over k+1 positions costs little more than one.
If something cheap can guess the next k tokens, the engine's verify
program scores all k guesses plus the bonus position in one pass
(`models.gpt.gpt_spec_verify`), keeps the longest agreeing prefix, and a
step delivers up to k+1 tokens for one weight stream.

The proposer is **prompt lookup** (n-gram continuation): the next tokens
of a sequence are guessed from its OWN history — find the most recent
earlier occurrence of the trailing n-gram and propose the tokens that
followed it. No second model, no device work: numpy over the host-side
token list. When nothing matches it proposes nothing and the slot runs as
plain one-token decode inside the same verify program; acceptance is
exact greedy agreement, so output is token-identical with speculation on
or off.
"""
from __future__ import annotations

import numpy as np

from ..framework.errors import InvalidArgumentError

__all__ = ["NGramProposer"]


class NGramProposer:
    """Prompt-lookup draft proposer: continue the trailing n-gram from
    its most recent earlier occurrence in the sequence's own tokens.

    Tries pattern lengths `max_ngram` down to 1; within one length the
    RIGHTMOST earlier occurrence **with k following tokens** wins (a
    match flush against the end of the history could propose only the
    few tokens after it, which on a periodic tail would cap every
    proposal at one token); when no occurrence has k followers the plain
    rightmost wins (a partial proposal). Returns at most `k` draft
    tokens; empty means no signal."""

    def __init__(self, max_ngram: int = 3):
        if int(max_ngram) < 1:
            raise InvalidArgumentError(
                f"NGramProposer needs max_ngram >= 1, got {max_ngram}")
        self.max_ngram = int(max_ngram)

    def propose(self, tokens, k: int) -> np.ndarray:
        """Up to `k` int32 draft tokens continuing `tokens` (1-D int
        array: the sequence's prompt + generated tokens so far). Empty
        when the history holds no matching n-gram."""
        toks = np.asarray(tokens, np.int32)
        T = int(toks.size)
        k = int(k)
        if k <= 0 or T < 2:
            return np.zeros((0,), np.int32)
        for n in range(min(self.max_ngram, T - 1), 0, -1):
            pat = toks[T - n:]
            # candidate starts s < T - n: the trailing pattern itself is
            # excluded, and every candidate has >= 1 following token
            windows = np.lib.stride_tricks.sliding_window_view(
                toks[:T - 1], n)                    # [T-n, n]
            hits = np.flatnonzero((windows == pat[None]).all(axis=1))
            if hits.size == 0:
                continue
            full = hits[hits + n + k <= T]          # can fund k drafts
            s = int(full[-1] if full.size else hits[-1])
            out = toks[s + n:s + n + k]
            if out.size:
                return out.astype(np.int32, copy=True)
        return np.zeros((0,), np.int32)
