"""BERT model family (port of `paddle_tpu.models.bert`; reference PaddleNLP
`transformers/bert/modeling.py`).

BERT and ERNIE share one encoder architecture (the difference is the
pretraining data and objectives, not the graph), so the BERT classes are
configuration aliases over the ERNIE tower, as in the JAX package."""
from __future__ import annotations

from .ernie import (ErnieConfig, ErnieForPretraining,
                    ErnieForSequenceClassification, ErnieModel)

__all__ = ["BertConfig", "BertModel", "BertForSequenceClassification",
           "BertForPretraining"]


class BertConfig(ErnieConfig):
    @classmethod
    def base(cls):
        return cls(vocab_size=30522, hidden_size=768,
                   num_hidden_layers=12, num_attention_heads=12,
                   intermediate_size=3072)

    @classmethod
    def large(cls):
        return cls(vocab_size=30522, hidden_size=1024,
                   num_hidden_layers=24, num_attention_heads=16,
                   intermediate_size=4096)


class BertModel(ErnieModel):
    pass


class BertForSequenceClassification(ErnieForSequenceClassification):
    pass


class BertForPretraining(ErnieForPretraining):
    pass
