from .bert import (BertConfig, BertForPretraining,  # noqa: F401
                   BertForSequenceClassification, BertModel)
from .ernie import (ErnieConfig, ErnieForPretraining,  # noqa: F401
                    ErnieForSequenceClassification, ErnieModel, tp_annotate)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  MoEFeedForward, load_reference_state)
