from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  load_reference_state)
