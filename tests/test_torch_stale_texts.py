"""The port's help texts and docstrings name no ported feature as "not
ported": int8 KV pages (`FLAGS_kv_cache_dtype`), tensor-parallel serving
(`GenerationConfig`) and the InferenceEngine (`serving.restart`)."""
import ast
import re

import pytest


def _flag_help(name):
    """The help string a `register_flag(name, default, help)` call of
    `framework/flags.py` gives (the registry keeps no help)."""
    from paddle_tpu_torch.framework import flags
    with open(flags.__file__) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == \
                "register_flag" and node.args[0].value == name:
            return ast.literal_eval(node.args[2])
    raise KeyError(name)


def _texts():
    from paddle_tpu_torch.serving import generation, restart
    return {"FLAGS_kv_cache_dtype": _flag_help("FLAGS_kv_cache_dtype"),
            "GenerationConfig": generation.GenerationConfig.__doc__,
            "serving.restart": restart.__doc__}


@pytest.mark.parametrize("name,feature", [
    ("FLAGS_kv_cache_dtype", "int8"), ("GenerationConfig", "tp"),
    ("serving.restart", "InferenceEngine")])
def test_no_not_ported_for_ported_features(name, feature):
    text = " ".join(_texts()[name].split())
    assert feature in text
    for sentence in re.split(r"(?<=[.;])\s", text):
        if feature in sentence:
            assert "not ported" not in sentence and \
                "not yet ported" not in sentence, sentence


def _slice_texts():
    from paddle_tpu_torch import models
    from paddle_tpu_torch.distributed import sharding
    from paddle_tpu_torch.models.gpt import MoEFeedForward
    from paddle_tpu_torch.parallel import pipeline, spmd
    return {"tp_annotate": models.tp_annotate.__doc__,
            "MoEFeedForward": MoEFeedForward.__doc__,
            "parallel.spmd": spmd.__doc__,
            "parallel.pipeline": pipeline.__doc__,
            "distributed.sharding": sharding.__doc__}


@pytest.mark.parametrize("name,feature", [
    ("tp_annotate", "mp"), ("MoEFeedForward", "ep"),
    ("parallel.spmd", "Lamb"), ("parallel.spmd", "clip"),
    ("parallel.pipeline", "clip"), ("distributed.sharding", "ZeRO-3")])
def test_multi_gpu_texts_name_no_refusal(name, feature):
    """tp_annotate, the experts over 'ep', the whole-norm rules and the
    clip under ZeRO and in the pipeline, and ZeRO-3's sharded parameters
    are ported: their texts keep no sentence saying they wait, are not
    ported, or must be avoided."""
    text = " ".join(_slice_texts()[name].split())
    assert feature in text
    for sentence in re.split(r"(?<=[.;])\s", text):
        if feature in sentence:
            for stale in ("not yet ported", "not ported", "waits for",
                          "must be elementwise", "keeps the gathered"):
                assert stale not in sentence, sentence
