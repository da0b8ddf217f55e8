"""Subprocess worker of tests/test_torch_program_store.py: builds ONE
port GenerationEngine in a fresh process, serves two fixed greedy
prompts and writes a JSON report: the cold-process half of the
warm-start test (a ledger read inside one process cannot show that the
store survives a process; this script can).

    python tests/torch_program_store_worker.py --out report.json \
        --weights gpt.npz [--store DIR]

Imports only numpy, torch and paddle_tpu_torch. The weights are the JAX
package's tiny GPT's state (`--weights`, copied in with
`models.load_reference_state`) and the prompts are RandomState(0)'s, so
two processes with the same argv have the same store key and, warm or
cold, must produce the same tokens.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--store", default="")
    args = ap.parse_args()

    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                         load_reference_state)

    net = GPTForCausalLM(GPTConfig.tiny(dropout=0.0), device="cpu").eval()
    with np.load(args.weights) as z:
        load_reference_state(net, {k: z[k] for k in z.files})
    prompts = np.random.RandomState(0).randint(
        0, 512, size=(2, 7)).astype("int64")

    eng = serving.GenerationEngine(
        net, device="cpu", max_slots=2, page_size=4, num_pages=64,
        prefill_buckets=(8,), max_new_tokens=5, request_timeout_ms=0,
        program_store=args.store or "")
    try:
        outs = [f.result(timeout=300)
                for f in [eng.submit(p, max_new_tokens=5) for p in prompts]]
        stats = eng.stats()
    finally:
        eng.shutdown()

    report = {
        "outputs": [np.asarray(o).tolist() for o in outs],
        "compiles": stats["compiles"],
        "loaded": stats["loaded"],
        "programs": stats["programs"],
        "program_store": stats["program_store"],
    }
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
