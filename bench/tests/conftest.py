"""Shared set-up of the benchmark's own tests (run them from the repo's
root: ``python -m pytest -q bench/tests``; on the card add ``-m gpu``).
Cells run on the CPU at a small size here, with the kernels' plain
versions."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: small sizes of each configuration and mix, for cells run on the CPU
SMALL = {
    "knn100-exact-1m": {"support_rows": 6000, "prototypes": 300,
                        "pool_reduced": True},
    "h2o-danube-1.8b": {"num_hidden_layers": 2, "hidden_size": 128,
                        "num_attention_heads": 4, "num_key_value_heads": 2,
                        "head_dim": 32, "intermediate_size": 256,
                        "vocab_size": 512, "sliding_window": 64},
    "backlog": {"max_batch": 64, "text_pool": 256, "check_share": 1.0},
    "open": {"rate": 100, "text_pool": 256, "check_share": 1.0},
    "s4k": {"batch": 2, "seq": 64, "max_steps": 8},
    "s1k": {"batch": 4, "seq": 32, "max_steps": 8},
}


def small(workload: str) -> dict:
    from bench import common
    w = common.workload(common.manifest(), workload)
    return {"config": dict(SMALL[w["config"]]),
            "traffic": dict(SMALL[w["traffic"]])}


def run_small(workload: str, seed: int, seconds: float = 2.0, trace=0,
              extra=None):
    """One run of ``workload`` on the CPU at its small size."""
    from bench import run
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace)])
    return run.run_cell(args, overrides=small(workload), device="cpu",
                        extra=extra)
