"""The standardized benchmark suite (paper §4): builders for every column of
Tables 2 and 5 plus the RouterBench per-task datasets used by the OOD study.
All seeded and deterministic; a copy of the JAX package's
`repro.data.routing_bench`, byte-equal datasets."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.dataset import RoutingDataset
from . import prices
from .synthetic import GenSpec, generate

_N = 2000  # queries per benchmark (same order as the paper's suites)


def _bench(name, models, seed, *, binary=True, n=_N, locality=0.85,
           latent_dim=8, ambient_dim=768, cluster_offset=0.0):
    return generate(GenSpec(name=name, models=models, n_queries=n,
                            binary=binary, seed=seed, locality=locality,
                            latent_dim=latent_dim, ambient_dim=ambient_dim,
                            cluster_offset=cluster_offset))


def text_benchmarks() -> Dict[str, RoutingDataset]:
    """The 9 family-suites of Table 2 (AlpacaEval/HELM-Lite/OpenLLM x 3)."""
    out = {}
    seed = 100
    for fam, models in prices.ALPACAEVAL.items():
        out[f"AlpacaEval/{fam}"] = _bench(f"AlpacaEval/{fam}", models, seed,
                                          binary=False)   # LC win rates
        seed += 1
    for fam, models in prices.HELM_LITE.items():
        out[f"HELM-Lite/{fam}"] = _bench(f"HELM-Lite/{fam}", models, seed)
        seed += 1
    for fam, models in prices.OPENLLM.items():
        out[f"OpenLLM/{fam}"] = _bench(f"OpenLLM/{fam}", models, seed)
        seed += 1
    return out


def routerbench_tasks() -> Dict[str, RoutingDataset]:
    """Six per-task RouterBench datasets (same 11-model pool, different query
    distributions — distinct latent cluster regions => real domain shift for
    the OOD protocol of Appendix H)."""
    out = {}
    models = prices.ROUTERBENCH["RouterBench"]
    for i, task in enumerate(prices.ROUTERBENCH_TASKS):
        out[task] = _bench(f"RouterBench/{task}", models, 300 + i,
                           cluster_offset=2.5 * i, n=1200)
    return out


def routerbench_combined() -> RoutingDataset:
    """The single 'RouterBench' column of Table 2 (all tasks pooled)."""
    import numpy as np
    tasks = routerbench_tasks()
    parts = list(tasks.values())
    emb = np.concatenate([p.embeddings for p in parts])
    sc = np.concatenate([p.scores for p in parts])
    co = np.concatenate([p.costs for p in parts])
    ds = RoutingDataset("RouterBench", emb, sc, co,
                        list(parts[0].model_names))
    ds.split(seed=99)
    return ds


def vlm_benchmarks() -> Dict[str, RoutingDataset]:
    """Table 5: 5 vision-language datasets x 2 model families (vHELM pools);
    3584-d fused VLM2Vec-style embeddings, intrinsic dim ~13-18."""
    out = {}
    seed = 500
    for task in prices.VHELM_TASKS:
        for fam, models in prices.VHELM.items():
            name = f"{task}/{fam}"
            out[name] = _bench(name, models, seed, ambient_dim=3584,
                               latent_dim=14, n=1500)
            seed += 1
    return out


def full_suite() -> Dict[str, RoutingDataset]:
    suite = dict(text_benchmarks())
    suite["RouterBench"] = routerbench_combined()
    return suite
