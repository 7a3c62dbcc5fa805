"""What decides ``correct``, at a size a test run holds (the CPU, the
kernels' plain versions): a sound run passes every limit; the control (the
reference in the program's place one precision below the configuration's)
fails one; and, with the timed path broken underneath, each fault the
cell can have makes ``correct`` false.  The limits are the committed ones
(`bench/limits/<cell>.json`).  On the card (``-m gpu``) the control runs
at the cell's own size."""
import numpy as np
import pytest
import torch

from bench.tests.conftest import run_small

ROUTE = "route.knn100-1m.backlog"
TRAIN = "train.danube-1.8b.s4k"


def _fails_a_limit(readings, result):
    return any(readings[n] > c["limit"] for n, c in result["checks"].items())


@pytest.mark.parametrize("workload", [ROUTE, TRAIN, "train.danube-1.8b.s1k"])
def test_sound_run_is_correct(workload):
    code, res = run_small(workload, seed=2**31 + 17)
    assert code == 0 and res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("workload", [ROUTE, TRAIN])
def test_control_separates(workload):
    """The control reads at least three times what the program reads on
    some number at this size; at the cell's own size it fails a limit
    (the ``gpu`` test below, and the readings in PERF.md)."""
    code, res = run_small(workload, seed=2**31 + 23,
                          extra=lambda cell, lim: cell.control(lim))
    assert code == 0 and res["correct"]
    ctl = res["extra"]
    assert any(ctl[n] > 3 * c["value"] and ctl[n] > 0
               for n, c in res["checks"].items()), (ctl, res["checks"])
    if workload == ROUTE:
        assert _fails_a_limit(ctl, res), ctl


# ---- faults planted under the timed path --------------------------------

def test_route_answer_altered(monkeypatch):
    from repro_torch.serving.router_service import RouterService
    orig = RouterService.submit_texts

    def altered(self, texts, *a, **kw):
        out = orig(self, texts, *a, **kw)
        r = out[0]
        r.model = [m for m in self.model_names if m != r.model][0]
        return out
    monkeypatch.setattr(RouterService, "submit_texts", altered)
    code, res = run_small(ROUTE, seed=41)
    assert code == 0 and not res["correct"]
    assert res["checks"]["choice_mismatch"]["value"] > 0


def test_route_half_of_the_wave_left_out(monkeypatch):
    from repro_torch.core.routers.knn import KNNRouter
    orig = KNNRouter.serve_fused

    def half(self, X, lam, *a, **kw):
        h = max(1, len(X) // 2)
        out = orig(self, X[:h], lam[:h], *a, **kw)
        return tuple(np.resize(o, (len(X),) + o.shape[1:]) for o in out)
    monkeypatch.setattr(KNNRouter, "serve_fused", half)
    code, res = run_small(ROUTE, seed=43)
    assert code == 0 and not res["correct"]


def test_route_result_to_the_wrong_ticket(monkeypatch):
    from repro_torch.serving.scheduler import MicroBatcher
    orig = MicroBatcher.flush

    def swapped(self):
        out = orig(self)
        if len(out) > 1:
            keys = sorted(self._results)[-len(out):]
            a, b = keys[0], keys[1]
            self._results[a], self._results[b] = (self._results[b],
                                                  self._results[a])
        return out
    monkeypatch.setattr(MicroBatcher, "flush", swapped)
    code, res = run_small(ROUTE, seed=47)
    assert code == 0 and not res["correct"]


def test_train_state_unchanged(monkeypatch):
    from repro_torch.training import optimizer as O

    def frozen(opt, grads, state, params):
        state["step"].add_(1)
        return {"grad_norm": O.global_norm(grads),
                "lr": O.schedule(opt, state["step"])}
    monkeypatch.setattr(O, "update", frozen)
    code, res = run_small(TRAIN, seed=53)
    assert code == 0 and not res["correct"]
    assert res["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_train_half_of_the_batch_left_out(monkeypatch):
    from repro_torch.models import model as M
    orig = M.loss_fn

    def half(lm, cfg, batch, *a, **kw):
        h = max(1, batch["tokens"].shape[0] // 2)
        return orig(lm, cfg, {k: v[:h] for k, v in batch.items()}, *a, **kw)
    monkeypatch.setattr(M, "loss_fn", half)
    code, res = run_small(TRAIN, seed=59)
    assert code == 0 and not res["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [ROUTE, TRAIN])
def test_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    from bench import run
    args = run.parse(["--workload", workload, "--seed", str(2**31 + 101),
                      "--seconds", "2", "--trace", "0"])
    code, res = run.run_cell(args, extra=lambda cell, lim: cell.control(lim))
    assert code == 0 and res["correct"], res["checks"]
    assert _fails_a_limit(res["extra"], res), res["extra"]
