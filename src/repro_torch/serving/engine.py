"""Single-model serving engine (mirrors `repro.serving.engine`): slot-based
continuous batching over the decode step.

Requests are admitted into fixed decode slots; each slot tracks its own
position and every decode wave passes the per-slot position vector, so new
requests join while others are mid-generation.  Prefill replays the prompt
through decode steps in teacher-forcing mode, exactly as the reference
does (including the zero token the other slots see at their positions).

Recurrent (SSM) state is per request, where the reference lets it leak: a
slot's conv and SSD state are zeroed at `admit`, and a decode step
advances the state only of the slots it feeds (the slot being prefilled,
or the active slots of a wave).  The reference feeds every slot and never
clears one, so a Mamba request's tokens there depend on what else shares
the engine.  Attention caches behave as the reference's: a stray row
written for an unfed slot is overwritten when that slot reaches the
position."""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.models import model as M

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class Request:
    uid: int
    prompt_tokens: np.ndarray           # (L,)
    max_new_tokens: int = 16
    # filled by the engine:
    output_tokens: Optional[List[int]] = None
    n_prompt: int = 0
    done: bool = False
    t_submit: float = 0.0
    t_finish: float = 0.0
    #: terminal error state (drain truncation, no available engine)
    error: Optional[str] = None
    #: called with each decoded token id as the decode wave produces it
    on_token: Optional[Callable[[int], None]] = None
    #: cooperative cancellation: the slot is freed at the next decode wave
    cancelled: bool = False


class IncompleteDrainError(RuntimeError):
    """`run_until_drained` hit ``max_steps`` with requests still pending;
    the survivors are marked ``error="incomplete_drain"`` and carried on
    the exception."""

    def __init__(self, msg: str, *, survivors: List["Request"], steps: int):
        super().__init__(msg)
        self.survivors = survivors
        self.steps = steps


class ServingEngine:
    """Greedy-decoding engine for one pool model on ``device``.  ``params``
    (an `LM`, e.g. from `params_from_jax`) are moved to ``device`` in
    place; by default the engine draws its own seeded weights there."""

    def __init__(self, cfg, params: Optional[M.LM] = None, *,
                 max_slots: int = 4, cache_len: int = 128, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = (params.to(self.device) if params is not None
                       else M.init_params(cfg, seed=seed, device=self.device))
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.caches = M.init_caches(cfg, max_slots, cache_len, self.device)
        self.pos = np.full((max_slots,), -1, np.int64)       # next position
        self.slot_req: List[Optional[Request]] = [None] * max_slots
        self.stats = {"decode_steps": 0, "tokens_out": 0, "prefill_tokens": 0}

    def _decode(self, batch_tok: np.ndarray, pos_vec: np.ndarray,
                feed: np.ndarray):
        tok = torch.from_numpy(batch_tok).to(self.device, torch.int64)
        pos = torch.from_numpy(pos_vec).to(self.device, torch.int32)
        fed = torch.from_numpy(feed).to(self.device)
        logits, self.caches = M.decode_step(self.params, self.cfg,
                                            self.caches, tok, pos, feed=fed)
        return logits

    def _clear_state(self, slot: int) -> None:
        """Zero the recurrent state a new request starts from."""
        for cache in self.caches:
            if "ssd" in cache:
                for t in cache.values():
                    t[slot].zero_()

    # ---- slot management ----
    def has_free_slot(self) -> bool:
        return any(r is None for r in self.slot_req)

    def admit(self, req: Request) -> bool:
        for s in range(self.max_slots):
            if self.slot_req[s] is None:
                self.slot_req[s] = req
                req.output_tokens = []
                req.n_prompt = len(req.prompt_tokens)
                req.t_submit = time.time()
                self.pos[s] = 0
                self._clear_state(s)
                self._prefill_slot(s, req)
                return True
        return False

    def _prefill_slot(self, slot: int, req: Request):
        """Teacher-forced prompt replay into the slot's cache."""
        toks = np.asarray(req.prompt_tokens, np.int32)
        self.stats["prefill_tokens"] += len(toks)
        batch_tok = np.zeros((self.max_slots, 1), np.int32)
        feed = np.zeros((self.max_slots,), bool)
        feed[slot] = True
        for t, tok in enumerate(toks):
            batch_tok[:] = 0
            batch_tok[slot, 0] = tok
            pos_vec = np.maximum(self.pos, 0).astype(np.int32)
            pos_vec[slot] = t
            self._decode(batch_tok, pos_vec, feed)
        self.pos[slot] = len(toks)

    # ---- decode wave over all active slots ----
    def step(self):
        for s, r in enumerate(self.slot_req):
            if r is not None and r.cancelled:
                r.error = "cancelled"
                r.t_finish = time.time()
                self.slot_req[s] = None
                self.pos[s] = -1
        active = [s for s, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return
        batch_tok = np.zeros((self.max_slots, 1), np.int32)
        for s in active:
            r = self.slot_req[s]
            last = (r.output_tokens[-1] if r.output_tokens
                    else int(r.prompt_tokens[-1]))
            batch_tok[s, 0] = last
        pos_vec = np.maximum(self.pos, 0).astype(np.int32)
        feed = np.zeros((self.max_slots,), bool)
        feed[active] = True
        logits = self._decode(batch_tok, pos_vec, feed)
        best = logits.argmax(dim=-1).cpu().numpy()   # first max, as np.argmax
        self.stats["decode_steps"] += 1
        for s in active:
            r = self.slot_req[s]
            nxt = int(best[s])
            r.output_tokens.append(nxt)
            self.stats["tokens_out"] += 1
            self.pos[s] += 1
            if r.on_token is not None:
                try:
                    r.on_token(nxt)
                except Exception:
                    # a failing stream consumer must not fail the other
                    # slots' requests in this wave
                    _log.exception("on_token callback failed (uid=%s)",
                                   r.uid)
                    r.on_token = None
            if (len(r.output_tokens) >= r.max_new_tokens
                    or self.pos[s] >= self.cache_len - 1):
                r.done = True
                r.t_finish = time.time()
                self.slot_req[s] = None
                self.pos[s] = -1

    def release(self, reqs: List[Request]) -> int:
        """Evict ``reqs`` from their slots without marking them done (the
        reroute path).  Returns the number of slots freed."""
        wanted = {id(r) for r in reqs}
        freed = 0
        for s, r in enumerate(self.slot_req):
            if r is not None and id(r) in wanted:
                self.slot_req[s] = None
                self.pos[s] = -1
                freed += 1
        return freed

    def run_until_drained(self, pending: List[Request],
                          max_steps: int = 10_000) -> int:
        """Admit + decode until every request finishes.  Hitting
        ``max_steps`` with work outstanding marks every survivor
        ``error="incomplete_drain"``, evicts it and raises
        `IncompleteDrainError`."""
        pending = list(pending)
        steps = 0
        while pending or any(r is not None for r in self.slot_req):
            if steps >= max_steps:
                survivors = pending + [r for r in self.slot_req
                                       if r is not None]
                for r in survivors:
                    r.error = "incomplete_drain"
                self.release(survivors)
                raise IncompleteDrainError(
                    f"engine drained {steps} steps but {len(survivors)} "
                    f"request(s) remain unfinished (max_steps={max_steps}); "
                    f"uids={[r.uid for r in survivors]}",
                    survivors=survivors, steps=steps)
            while pending and self.has_free_slot():
                req = pending.pop(0)
                if req.cancelled:
                    req.error = "cancelled"
                    req.t_finish = time.time()
                    continue
                self.admit(req)
            self.step()
            steps += 1
        return steps
