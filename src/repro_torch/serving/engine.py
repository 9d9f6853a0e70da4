"""Batched serving engine of the port: continuous batching over fixed
decode slots with per-tick CARINA accounting, as the reference's
`src/repro/serving/engine.py` runs it:

  * `slots` concurrent sequences share one (L, B, S_max, ...) cache;
  * admission runs a single-sequence prefill and writes its cache
    entries (keys and values, MLA's latent and roped key, or the RG-LRU's
    or Mamba's conv tail and state) into the slot; a local-attention
    layer's ring buffer takes the prompt's last min(window, S_p) keys and
    values at their positions modulo its size, the rest of the slot
    zeroed;
  * every engine tick decodes all active slots in one batched
    `decode_step` with per-slot positions, and picks tokens greedily
    (`argmax`);
  * finished slots are freed and refilled from the queue;
  * a `ServingSession` in live mode gates admissions on grid carbon and
    accounts each tick's runtime, energy and CO2.

The engine runs on the card unless `device=` says otherwise.  Full-
attention, MLA, ring-buffer (local attention), RG-LRU and Mamba caches
are ported.  Refused: a cache of any other kind (`NotImplementedError`,
never written); a prompt longer than a full-attention cache
(`NotImplementedError`: the reference would go on to write its decode
steps past the cache's end); and a prompt shorter than an RG-LRU's or a
Mamba layer's d_conv - 1 tokens (`ValueError`: the reference's conv
tail is then short, and its slot write broadcasts or fails).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import LOCAL_ATTN, ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.model import Model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S_prompt,) int32
    max_new: int = 16
    # filled by the engine
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_finish: float = 0.0


def _write_slot(cache, prefill_cache, slot: int, cfg: ModelConfig,
                prompt_len: int):
    """Copy a single-sequence prefill cache into the batch cache at `slot`
    (in place; returns the batch cache)."""
    for seg, seg_c, seg_p in zip(T.layer_plan(cfg), cache, prefill_cache):
        for (kind, _), c, pc in zip(seg.pattern, seg_c, seg_p):
            # RG-LRU: conv (L, B, K-1, w) and h (L, B, w); Mamba: conv
            # (L, B, K-1, d_inner) and ssm (L, B, d_inner, N)
            if set(c) in ({"conv", "h"}, {"conv", "ssm"}):
                if pc["conv"].shape[2] != c["conv"].shape[2]:
                    block = "RG-LRU" if "h" in c else "Mamba layer"
                    raise ValueError(
                        f"a prompt of {prompt_len} tokens is shorter than "
                        f"the {block}'s conv tail of {c['conv'].shape[2]}")
                for key in c:
                    c[key][:, slot] = pc[key][:, 0]
                continue
            if set(c) not in ({"k", "v"}, {"c_kv", "k_rope"}):
                raise NotImplementedError(
                    f"cache entries {sorted(c)} are not ported")
            for key in c:                      # (L, B, S, ...)
                src = pc[key]                  # (L, 1, S_p, ...)
                s_cache, s_p = c[key].shape[2], src.shape[2]
                if kind == LOCAL_ATTN:         # the ring: position i at i % S
                    take = min(s_cache, s_p)
                    dest = torch.arange(s_p - take, s_p,
                                        device=src.device) % s_cache
                    c[key][:, slot] = 0
                    c[key][:, slot, dest] = src[:, 0, s_p - take:].to(
                        c[key].dtype)
                elif s_p > s_cache:
                    raise NotImplementedError(
                        f"a prompt of {s_p} tokens is longer than the "
                        f"full-attention cache's s_max = {s_cache}")
                else:
                    c[key][:, slot, :s_p] = src[:, 0]
    return cache


class ServingEngine:
    def __init__(self, model: Model, params, *, slots: int = 4,
                 s_max: int = 256, session=None, eos_id: int = -1,
                 device=None):
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.slots = slots
        self.s_max = s_max
        # a core.serve.ServingSession in live mode: carbon-gated
        # admission + per-tick energy/CO2 accounting
        self.session = session
        self.eos_id = eos_id
        self.device = resolve_device(device)
        self.cache = model.cache_zeros(slots, s_max, self.device)
        self.lengths = np.zeros((slots,), np.int32)      # current position
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self._decode = model.decode_step
        self._prefill = model.prefill
        self._next_rid = 0
        self.completed: List[Request] = []

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int = 16) -> int:
        r = Request(self._next_rid, np.asarray(prompt, np.int32), max_new,
                    t_submit=time.monotonic())
        self._next_rid += 1
        self.queue.append(r)
        return r.rid

    def _admit(self):
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            if (self.session is not None
                    and not self.session.gate_open(len(self.queue))):
                break                      # dirty hour: let the queue wait
            r = self.queue.pop(0)
            tokens = torch.as_tensor(r.prompt[None, :], dtype=torch.int64,
                                     device=self.device)
            logits, pc = self._prefill(self.params, {"tokens": tokens})
            self.cache = _write_slot(self.cache, pc, slot, self.cfg,
                                     len(r.prompt))
            r.generated.append(int(torch.argmax(logits[0])))
            self.active[slot] = r
            self.lengths[slot] = len(r.prompt)

    # ------------------------------------------------------------------
    def tick(self) -> int:
        """One engine iteration: admit + one batched decode step.
        Returns the number of active slots."""
        self._admit()
        act = [s for s in range(self.slots) if self.active[s] is not None]
        if not act:
            return 0
        t0 = time.monotonic()
        tokens = np.zeros((self.slots, 1), np.int64)
        for s in act:
            tokens[s, 0] = self.active[s].generated[-1]
        idx = torch.as_tensor(self.lengths, dtype=torch.int64,
                              device=self.device)
        logits, self.cache = self._decode(
            self.params, self.cache,
            torch.as_tensor(tokens, device=self.device), idx)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        for s in act:
            r = self.active[s]
            r.generated.append(int(nxt[s]))
            self.lengths[s] += 1
            if (len(r.generated) >= r.max_new
                    or int(nxt[s]) == self.eos_id
                    or self.lengths[s] >= self.s_max - 1):
                r.done = True
                r.t_finish = time.monotonic()
                self.completed.append(r)
                self.active[s] = None
                self.lengths[s] = 0
        if self.session is not None:
            self.session.record_tick(time.monotonic() - t0,
                                     active=len(act), steps=1)
        return len(act)

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        for _ in range(max_ticks):
            if not self.queue and all(a is None for a in self.active):
                break
            self.tick()
        return self.completed
