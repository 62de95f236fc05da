"""Serving engine (counterpart of ``repro.serve.engine``): bucketed prefill
+ continuous-batching decode over fixed slots for the recurrent cell
families (GRU and sLSTM), and one aligned wave for the dense LM.

Cell families. A family's cache is its flat tuple of per-layer state
leaves (one per layer for the GRU, four for the sLSTM); the admit scatter
copies it leaf by leaf. The figure of merit is the per-step latency of the
sequential decode path (the paper's deadline per feature vector);
throughput comes from batching requests into a fixed number of slots.

* **Prompt-length buckets**: prompts are left-padded to the next power of
  two (>= ``BUCKET_MIN``) with a (B, T) length mask; masked steps freeze
  the recurrent state, so a bucketed prompt gives its unpadded result.
* **Fixed slots**: prefill and decode always run at ``max_batch`` rows;
  empty slots carry zero features and fully masked prompts.
* **Continuous batching**: ``generate`` takes more requests than slots.
  Whenever slots free up, queued requests are admitted; all admits of one
  step share one bucketed prefill, whose rows are copied into the freed
  slots of the live cache in place (``index_copy_``).

A cell request's ``prompt`` is a float (S, X) feature window; each decode
step pushes one feature vector (the request's ``stream``, else the last
prompt vector again) and emits the running class prediction. A lane
retires at ``max_new_tokens`` or when its class equals ``eos_id``. The
engine records the executor backend of every prefill
(``prefill_backends``) and of every recorded decode step
(``decode_backends``, aligned with ``step_times``).

The dense LM (``family="dense"``): ``generate`` serves one wave of at most
``max_batch`` token prompts, left-padded with token 0 to the longest
prompt. The pad tokens are attended: there is no pad mask and positions
run 0..S-1 over the padded row, exactly as in the JAX engine. Decoding is
greedy (argmax); a request ends at ``eos_id`` or at ``max_new_tokens``,
and the wave at the longest budget or when every request has ended.

Under a mesh (``ctx=ShardCtx(mesh)``, cell families) every rank runs an
engine over the same requests, SPMD: the model calls and the executables
the engine records take the ctx's placement, so a prefill or step is
attributed to the mesh backend that served it (``cuda_sharded`` under
``"cuda"`` for prefill) and the ranks' streams are equal.

Steps and prefills are timed with the engine clock around work that ends
in ``torch.cuda.synchronize()`` on the card; each decode key's first step
is excluded from the step statistics, as in the JAX engine.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import cells as cell_families
from repro_torch.core import runtime
from repro_torch.distributed.sharding import NO_SHARD, ShardCtx
from repro_torch.models import api as mapi
from repro_torch.serve.clock import Clock, SystemClock

BUCKET_MIN = 8      # shortest prefill bucket


@dataclass
class Request:
    prompt: np.ndarray               # (S,) int tokens | (S, X) float features
    max_new_tokens: int = 16
    eos_id: int = -1                 # -1 = never
    stream: Optional[np.ndarray] = None  # cells: (>=max_new, X) features
    out: List[int] = field(default_factory=list)
    done: bool = False
    # lifecycle timestamps (engine clock): submit -> admit is the queue
    # wait, submit -> finish the end-to-end time
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_finish: Optional[float] = None


def _pct(xs, q: float) -> float:
    """Percentile; an empty history is NaN, never 0.0."""
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else float("nan")


def _mean(xs) -> float:
    return float(np.mean(np.asarray(xs))) if len(xs) else float("nan")


def bucket_len(S: int, minimum: int = BUCKET_MIN) -> int:
    """Next power of two >= max(S, minimum): the prefill bucket."""
    b = max(minimum, 1)
    while b < S:
        b *= 2
    return b


@dataclass
class _Slot:
    """One live decode lane of a wave."""
    req: Request
    last_feat: np.ndarray            # free-running fallback feature vector
    step: int = 0                    # per-request decode step (stream index)


@dataclass
class _GruWave:
    """The wave a stepwise caller (``gru_wave_step``) advances."""
    slots: List[Optional[_Slot]]
    nxt: np.ndarray                  # (max_batch, X) next-feature staging
    key: tuple                       # decode key (max_batch, X)
    pending: deque = field(default_factory=deque)
    cache: Optional[dict] = None     # None until the first admit prefills


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, max_batch: int = 8,
                 clock: Optional[Clock] = None, device="cuda",
                 ctx: ShardCtx = NO_SHARD):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.clock = clock or SystemClock()
        self.api = mapi.get_api(cfg)
        self.ctx = ctx
        if ctx.mesh is not None:
            if not self._is_cell():
                raise NotImplementedError(
                    f"family {cfg.family!r} has no mesh path in the port "
                    f"yet; the cell families serve under a mesh")
            if ctx.mesh.device != self.device:
                raise ValueError(f"engine on {self.device} but this rank's "
                                 f"mesh device is {ctx.mesh.device}")
        self._kw = {"ctx": ctx} if self._is_cell() else {}
        self.params = self.api.prepare_params(params, cfg, self.device,
                                              **self._kw)
        self._decode_backends_by_key: Dict[tuple, Optional[str]] = {}
        self._decode_warm = set()        # keys whose first step has passed
        self._prefill_backends_by_bucket: Dict[int, Optional[str]] = {}
        self._wave: Optional[_GruWave] = None
        self.step_times: List[float] = []
        self.prefill_times: List[float] = []
        self.prefill_backends: List[str] = []   # executor choice per prefill
        self.decode_backend: Optional[str] = None    # latest resolved
        self.decode_backends: List[str] = []    # per recorded step
        self.queue_waits: List[float] = []      # per request: submit -> admit
        self.e2e_times: List[float] = []        # per request: submit -> finish

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- waves ---------------------------------------------------------------

    def _is_cell(self) -> bool:
        return cell_families.is_cell_family(self.cfg.family)

    def generate(self, requests: Sequence[Request]) -> List[Request]:
        """Serve a wave of requests: any number by continuous batching for
        a cell family, one aligned batch of at most ``max_batch`` for the
        dense LM."""
        reqs = list(requests)
        if not reqs:
            return []
        if not self._is_cell():
            return self._generate_lm(reqs)
        self.gru_wave_begin(reqs)
        while self.gru_wave_active():
            self.gru_wave_step()
        self._wave = None
        return reqs

    def _admitted(self, r: Request, now: float) -> None:
        r.t_admit = now
        self.queue_waits.append(now - r.t_submit)

    def _generate_lm(self, reqs: List[Request]) -> List[Request]:
        """The dense LM's wave (JAX ``ServeEngine.generate``'s LM path):
        left-pad with token 0, one prefill, greedy decode steps until every
        request has its budget or its ``eos_id``."""
        if len(reqs) > self.max_batch:
            raise ValueError(f"{len(reqs)} requests > max_batch "
                             f"{self.max_batch}: an LM wave is one batch")
        B = len(reqs)
        now = self.clock.now()
        for r in reqs:
            if r.t_submit is None:
                r.t_submit = now
        S = max(len(r.prompt) for r in reqs)
        toks = np.zeros((B, S), np.int32)
        for i, r in enumerate(reqs):
            toks[i, S - len(r.prompt):] = r.prompt      # left-pad alignment
        t0 = self.clock.now()
        logits, cache = self.api.prefill(
            self.params, self.cfg,
            {"tokens": torch.from_numpy(toks).to(self.device)})
        self._sync()
        self._record_prefill(S, self.clock.now() - t0)
        now = self.clock.now()
        for r in reqs:
            self._admitted(r, now)
        max_new = max(r.max_new_tokens for r in reqs)
        next_tok = logits.argmax(-1)
        key = tuple(next_tok.shape)
        finished = np.zeros(B, bool)
        for _ in range(max_new):
            t0 = self.clock.now()
            logits, cache = self.api.decode_step(self.params, self.cfg, cache,
                                                 next_tok)
            self._sync()
            self._record_step(key, self.clock.now() - t0, None)
            tok_np = next_tok.cpu().numpy()
            for i, r in enumerate(reqs):
                if not finished[i]:
                    r.out.append(int(tok_np[i]))
                    if (int(tok_np[i]) == r.eos_id
                            or len(r.out) >= r.max_new_tokens):
                        finished[i] = True
                        self._finish(r)
            if finished.all():
                break
            next_tok = logits.argmax(-1)
        for r in reqs:
            if not r.done:
                self._finish(r)
        return reqs

    def _finish(self, r: Request) -> None:
        r.done = True
        r.t_finish = self.clock.now()
        self.e2e_times.append(r.t_finish - r.t_submit)

    def _record_prefill(self, S: int, dt: float) -> None:
        """Record one prefill latency (the first of every bucket included:
        no retune invalidates anything in the port yet)."""
        self.prefill_times.append(dt)

    def _gru_prefill_batch(self, prompts: List[np.ndarray], Sb: int):
        """Left-pad prompts into the fixed (max_batch, Sb, X) slot shape
        with a length mask; rows beyond len(prompts) are fully masked."""
        X = self.cfg.gru.input_dim
        Bs = self.max_batch
        feats = np.zeros((Bs, Sb, X), np.float32)
        mask = np.zeros((Bs, Sb), bool)
        for i, p in enumerate(prompts):
            feats[i, Sb - p.shape[0]:] = p
            mask[i, Sb - p.shape[0]:] = True
        return feats, mask

    def _prefill_backend_for(self, Sb: int) -> Optional[str]:
        if Sb not in self._prefill_backends_by_bucket:
            self._prefill_backends_by_bucket[Sb] = self.api.executable(
                self.cfg, batch=self.max_batch, seq=Sb, masked=True,
                mesh=self.ctx.mesh).sequence_backend
        return self._prefill_backends_by_bucket[Sb]

    def _gru_prefill(self, prompts: List[np.ndarray]) -> dict:
        """One bucketed prefill of up to max_batch prompts; returns cache."""
        Sb = bucket_len(max(p.shape[0] for p in prompts))
        feats, mask = self._gru_prefill_batch(prompts, Sb)
        self.prefill_backends.append(self._prefill_backend_for(Sb))
        t0 = self.clock.now()
        batch = {"features": torch.from_numpy(feats).to(self.device),
                 "mask": torch.from_numpy(mask).to(self.device)}
        _, cache = self.api.prefill(self.params, self.cfg, batch, **self._kw)
        self._sync()
        self._record_prefill(Sb, self.clock.now() - t0)
        return cache

    def _make_slot(self, r: Request) -> _Slot:
        X = self.cfg.gru.input_dim
        p = np.asarray(r.prompt, np.float32).reshape(-1, X)
        return _Slot(req=r, last_feat=p[-1])

    def gru_wave_begin(self, requests: Sequence[Request] = ()) -> None:
        """Start a fresh continuous-batching wave (cell families only)."""
        if not self._is_cell():
            raise ValueError(f"family {self.cfg.family!r}: the stepwise wave "
                             f"API serves the cell families only")
        X = self.cfg.gru.input_dim
        Bs = self.max_batch
        self._wave = _GruWave(slots=[None] * Bs,
                              nxt=np.zeros((Bs, X), np.float32),
                              key=(Bs, X))
        now = self.clock.now()
        for r in requests:
            if r.t_submit is None:
                r.t_submit = now
            self._wave.pending.append(r)

    def gru_wave_active(self) -> int:
        """Live lanes + queued requests still owed work by this wave."""
        w = self._wave
        if w is None:
            return 0
        return sum(s is not None for s in w.slots) + len(w.pending)

    def _admit(self, w: _GruWave, empty: List[int]) -> None:
        """Admit queued requests into the empty slots: one shared prefill,
        then an in-place row copy into the live cache."""
        X = self.cfg.gru.input_dim
        k = min(len(empty), len(w.pending))
        admits = [self._make_slot(w.pending.popleft()) for _ in range(k)]
        now = self.clock.now()
        for s in admits:
            self._admitted(s.req, now)
        fresh = self._gru_prefill(
            [np.asarray(s.req.prompt, np.float32).reshape(-1, X)
             for s in admits])
        if w.cache is None:
            w.cache = fresh      # first cohort: row i belongs to slot i
        else:
            idx = torch.tensor(empty[:k], dtype=torch.long,
                               device=self.device)
            for h, f in zip(w.cache["h"], fresh["h"]):
                h.index_copy_(0, idx, f[:k])
        for j, s in zip(empty[:k], admits):
            w.slots[j] = s

    def gru_wave_step(self) -> List[Request]:
        """Advance the wave one decode step: admit queued requests into
        empty slots, run one decode step over the fixed slots, retire
        finished lanes. Returns the requests that finished this step."""
        w = self._wave
        if w is None:
            return []
        empty = [j for j, s in enumerate(w.slots) if s is None]
        if empty and w.pending:
            self._admit(w, empty)
        if not any(s is not None for s in w.slots):
            return []
        for j, s in enumerate(w.slots):
            if s is None:
                w.nxt[j] = 0.0
                continue
            r = s.req
            w.nxt[j] = (r.stream[s.step] if r.stream is not None
                        and s.step < len(r.stream) else s.last_feat)
        backend = self._decode_backend_for(w.key)
        t0 = self.clock.now()
        x = torch.from_numpy(w.nxt).to(self.device)
        logits, w.cache = self.api.decode_step(self.params, self.cfg,
                                               w.cache, x, **self._kw)
        self._sync()
        self._record_step(w.key, self.clock.now() - t0, backend)
        cls = logits.argmax(-1).cpu().numpy()
        finished = []
        for j, s in enumerate(w.slots):
            if s is None:
                continue
            r = s.req
            r.out.append(int(cls[j]))
            s.step += 1
            if int(cls[j]) == r.eos_id or len(r.out) >= r.max_new_tokens:
                self._finish(r)
                w.slots[j] = None                       # retire mid-wave
                finished.append(r)
        return finished

    # -- stats ---------------------------------------------------------------

    def _decode_backend_for(self, key: tuple) -> Optional[str]:
        if not self._is_cell():
            return None
        if key not in self._decode_backends_by_key:
            self._decode_backends_by_key[key] = self.api.executable(
                self.cfg, batch=key[0], mesh=self.ctx.mesh).decode_backend
        self.decode_backend = self._decode_backends_by_key[key]
        return self.decode_backend

    def _record_step(self, key: tuple, dt: float,
                     backend: Optional[str]) -> None:
        """Record one decode-step latency; each key's first step is left
        out of the statistics (``decode_backends`` stays aligned)."""
        if key in self._decode_warm:
            self.step_times.append(dt)
            self.decode_backends.append(backend)
        else:
            self._decode_warm.add(key)

    def latency_stats(self) -> Dict[str, float]:
        """Per-step decode latency distribution (the paper's constraint is
        a deadline, so tails matter), prefill timings, per-request queue
        wait and end-to-end time, recorded steps per backend and the
        served dtype (cells: int8 for the ``*_q8`` backends, float32
        otherwise, of the latest resolved decode backend; the dense LM:
        its compute dtype). Empty histories report NaN."""
        ts, pf = self.step_times, self.prefill_times
        qw, ee = self.queue_waits, self.e2e_times
        per_backend: Dict[str, int] = {}
        for b in self.decode_backends:
            if b is not None:
                per_backend[b] = per_backend.get(b, 0) + 1
        return {"decode_backend_steps": per_backend,
                "device": str(self.device),
                "requests": len(ee),
                "queue_wait_mean_s": _mean(qw),
                "queue_wait_p50_s": _pct(qw, 50),
                "queue_wait_p99_s": _pct(qw, 99),
                "e2e_mean_s": _mean(ee),
                "e2e_p50_s": _pct(ee, 50),
                "e2e_p99_s": _pct(ee, 99),
                "served_dtype": (runtime.backend_dtype(self.decode_backend)
                                 if self._is_cell() else self.cfg.dtype),
                "mean_s": _mean(ts),
                "p50_s": _pct(ts, 50),
                "p90_s": _pct(ts, 90),
                "p99_s": _pct(ts, 99),
                "max_s": float(max(ts)) if ts else float("nan"),
                "steps": len(ts),
                "prefill_mean_s": _mean(pf),
                "prefill_p99_s": _pct(pf, 99),
                "prefills": len(pf)}
