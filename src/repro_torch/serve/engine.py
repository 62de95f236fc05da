"""Serving engine (counterpart of ``repro.serve.engine``): bucketed prefill
+ continuous-batching decode over fixed slots for the recurrent cell
families (GRU and sLSTM), and one aligned wave for the LMs (the
transformers and the recurrent LMs, xLSTM and hymba).

Cell families. A family's cache is its flat tuple of per-layer state
leaves (one per layer for the GRU, four for the sLSTM); the admit scatter
copies it leaf by leaf. The figure of merit is the per-step latency of the
sequential decode path (the paper's deadline per feature vector);
throughput comes from batching requests into a fixed number of slots.

* **Prompt-length buckets**: prompts are left-padded to the next power of
  two (>= ``bucket_min``, 8 by default) with a (B, T) length mask; masked
  steps freeze the recurrent state, so a bucketed prompt gives its
  unpadded result. An autotuned engine may install a ladder of bucket
  lengths instead (``bucket_ladder``).
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

The LMs (``family="dense"``, ``"moe"``, ``"ssm"`` (the xLSTM) and
``"hybrid"`` (hymba)): ``generate`` serves one wave of at most ``max_batch`` token prompts, left-padded with
token 0 to the longest prompt. The pad tokens are attended: there is no pad mask and positions
run 0..S-1 over the padded row, exactly as in the JAX engine. Decoding is
greedy (argmax); a request ends at ``eos_id`` or at ``max_new_tokens``,
and the wave at the longest budget or when every request has ended. An
MoE wave's requests share the experts' capacity (JAX's semantics): at a
decode step of B requests an expert takes ceil(B*k/E*1.25) tokens in
request order and drops the rest, so a request's stream depends on its
wave-mates.

Under a mesh (``ctx=ShardCtx(mesh)``) every rank runs an engine over the
same requests, SPMD, and the ranks' streams are equal. A cell family's
model calls and the executables the engine records take the ctx's
placement (the mesh's ``model`` axis), so a prefill or step is attributed
to the mesh backend that served it (``cuda_sharded`` under ``"cuda"`` for
prefill). An LM wave passes the ctx to every prefill and decode step: the
MoE layers split their experts over the mesh (``models.moe``), and
``prepare_params`` keeps only this rank's block of the experts.

Frozen executables. The engine freezes one executor executable per decode
key and one per prefill bucket at first use and calls every step and
prefill through it (``exe=``), so a cost model installed mid-wave changes
neither the backend of a live wave nor its attribution, and a live key
never compiles again: the counterpart of JAX's jit caches, which embed the
backend of their trace. ``_invalidate_jits`` drops them.

Autotuning (counterpart of JAX's; ``repro_torch.serve.autotune``): an
attached ``AutoTuner`` observes every enqueued prompt's length and every
warm step's time, and retunes only at wave boundaries (no live lane, no
queued request; ``_maybe_retune``): the wave size, the bucket ladder, and
the CostModel from served timings (``refresh_executables`` then drops the
frozen executables only if a backend changed). A table installed from
outside takes effect when the caller calls ``refresh_executables`` at a
boundary, with or without a tuner, as in JAX. Executables that read
weight views the prepared params lack (a flip, under a mesh, to a
backend whose views were not built) make the engine rebuild its params
once, when they are frozen or refreshed, never per step. The applied
decisions are in ``latency_stats()["autotune"]``.

Steps and prefills are timed with the engine clock around work that ends
in ``torch.cuda.synchronize()`` on the card; each decode key's first step
is excluded from the step statistics, as in the JAX engine, and so is the
first prefill of a bucket created after a retune.
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
                 ctx: ShardCtx = NO_SHARD, bucket_min: int = BUCKET_MIN,
                 tuner=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.bucket_min = bucket_min
        self.clock = clock or SystemClock()
        # optional feedback loop (repro_torch.serve.autotune.AutoTuner):
        # applied only at wave boundaries (_maybe_retune)
        self.tuner = tuner
        # autotuned prefill ladder: None = the power-of-two ladder; else a
        # small ascending tuple of bucket lengths
        self.bucket_ladder: Optional[tuple] = None
        self.api = mapi.get_api(cfg)
        self.ctx = ctx
        if ctx.mesh is not None and ctx.mesh.device != self.device:
            raise ValueError(f"engine on {self.device} but this rank's "
                             f"mesh device is {ctx.mesh.device}")
        # the model calls take the ctx (an LM's only under a mesh)
        self._kw = ({"ctx": ctx} if self._is_cell() or ctx.mesh is not None
                    else {})
        prep = dict(self._kw, batch=max_batch) if self._is_cell() else self._kw
        self.params = self.api.prepare_params(params, cfg, self.device,
                                              **prep)
        self._prefill_exes: Dict[int, runtime.GRUExecutable] = {}
        self._decode_exes: Dict[tuple, runtime.GRUExecutable] = {}
        self._decode_warm = set()        # keys whose first step has passed
        self._prefill_cold = set()       # post-retune buckets whose first
                                         # timing is left out
        self._jit_gen = 0                # bumped by every retune
        self.param_rebuilds = 0          # view rebuilds of self.params
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
        a cell family, one aligned batch of at most ``max_batch`` for an
        LM. The encoder-decoder and vision-language families (``audio``,
        ``vlm``) raise ``NotImplementedError``, as in JAX: their inputs
        are more than tokens, and they are served through the model API's
        ``prefill`` and ``decode_step``."""
        reqs = list(requests)
        if self.cfg.family in ("audio", "vlm"):
            raise NotImplementedError("wave serving is LM/cell-family-only; "
                                      "use the model API directly for other "
                                      "families")
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
        """An LM's wave (JAX ``ServeEngine.generate``'s LM path):
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
            {"tokens": torch.from_numpy(toks).to(self.device)}, **self._kw)
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
                                                 next_tok, **self._kw)
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
        """Record one prefill latency. A bucket's first prefill is included
        (cold start is part of the prefill story), except for a bucket
        created after a retune: its first timing is left out, as each
        decode key's first step is, so mid-serve retunes do not pollute
        the steady-state percentiles."""
        if S in self._prefill_cold:
            self._prefill_cold.discard(S)
            return
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

    def _bucket_for(self, S: int) -> int:
        """The prefill bucket a prompt of length ``S`` pads to: the
        autotuned ladder's smallest rung >= S when one is installed
        (prompts above the top rung double from it, so the set of buckets
        stays small), else the power-of-two ladder from ``bucket_min``."""
        if self.bucket_ladder:
            for b in self.bucket_ladder:
                if S <= b:
                    return b
            return bucket_len(S, minimum=self.bucket_ladder[-1] * 2)
        return bucket_len(S, minimum=self.bucket_min)

    # -- frozen executables (the counterpart of JAX's jit caches) -----------

    def _rebuild_views(self, exes) -> bool:
        """Rebuild the prepared params once if ``exes`` read weight views
        they lack (else every call through them would build the views
        again); views already there are kept."""
        if not any(e.missing_views(self.params, device=self.device)
                   for e in exes):
            return False
        self.params = self.api.prepare_params(
            self.params, self.cfg, self.device, executables=tuple(exes),
            **self._kw)
        self.param_rebuilds += 1
        return True

    def _prefill_exe(self, Sb: int) -> runtime.GRUExecutable:
        """The frozen prefill executable of bucket ``Sb`` (slot-shaped
        batch, masked). A bucket created after a retune has its first
        timing left out (``_record_prefill``)."""
        if Sb not in self._prefill_exes:
            exe = self.api.executable(self.cfg, batch=self.max_batch, seq=Sb,
                                      masked=True, mode="prefill",
                                      mesh=self.ctx.mesh)
            self._rebuild_views([exe])
            self._prefill_exes[Sb] = exe
            if self._jit_gen > 0:
                self._prefill_cold.add(Sb)
        return self._prefill_exes[Sb]

    def _decode_exe(self, key: tuple) -> runtime.GRUExecutable:
        """The frozen decode executable of decode key ``key``."""
        if key not in self._decode_exes:
            exe = self.api.executable(self.cfg, batch=key[0], mode="decode",
                                      mesh=self.ctx.mesh)
            self._rebuild_views([exe])
            self._decode_exes[key] = exe
        return self._decode_exes[key]

    def _gru_prefill(self, prompts: List[np.ndarray]) -> dict:
        """One bucketed prefill of up to max_batch prompts; returns cache."""
        Sb = self._bucket_for(max(p.shape[0] for p in prompts))
        feats, mask = self._gru_prefill_batch(prompts, Sb)
        exe = self._prefill_exe(Sb)
        self.prefill_backends.append(exe.sequence_backend)
        t0 = self.clock.now()
        batch = {"features": torch.from_numpy(feats).to(self.device),
                 "mask": torch.from_numpy(mask).to(self.device)}
        _, cache = self.api.prefill(self.params, self.cfg, batch, exe=exe,
                                    **self._kw)
        self._sync()
        self._record_prefill(Sb, self.clock.now() - t0)
        return cache

    def _make_slot(self, r: Request) -> _Slot:
        X = self.cfg.gru.input_dim
        p = np.asarray(r.prompt, np.float32).reshape(-1, X)
        return _Slot(req=r, last_feat=p[-1])

    # -- stepwise wave API: begin / enqueue / step / cancel -----------------

    def gru_wave_begin(self, requests: Sequence[Request] = ()) -> None:
        """Start a fresh continuous-batching wave (cell families only). A
        wave boundary: the attached tuner may retune first."""
        if not self._is_cell():
            raise ValueError(f"family {self.cfg.family!r}: the stepwise wave "
                             f"API serves the cell families only")
        self._maybe_retune()
        X = self.cfg.gru.input_dim
        Bs = self.max_batch
        self._wave = _GruWave(slots=[None] * Bs,
                              nxt=np.zeros((Bs, X), np.float32),
                              key=(Bs, X))
        self.gru_wave_enqueue(requests)

    def gru_wave_enqueue(self, requests: Sequence[Request]) -> None:
        """Queue requests into the live wave (FIFO; they enter slots as
        capacity frees). Starts a wave if none is live."""
        if self._wave is None:
            self.gru_wave_begin(())
        now = self.clock.now()
        X = self.cfg.gru.input_dim
        for r in requests:
            if r.t_submit is None:
                r.t_submit = now
            if self.tuner is not None:
                self.tuner.observe_prompt(
                    np.asarray(r.prompt).reshape(-1, X).shape[0])
            self._wave.pending.append(r)

    def gru_wave_active(self) -> int:
        """Live lanes + queued requests still owed work by this wave."""
        w = self._wave
        if w is None:
            return 0
        return sum(s is not None for s in w.slots) + len(w.pending)

    def gru_work_remaining(self) -> tuple:
        """(requests, decode tokens) still owed by this wave: a router's
        measured queue depth."""
        w = self._wave
        if w is None:
            return 0, 0
        toks = sum(max(1, s.req.max_new_tokens - len(s.req.out))
                   for s in w.slots if s is not None)
        toks += sum(max(1, r.max_new_tokens) for r in w.pending)
        return self.gru_wave_active(), toks

    def bucket_warm(self, prompt_len: int) -> bool:
        """Whether the prefill bucket a prompt of ``prompt_len`` lands in
        already has its executable (a router's bucket affinity)."""
        return self._bucket_for(prompt_len) in self._prefill_exes

    def gru_wave_cancel(self, request: Request) -> bool:
        """Drop a request from the live wave, queued or mid-decode. The
        lane frees at once; its stale cache row is inert (an empty slot's
        output is never read). False if the request is not in this wave
        (it may just have finished)."""
        w = self._wave
        if w is None:
            return False
        for i, r in enumerate(w.pending):
            if r is request:
                del w.pending[i]
                return True
        for j, s in enumerate(w.slots):
            if s is not None and s.req is request:
                w.slots[j] = None
                return True
        return False

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
        exe = self._decode_exe(w.key)
        # attribution follows the frozen executable the step runs through
        backend = self.decode_backend = exe.decode_backend
        t0 = self.clock.now()
        x = torch.from_numpy(w.nxt).to(self.device)
        logits, w.cache = self.api.decode_step(self.params, self.cfg,
                                               w.cache, x, exe=exe,
                                               **self._kw)
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
        if not w.pending and all(s is None for s in w.slots):
            # the wave just drained: a boundary, where the tuner may retune
            self._maybe_retune()
        return finished

    # -- autotune surface (repro_torch.serve.autotune) ----------------------
    #
    # The tuner never mutates the engine directly: it calls these mutators
    # from its maybe_retune(), which the engine invokes only between waves.

    def _maybe_retune(self) -> None:
        """Run the attached tuner if (and only if) no wave work is live."""
        if self.tuner is None:
            return
        if self._wave is not None and self.gru_wave_active() > 0:
            return
        self.tuner.maybe_retune(self)

    def _invalidate_jits(self) -> None:
        """Drop every frozen executable, so the next call resolves against
        the current wave size and cost epoch; the warm and cold markers
        reset with them (each new decode key's first step and each new
        bucket's first prefill are left out of the statistics)."""
        self._prefill_exes.clear()
        self._decode_exes.clear()
        self._decode_warm.clear()
        self._prefill_cold.clear()
        self._jit_gen += 1

    def apply_wave_size(self, n: int) -> None:
        """Resize the decode slot count (a tuner decision, between waves).
        Every executable is batch-shaped, so all are dropped; a drained
        wave object is dropped so the next enqueue builds slots at the new
        size."""
        n = int(n)
        if n < 1 or n == self.max_batch:
            return
        self.max_batch = n
        self._invalidate_jits()
        if self._wave is not None and self.gru_wave_active() == 0:
            self._wave = None

    def apply_bucket_ladder(self, ladder) -> None:
        """Install an autotuned prefill-bucket ladder (ascending lengths;
        empty or None restores the power-of-two ladder). Existing bucket
        executables stay; buckets created from now on have their first
        timing left out."""
        ladder = tuple(int(b) for b in (ladder or ())) or None
        if ladder != self.bucket_ladder:
            self.bucket_ladder = ladder
            self._jit_gen += 1

    def refresh_executables(self) -> bool:
        """After a cost-epoch bump: re-resolve every frozen key and drop
        the executables only if some backend changed (True). The params
        are rebuilt here, once, if the new executables read views they
        lack. When the table confirms the frozen choices, nothing is
        dropped. The tuner calls it after a recalibration; a caller that
        installs a table itself calls it at a wave boundary."""
        if not self._is_cell():
            return False
        mesh = self.ctx.mesh
        fresh = []
        changed = False
        for key, frozen in self._decode_exes.items():
            exe = self.api.executable(self.cfg, batch=key[0], mode="decode",
                                      mesh=mesh)
            fresh.append(exe)
            changed |= exe.decode_backend != frozen.decode_backend
        for Sb, frozen in self._prefill_exes.items():
            exe = self.api.executable(self.cfg, batch=self.max_batch, seq=Sb,
                                      masked=True, mode="prefill", mesh=mesh)
            fresh.append(exe)
            changed |= exe.sequence_backend != frozen.sequence_backend
        if changed:
            self._invalidate_jits()
            self._rebuild_views(fresh)
        return changed

    # -- stats ---------------------------------------------------------------

    def _record_step(self, key: tuple, dt: float,
                     backend: Optional[str]) -> None:
        """Record one decode-step latency; each key's first step is left
        out of the statistics (``decode_backends`` stays aligned). Warm
        steps go to the tuner, which folds them into cost rows."""
        if key in self._decode_warm:
            self.step_times.append(dt)
            self.decode_backends.append(backend)
            if self.tuner is not None and backend is not None:
                g = self.cfg.gru
                self.tuner.observe_step(
                    dt, batch=key[0], backend=backend,
                    depth=g.resolved_num_layers,
                    hidden=g.resolved_layer_dims[0],
                    family=cell_families.cfg_family(g))
        else:
            self._decode_warm.add(key)

    def latency_stats(self) -> Dict[str, float]:
        """Per-step decode latency distribution (the paper's constraint is
        a deadline, so tails matter), prefill timings, per-request queue
        wait and end-to-end time, recorded steps per backend and the
        served dtype (cells: int8 for the ``*_q8`` backends, float32
        otherwise, of the latest resolved decode backend; a transformer LM:
        its compute dtype), and ``autotune``: the tuned shape and, with a
        tuner attached, its decisions. Empty histories report NaN."""
        ts, pf = self.step_times, self.prefill_times
        qw, ee = self.queue_waits, self.e2e_times
        per_backend: Dict[str, int] = {}
        for b in self.decode_backends:
            if b is not None:
                per_backend[b] = per_backend.get(b, 0) + 1
        autotune = {"enabled": self.tuner is not None,
                    "wave_size": self.max_batch,
                    "bucket_ladder": (list(self.bucket_ladder)
                                      if self.bucket_ladder else None)}
        if self.tuner is not None:
            autotune.update(self.tuner.stats())
        return {"decode_backend_steps": per_backend,
                "autotune": autotune,
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
