"""Online autotuner (counterpart of ``repro.serve.autotune``): served step
timings flow back into the engine's configuration, so the workload
distribution follows the card's measured behaviour, not static heuristics.

Three dimensions, each evaluated only at wave boundaries (the engine calls
:meth:`AutoTuner.maybe_retune` from ``ServeEngine._maybe_retune``, never
under a live wave):

* **Wave size**: the engine's decode slot count, from the measured
  batch-latency curve of the resolved decode backend
  (:meth:`~repro_torch.core.runtime.CostModel.batch_points` at the served
  (family, depth, H)): the largest batch whose marginal cost
  ``step(B) - step(B-1)`` stays under ``marginal_frac x step(1)`` (and
  under ``step_budget_us``, if set). Fewer than two measured batches: no
  curve, the static size stands.
* **Prompt-bucket ladder**: quantiles of the observed prompt lengths
  (default p50/p75/p90/max) replace the power-of-two buckets; prompts
  above the top rung double from it, so the set of buckets stays small.
* **Online recalibration**: the p50 of the served warm steps folds back
  into the CostModel as measured rows (``CostModel.merged`` +
  ``set_cost_model``, which bumps the cost epoch); the engine drops its
  frozen executables only if the refreshed table changes a backend
  (``refresh_executables``).

Units: a row's ``p50_us`` is the engine's served step, the host clock
around a step that ends in ``torch.cuda.synchronize()`` on the card, not
device time; a table written on one card prices backends on that card
only. Non-positive timings are dropped (``observe_step``; ``merged`` skips
them too), so a ``ManualClock`` run never prices a backend as free.

Every applied change appends a JSON-serializable decision record
``{"kind", "t", "from", "to", "measurement"}`` to
:attr:`AutoTuner.decisions`, surfaced by ``latency_stats()["autotune"]``.
Don't attach a tuner to keep the static behaviour, or switch dimensions
off in :class:`AutoTuneConfig`. An exact ``cfg.backend`` pin is never
overridden by recalibration: pins bypass cost selection.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import cells as cell_families
from repro_torch.core import runtime


@dataclasses.dataclass(frozen=True)
class AutoTuneConfig:
    """Tuning policy knobs (all latencies in µs, matching CostModel rows).

    ``marginal_frac``: a slot is worth adding while the marginal step
    cost of adding it stays under this fraction of the single-lane step
    cost. ``step_budget_us`` optionally caps the absolute per-step
    latency (the paper's deadline translated to a wave-size bound).
    ``ladder_quantiles`` are the observed-prompt-length quantiles that
    become bucket boundaries (the top one should be 1.0 so the ladder
    covers the longest observed prompt). ``recal_min_steps`` throttles
    recalibration: fold timings back only once this many fresh warm
    steps have accumulated since the last fold.
    """
    tune_wave_size: bool = True
    tune_buckets: bool = True
    recalibrate: bool = True
    wave_floor: int = 1
    wave_cap: int = 16
    marginal_frac: float = 0.5
    step_budget_us: Optional[float] = None
    ladder_quantiles: Tuple[float, ...] = (0.5, 0.75, 0.9, 1.0)
    ladder_min_prompts: int = 8
    ladder_max_prompts: int = 4096       # observation window (newest kept)
    recal_min_steps: int = 32


class AutoTuner:
    """The feedback loop's state: observations in, decisions out.

    One tuner per engine. The engine feeds it observations on the hot path
    (cheap appends, no device work):
    ``observe_prompt`` per enqueued request, ``observe_step`` per warm
    recorded decode step. At wave boundaries the engine hands itself to
    ``maybe_retune``, which evaluates each enabled dimension against the
    accumulated measurements and applies what changed through the
    engine's own boundary-safe mutators (``apply_wave_size``,
    ``apply_bucket_ladder``, ``refresh_executables``).
    """

    def __init__(self, config: AutoTuneConfig = AutoTuneConfig()):
        self.config = config
        self.prompt_lens: List[int] = []
        # fresh warm-step samples since the last recalibration fold,
        # grouped by the CostModel row they will become
        self._fresh: Dict[tuple, List[float]] = {}
        self._fresh_n = 0
        self.decisions: List[dict] = []
        self.retunes = 0                 # boundary evaluations that applied
                                         # at least one change

    # -- observation hooks (called by the engine on the hot path) -----------

    def observe_prompt(self, length: int) -> None:
        self.prompt_lens.append(int(length))
        if len(self.prompt_lens) > self.config.ladder_max_prompts:
            del self.prompt_lens[:-self.config.ladder_max_prompts]

    def observe_step(self, dt_s: float, *, batch: int, backend: Optional[str],
                     depth: int, hidden: int, family: str = "gru") -> None:
        """One warm decode-step timing. Non-positive dts are ignored (a
        plain ManualClock measures 0.0 between now() calls — folding that
        into the table would price the backend as free)."""
        if backend is None or dt_s <= 0.0:
            return
        key = (str(family), str(backend), int(depth), int(hidden),
               int(batch))
        self._fresh.setdefault(key, []).append(float(dt_s))
        self._fresh_n += 1

    # -- the retune entry point (wave boundaries only) ----------------------

    def maybe_retune(self, engine) -> List[dict]:
        """Evaluate every enabled dimension; apply and record what
        changed. MUST be called at a wave boundary only — the engine
        enforces that (``ServeEngine._maybe_retune``), which is what
        keeps a retune from ever dropping a live wave's executables.
        Recalibration runs first so the wave-size rule reads the freshest
        curve. Returns the decision records applied this call."""
        applied: List[dict] = []
        now = engine.clock.now()
        if self.config.recalibrate:
            d = self._recalibrate(engine, now)
            if d is not None:
                applied.append(d)
        if self.config.tune_wave_size:
            d = self._tune_wave_size(engine, now)
            if d is not None:
                applied.append(d)
        if self.config.tune_buckets:
            d = self._tune_buckets(engine, now)
            if d is not None:
                applied.append(d)
        if applied:
            self.retunes += 1
            self.decisions.extend(applied)
        return applied

    # -- dimension 1: wave size from the measured batch-latency curve -------

    def _tune_wave_size(self, engine, now: float) -> Optional[dict]:
        g = engine.cfg.gru
        fam = cell_families.cfg_family(g)
        depth = g.resolved_num_layers
        hidden = g.resolved_layer_dims[0]
        exe = runtime.compile(g, batch=engine.max_batch, mode="decode",
                              placement=engine.ctx.mesh)
        backend = exe.decode_backend
        model = runtime.cost_model()
        pts = model.batch_points(backend, "decode", depth=depth,
                                 hidden=hidden, family=fam)
        if len(pts) < 2:
            return None              # no measured curve: static default wins

        def cost(b: int) -> float:
            return model.lookup(backend, "decode", depth=depth, batch=b,
                                hidden=hidden, family=fam)

        cap = max(1, min(self.config.wave_cap, pts[-1][0]))
        floor = max(1, self.config.wave_floor)
        solo = cost(1)
        margin = self.config.marginal_frac * solo
        best = floor
        prev = cost(best)
        for b in range(floor + 1, cap + 1):
            c = cost(b)
            if self.config.step_budget_us is not None \
                    and c > self.config.step_budget_us:
                break
            if c - prev > margin:
                break
            best, prev = b, c
        if best == engine.max_batch:
            return None
        decision = {
            "kind": "wave_size", "t": float(now),
            "from": int(engine.max_batch), "to": int(best),
            "measurement": {
                "family": fam, "backend": backend, "depth": int(depth),
                "hidden": int(hidden),
                "curve_us": [[int(b), float(cost(b))]
                             for b in range(1, cap + 1)],
                "solo_us": float(solo),
                "marginal_cap_us": float(margin),
                "step_budget_us": self.config.step_budget_us,
                "rule": (f"largest B<=cap with step(B)-step(B-1) <= "
                         f"{self.config.marginal_frac:g} x step(1)")}}
        engine.apply_wave_size(best)
        return decision

    # -- dimension 2: bucket ladder from observed prompt lengths ------------

    def _tune_buckets(self, engine, now: float) -> Optional[dict]:
        lens = self.prompt_lens
        if len(lens) < self.config.ladder_min_prompts:
            return None
        arr = np.asarray(lens, np.int64)
        qs = self.config.ladder_quantiles
        # method="higher": every rung is an actually-observed length, so
        # quantile prompts pad by zero timesteps
        rungs = np.quantile(arr, qs, method="higher")
        ladder = tuple(sorted({max(1, int(r)) for r in rungs}))
        if ladder == (engine.bucket_ladder or ()):
            return None
        decision = {
            "kind": "bucket_ladder", "t": float(now),
            "from": (list(engine.bucket_ladder) if engine.bucket_ladder
                     else f"pow2(min={engine.bucket_min})"),
            "to": list(ladder),
            "measurement": {
                "prompts": int(arr.size),
                "quantiles": [float(q) for q in qs],
                "len_p50": int(np.percentile(arr, 50)),
                "len_max": int(arr.max()),
                "rule": "observed prompt-length quantiles become the "
                        "prefill jit keys (longer prompts double from "
                        "the top rung)"}}
        engine.apply_bucket_ladder(ladder)
        return decision

    # -- dimension 3: fold served timings back into the CostModel -----------

    def _recalibrate(self, engine, now: float) -> Optional[dict]:
        if self._fresh_n < self.config.recal_min_steps:
            return None
        g = engine.cfg.gru
        entries = []
        for (fam, backend, depth, hidden, batch), dts in self._fresh.items():
            entries.append({"family": fam, "backend": backend,
                            "op": "decode", "depth": depth,
                            "hidden_dim": hidden, "batch": batch,
                            "p50_us": float(np.percentile(dts, 50) * 1e6),
                            "steps": len(dts)})
        samples, self._fresh, self._fresh_n = self._fresh_n, {}, 0
        if not entries:
            return None
        epoch_from = runtime.cost_epoch()
        runtime.set_cost_model(runtime.cost_model().merged(
            entries, source="<autotune>"))
        # drop the engine's frozen executables only when the refreshed
        # table changes a backend they froze; the same choice costs nothing
        rebuilt = engine.refresh_executables()
        return {
            "kind": "recalibrate", "t": float(now),
            "from": epoch_from, "to": runtime.cost_epoch(),
            "rebuilt_jits": bool(rebuilt),
            "measurement": {
                "steps_folded": samples,
                "entries": entries,
                "decode_backend": engine.decode_backend,
                "rule": (f"fold p50 of >= {self.config.recal_min_steps} "
                         "fresh warm steps into the CostModel "
                         "(set_cost_model epoch bump)")}}

    # -- surface for latency_stats() ----------------------------------------

    def stats(self) -> dict:
        return {"retunes": self.retunes,
                "prompts_observed": len(self.prompt_lens),
                "fresh_steps": self._fresh_n,
                "decisions": [dict(d) for d in self.decisions]}
