"""Trace-replay arrival schedules for the serving benches.

Port of ``llm_in_practise_tpu/serve/arrivals.py`` (numpy only; the same
seed gives the same schedule). Uniform closed-loop ladders (N workers,
back-to-back requests) measure steady-state throughput but never the
shapes real traffic has: bursts, idle gaps, and mixed prompt and output
lengths arriving together. This module synthesizes a seeded, replayable
arrival trace:

- **Bursty inter-arrivals**: Gamma-distributed gaps with a chosen
  coefficient of variation (``cv = 1`` is Poisson; ``cv > 1`` is
  burstier). The Gamma shape is ``1/cv^2`` and the scale
  ``mean * cv^2``, so the mean inter-arrival time is exact whatever the
  burstiness.
- **Mixed lengths**: per-request prompt and output token counts drawn
  log-uniformly from configured ranges.
- **Replayability**: everything derives from one ``numpy`` Generator
  seed, so a later run replays the identical trace.

:func:`replay` drives any ``submit(request) -> handle`` callable at the
scheduled offsets from a pool of worker threads (open loop: a late
engine does not slow the arrival clock; queueing shows up as queueing).
``chip_smoke.py``'s ``serve_struct`` phase drives its traffic with it.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request: offset seconds from trace start, prompt
    length and output budget in tokens."""

    at_s: float
    prompt_tokens: int
    max_tokens: int


def synthesize(*, seed: int, n_requests: int, mean_iat_s: float,
               cv: float = 2.0, prompt_tokens: tuple[int, int] = (8, 64),
               max_tokens: tuple[int, int] = (8, 64)) -> list[Arrival]:
    """Seeded bursty trace: Gamma(1/cv², mean·cv²) inter-arrivals plus
    log-uniform prompt/output lengths. ``cv=1`` degenerates to Poisson;
    ``cv=0`` to a uniform (closed-ladder-like) clock."""
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if mean_iat_s < 0:
        raise ValueError(f"mean_iat_s must be >= 0, got {mean_iat_s}")
    rng = np.random.default_rng(seed)
    if cv <= 0 or mean_iat_s == 0:
        gaps = np.full((n_requests,), mean_iat_s)
    else:
        shape = 1.0 / (cv * cv)
        gaps = rng.gamma(shape, mean_iat_s / shape, size=n_requests)
    at = np.cumsum(gaps)
    at -= at[0]  # first request arrives at t=0

    def log_uniform(lo: int, hi: int, size: int) -> np.ndarray:
        lo, hi = max(1, int(lo)), max(1, int(hi))
        if hi <= lo:
            return np.full((size,), lo)
        return np.exp(rng.uniform(np.log(lo), np.log(hi + 1), size=size)
                      ).astype(np.int64).clip(lo, hi)

    plens = log_uniform(*prompt_tokens, n_requests)
    olens = log_uniform(*max_tokens, n_requests)
    return [Arrival(float(at[i]), int(plens[i]), int(olens[i]))
            for i in range(n_requests)]


def describe(schedule: list[Arrival]) -> dict:
    """Artifact block: the schedule's realized statistics (the seeded
    parameters reproduce it; the realized numbers make drift visible)."""
    gaps = np.diff([a.at_s for a in schedule]) if len(schedule) > 1 else (
        np.zeros((1,)))
    return {
        "n_requests": len(schedule),
        "span_s": round(schedule[-1].at_s, 4) if schedule else 0.0,
        "iat_mean_s": round(float(np.mean(gaps)), 5),
        "iat_cv": round(float(np.std(gaps) / np.mean(gaps)), 3)
        if float(np.mean(gaps)) > 0 else 0.0,
        "prompt_tokens_mean": round(float(np.mean(
            [a.prompt_tokens for a in schedule])), 1),
        "max_tokens_mean": round(float(np.mean(
            [a.max_tokens for a in schedule])), 1),
    }


@dataclasses.dataclass(frozen=True)
class SessionArrival:
    """One turn of one conversation in a multi-turn trace: the session
    identity and turn index ride with the usual offset/length fields so
    a bench can key routing, build the cumulative prompt, and tell a
    cold first turn from warm follow-ups."""

    at_s: float
    session_id: str
    turn: int                # 0-based within the session
    n_turns: int             # this session's total turns
    prompt_tokens: int       # NEW tokens this turn appends
    max_tokens: int
    adapter: str | None = None   # tenant (--lora-modules name), if mixed


def synthesize_sessions(*, seed: int, n_sessions: int,
                        turns: tuple[int, int] = (2, 5),
                        mean_iat_s: float = 0.05, cv: float = 2.0,
                        think_time_s: tuple[float, float] = (0.05, 0.3),
                        prompt_tokens: tuple[int, int] = (8, 48),
                        max_tokens: tuple[int, int] = (8, 32),
                        adapters: list[str] | None = None,
                        ) -> list[SessionArrival]:
    """Seeded multi-turn session trace.

    Sessions OPEN with the bursty Gamma inter-arrival clock of
    :func:`synthesize`; each session then runs ``turns`` follow-ups
    separated by log-uniform think-time gaps — so turns of different
    sessions interleave and a replica's cache sees unrelated traffic
    between one conversation's turns (the case session pinning exists
    for). ``adapters`` assigns each session a tenant round-robin
    (mixed multi-LoRA traffic); the per-turn ``prompt_tokens`` is the
    NEW suffix — the caller accumulates the shared prefix, which is
    what makes follow-ups warm-hittable at all. Returned sorted by
    ``at_s``: the global arrival order :func:`replay` fires in.
    """
    if n_sessions < 1:
        raise ValueError(f"n_sessions must be >= 1, got {n_sessions}")
    rng = np.random.default_rng(seed)
    if cv <= 0 or mean_iat_s == 0:
        gaps = np.full((n_sessions,), mean_iat_s)
    else:
        shape = 1.0 / (cv * cv)
        gaps = rng.gamma(shape, mean_iat_s / shape, size=n_sessions)
    opens = np.cumsum(gaps)
    opens -= opens[0]
    out: list[SessionArrival] = []
    lo_t, hi_t = max(1, int(turns[0])), max(1, int(turns[1]))
    for s in range(n_sessions):
        n_turns = int(rng.integers(lo_t, hi_t + 1))
        adapter = (adapters[s % len(adapters)]
                   if adapters else None)
        at = float(opens[s])
        for t in range(n_turns):
            if t > 0:
                lo, hi = think_time_s
                at += float(np.exp(rng.uniform(
                    np.log(max(lo, 1e-4)), np.log(max(hi, 1e-4)))))
            out.append(SessionArrival(
                at_s=at,
                session_id=f"sess-{seed}-{s}",
                turn=t, n_turns=n_turns,
                prompt_tokens=int(rng.integers(
                    max(1, prompt_tokens[0]),
                    max(1, prompt_tokens[1]) + 1)),
                max_tokens=int(rng.integers(
                    max(1, max_tokens[0]),
                    max(1, max_tokens[1]) + 1)),
                adapter=adapter))
    out.sort(key=lambda a: (a.at_s, a.session_id, a.turn))
    return out


def describe_sessions(schedule: list[SessionArrival]) -> dict:
    """Artifact block for a session trace (mirrors :func:`describe`)."""
    sessions = {a.session_id for a in schedule}
    warm = [a for a in schedule if a.turn > 0]
    return {
        "n_sessions": len(sessions),
        "n_turns": len(schedule),
        "warm_turns": len(warm),
        "span_s": round(schedule[-1].at_s, 4) if schedule else 0.0,
        "turns_per_session_mean": round(
            len(schedule) / max(1, len(sessions)), 2),
        "prompt_tokens_mean": round(float(np.mean(
            [a.prompt_tokens for a in schedule])), 1) if schedule else 0.0,
        "adapters": sorted({a.adapter for a in schedule
                            if a.adapter is not None}),
    }


def replay(schedule: list[Arrival], submit, *, workers: int = 8,
           time_scale: float = 1.0, lateness: list | None = None) -> list:
    """Open-loop replay: fire ``submit(arrival)`` at each arrival's
    scheduled offset (scaled by ``time_scale``) from a worker pool, and
    return the submit results in schedule order.

    Open-loop holds only while in-flight requests fit the pool: callers
    that BLOCK inside ``submit`` (drain the stream) bound concurrency
    at ``workers``, and arrivals past that fire LATE — a degradation
    toward closed-loop that must be visible, not assumed away. Pass a
    ``lateness`` list to receive each arrival's realized (start − due)
    seconds in schedule order; the benches embed its p99/max so an
    artifact states the load actually applied, not just the schedule.
    """
    results: list = [None] * len(schedule)
    late: list = [0.0] * len(schedule)
    idx_lock = threading.Lock()
    next_idx = [0]
    t0 = time.monotonic()

    def worker():
        while True:
            with idx_lock:
                i = next_idx[0]
                if i >= len(schedule):
                    return
                next_idx[0] += 1
            due = t0 + schedule[i].at_s * time_scale
            delay = due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            late[i] = max(0.0, time.monotonic() - due)
            results[i] = submit(schedule[i])

    threads = [threading.Thread(target=worker)
               for _ in range(max(1, workers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if lateness is not None:
        lateness.extend(late)
    return results


def lateness_stats(lateness: list) -> dict:
    """Artifact block for a replay's realized arrival lateness."""
    arr = np.asarray(lateness if lateness else [0.0])
    return {
        "arrival_lateness_p99_s": round(float(np.percentile(arr, 99)), 4),
        "arrival_lateness_max_s": round(float(arr.max()), 4),
    }
