"""Launch counters of the kernel wrappers, and their replay through graphs.

Each wrapper that launches a hand-written kernel is registered here with
:func:`counter` and bumps its count with :func:`count` at the launch:
``fn.launches`` in all, and ``fn.launches_by_route[route]`` for the
forwards that pick between two kernels. A CUDA graph replay runs the
recorded kernels without the Python that counts them, so
:mod:`~llm_in_practise_tpu_torch.serve.graphs` takes a :func:`snapshot`
around each capture, puts the counts back (a capture launches nothing),
and :func:`add`\\ s the capture's :func:`delta` on every replay.
"""

from __future__ import annotations

_COUNTED: list = []   # every registered wrapper, in registration order


def counter(fn, routes: tuple | None = None):
    """Register ``fn`` with its counts at 0 (and one per route)."""
    fn.launches = 0
    if routes is not None:
        fn.launches_by_route = dict.fromkeys(routes, 0)
    _COUNTED.append(fn)
    return fn


def count(fn, route: str | None = None) -> None:
    """One launch of ``fn``'s kernel (on ``route``)."""
    fn.launches += 1
    if route is not None:
        fn.launches_by_route[route] += 1


def snapshot() -> dict:
    """Every registered wrapper's counts: ``{fn: (launches, by_route)}``."""
    return {fn: (fn.launches, dict(getattr(fn, "launches_by_route", {})))
            for fn in _COUNTED}


def delta(before: dict, after: dict) -> dict:
    """The launches between two snapshots, in the snapshot's form."""
    out = {}
    for fn, (n, routes) in after.items():
        n0, routes0 = before[fn]
        out[fn] = (n - n0, {r: c - routes0[r] for r, c in routes.items()})
    return out


def restore(snap: dict) -> None:
    for fn, (n, routes) in snap.items():
        fn.launches = n
        if routes:
            fn.launches_by_route.update(routes)


def add(d: dict) -> None:
    """Book the launches ``d`` (a :func:`delta`) once more."""
    for fn, (n, routes) in d.items():
        fn.launches += n
        for r, c in routes.items():
            fn.launches_by_route[r] += c
