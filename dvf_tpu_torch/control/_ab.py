"""The A/B leg machinery the auto-planner ranks its candidates with
(port of the repo-root ``benchtools.ab_comparison``).

The package keeps its own copy: it never imports ``benchtools``, which
belongs to the JAX package's bench harness. The function is the
reference's line for line, so a plan search ranks, seeds and aborts its
legs as the reference's does.
"""

from __future__ import annotations


def ab_comparison(legs, measure, *, prior=None, keep_leg=None, meta=None,
                  on_leg=None, abort=None, log=None):
    """One incremental A/B comparison — the leg machinery shared by
    the reference's bench table (its
    benchmarks/run_table.py impl-comparison phase) and the auto-planner's
    candidate search (``dvf_tpu_torch.control.planner``), per the
    "one paced-measurement path" rule: bench rounds and production plan
    search must rank legs, seed partial priors, and early-abort the same
    way, or their winners are not comparable.

    - ``legs``: ``[(label, payload), ...]`` measured in order by
      ``measure(label, payload) -> dict`` (``{"fps": ...}`` on success,
      ``{"error": ...}`` on failure — an error leg is recorded, not
      raised).
    - ``prior``: an earlier partial comparison dict; legs whose prior
      entry passes ``keep_leg(entry)`` are seeded and not re-measured
      (the caller decides whether the prior's run mode/stamp qualifies
      it at all).
    - ``meta``: provenance merged into the comparison up front
      (code_rev, run mode).
    - ``on_leg(comp, label)``: called after every measured leg — the
      per-leg persist hook (a dying run keeps its finished legs).
    - ``abort(result) -> bool``: consulted after an error leg; True
      stops the comparison (returned incomplete, no winner — the next
      run fills the rest from the seeded partial).

    Returns ``(comp, completed)``. On completion ``comp["winner"]`` is
    the label with the highest ``fps`` (``"n/a"`` when every leg
    errored)."""
    comp = dict(meta or {})
    prior = prior or {}
    for label, _ in legs:
        entry = prior.get(label)
        if keep_leg is not None and isinstance(entry, dict) \
                and keep_leg(entry):
            comp[label] = entry
            if log:
                log(f"{label}: kept from partial prior run")
    for label, payload in legs:
        if label in comp:
            continue
        comp[label] = measure(label, payload)
        if on_leg:
            on_leg(comp, label)
        if ("error" in comp[label] and abort is not None
                and abort(comp[label])):
            return comp, False
    fps = {k: v.get("fps", 0) for k, v in comp.items()
           if isinstance(v, dict) and "fps" in v}
    comp["winner"] = max(fps, key=fps.get) if any(fps.values()) else "n/a"
    return comp, True
