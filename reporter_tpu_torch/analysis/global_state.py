"""Process-global state leak detection for the port's tests.

Counterpart: reporter_tpu/analysis/global_state.py, over the port's
twins of the same globals: the flight recorder (``tracing.tracer()``),
the installed fault plan, the process link-health sampler, the shadow
auditor, the installed SLO evaluator and the RTPU_* / REPORTER_* /
DATASTORE_* environment. A test that mutates one without restoring it
poisons every later test of its worker process.

Beyond the JAX keys, the link sampler's MOOD is held as well as its
identity: a dispatch timeout notes "dead" on the process sampler, and a
sampler left dead made a later test's /health read dead (the leak behind
the port's test-order failure in test_torch_scheduler.py). Tests that
drive a timeout scope their own sampler (tests/_torch_support.py
``fresh_link_sampler``).

``snapshot()`` captures the restorable surface; ``diff()`` renders the
delta. tests/_torch_support.py snapshots around every port test and fails
the test that leaked.
"""

from __future__ import annotations

import os

__all__ = ["snapshot", "diff"]

_ENV_PREFIXES = ("RTPU_", "REPORTER_", "DATASTORE_")


def _mood(sampler) -> "str | None":
    if sampler is None:
        return None
    latest = sampler.latest()
    return None if latest is None else latest.mood


def snapshot() -> dict:
    from reporter_tpu_torch import faults
    from reporter_tpu_torch.obs import slo as obs_slo
    from reporter_tpu_torch.quality import audit as quality_audit
    from reporter_tpu_torch.utils import linkhealth, tracing

    tr = tracing.tracer()
    lh = linkhealth._global
    return {
        "tracer.enabled": tr.enabled,
        "tracer.dump_dir": tr.dump_dir,
        "tracer.capacity": tr.capacity,
        "tracer.max_dumps": tr.max_dumps,
        # identity: `with faults.use(plan)` restores the previous object
        "faults.installed": faults._installed,
        # identity; None -> X is lazy first construction (legal)
        "linkhealth.sampler": lh,
        "linkhealth.mood": _mood(lh),
        "quality.auditor": quality_audit._global,
        # the package never installs an evaluator: any change is a leak
        "obs.slo": obs_slo._installed,
        "env": {k: v for k, v in os.environ.items()
                if k.startswith(_ENV_PREFIXES)},
    }


def diff(pre: dict, post: dict) -> "list[str]":
    out = []
    for key in ("tracer.enabled", "tracer.dump_dir", "tracer.capacity",
                "tracer.max_dumps"):
        if pre[key] != post[key]:
            out.append(f"{key}: {pre[key]!r} -> {post[key]!r} "
                       "(restore the process-global recorder: "
                       "tracing.configure mutates a singleton)")
    if pre["faults.installed"] is not post["faults.installed"]:
        out.append("faults plan left installed "
                   f"({post['faults.installed']!r}): use "
                   "`with faults.use(plan):` so the restore is scoped")
    pre_lh = pre.get("linkhealth.sampler")
    if pre_lh is not None and pre_lh is not post.get("linkhealth.sampler"):
        out.append("linkhealth sampler swapped and not restored "
                   "(linkhealth.configure(fake) without restoring the "
                   "previous sampler in finally): later tests publish "
                   "the fake's mood at /metrics and /health")
    was, now = pre.get("linkhealth.mood"), post.get("linkhealth.mood")
    if pre_lh is None or pre_lh is post.get("linkhealth.sampler"):
        # a fresh sample on a sampler without one is its first probe; a
        # recorded mood that changes, or any sampler left dead, leaks
        if (now == "dead" and was != "dead") \
                or (was is not None and now != was):
            out.append(f"linkhealth mood {was!r} -> {now!r} on the "
                       "process sampler: a dispatch timeout noted on it "
                       "makes every later /health read dead (scope a "
                       "sampler: tests/_torch_support.fresh_link_sampler)")
    pre_qa = pre.get("quality.auditor")
    if pre_qa is not None and pre_qa is not post.get("quality.auditor"):
        out.append("quality shadow auditor swapped and not restored "
                   "(quality.audit.configure(fake) without restoring the "
                   "previous auditor in finally)")
    if pre.get("obs.slo") is not post.get("obs.slo"):
        out.append("SLO evaluator left installed via obs.slo.install and "
                   "not restored (restore the previous evaluator in "
                   "finally; the package itself never installs one)")
    pe, qe = pre["env"], post["env"]
    for k in sorted(set(pe) | set(qe)):
        if pe.get(k) != qe.get(k):
            out.append(f"os.environ[{k!r}]: {pe.get(k)!r} -> {qe.get(k)!r} "
                       "(use monkeypatch.setenv / restore in finally)")
    return out
