"""Runs the two experience phases of ``chip_smoke.py`` alone (the store's
cold run, then the warm run in a second process over the same store) and
keeps what the warm boot decides on, so a missed warm boot can be studied
on the host afterwards.

    python3 scripts/experience_probe.py [--out DIR]
    python3 scripts/experience_probe.py --analyse [--out DIR]

The link is measured once, as ``chip_smoke.py`` does, and both phases get
it.  In the cold process every ``ExperienceStore.record_job`` pickles the
job's sequence (the timeline its final plan was certified on); in the warm
process every ``ExperienceStore.lookup_plan`` logs, for each stored plan
of the pipeline, its certified peak, the iteration time it was built on
and the peak it verifies at after the rebase onto the current timeline
(the first lookup of each job also pickles the sequence it is asked
about).  The files go to ``DIR`` (default
``chiprun_out/experience_probe``): ``cold_<job>.pkl`` and
``warm_<job>.pkl``, and ``result.json`` with both phases' results (or the
error of the one that failed).  Needs one CUDA card.

``--analyse`` reads those files on the host (no card): for each job the
warm run looked up, the stored plan's peak on the cold timeline it was
certified on, and the peaks the current ``_rebase_plan`` verifies at on
that timeline and on the warm one.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import experience as exp  # noqa: E402
from repro_torch.core import analyze  # noqa: E402


def _dump(out: str, name: str, obj) -> None:
    with open(os.path.join(out, name), "wb") as f:
        pickle.dump(obj, f)


def _spy_cold(out: str) -> None:
    record_job = exp.ExperienceStore.record_job

    def spy(self, fp, *, seq, **kw):
        plan = kw.get("plan")
        _dump(out, f"cold_{kw.get('job_id')}.pkl",
              {"fingerprint": fp, "seq": seq,
               "plan": plan.to_dict() if plan is not None else None})
        return record_job(self, fp, seq=seq, **kw)

    exp.ExperienceStore.record_job = spy


def _spy_warm(out: str) -> None:
    lookup = exp.ExperienceStore.lookup_plan

    def spy(self, seq, pipeline, budget_bytes, profile=None):
        entry = self.get(self.fingerprint(seq))
        cands = []
        for rec in (entry.plans.values() if entry is not None else ()):
            plan = exp._rebase_plan(rec, seq)
            cands.append({
                "pipeline": rec.pipeline, "bucket": rec.bucket,
                "budget_bytes": rec.budget_bytes,
                "peak_bytes": rec.peak_bytes,
                "iteration_time": rec.iteration_time,
                "events": len(rec.plan.get("events", ())),
                "rebased_peak": (analyze([seq], plans={seq.job_id: plan})
                                 .peak_bytes if plan is not None else None)})
        print("[probe] lookup_plan " + json.dumps({
            "job": seq.job_id, "budget": budget_bytes,
            "iteration_time": seq.iteration_time, "candidates": cands}),
            flush=True)
        if not os.path.exists(os.path.join(out, f"warm_{seq.job_id}.pkl")):
            _dump(out, f"warm_{seq.job_id}.pkl",
                  {"seq": seq, "budget": budget_bytes, "candidates": cands,
                   "records": [r.__dict__ for r in (
                       entry.plans.values() if entry is not None else ())]})
        return lookup(self, seq, pipeline, budget_bytes, profile)

    exp.ExperienceStore.lookup_plan = spy


def child(phase: str, out: str, args: list) -> int:
    """One phase in this process: the spies on, then the phase; the last
    line is its result as JSON."""
    (_spy_cold if phase == "experience_cold" else _spy_warm)(out)
    res = cs.FRESH_PHASES[phase](*args)
    print(json.dumps(res, default=str))
    return 0


def run_child(phase: str, out: str, *args) -> dict:
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--child", phase, "--out", out, json.dumps(args)],
                         capture_output=True, text=True, timeout=900)
    print(res.stdout[-200000:], end="")
    print(res.stderr[-20000:], end="", file=sys.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"{phase} failed (rc {res.returncode})")
    print(f"[probe] {phase} {time.perf_counter() - t0:.2f} s", flush=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


def analyse(out: str) -> dict:
    """The stored plans of the dumped runs, rebased by this checkout."""
    res = {}
    for name in sorted(os.listdir(out)):
        if not name.startswith("warm_"):
            continue
        job = name[len("warm_"):-len(".pkl")]
        with open(os.path.join(out, name), "rb") as f:
            warm = pickle.load(f)
        with open(os.path.join(out, f"cold_{job}.pkl"), "rb") as f:
            cold = pickle.load(f)
        rows = []
        for r in warm["records"]:
            rec = exp.PlanRecord(**r)
            plan = exp.SchedulingPlan.from_dict(rec.plan)
            row = {"certified_peak": rec.peak_bytes,
                   "budget": warm["budget"],
                   "cold_timeline_s": cold["seq"].iteration_time,
                   "warm_timeline_s": warm["seq"].iteration_time,
                   "on_cold": analyze([cold["seq"]], plans={
                       job: plan}).peak_bytes}
            for where in ("cold", "warm"):
                seq = (cold if where == "cold" else warm)["seq"]
                p = exp._rebase_plan(rec, seq)
                row[f"rebased_on_{where}"] = (
                    analyze([seq], plans={job: p}).peak_bytes
                    if p is not None else None)
            rows.append(row)
        res[job] = rows
    print("[probe] analyse " + json.dumps(res))
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "experience_probe"))
    ap.add_argument("--child", default=None)
    ap.add_argument("--analyse", action="store_true")
    ap.add_argument("args", nargs="?", default="[]")
    a = ap.parse_args()
    os.makedirs(a.out, exist_ok=True)
    if a.child:
        return child(a.child, a.out, json.loads(a.args))
    if a.analyse:
        analyse(a.out)
        return 0
    print(cs.card_line(), flush=True)
    link = cs.measure_host_link()
    print("[probe] link " + json.dumps(link), flush=True)
    store = tempfile.mkdtemp(prefix="tensile-experience-")
    result = {"link": link}
    try:
        cold = run_child("experience_cold", a.out, link, store)
        result["cold"] = cold
        result["warm"] = run_child("experience_warm", a.out, link, store,
                                   cold["handoff"])
    except Exception:  # noqa: BLE001 - kept beside what the phases left
        result["error"] = traceback.format_exc()
    finally:
        shutil.rmtree(store, ignore_errors=True)
        with open(os.path.join(a.out, "result.json"), "w") as f:
            json.dump(result, f, default=str)
    print("[probe] " + ("failed" if "error" in result else "ok"))
    return 1 if "error" in result else 0


if __name__ == "__main__":
    sys.exit(main())
