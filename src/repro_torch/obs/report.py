"""Run reports from exported traces:  ``python -m repro_torch.obs.report
trace.jsonl`` renders the run timeline — regime marks, drift alarms,
every committed decision with its re-plan latency, cache hit rate,
first-call costs per surface key, engine calls by device, SLO burn —
from the JSONL flight-recorder export alone.

The report is evidence, not narration: the decision log it reconstructs
from ``commit`` events is bit-for-bit the controller's own event list
(``benchmarks/control_loop.py`` gates the equality on every run, and
``--smoke`` fails CI if they ever disagree), so a trace file IS the
authoritative record of what the control loop decided and why.
"""
from __future__ import annotations

import argparse
import sys
from collections import Counter as _TallyCounter
from typing import Iterable, List, Sequence, Tuple

from .recorder import Event, parse_jsonl

__all__ = ["decision_log", "decision_log_from_control_events",
           "load_trace", "render_report"]


def load_trace(path: str) -> List[Event]:
    return parse_jsonl(path)


def decision_log(events: Iterable[Event]) -> List[Tuple]:
    """The committed decision log carried by a trace, in commit order:
    ``(at, kind, old_k, new_k, assignment, trigger)`` per commit —
    logical (sample-index) coordinates only, so the log is clock- and
    machine-independent."""
    out = []
    for e in events:
        if e.kind != "commit":
            continue
        f = e.field_dict()
        out.append((int(f["at"]), e.name, int(f["old_k"]),
                    int(f["new_k"]), f.get("assignment"),
                    f.get("trigger", e.name)))
    return out


def decision_log_from_control_events(control_events) -> List[Tuple]:
    """The same tuple shape derived from live ``ControlEvent`` objects
    (``controller.events`` / ``ReplayResult.events``) — what the trace
    log is gated bit-for-bit against."""
    out = []
    for e in control_events:
        trigger = e.drift.kind if e.drift is not None else e.kind
        a = e.new_policy.assignment
        out.append((int(e.at), e.kind, int(e.old_policy.k),
                    int(e.new_policy.k),
                    None if a is None else repr(a), trigger))
    return out


def _fmt_ms(seconds) -> str:
    return f"{seconds * 1e3:8.2f} ms"


def render_report(events: Sequence[Event]) -> str:
    """Human-readable run timeline of one trace."""
    lines: List[str] = []
    w = lines.append
    tally = _TallyCounter(e.kind for e in events)
    t_span = events[-1].ts - events[0].ts if events else 0.0
    w("== trace summary " + "=" * 45)
    w(f"  events: {len(events)}  spanning {t_span:.3f} s  "
      f"({', '.join(f'{k}:{v}' for k, v in sorted(tally.items()))})")

    regimes = [e for e in events if e.kind == "mark" and e.name == "regime"]
    if regimes:
        w("== regimes " + "=" * 51)
        for e in regimes:
            f = e.field_dict()
            extra = "  ".join(f"{k}={v}" for k, v in sorted(f.items())
                              if k != "regime")
            w(f"  regime {f.get('regime', '?')}: {extra}")

    alarms = [e for e in events if e.kind == "drift_alarm"]
    if alarms:
        w("== drift alarms " + "=" * 46)
        for e in alarms:
            f = e.field_dict()
            w(f"  t={e.ts:9.3f}s  [{f.get('channel', '?'):7s}] "
              f"{f.get('alarm_kind', e.name):14s} at sample "
              f"{f.get('at', '?')} (stat {f.get('stat', '?')})")

    commits = [e for e in events if e.kind == "commit"]
    if commits:
        w("== committed decisions " + "=" * 39)
        for e in commits:
            f = e.field_dict()
            flags = "".join([
                " cached" if f.get("cached") else "",
                " warm" if f.get("warm") else "",
                " FALLBACK" if f.get("fallback") else "",
                " hedged" if f.get("hedged") else "",
                " switched" if f.get("switched") else " held"])
            asg = f.get("assignment")
            asg_s = "" if asg is None else f"  placement {asg}"
            q = f.get("quarantined") or ()
            q_s = f"  quarantined {list(q)}" if q else ""
            w(f"  t={e.ts:9.3f}s  at={f['at']:<7d} {e.name:8s} "
              f"trigger={f.get('trigger', e.name):12s} "
              f"k {f['old_k']:>3d} -> {f['new_k']:<3d} "
              f"replan {f.get('replan_ms', float('nan')):7.2f} ms "
              f"[{f.get('family', '?')}]{flags}{asg_s}{q_s}")
        replans = [e.field_dict().get("replan_ms") for e in commits]
        replans = [r for r in replans if r is not None]
        if replans:
            w(f"  re-plan latency: n={len(replans)}  "
              f"max {max(replans):.2f} ms  "
              f"mean {sum(replans) / len(replans):.2f} ms")

    hits = tally.get("cache_hit", 0)
    misses = tally.get("cache_miss", 0)
    if hits or misses:
        # the port compiles nothing: a miss is a new structural key, and
        # its ``compile`` event carries that first call's wall time
        w("== surface cache " + "=" * 45)
        w(f"  lookups {hits + misses}  hits {hits}  misses {misses}  "
          f"hit rate {hits / max(hits + misses, 1):.1%}")
        compiles = [e for e in events if e.kind == "compile"]
        for e in compiles:
            f = e.field_dict()
            w(f"  first call t={e.ts:9.3f}s  {e.name}  "
              f"{f.get('wall_ms', float('nan')):.1f} ms")

    fallbacks = [e for e in events if e.kind == "oracle_fallback"]
    if fallbacks:
        w("== oracle fallbacks " + "=" * 42)
        for e in fallbacks:
            w(f"  t={e.ts:9.3f}s  {e.name}: "
              f"{e.field_dict().get('error', '')}")

    quarantines = [e for e in events if e.kind == "quarantine"]
    if quarantines:
        w("== quarantine " + "=" * 48)
        for e in quarantines:
            f = e.field_dict()
            w(f"  t={e.ts:9.3f}s  workers {list(f.get('workers', ()))} "
              f"(was {list(f.get('previous', ()))})")

    slo_alarms = [e for e in events if e.kind == "slo_alarm"]
    slo_marks = [e for e in events if e.kind == "mark" and e.name == "slo"]
    if slo_alarms or slo_marks:
        w("== SLO " + "=" * 55)
        for e in slo_alarms:
            f = e.field_dict()
            w(f"  BURN t={e.ts:9.3f}s at obs {f.get('at', '?')}: "
              f"fast {f.get('burn_fast', float('nan')):.1f}x / "
              f"slow {f.get('burn_slow', float('nan')):.1f}x budget "
              f"(target {f.get('target', '?')})")
        for e in slo_marks:
            f = e.field_dict()
            w("  state: " + "  ".join(
                f"{k}={v}" for k, v in sorted(f.items())))

    sweeps = [e for e in events if e.kind == "sweep"]
    if sweeps:
        w("== engine sweeps " + "=" * 45)
        by_name = _TallyCounter(e.name for e in sweeps)
        for name in sorted(by_name):
            sel = [e for e in sweeps if e.name == name]
            durs = [e.dur for e in sel if e.dur is not None]
            devices = _TallyCounter(str(e.field_dict().get("device", "?"))
                                    for e in sel)
            extra = "  (" + ", ".join(
                f"{c} on {d}" for d, c in sorted(devices.items())) + ")"
            if durs:
                w(f"  {name}: {len(sel)} calls  total "
                  f"{_fmt_ms(sum(durs))}  max {_fmt_ms(max(durs))}{extra}")
            else:
                w(f"  {name}: {len(sel)} calls{extra}")

    spans = [e for e in events if e.kind == "span"]
    if spans:
        w("== spans " + "=" * 53)
        agg = {}
        for e in spans:
            tot, mx, cnt = agg.get(e.name, (0.0, 0.0, 0))
            agg[e.name] = (tot + (e.dur or 0.0),
                           max(mx, e.dur or 0.0), cnt + 1)
        for name in sorted(agg):
            tot, mx, cnt = agg[name]
            w(f"  {name:24s} n={cnt:<5d} total {_fmt_ms(tot)}  "
              f"max {_fmt_ms(mx)}")

    if commits:
        w("== decision log " + "=" * 46)
        for row in decision_log(events):
            w(f"  {row}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Render a run report from a flight-recorder JSONL "
                    "trace.")
    ap.add_argument("trace", help="path to the exported trace.jsonl")
    ap.add_argument("--decisions", action="store_true",
                    help="print only the reconstructed decision log "
                         "(one tuple per line)")
    args = ap.parse_args(argv)
    events = load_trace(args.trace)
    if args.decisions:
        for row in decision_log(events):
            print(row)
        return 0
    print(render_report(events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
