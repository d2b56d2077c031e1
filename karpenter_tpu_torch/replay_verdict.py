"""Replay verdict: one human-readable gate line from the replay JSON.

A stdin filter: ``python -m karpenter_tpu_torch.replay | python -m
karpenter_tpu_torch.replay_verdict``. It reads JSON lines holding a
``"replay"`` key (``{"replay": <report>, "store_ab": <A/B or null>}``) or
a ``"metric"`` key (a bench line carrying the report under
``extra.config_9_million_pod_replay``). The JSON passes through UNCHANGED
on stdout (so redirects still capture it); the verdict goes to stderr:

    replay: 1000000 pods / 4 shards peak=L2 crit_shed=0 recovery=1.2s \
default_p99=0.71s store_scan=33.2x — PASS

PASS needs:
- the replay completed (every surviving cohort pod bound, workers alive,
  ladder released) with >= 99% of the configured pods actually offered;
- ZERO system-critical sheds across the whole replay;
- recovery to L0 after the flood (recovery_to_l0_s present);
- ZERO partial gangs when the run injected gang workloads
  (gang_fraction > 0): every all-or-nothing pod group either bound
  whole or stayed wholly Pending;
- when the run pinned cohort pods to spot (spot_fraction > 0): at least
  one seeded spot-interruption actually fired (chaos on), some cohort
  pods really ran on spot, and every pod displaced by a reclaim REBOUND
  (displaced == rebound) — with zero system-critical sheds throughout;
- store list-by-kind scan speedup >= 5x vs the naive store at the
  A/B leg's object count (absent A/B leg → gate N/A, labelled).
"""

from __future__ import annotations

import json
import sys

GATE_SCAN_SPEEDUP = 5.0
GATE_OFFERED_FRACTION = 0.99


def _extract(line: dict):
    """(replay report, store A/B) from either accepted shape: the bench
    line (config_9 under extra) or the replay CLI's direct output."""
    if "replay" in line:
        return line.get("replay"), line.get("store_ab")
    cfg = line.get("extra", {}).get("config_9_million_pod_replay", {})
    return cfg.get("replay"), cfg.get("store_ab")


def verdict(line: dict) -> str:
    replay, ab = _extract(line)
    if not replay:
        note = line.get("extra", {}).get(
            "config_9_million_pod_replay", {}).get("error", "no replay run")
        return f"replay: no report in input ({note}) — NO VERDICT"
    cfg = replay.get("config", {})
    want = cfg.get("pods_total", 0)
    offered = replay.get("offered_total", 0)
    crit_shed = replay.get("system_critical_shed")
    recovery = replay.get("recovery_to_l0_s")
    lat = (replay.get("pending_to_bound_s") or {}).get("default") or {}
    scan_x = (ab or {}).get("scan_speedup")
    gangs = replay.get("gangs") or {}
    gang_cell = (f"{gangs.get('gangs_fully_bound')}/"
                 f"{gangs.get('offered_gangs')}"
                 if gangs.get("offered_gangs") else "n/a")
    spot = replay.get("spot") or {}
    spot_cell = (f"{spot.get('rebound')}/{spot.get('displaced')}rebound"
                 f"(intr={spot.get('interruptions')})"
                 if spot else "n/a")
    head = (f"replay: {offered} pods / {cfg.get('shards')} shards "
            f"peak=L{replay.get('peak_level')} crit_shed={crit_shed} "
            f"recovery={recovery}s default_p99={lat.get('p99')}s "
            f"gangs={gang_cell} spot={spot_cell} "
            f"store_scan={scan_x if scan_x is not None else 'n/a'}x")
    problems = []
    if not replay.get("completed"):
        problems.append(f"incomplete (unbound={replay.get('cohort_unbound')},"
                        f" healthy={replay.get('workers_healthy')})")
    if want and offered < GATE_OFFERED_FRACTION * want:
        problems.append(f"offered {offered} < {GATE_OFFERED_FRACTION:.0%} "
                        f"of configured {want}")
    if crit_shed != 0:
        problems.append(f"{crit_shed} system-critical sheds")
    if recovery is None:
        problems.append("never recovered to L0")
    if gangs.get("offered_gangs") and gangs.get("partial_gangs", 0) != 0:
        problems.append(f"{gangs['partial_gangs']} partial gang(s) — "
                        "all-or-nothing invariant broken")
    if spot:
        if spot.get("rebound", 0) != spot.get("displaced", 0):
            problems.append(
                f"{spot.get('displaced', 0) - spot.get('rebound', 0)} "
                "reclaimed pod(s) never rebound")
        if spot.get("cohort_spot_pods", 0) < 1:
            problems.append("spot leg vacuous: no cohort pod pinned to spot")
        if cfg.get("chaos") and spot.get("interruptions", 0) < 1:
            problems.append("spot leg vacuous: no interruption ever fired")
    if ab is None:
        return f"{head} — store GATE N/A (A/B leg not run); replay " + \
            ("PASS" if not problems else f"FAIL ({'; '.join(problems)})")
    if scan_x is None or scan_x < GATE_SCAN_SPEEDUP:
        problems.append(f"store scan speedup {scan_x} < {GATE_SCAN_SPEEDUP}x")
    if problems:
        return f"{head} — FAIL ({'; '.join(problems)})"
    return (f"{head} — PASS (crit_shed=0, L0 recovery, "
            f"scan >= {GATE_SCAN_SPEEDUP}x at {(ab or {}).get('objects')} "
            "objects)")


def main() -> int:
    last = None
    for raw in sys.stdin:
        sys.stdout.write(raw)  # pass-through: stdout stays the pure JSON
        raw = raw.strip()
        if not raw:
            continue
        try:
            line = json.loads(raw)
            if isinstance(line, dict) and ("metric" in line
                                           or "replay" in line):
                last = line
        except ValueError:
            continue
    sys.stdout.flush()
    if last is None:
        print("replay: no JSON line on stdin — NO VERDICT", file=sys.stderr)
        return 1
    print(verdict(last), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
